// Tiling shared by the flash-CE forward (flash_ce.cu) and backward
// (flash_ce_bwd.cu) kernels: a 128 x 128 output tile per block of 256
// threads, each thread an 8 x 8 micro-tile in registers, operands staged
// through shared memory 16 deep. Every product is fp32 FMA on the CUDA
// cores (no tensor cores, no TF32).
//
// A thread's 8 rows (or columns) are two groups of 4, 64 apart
// (`tile_index`), so that the 16 threads of a half-warp read 64 consecutive
// floats of a staged operand with one conflict-free 16-byte load each.
//
// With `bf16` set the operands of a product are rounded to bfloat16 before
// they are staged and accumulated in fp32: the arithmetic of a bf16 matrix
// product with an fp32 accumulator. Row norms always come from the fp32
// values.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hfa_ce {

constexpr int TILE = 128;     // rows and columns of a block's output tile
constexpr int DEPTH = 16;     // staged depth of a product
constexpr int LD = TILE + 4;  // row pitch of a staged operand, in floats
constexpr int THREADS = 256;  // 16 x 16 threads, 8 x 8 outputs each

// The i-th (0..7) row or column of thread coordinate t (0..15).
__device__ __forceinline__ int tile_index(int t, int i) {
  return (i < 4) ? t * 4 + i : 64 + t * 4 + (i - 4);
}

__device__ __forceinline__ float maybe_bf16(float x, bool bf16) {
  return bf16 ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

// Stage rows [r0, r0 + 128) x depth [k0, k0 + 16) of a row-major (rows, d)
// matrix, depth contiguous in memory, as dst[k][row] (transposed). Rows at
// or beyond `rows` and depths at or beyond `d` read as 0. Thread t loads 4
// consecutive depths of rows t/4 and t/4 + 64. `sumsq`, when given, gets
// the squares of the fp32 values of those two rows added (before any bf16
// rounding).
__device__ __forceinline__ void stage_depth_major(
    float* __restrict__ dst, const float* __restrict__ src, int64_t rows,
    int d, int64_t r0, int k0, bool vec, bool bf16, float* sumsq) {
  const int t = threadIdx.x;
  const int kq = (t & 3) * 4;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = (t >> 2) + half * 64;
    const int64_t r = r0 + row;
    float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (r < rows) {
      const float* p = src + r * (int64_t)d + k0 + kq;
      if (vec) {
        if (k0 + kq < d) {
          const float4 q = *reinterpret_cast<const float4*>(p);
          v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
        }
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (k0 + kq + i < d) v[i] = p[i];
      }
    }
    if (sumsq != nullptr)
      sumsq[half] += v[0] * v[0] + v[1] * v[1] + v[2] * v[2] + v[3] * v[3];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      dst[(kq + i) * LD + row] = maybe_bf16(v[i], bf16);
  }
}

// Stage depth rows [k0, k0 + 16) x columns [n0, n0 + 128) of a row-major
// (krows, d) matrix, columns contiguous in memory, as dst[k][col]. Thread t
// loads 4 consecutive columns of depth rows t/32 and t/32 + 8.
__device__ __forceinline__ void stage_column_major(
    float* __restrict__ dst, const float* __restrict__ src, int64_t krows,
    int d, int64_t k0, int n0, bool vec, bool bf16) {
  const int t = threadIdx.x;
  const int col = (t & 31) * 4;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int kr = (t >> 5) + half * 8;
    const int64_t k = k0 + kr;
    float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (k < krows) {
      const float* p = src + k * (int64_t)d + n0 + col;
      if (vec) {
        if (n0 + col < d) {
          const float4 q = *reinterpret_cast<const float4*>(p);
          v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
        }
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (n0 + col + i < d) v[i] = p[i];
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      dst[kr * LD + col + i] = maybe_bf16(v[i], bf16);
  }
}

// acc[i][j] += sum over k < DEPTH of a[k][row_i] * b[k][col_j], both
// operands staged as [k][index] with pitch LD.
__device__ __forceinline__ void fma_staged(const float* __restrict__ a,
                                           const float* __restrict__ b,
                                           int ty, int tx,
                                           float (&acc)[8][8]) {
#pragma unroll
  for (int k = 0; k < DEPTH; ++k) {
    float av[8], bv[8];
    const float4 a0 = *reinterpret_cast<const float4*>(a + k * LD + ty * 4);
    const float4 a1 =
        *reinterpret_cast<const float4*>(a + k * LD + 64 + ty * 4);
    const float4 b0 = *reinterpret_cast<const float4*>(b + k * LD + tx * 4);
    const float4 b1 =
        *reinterpret_cast<const float4*>(b + k * LD + 64 + tx * 4);
    av[0] = a0.x; av[1] = a0.y; av[2] = a0.z; av[3] = a0.w;
    av[4] = a1.x; av[5] = a1.y; av[6] = a1.z; av[7] = a1.w;
    bv[0] = b0.x; bv[1] = b0.y; bv[2] = b0.z; bv[3] = b0.w;
    bv[4] = b1.x; bv[5] = b1.y; bv[6] = b1.z; bv[7] = b1.w;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// The class tile's raw products: acc[i][j] = w[c0 + row_i] . ne[b0 + col_j]
// over the whole depth d, and inv_s[row] = 1 / sqrt(sum of squares of the
// fp32 row of w), correctly rounded rather than the 2-ulp rsqrtf. `sa` and
// `sb` are two staging buffers of DEPTH * LD floats. Ends with the block
// synchronised and inv_s visible.
__device__ __forceinline__ void raw_tile(
    const float* __restrict__ w, const float* __restrict__ ne, int64_t C,
    int B, int d, int64_t c0, int b0, bool vec, bool bf16, float* sa,
    float* sb, float* inv_s, float (&acc)[8][8]) {
  const int t = threadIdx.x;
  const int ty = t >> 4, tx = t & 15;
  float sumsq[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  for (int k0 = 0; k0 < d; k0 += DEPTH) {
    stage_depth_major(sa, w, C, d, c0, k0, vec, bf16, sumsq);
    stage_depth_major(sb, ne, B, d, b0, k0, vec, bf16, nullptr);
    __syncthreads();
    fma_staged(sa, sb, ty, tx, acc);
    __syncthreads();
  }
  // a row of w was loaded by the 4 neighbouring lanes t, t^1, t^2, t^3
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float v = sumsq[half];
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    if ((t & 3) == 0) inv_s[(t >> 2) + half * 64] = 1.0f / sqrtf(v);
  }
  __syncthreads();
}

}  // namespace hfa_ce
