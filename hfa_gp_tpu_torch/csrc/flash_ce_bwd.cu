// Flash cross-entropy statistics, backward. Replaces the TPU kernel
// hfa_gp_tpu/parallel/pallas_ce.py::_bwd_kernel (reached through
// _stats_bwd, the VJP of flash_ce_stats).
//
// Inputs as the forward's (flash_ce.cu), and the cotangents ct_se, ct_tgt
// (B,) fp32 of se_x and tgt_raw. With raw = w . ne, inv = 1 / |w_j|,
// li = raw * inv, e = exp(s * clip(li) - s):
//   dl   = ct_tgt[b] at the target column, ct_se[b] * s * e elsewhere, and
//          0 where li is outside [-1, 1]
//   draw = dl * inv
//   dW   = draw . ne - (sum_b dl * raw) * inv^3 * w        (C, d)
//   dne  = draw^T . w                                      (B, d)
//
// A block owns one tile of 128 classes. For each chunk of 128 batch rows it
// recomputes the raw products (as the forward does), keeps the tile's draw
// (128 x 128) in shared memory, and runs both gradient products from there:
// neither the cosines nor draw ever reach device memory. Three products, so
// three times the forward's operations; at B 256, d 512, C 1,000,000 that
// is 0.786 TFLOP of fp32 FMA against 4.1 GB moved: bound by operations.
//
// dW rows belong to one block, which writes them without atomics (and adds
// to them for batch chunks after the first). dne sums over all class tiles,
// which run in parallel: fp32 atomic adds into a zeroed buffer, so dne's
// last bits change from run to run with the order of the adds. dW is the
// same bit for bit from run to run.
//
// With bf16 set, ne, w and draw are rounded to bfloat16 as operands of the
// products; norms, dl, the sum dl * raw and dW's second term stay fp32.

#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_ce_common.cuh"

namespace {

using namespace hfa_ce;

constexpr int SMEM_FLOATS = TILE * LD + 2 * DEPTH * LD + 4 * TILE;
constexpr int SMEM_BYTES = SMEM_FLOATS * 4 + TILE * 4;

// two blocks a multiprocessor: at most 128 registers a thread
__global__ void __launch_bounds__(THREADS, 2)
flash_ce_bwd_kernel(const float* __restrict__ ne, const float* __restrict__ w,
                    const int* __restrict__ lab,
                    const float* __restrict__ ct_se,
                    const float* __restrict__ ct_tgt, float* __restrict__ dw,
                    float* __restrict__ dne, int B, int d, int64_t C, float s,
                    int vec_i, int bf16_i) {
  extern __shared__ __align__(16) float smem[];
  float* draw_s = smem;                     // [batch row][class], pitch LD
  float* sa = draw_s + TILE * LD;           // staging, DEPTH x LD
  float* sb = sa + DEPTH * LD;              // staging, DEPTH x LD
  float* inv_s = sb + DEPTH * LD;           // [class]
  float* dinv_s = inv_s + TILE;             // [class] sum_b dl * raw
  float* cts_s = dinv_s + TILE;             // [batch row]
  float* ctt_s = cts_s + TILE;              // [batch row]
  int* lab_s = reinterpret_cast<int*>(ctt_s + TILE);

  const bool vec = vec_i != 0, bf16 = bf16_i != 0;
  const int64_t c0 = (int64_t)blockIdx.x * TILE;
  const int t = threadIdx.x;
  const int ty = t >> 4, tx = t & 15;
  if (t < TILE) dinv_s[t] = 0.0f;

  float acc[8][8];
  for (int b0 = 0; b0 < B; b0 += TILE) {
    if (t < TILE) {
      const bool in = b0 + t < B;
      lab_s[t] = in ? lab[b0 + t] : -1;
      cts_s[t] = in ? ct_se[b0 + t] : 0.0f;
      ctt_s[t] = in ? ct_tgt[b0 + t] : 0.0f;
    }
    // -- raw products of the tile; rows of acc are classes, columns batch
    raw_tile(w, ne, C, B, d, c0, b0, vec, bf16, sa, sb, inv_s, acc);

    // -- dl, draw into shared memory, and the row sums of dl * raw
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = tile_index(ty, i);
      const int64_t c = c0 + m;
      const float inv = inv_s[m];
      float dinv = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = tile_index(tx, j);
        float draw = 0.0f;
        if (c < C && b0 + n < B) {
          const float raw = acc[i][j];
          const float li = raw * inv;
          const float logit = fminf(fmaxf(li, -1.0f), 1.0f);
          float dl = ((int64_t)lab_s[n] == c)
                         ? ctt_s[n]
                         : cts_s[n] * (s * expf(logit * s - s));
          if (!(li >= -1.0f && li <= 1.0f)) dl = 0.0f;
          draw = dl * inv;
          dinv += dl * raw;
        }
        draw_s[n * LD + m] = maybe_bf16(draw, bf16);
      }
      // the 16 threads of one ty are the 16 lanes of a half-warp
      dinv += __shfl_xor_sync(0xffffffffu, dinv, 8);
      dinv += __shfl_xor_sync(0xffffffffu, dinv, 4);
      dinv += __shfl_xor_sync(0xffffffffu, dinv, 2);
      dinv += __shfl_xor_sync(0xffffffffu, dinv, 1);
      if (tx == 0) dinv_s[m] += dinv;       // one owner per class row
    }
    __syncthreads();

    // -- dW[c, n0..] (+)= sum over batch rows of draw[b][c] * ne[b][n]
    for (int n0 = 0; n0 < d; n0 += TILE) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
      for (int k0 = 0; k0 < TILE; k0 += DEPTH) {
        stage_column_major(sb, ne, B, d, (int64_t)b0 + k0, n0, vec, bf16);
        __syncthreads();
        fma_staged(draw_s + k0 * LD, sb, ty, tx, acc);
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int64_t c = c0 + tile_index(ty, i);
        if (c >= C) continue;
#pragma unroll
        for (int jg = 0; jg < 2; ++jg) {
          // the thread's 4 consecutive columns of this half of the tile
          const int n = n0 + jg * 64 + tx * 4;
          float* p = dw + c * (int64_t)d + n;
          const float* a = &acc[i][jg * 4];
          if (vec) {
            if (n >= d) continue;
            float4 q = make_float4(a[0], a[1], a[2], a[3]);
            if (b0 != 0) {
              const float4 o = *reinterpret_cast<const float4*>(p);
              q.x += o.x; q.y += o.y; q.z += o.z; q.w += o.w;
            }
            *reinterpret_cast<float4*>(p) = q;
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (n + j < d) p[j] = (b0 == 0) ? a[j] : p[j] + a[j];
          }
        }
      }
    }

    // -- dne[b, n0..] += sum over the tile's classes of draw[b][c] * w[c][n]
    for (int n0 = 0; n0 < d; n0 += TILE) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
      for (int k0 = 0; k0 < TILE; k0 += DEPTH) {
        stage_column_major(sb, w, C, d, c0 + k0, n0, vec, bf16);
        __syncthreads();
#pragma unroll
        for (int k = 0; k < DEPTH; ++k) {
          float av[8], bv[8];
#pragma unroll
          for (int i = 0; i < 8; ++i)
            av[i] = draw_s[tile_index(ty, i) * LD + k0 + k];
          const float4 q0 =
              *reinterpret_cast<const float4*>(sb + k * LD + tx * 4);
          const float4 q1 =
              *reinterpret_cast<const float4*>(sb + k * LD + 64 + tx * 4);
          bv[0] = q0.x; bv[1] = q0.y; bv[2] = q0.z; bv[3] = q0.w;
          bv[4] = q1.x; bv[5] = q1.y; bv[6] = q1.z; bv[7] = q1.w;
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j)
              acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int b = b0 + tile_index(ty, i);
        if (b >= B) continue;
#pragma unroll
        for (int jg = 0; jg < 2; ++jg) {
          const int n = n0 + jg * 64 + tx * 4;
          float* p = dne + b * (int64_t)d + n;
          const float* a = &acc[i][jg * 4];
          if (vec) {
            // one 16-byte atomic for the thread's 4 consecutive columns
            if (n < d)
              atomicAdd(reinterpret_cast<float4*>(p),
                        make_float4(a[0], a[1], a[2], a[3]));
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (n + j < d) atomicAdd(p + j, a[j]);
          }
        }
      }
    }
  }

  // -- dW[c, :] -= (sum_b dl * raw) * inv^3 * w[c, :], with the fp32 w
  __syncthreads();
  for (int m = 0; m < TILE; ++m) {
    const int64_t c = c0 + m;
    if (c >= C) break;
    const float inv = inv_s[m];
    const float scale = dinv_s[m] * inv * inv * inv;
    for (int n = t; n < d; n += THREADS) {
      const int64_t at = c * (int64_t)d + n;
      dw[at] -= scale * w[at];
    }
  }
}

}  // namespace

// dne must be zeroed by the caller; dw is written in full.
extern "C" int hfa_flash_ce_bwd(const void* ne, const void* w,
                                const void* lab, const void* ct_se,
                                const void* ct_tgt, void* dw, void* dne,
                                int B, int d, int64_t C, float s, int bf16,
                                void* stream) {
  if (B <= 0 || C <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  const int64_t n_ctiles = (C + TILE - 1) / TILE;
  if (n_ctiles > 2147483647LL) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_ce_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  flash_ce_bwd_kernel<<<(unsigned)n_ctiles, THREADS, SMEM_BYTES,
                        (cudaStream_t)stream>>>(
      (const float*)ne, (const float*)w, (const int*)lab,
      (const float*)ct_se, (const float*)ct_tgt, (float*)dw, (float*)dne, B,
      d, C, s, d % 4 == 0, bf16);
  return (int)cudaGetLastError();
}
