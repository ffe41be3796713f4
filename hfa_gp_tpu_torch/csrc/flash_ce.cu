// Flash cross-entropy statistics, forward. Replaces the TPU kernel
// hfa_gp_tpu/parallel/pallas_ce.py::_fwd_kernel (reached through
// _stats_fwd / flash_ce_stats).
//
//   ne  (B, d) fp32, unit rows          w (C, d) fp32, raw class centres
//   lab (B,)   int32, column of each row's class in w, or < 0 for none
//   se_x[b]    = sum over j != lab[b] of exp(s * clip(cos_bj, -1, 1) - s)
//   tgt_raw[b] = clip(cos_{b, lab[b]}), 0 when lab[b] is outside [0, C)
//   cos_bj     = (w_j . ne_b) / |w_j|
//
// The (B, C) cosines never reach device memory: a block computes a
// 128-class x 256-row tile of them in registers and reduces it at once. The
// target column is left out of the sum inside the kernel (the caller adds
// the margined term with its own exp, so the denominator can never fall
// below the target's term); nothing is summed in full and subtracted.
//
// Bound on the H100: operations. At B 256, d 512, C 1,000,000 the product
// is 0.262 TFLOP of fp32 FMA (3.9 ms at 67 TFLOP/s) against 2.05 GB of
// table read once (0.6 ms). Design: the pipelined fp32 product of
// flash_ce_common.cuh (a block of 512 threads owns 128 classes x 256 batch
// rows; operand slices arrive through a three-stage `cp.async` ring; the
// embeddings are transposed once, by a small kernel ahead of this one, so
// that no slice is transposed on its way) with the norm, clip, exp and row
// sum fused into its epilogue.
// Blocks of neighbouring batch groups share a class tile, which L2 serves.
// With bf16 operands the entry point launches the tensor-core kernel of
// flash_ce_bf16.cu instead; this kernel is the fp32-operand route.
//
// Classes run in parallel blocks, so the sum over class tiles is finished by
// a second small kernel from per-tile partial sums, in a fixed order: se_x
// is the same bit for bit from run to run. tgt_raw has one writer per row.

#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_ce_common.cuh"

namespace {

using namespace hfa_ce;

// the ring, 1 / |w| per class, the labels of the batch group
constexpr int FWD_SMEM_BYTES = (NST_RAW * RAW_STAGE + TILE_C + TILE_B) * 4;

__global__ void __launch_bounds__(THREADS, 1)
flash_ce_fwd_kernel(const float* __restrict__ ne_t,
                    const float* __restrict__ w, const int* __restrict__ lab,
                    float* __restrict__ partial,
                    float* __restrict__ tgt_raw, int B, int d, int64_t C,
                    int n_bgroups, float s, int vec) {
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;
  float* inv_s = ring + NST_RAW * RAW_STAGE;
  int* lab_s = reinterpret_cast<int*>(inv_s + TILE_C);
  const int64_t ctile = blockIdx.x / n_bgroups;
  const int bgroup = blockIdx.x % n_bgroups;
  const int64_t c0 = ctile * TILE_C;
  const int b0 = bgroup * TILE_B;
  const int t = threadIdx.x;
  const Lane ln;
  for (int r = t; r < TILE_B; r += THREADS)
    lab_s[r] = (b0 + r < B) ? lab[b0 + r] : -1;

  float acc[TM][TN];
  raw_tile<false>(w, ne_t, C, B, d, c0, b0, vec != 0, ring, inv_s, acc);

  // epilogue: rows of acc are classes, columns batch rows
  float se[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) se[j] = 0.0f;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = raw_class(ln, i);
    const int64_t c = c0 + m;
    if (c >= C) continue;
    const float inv = inv_s[m];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = raw_row(ln, j);
      if (b0 + n >= B) continue;
      const float logit = fminf(fmaxf(acc[i][j] * inv, -1.0f), 1.0f);
      if ((int64_t)lab_s[n] == c)
        tgt_raw[b0 + n] = logit;
      else
        se[j] += expf(logit * s - s);
    }
  }
  // sum over the tile's classes in a fixed order: the warp's 4 lane rows,
  // then the 4 warps that share the batch rows
  float* red = ring;                        // [4][TILE_B]; the ring is free
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    float v = se[j];
    v += __shfl_xor_sync(0xffffffffu, v, 8);
    v += __shfl_xor_sync(0xffffffffu, v, 16);
    if (ln.ty == 0) red[(ln.warp / WX) * TILE_B + raw_row(ln, j)] = v;
  }
  __syncthreads();
  for (int r = t; r < TILE_B && b0 + r < B; r += THREADS)
    partial[ctile * B + b0 + r] = ((red[r] + red[TILE_B + r]) +
                                   red[2 * TILE_B + r]) + red[3 * TILE_B + r];
}

// se_x[b] = sum over class tiles of partial[tile][b], in a fixed order.
__global__ void flash_ce_reduce_kernel(const float* __restrict__ partial,
                                       float* __restrict__ se_x, int B,
                                       int64_t n_ctiles) {
  __shared__ float red[32][33];
  const int b = blockIdx.x * 32 + threadIdx.x;
  float sum = 0.0f;
  if (b < B)
    for (int64_t tile = threadIdx.y; tile < n_ctiles; tile += 32)
      sum += partial[tile * B + b];
  red[threadIdx.y][threadIdx.x] = sum;
  __syncthreads();
  if (threadIdx.y == 0 && b < B) {
    float total = 0.0f;
    for (int g = 0; g < 32; ++g) total += red[g][threadIdx.x];
    se_x[b] = total;
  }
}

cudaError_t launch_fwd(const float* ne_t, const float* w, const int* lab,
                       float* partial, float* tgt_raw, int B, int d,
                       int64_t C, int64_t n_ctiles, int n_bgroups, float s,
                       cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_ce_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      FWD_SMEM_BYTES);
  if (err != cudaSuccess) return err;
  flash_ce_fwd_kernel
      <<<(unsigned)(n_ctiles * n_bgroups), THREADS, FWD_SMEM_BYTES, st>>>(
          ne_t, w, lab, partial, tgt_raw, B, d, C, n_bgroups, s, d % 4 == 0);
  return cudaGetLastError();
}

}  // namespace

// partial: scratch of ceil(C / 128) * B floats; ne_t: scratch of the
// embeddings' copy, d * ceil(B / 4) * 4 floats (transposed and padded) for
// fp32 operands, ceil(B / 256) * 256 * ceil(d / 64) * 64 bf16 (rounded and
// padded) for bf16 operands, which take the tensor-core kernel of
// flash_ce_bf16.cu. tgt_raw must be zeroed by the caller; se_x is written
// in full.
extern "C" int hfa_flash_ce_fwd(const void* ne, const void* w,
                                const void* lab, void* partial, void* ne_t,
                                void* se_x, void* tgt_raw, int B, int d,
                                int64_t C, float s, int bf16, void* stream) {
  if (B <= 0 || C <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  const int64_t n_ctiles = (C + TILE_C - 1) / TILE_C;
  const int n_bgroups = (B + TILE_B - 1) / TILE_B;
  if (n_ctiles * n_bgroups > 2147483647LL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (bf16) {
    err = tc::launch_fwd((const float*)ne, (const float*)w, (const int*)lab,
                         (float*)partial, ne_t, (float*)tgt_raw, B, d, C,
                         n_ctiles, s, st);
  } else {
    err = transpose_embeddings((const float*)ne, (float*)ne_t, B, d, st);
    if (err != cudaSuccess) return (int)err;
    err = launch_fwd((const float*)ne_t, (const float*)w, (const int*)lab,
                     (float*)partial, (float*)tgt_raw, B, d, C, n_ctiles,
                     n_bgroups, s, st);
  }
  if (err != cudaSuccess) return (int)err;
  flash_ce_reduce_kernel<<<(unsigned)((B + 31) / 32), dim3(32, 32), 0, st>>>(
      (const float*)partial, (float*)se_x, B, n_ctiles);
  return (int)cudaGetLastError();
}
