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
// 128-class x 128-row tile of them in registers and reduces it at once. The
// target column is left out of the sum inside the kernel (the caller adds
// the margined term with its own exp, so the denominator can never fall
// below the target's term); nothing is summed in full and subtracted.
//
// Bound on the H100: operations. At B 256, d 512, C 1,000,000 the product
// is 0.262 TFLOP of fp32 FMA against 2.05 GB of table read once. Design: a
// shared-memory-tiled fp32 product (flash_ce_common.cuh) with the norm,
// clip, exp and row sum fused into its epilogue. Blocks of neighbouring
// batch tiles share a class tile, which L2 serves.
//
// Classes run in parallel blocks, so the sum over class tiles is finished by
// a second small kernel from per-tile partial sums, in a fixed order: se_x
// is the same bit for bit from run to run. tgt_raw has one writer per row.

#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_ce_common.cuh"

namespace {

using namespace hfa_ce;

__global__ void __launch_bounds__(THREADS)
flash_ce_fwd_kernel(const float* __restrict__ ne, const float* __restrict__ w,
                    const int* __restrict__ lab, float* __restrict__ partial,
                    float* __restrict__ tgt_raw, int B, int d, int64_t C,
                    int n_btiles, float s, int vec, int bf16) {
  __shared__ __align__(16) float stage[2 * DEPTH * LD];
  __shared__ float inv_s[TILE];
  __shared__ int lab_s[TILE];
  const int64_t ctile = blockIdx.x / n_btiles;
  const int btile = blockIdx.x % n_btiles;
  const int64_t c0 = ctile * TILE;
  const int b0 = btile * TILE;
  const int t = threadIdx.x;
  const int ty = t >> 4, tx = t & 15;
  if (t < TILE) lab_s[t] = (b0 + t < B) ? lab[b0 + t] : -1;

  float acc[8][8];
  raw_tile(w, ne, C, B, d, c0, b0, vec != 0, bf16 != 0, stage,
           stage + DEPTH * LD, inv_s, acc);

  // epilogue: rows of acc are classes (ty), columns batch rows (tx)
  float se[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) se[j] = 0.0f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = tile_index(ty, i);
    const int64_t c = c0 + m;
    if (c >= C) continue;
    const float inv = inv_s[m];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = tile_index(tx, j);
      if (b0 + n >= B) continue;
      const float logit = fminf(fmaxf(acc[i][j] * inv, -1.0f), 1.0f);
      if ((int64_t)lab_s[n] == c)
        tgt_raw[b0 + n] = logit;
      else
        se[j] += expf(logit * s - s);
    }
  }
  // sum over the 16 class groups (ty) in a fixed order
  float* red = stage;                       // [16][TILE]
#pragma unroll
  for (int j = 0; j < 8; ++j) red[ty * TILE + tile_index(tx, j)] = se[j];
  __syncthreads();
  if (t < TILE && b0 + t < B) {
    float sum = 0.0f;
#pragma unroll
    for (int g = 0; g < 16; ++g) sum += red[g * TILE + t];
    partial[ctile * B + b0 + t] = sum;
  }
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

}  // namespace

// partial: scratch of ceil(C / 128) * B floats. tgt_raw must be zeroed by
// the caller; se_x is written in full.
extern "C" int hfa_flash_ce_fwd(const void* ne, const void* w,
                                const void* lab, void* partial, void* se_x,
                                void* tgt_raw, int B, int d, int64_t C,
                                float s, int bf16, void* stream) {
  if (B <= 0 || C <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  const int64_t n_ctiles = (C + TILE - 1) / TILE;
  const int n_btiles = (B + TILE - 1) / TILE;
  if (n_ctiles * n_btiles > 2147483647LL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  flash_ce_fwd_kernel<<<(unsigned)(n_ctiles * n_btiles), THREADS, 0, st>>>(
      (const float*)ne, (const float*)w, (const int*)lab, (float*)partial,
      (float*)tgt_raw, B, d, C, n_btiles, s, d % 4 == 0, bf16);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_ce_reduce_kernel<<<(unsigned)((B + 31) / 32), dim3(32, 32), 0, st>>>(
      (const float*)partial, (float*)se_x, B, n_ctiles);
  return (int)cudaGetLastError();
}
