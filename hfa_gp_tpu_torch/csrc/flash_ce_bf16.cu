// Flash cross-entropy statistics, forward, with bf16 operands on the tensor
// cores: the route of hfa_flash_ce_fwd (flash_ce.cu) when `bf16` is set.
// Replaces, as flash_ce.cu does, the TPU kernel
// hfa_gp_tpu/parallel/pallas_ce.py::_fwd_kernel (via _stats_fwd), here
// with mm_dtype = bfloat16. The function and its outputs are flash_ce.cu's;
// the design is flash_ce_bf16.cuh's.
//
// A block of 16 warps owns 128 classes x 256 batch rows. Slices of w 32
// deep arrive as fp32 through a four-stage `cp.async` ring beside the
// matching slices of the rounded embeddings; each w slice is squared (for
// the norms) and rounded into one bf16 buffer, and the warps multiply it
// with `mma.sync`. (Two or three stages, or slices 64 deep: 1.92 to 2.01
// ms against 1.85 on the H100.) The epilogue (norm, clip, exp, the sum over the tile's
// classes without the target column, tgt_raw) works on the fragments in
// registers; the sum over class tiles is flash_ce.cu's fixed-order reduce.

#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_ce_bf16.cuh"

namespace {

using namespace hfa_ce;
using namespace hfa_ce::tc;

constexpr int KS_FWD = 32;       // depth of a slice
constexpr int NST_FWD = 4;       // stages of the ring
using SF = Slice<KS_FWD>;
// the ring, one bf16 slice of w, 1 / |w| per class, the group's labels
constexpr int FWD_SMEM_BYTES =
    NST_FWD * SF::BYTES + TILE_C * SF::PN * 2 + TILE_C * 4 + TILE_B * 4;
static_assert(FWD_SMEM_BYTES <= 232448, "a block's shared memory on sm_90");
static_assert(WM * TILE_B * 4 <= NST_FWD * SF::BYTES, "the sums fit the ring");

__global__ void __launch_bounds__(NT, 1)
flash_ce_fwd_bf16_kernel(const bf16* __restrict__ ne,
                         const float* __restrict__ w,
                         const int* __restrict__ lab,
                         float* __restrict__ partial,
                         float* __restrict__ tgt_raw, int B, int d, int dp,
                         int64_t C, int n_bgroups, float s, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;
  bf16* w_bf = reinterpret_cast<bf16*>(ring + NST_FWD * SF::BYTES);
  float* inv_s = reinterpret_cast<float*>(w_bf + TILE_C * SF::PN);
  int* lab_s = reinterpret_cast<int*>(inv_s + TILE_C);
  const int64_t ctile = blockIdx.x / n_bgroups;
  const int b0 = (blockIdx.x % n_bgroups) * TILE_B;
  const int64_t c0 = ctile * TILE_C;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int wm = warp / WN, wn = warp % WN;
  for (int r = t; r < TILE_B; r += NT)
    lab_s[r] = (b0 + r < B) ? lab[b0 + r] : -1;

  Acc acc;
  cosine_tile<false, NST_FWD, KS_FWD>(w, ne, C, d, dp, c0, b0, vec != 0,
                                      b0 + wn * WTN < B, ring, w_bf, SF::PN,
                                      inv_s, acc);

  // epilogue: rows of the fragments are classes, columns batch rows
  float se[NJ][2];
#pragma unroll
  for (int j = 0; j < NJ; ++j) se[j][0] = se[j][1] = 0.0f;
#pragma unroll
  for (int i = 0; i < MI; ++i) {
#pragma unroll
    for (int eh = 0; eh < 2; ++eh) {
      const int m = wm * WTM + frag_row(i, eh * 2);
      const int64_t c = c0 + m;
      if (c >= C) continue;
      const float inv = inv_s[m];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
#pragma unroll
        for (int el = 0; el < 2; ++el) {
          const int n = wn * WTN + frag_col(j, el);
          if (b0 + n >= B) continue;
          const float logit =
              fminf(fmaxf(acc[i][j][eh * 2 + el] * inv, -1.0f), 1.0f);
          if ((int64_t)lab_s[n] == c)
            tgt_raw[b0 + n] = logit;
          else
            se[j][el] += expf(logit * s - s);
        }
      }
    }
  }
  // sum over the tile's classes in a fixed order: the 8 lane rows of the
  // warp, then the WM warps that share the batch rows
  float* red = reinterpret_cast<float*>(ring);   // [WM][TILE_B]; ring free
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
#pragma unroll
    for (int el = 0; el < 2; ++el) {
      float v = se[j][el];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (lane < 4) red[wm * TILE_B + wn * WTN + frag_col(j, el)] = v;
    }
  }
  __syncthreads();
  for (int r = t; r < TILE_B && b0 + r < B; r += NT) {
    float v = red[r];
#pragma unroll
    for (int x = 1; x < WM; ++x) v += red[x * TILE_B + r];
    partial[ctile * B + b0 + r] = v;
  }
}

}  // namespace

namespace hfa_ce {
namespace tc {

cudaError_t launch_fwd(const float* ne, const float* w, const int* lab,
                       float* partial, void* scratch, float* tgt_raw, int B,
                       int d, int64_t C, int64_t n_ctiles, float s,
                       cudaStream_t st) {
  cudaError_t err = round_embeddings(ne, scratch, B, d, st);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_ce_fwd_bf16_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             FWD_SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const int n_bgroups = padded_rows(B) / TILE_B;
  flash_ce_fwd_bf16_kernel<<<(unsigned)(n_ctiles * n_bgroups), NT,
                             FWD_SMEM_BYTES, st>>>(
      (const bf16*)scratch, w, lab, partial, tgt_raw, B, d, padded_depth(d),
      C, n_bgroups, s, d % 4 == 0);
  return cudaGetLastError();
}

}  // namespace tc
}  // namespace hfa_ce
