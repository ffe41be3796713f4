// The flash-CE backward kernel as a template on the operands' rounding:
// flash_ce_bwd.cu instantiates it for fp32 and bf16 operands. The header
// comment of flash_ce_bwd.cu describes the function and the design.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_ce_common.cuh"

namespace hfa_ce {

constexpr int LDD = TILE_C + 4;  // pitch of draw[batch row][class], ≡ 4 mod 32
constexpr int DW_COLS = 256;     // columns of d a dW pass covers
constexpr int DNE_COLS = 128;    // columns of d a dne pass covers
constexpr int DW_STAGE = KD * (DW_COLS + 4);
constexpr int DNE_STAGE = KD * (DNE_COLS + 4);
constexpr int GRAD_RING = NST_DW * DW_STAGE > NST_DNE * DNE_STAGE
                              ? NST_DW * DW_STAGE : NST_DNE * DNE_STAGE;

// shared memory, in floats: draw (the cosine product's ring lies over it
// and over the next: draw is written only after that product ends), the
// gradient products' ring, 1 / |w|, the WX partial sums of dl * raw per
// class, the two cotangents and the labels of the batch group
constexpr int DRAW_FLOATS = TILE_B * LDD;
static_assert(NST_RAW * RAW_STAGE <= DRAW_FLOATS + GRAD_RING,
              "the cosines' ring fits over draw and the gradients' ring");
constexpr int BWD_SMEM_FLOATS = DRAW_FLOATS + GRAD_RING + TILE_C +
                                WX * TILE_C + 3 * TILE_B;
constexpr int BWD_SMEM_BYTES = BWD_SMEM_FLOATS * 4;
static_assert(BWD_SMEM_BYTES <= 232448, "a block's shared memory on sm_90");

// acc[i][j] += sum over k < KD of a[k][col_i] * b[k][col_j]: both operands
// [k][col]; `a` (pitch pa) points at the thread's first column, its 8
// columns are two groups of 4, 16 apart; `b` (pitch pb) likewise, its TN
// columns groups of 4, 32 apart. `a` is draw, rounded when written.
template <bool BF16>
__device__ __forceinline__ void fma_cols_cols(const float* __restrict__ a,
                                              int pa,
                                              const float* __restrict__ b,
                                              int pb, float (&acc)[TM][TN]) {
#pragma unroll 1
  for (int k0 = 0; k0 < KD; k0 += KU) {
#pragma unroll
    for (int k = k0; k < k0 + KU; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(a + k * pa);
      const float4 a1 = *reinterpret_cast<const float4*>(a + k * pa + 16);
      const float av[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      float bv[TN];
      ld_cols<BF16>(b + k * pb, bv);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
}

template <bool BF16>
__global__ void __launch_bounds__(THREADS, 1)
flash_ce_bwd_kernel(const float* __restrict__ ne,
                    const float* __restrict__ ne_t,
                    const float* __restrict__ w, const int* __restrict__ lab,
                    const float* __restrict__ ct_se,
                    const float* __restrict__ ct_tgt, float* __restrict__ dw,
                    float* __restrict__ dne, int B, int d, int64_t C, float s,
                    int vec_i) {
  extern __shared__ __align__(16) float smem[];
  float* draw_s = smem;                          // [batch row][class]
  float* ring = draw_s + DRAW_FLOATS;            // the gradient products'
  float* inv_s = ring + GRAD_RING;               // [class]
  float* dpart_s = inv_s + TILE_C;               // [WX][class] sum dl * raw
  float* cts_s = dpart_s + WX * TILE_C;          // [batch row]
  float* ctt_s = cts_s + TILE_B;                 // [batch row]
  int* lab_s = reinterpret_cast<int*>(ctt_s + TILE_B);

  const bool vec = vec_i != 0;
  const int64_t c0 = (int64_t)blockIdx.x * TILE_C;
  const int t = threadIdx.x;
  const Lane ln;
  // the tile's classes, rounded up to whole slices: rows beyond have draw 0
  const int n_cs = ((int)(C - c0 < TILE_C ? C - c0 : TILE_C) + KD - 1) / KD;

  float acc[TM][TN];
  for (int g0 = 0; g0 < B; g0 += TILE_B) {       // groups of 256 batch rows
    for (int r = t; r < TILE_B; r += THREADS) {
      const bool in = g0 + r < B;
      lab_s[r] = in ? lab[g0 + r] : -1;
      cts_s[r] = in ? ct_se[g0 + r] : 0.0f;
      ctt_s[r] = in ? ct_tgt[g0 + r] : 0.0f;
    }
    // -- the cosines' raw products; its ring lies over draw_s
    raw_tile<BF16>(w, ne_t, C, B, d, c0, g0, vec, draw_s, inv_s, acc);

    // -- dl, draw into shared memory, and the class sums of dl * raw
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = raw_class(ln, i);
      const int64_t c = c0 + m;
      const float inv = inv_s[m];
      float dinv = 0.0f;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int n = raw_row(ln, j);
        float draw = 0.0f;
        if (c < C && g0 + n < B) {
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
        draw_s[n * LDD + m] = BF16 ? round_bf16(draw) : draw;
      }
      // the 8 lanes of one ty share the class; then one owner per warp
      dinv += __shfl_xor_sync(0xffffffffu, dinv, 4);
      dinv += __shfl_xor_sync(0xffffffffu, dinv, 2);
      dinv += __shfl_xor_sync(0xffffffffu, dinv, 1);
      if (ln.tx == 0) dpart_s[(ln.warp % WX) * TILE_C + m] = dinv;
    }
    __syncthreads();

    // -- dW[c, n] (+)= sum over the group's rows of draw[b][c] * ne[b][n]
    //    - (sum over them of dl * raw) * inv^3 * w[c, n]; 256 columns a
    //    pass, warps 4 (classes) x WX (columns)
    {
      const int wy = ln.warp / WX, wx = ln.warp % WX;
      const int rows = B - g0 < TILE_B ? B - g0 : TILE_B;
      const int n_bs = (rows + KD - 1) / KD;     // rows beyond have draw 0
      const int n_pass = (d + DW_COLS - 1) / DW_COLS;
      const float* a_col = draw_s + wy * 32 + ln.ty * 4;
      const int b_col = wx * WARP_COLS + ln.tx * 4;
      pipeline<NST_DW>(
          n_pass * n_bs,
          [&](int q) {
            fill_k_cols<DW_COLS>(ring + (q % NST_DW) * DW_STAGE, ne, B, d,
                                 (int64_t)g0 + (q % n_bs) * KD,
                                 (q / n_bs) * DW_COLS, vec);
          },
          [&](int q) {
            const int ks = q % n_bs, n0 = (q / n_bs) * DW_COLS;
            if (ks == 0) zero(acc);
            fma_cols_cols<BF16>(a_col + ks * KD * LDD, LDD,
                                ring + (q % NST_DW) * DW_STAGE + b_col,
                                DW_COLS + 4, acc);
            if (ks != n_bs - 1) return;
            // the pass's epilogue: the norm's term, and the one store
#pragma unroll
            for (int i = 0; i < TM; ++i) {
              const int m = wy * 32 + (i >> 2) * 16 + ln.ty * 4 + (i & 3);
              const int64_t c = c0 + m;
              if (c >= C) continue;
              const float inv = inv_s[m];
              float dinv = dpart_s[m];
#pragma unroll
              for (int x = 1; x < WX; ++x) dinv += dpart_s[x * TILE_C + m];
              const float scale = dinv * inv * inv * inv;
#pragma unroll
              for (int g = 0; g < TN / 4; ++g) {
                const int n = n0 + b_col + g * 32;
                const int64_t at = c * (int64_t)d + n;
                float* a = &acc[i][g * 4];
                if (vec) {
                  if (n >= d) continue;
                  const float4 wv =
                      __ldg(reinterpret_cast<const float4*>(w + at));
                  float4 o = make_float4(
                      fmaf(-scale, wv.x, a[0]), fmaf(-scale, wv.y, a[1]),
                      fmaf(-scale, wv.z, a[2]), fmaf(-scale, wv.w, a[3]));
                  if (g0 != 0) {     // later groups add to their own rows
                    const float4 p = *reinterpret_cast<const float4*>(dw + at);
                    o.x += p.x; o.y += p.y; o.z += p.z; o.w += p.w;
                  }
                  *reinterpret_cast<float4*>(dw + at) = o;
                } else {
#pragma unroll
                  for (int e = 0; e < 4; ++e) {
                    if (n + e >= d) continue;
                    float o = fmaf(-scale, w[at + e], a[e]);
                    if (g0 != 0) o += dw[at + e];
                    dw[at + e] = o;
                  }
                }
              }
            }
          });
    }

    // -- dne[b, n] += sum over the tile's classes of draw[b][c] * w[c][n];
    //    128 columns a pass, warps 8 (batch rows) x DNE_COLS / WARP_COLS
    {
      constexpr int WX2 = DNE_COLS / WARP_COLS;
      const int wy = ln.warp / WX2, wx = ln.warp % WX2;
      const int n_pass = (d + DNE_COLS - 1) / DNE_COLS;
      const float* a_row = draw_s + (wy * 32 + ln.ty) * LDD;
      const int b_col = wx * WARP_COLS + ln.tx * 4;
      // a warp whose 32 batch rows all lie beyond B has nothing to add
      const bool live = g0 + wy * 32 < B;
      pipeline<NST_DNE>(
          n_pass * n_cs,
          [&](int q) {
            fill_k_cols<DNE_COLS>(ring + (q % NST_DNE) * DNE_STAGE, w, C, d,
                                  c0 + (q % n_cs) * KD, (q / n_cs) * DNE_COLS,
                                  vec);
          },
          [&](int q) {
            const int ks = q % n_cs, n0 = (q / n_cs) * DNE_COLS;
            if (!live) return;
            if (ks == 0) zero(acc);
            fma_rows_cols<BF16, false, LDD>(
                a_row + ks * KD, ring + (q % NST_DNE) * DNE_STAGE + b_col,
                DNE_COLS + 4, acc);
            if (ks != n_cs - 1) return;
#pragma unroll
            for (int i = 0; i < TM; ++i) {
              const int b = g0 + wy * 32 + i * 4 + ln.ty;
              if (b >= B) continue;
#pragma unroll
              for (int g = 0; g < TN / 4; ++g) {
                const int n = n0 + b_col + g * 32;
                float* p = dne + b * (int64_t)d + n;
                const float* a = &acc[i][g * 4];
                if (vec) {
                  // one 16-byte atomic for the thread's 4 consecutive columns
                  if (n < d)
                    atomicAdd(reinterpret_cast<float4*>(p),
                              make_float4(a[0], a[1], a[2], a[3]));
                } else {
#pragma unroll
                  for (int e = 0; e < 4; ++e)
                    if (n + e < d) atomicAdd(p + e, a[e]);
                }
              }
            }
          });
    }
  }
}

// dne must be zeroed by the caller; dw is written in full; ne_t is scratch
// of d * padded_batch(B) floats.
template <bool BF16>
int launch_flash_ce_bwd(const void* ne, const void* w, const void* lab,
                        const void* ct_se, const void* ct_tgt, void* dw,
                        void* dne, void* ne_t, int B, int d, int64_t C,
                        float s, void* stream) {
  if (B <= 0 || C <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  const int64_t n_ctiles = (C + TILE_C - 1) / TILE_C;
  if (n_ctiles > 2147483647LL) return (int)cudaErrorInvalidValue;
  cudaError_t err = transpose_embeddings((const float*)ne, (float*)ne_t, B, d,
                                         (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      flash_ce_bwd_kernel<BF16>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, BWD_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  flash_ce_bwd_kernel<BF16>
      <<<(unsigned)n_ctiles, THREADS, BWD_SMEM_BYTES, (cudaStream_t)stream>>>(
          (const float*)ne, (const float*)ne_t, (const float*)w,
          (const int*)lab, (const float*)ct_se, (const float*)ct_tgt,
          (float*)dw, (float*)dne, B, d, C, s, d % 4 == 0);
  return (int)cudaGetLastError();
}

}  // namespace hfa_ce
