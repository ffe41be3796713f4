// Flash cross-entropy statistics, backward, with bf16 operands on the
// tensor cores: the route of hfa_flash_ce_bwd (flash_ce_bwd.cu) when `bf16`
// is set and d <= BWD_MAX_D. Replaces, as flash_ce_bwd.cu does, the TPU
// kernel hfa_gp_tpu/parallel/pallas_ce.py::_bwd_kernel (via _stats_bwd),
// here with mm_dtype = bfloat16: the operands ne and w of all three
// products and draw of the two gradient products are rounded to bf16 (as
// `drawmm` rounds draw, pallas_ce.py:134-141). The function is
// flash_ce_bwd.cu's; the design is flash_ce_bf16.cuh's.
//
// A block of 16 warps owns 128 classes and walks the batch in groups of
// 256 rows. Shared memory (231.7 KB) holds:
//   w_bf   the class tile in bf16, [class][k], written by the cosines' pass
//          and read again by dne's product (128 x (dp + 8) x 2 bytes); once
//          dne has read it, the same bytes take a dW pass's fp32 w, 128
//          classes x 256 columns at a pitch of 260 floats;
//   draw   [class][batch row] in bf16 (128 x 264 x 2 bytes), the A operand
//          of dW and, through `ldmatrix.trans`, of dne;
//   a ring of three 16-row slices of the rounded embeddings for dW;
//   the cosines' ring (four stages of an fp32 w slice and an embeddings
//   slice, 16 deep), which lies over draw and dW's ring: draw is written
//   only after the cosines end (two stages 32 deep, all that fit there,
//   waited on their copies: 7.65 ms against 6.56 on the H100);
//   1 / |w|, the per-warp sums dl * raw, the cotangents and labels.
// The steps of a group: the cosines (as the forward); dl, draw and the
// class sums of dl * raw from the fragments in registers; dne in passes of
// 128 columns from draw and w_bf, added to device memory by 16-byte
// atomics; dW in passes of 256 columns, each a pipeline of its own whose
// fills also bring the pass's fp32 w (a re-read of the tile the block
// streamed moments before, which L2 holds: the 132 tiles in flight are 34
// MB), so that the epilogue adds -(sum dl * raw) * inv^3 * w from shared
// memory and stores each element once (later groups add to their own
// rows). Loaded one by one from device memory in the epilogue itself, that
// w cost 1.5 ms of the kernel's 11.9 at B 256, d 512, C 1,000,000 on the
// H100 (every load waited out its latency with the whole block); asked for
// 32 at a time, still 0.2 ms more than from shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_ce_bf16.cuh"

namespace {

using namespace hfa_ce;
using namespace hfa_ce::tc;

constexpr int KS_COS = 16;               // depth of a cosines' slice
constexpr int NST_COSB = 4;
constexpr int NST_DWB = 3;
constexpr int KB = 16;                   // batch rows of a dW slice
constexpr int DW_COLS = WN * WTN;        // columns of d a dW pass covers
constexpr int DNE_COLS = 128;            // columns of d a dne pass covers
constexpr int DRP = TILE_B + PB;         // pitch of draw, bf16
constexpr int DWP = DW_COLS + PB;        // pitch of a dW slice, bf16
constexpr int DRAW_BYTES = TILE_C * DRP * 2;
constexpr int DW_STAGE = KB * DWP * 2;
constexpr int REGION_BYTES = DRAW_BYTES + NST_DWB * DW_STAGE;
static_assert(NST_COSB * Slice<KS_COS>::BYTES <= REGION_BYTES,
              "the cosines' ring fits over draw and dW's ring");
// 1 / |w|, WN partial sums of dl * raw per class, two cotangents, labels
constexpr int SMALL_BYTES = (TILE_C + WN * TILE_C + 3 * TILE_B) * 4;

// w_bf, then (in its place once dne has read it) a dW pass's fp32 w
constexpr int WSP = DW_COLS + 4;         // pitch of the fp32 w, floats
constexpr int W_BYTES = TILE_C * WSP * 4;
static_assert(TILE_C * (BWD_MAX_D + PB) * 2 <= W_BYTES, "w_bf fits");
constexpr int BWD_SMEM_BYTES = W_BYTES + REGION_BYTES + SMALL_BYTES;
static_assert(BWD_SMEM_BYTES <= 232448, "a block's shared memory on sm_90");

__global__ void __launch_bounds__(NT, 1)
flash_ce_bwd_bf16_kernel(const bf16* __restrict__ ne,
                         const float* __restrict__ w,
                         const int* __restrict__ lab,
                         const float* __restrict__ ct_se,
                         const float* __restrict__ ct_tgt,
                         float* __restrict__ dw, float* __restrict__ dne,
                         int B, int d, int dp, int64_t C, float s, int vec_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int wp = dp + PB;
  bf16* w_bf = reinterpret_cast<bf16*>(smem);
  float* w_f32 = reinterpret_cast<float*>(smem);
  unsigned char* region = smem + W_BYTES;
  bf16* draw_s = reinterpret_cast<bf16*>(region);
  bf16* ring_dw = reinterpret_cast<bf16*>(region + DRAW_BYTES);
  float* inv_s = reinterpret_cast<float*>(region + REGION_BYTES);
  float* dpart_s = inv_s + TILE_C;                 // [WN][class]
  float* cts_s = dpart_s + WN * TILE_C;
  float* ctt_s = cts_s + TILE_B;
  int* lab_s = reinterpret_cast<int*>(ctt_s + TILE_B);

  const bool vec = vec_i != 0;
  const int64_t c0 = (int64_t)blockIdx.x * TILE_C;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int wm = warp / WN, wn = warp % WN;

  Acc acc;
  for (int g0 = 0; g0 < B; g0 += TILE_B) {        // groups of 256 rows
    for (int r = t; r < TILE_B; r += NT) {
      const bool in = g0 + r < B;
      lab_s[r] = in ? lab[g0 + r] : -1;
      cts_s[r] = in ? ct_se[g0 + r] : 0.0f;
      ctt_s[r] = in ? ct_tgt[g0 + r] : 0.0f;
    }
    // -- the cosines' raw products; w_bf keeps the rounded tile
    cosine_tile<true, NST_COSB, KS_COS>(w, ne, C, d, dp, c0, g0, vec,
                               g0 + wn * WTN < B, region, w_bf, wp, inv_s,
                               acc);

    // -- dl, draw (bf16) into shared memory, the class sums of dl * raw
#pragma unroll
    for (int i = 0; i < MI; ++i) {
#pragma unroll
      for (int eh = 0; eh < 2; ++eh) {
        const int m = wm * WTM + frag_row(i, eh * 2);
        const int64_t c = c0 + m;
        const float inv = inv_s[m];
        float dinv = 0.0f;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int n = wn * WTN + frag_col(j, 0);
          float dr[2];
#pragma unroll
          for (int el = 0; el < 2; ++el) {
            float draw = 0.0f;
            if (c < C && g0 + n + el < B) {
              const float raw = acc[i][j][eh * 2 + el];
              const float li = raw * inv;
              const float logit = fminf(fmaxf(li, -1.0f), 1.0f);
              float dl = ((int64_t)lab_s[n + el] == c)
                             ? ctt_s[n + el]
                             : cts_s[n + el] * (s * expf(logit * s - s));
              if (!(li >= -1.0f && li <= 1.0f)) dl = 0.0f;
              draw = dl * inv;
              dinv += dl * raw;
            }
            dr[el] = draw;
          }
          *reinterpret_cast<uint32_t*>(draw_s + m * DRP + n) =
              pack_bf16(dr[0], dr[1]);
        }
        // the 4 lanes that share the class row, then one owner per warp
        dinv += __shfl_xor_sync(0xffffffffu, dinv, 1);
        dinv += __shfl_xor_sync(0xffffffffu, dinv, 2);
        if ((lane & 3) == 0) dpart_s[wn * TILE_C + m] = dinv;
      }
    }
    __syncthreads();

    // -- dne[b, n] += sum over the tile's classes of draw[c][b] * w[c][n]:
    //    warps NT / 64 (batch rows) x 2 (columns), 128 columns a pass
    {
      constexpr int WN2 = DNE_COLS / WTN;
      const int wb = warp / WN2, wc = warp % WN2;
      const bool odd = lane & 1;
      for (int n0 = 0; n0 < dp; n0 += DNE_COLS) {
        // nothing to add where the warp's rows or columns lie beyond
        if (g0 + wb * WTM >= B || n0 + wc * WTN >= dp) continue;
        zero(acc);
        mma_tile<true, TILE_C>(draw_s, DRP, w_bf, wp, wb * WTM,
                                     n0 + wc * WTN, acc);
#pragma unroll
        for (int i = 0; i < MI; ++i) {
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            const float* a = acc[i][j];
            const int b = g0 + wb * WTM + frag_row(i, 0);
            const int n = n0 + wc * WTN + frag_col(j, 0);
            if (d % 4 == 0) {
              // lanes 2q and 2q + 1 trade halves: the even one adds 4
              // consecutive columns of row b, the odd one of row b + 8
              const float r0 = __shfl_xor_sync(0xffffffffu, odd ? a[0] : a[2], 1);
              const float r1 = __shfl_xor_sync(0xffffffffu, odd ? a[1] : a[3], 1);
              const int row = odd ? b + 8 : b;
              const int col = n0 + wc * WTN + j * 8 + (lane & 2) * 2;
              if (row < B && col < d)
                atomicAdd(reinterpret_cast<float4*>(dne + row * (int64_t)d + col),
                          odd ? make_float4(r0, r1, a[2], a[3])
                              : make_float4(a[0], a[1], r0, r1));
            } else {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int row = b + (e >> 1) * 8, col = n + (e & 1);
                if (row < B && col < d)
                  atomicAdd(dne + row * (int64_t)d + col, a[e]);
              }
            }
          }
        }
      }
    }
    __syncthreads();     // w_bf is read: dW's fills take its place

    // -- dW[c, n] (+)= sum over the group's rows of draw[c][b] * ne[b][n]
    //    - (sum over them of dl * raw) * inv^3 * w[c, n], in passes of 256
    //    columns. Each slice's fill also brings a share of the pass's fp32
    //    w (128 x 256) into w_bf's place, which dne has read, so the
    //    epilogue finds the norm term's w in shared memory; a pass is a
    //    pipeline of its own, so no fill of the next pass overwrites that
    //    w while the epilogue reads it.
    const int rows = B - g0 < TILE_B ? B - g0 : TILE_B;
    const int n_bs = (rows + KB - 1) / KB;        // rows beyond have draw 0
    constexpr int W_PIECES = TILE_C * DW_COLS / 4;
    const int share = (W_PIECES + n_bs - 1) / n_bs;
    for (int n0 = 0; n0 < dp; n0 += DW_COLS) {
      pipeline<NST_DWB>(
          n_bs,
          [&](int ks) {
            fill_ne<KB, DW_COLS>(ring_dw + (ks % NST_DWB) * (DW_STAGE / 2),
                                 ne, dp, (int64_t)g0 + ks * KB, n0);
            const int end = min(W_PIECES, (ks + 1) * share);
            for (int it = ks * share + t; it < end; it += NT) {
              const int row = it / (DW_COLS / 4), col = (it % (DW_COLS / 4)) * 4;
              const int64_t c = c0 + row;
              const int n = n0 + col;
              float* q4 = w_f32 + row * WSP + col;
              if (vec) {
                const bool in = c < C && n < d;
                cp_async_16(q4, in ? w + c * (int64_t)d + n : w, in);
              } else {
#pragma unroll
                for (int e = 0; e < 4; ++e)
                  q4[e] = (c < C && n + e < d) ? w[c * (int64_t)d + n + e]
                                               : 0.0f;
              }
            }
          },
          [&](int ks) {
            const bool live = n0 + wn * WTN < dp;
            if (ks == 0) zero(acc);
            if (live)
              mma_tile<false, KB>(
                  draw_s + ks * KB, DRP,
                  ring_dw + (ks % NST_DWB) * (DW_STAGE / 2), DWP, wm * WTM,
                  wn * WTN, acc);
            if (ks != n_bs - 1 || !live) return;
            // the pass's epilogue: the norm's term, and the one store; the
            // pass's w has landed with this slice
#pragma unroll
            for (int i = 0; i < MI; ++i) {
#pragma unroll
              for (int eh = 0; eh < 2; ++eh) {
                const int m = wm * WTM + frag_row(i, eh * 2);
                const int64_t c = c0 + m;
                if (c >= C) continue;
                const float inv = inv_s[m];
                const float dinv =
                    ((dpart_s[m] + dpart_s[TILE_C + m]) +
                     dpart_s[2 * TILE_C + m]) + dpart_s[3 * TILE_C + m];
                const float scale = dinv * inv * inv * inv;
#pragma unroll
                for (int j = 0; j < NJ; ++j) {
                  const int col = wn * WTN + frag_col(j, 0), n = n0 + col;
                  if (n >= d) continue;
                  const float2 wv =
                      *reinterpret_cast<const float2*>(w_f32 + m * WSP + col);
                  float o0 = fmaf(-scale, wv.x, acc[i][j][eh * 2]);
                  float o1 = fmaf(-scale, wv.y, acc[i][j][eh * 2 + 1]);
                  float* out = dw + c * (int64_t)d + n;
                  if (d % 2 == 0) {
                    if (g0 != 0) {   // later groups add to their own rows
                      const float2 p = *reinterpret_cast<const float2*>(out);
                      o0 += p.x;
                      o1 += p.y;
                    }
                    *reinterpret_cast<float2*>(out) = make_float2(o0, o1);
                  } else {
                    if (g0 != 0) o0 += out[0];
                    out[0] = o0;
                    if (n + 1 >= d) continue;
                    if (g0 != 0) o1 += out[1];
                    out[1] = o1;
                  }
                }
              }
            }
          });
    }
  }
}

}  // namespace

namespace hfa_ce {
namespace tc {

int launch_bwd(const float* ne, const float* w, const int* lab,
               const float* ct_se, const float* ct_tgt, float* dw,
               float* dne, void* scratch, int B, int d, int64_t C, float s,
               cudaStream_t st) {
  if (d > BWD_MAX_D) return (int)cudaErrorInvalidValue;
  const int64_t n_ctiles = (C + TILE_C - 1) / TILE_C;
  if (n_ctiles > 2147483647LL) return (int)cudaErrorInvalidValue;
  cudaError_t err = round_embeddings(ne, scratch, B, d, st);
  if (err != cudaSuccess) return (int)err;
  const int dp = padded_depth(d);
  err = cudaFuncSetAttribute(flash_ce_bwd_bf16_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             BWD_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  flash_ce_bwd_bf16_kernel<<<(unsigned)n_ctiles, NT, BWD_SMEM_BYTES, st>>>(
      (const bf16*)scratch, w, lab, ct_se, ct_tgt, dw, dne, B, d, dp, C, s,
      d % 4 == 0);
  return (int)cudaGetLastError();
}

}  // namespace tc
}  // namespace hfa_ce
