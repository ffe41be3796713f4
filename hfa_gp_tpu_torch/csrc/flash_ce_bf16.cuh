// Building blocks of the flash-CE kernels for bf16 operands on Hopper's
// tensor cores: the forward (flash_ce_bf16.cu) and the backward
// (flash_ce_bwd_bf16.cu). They compute what the fp32-operand kernels of
// flash_ce.cu and flash_ce_bwd.cu compute with `bf16` set, the function of
// hfa_gp_tpu/parallel/pallas_ce.py with mm_dtype = bfloat16: every operand
// of a product is rounded to bf16 and the products are summed in fp32;
// row norms, the clip, the exp, dl, the sums dl * raw and dW's norm term
// stay fp32.
//
// What bounds them: bytes. At B 256, d 512, C 1,000,000 the forward reads
// the 2.05 GB fp32 table once (0.61 ms at 3.35 TB/s) against 0.26 TFLOP of
// bf16 products (0.27 ms at 989 TFLOP/s); the backward moves 4.1 GB (1.22
// ms) against 0.79 TFLOP (0.80 ms). The fp32-operand design, which rounded
// each operand inside its FMA loop and ran the products on the CUDA cores,
// took 11.8 and 32.3 ms. The design:
//
//  * Round once, where the tile is staged. The table's slices arrive as
//    fp32 by `cp.async` (a ring as in flash_ce_common.cuh); one pass over
//    each slice sums the squares for the fp32 row norms and writes the
//    slice as bf16 into the layout the tensor cores' operand loads read.
//    The embeddings (B x d, 0.5 MB) are rounded once by a small kernel
//    ahead of the main one, into scratch of B padded to 256 rows and d
//    padded to 64 columns with zeros, so the kernels load them without
//    masks and every product runs over whole 16-deep steps.
//  * Products by `mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32`,
//    operands by `ldmatrix` (`.trans` where shared memory holds an
//    operand as [k][column]). `wgmma` would reach further, but `mma.sync`
//    already puts each product under the byte time (the forward's 0.26
//    TFLOP at half the tensor cores' peak is 0.53 ms), and it keeps one
//    accumulator layout for the three products and their epilogues. A
//    block is 16 warps, 4 along its 128 rows by 4 along its 256 columns;
//    a thread holds 2 x 8 fragments of 4 fp32 sums. (8 warps of 64 x 64,
//    which read each operand from shared memory fewer times, left the
//    copies, barriers and epilogues less hidden: 2.26 and 10.2 ms against
//    1.85 and 7.65 on the H100.)
//  * Shared memory rows of bf16 are padded by 8 elements (16 bytes), so the
//    8 rows an `ldmatrix` phase reads start on distinct 16-byte bank
//    groups.
//  * The backward keeps the whole bf16 class tile (128 x d, 130 KB at d
//    512) and draw (128 classes x 256 batch rows, bf16, 66 KB) in shared
//    memory: the cosines write the tile, dne's product reads it back, so
//    device memory is read for w once; draw serves dW as [class][batch row]
//    and dne, transposed by `ldmatrix.trans`, as [batch row][class]. That
//    holds for d <= 512 (BWD_MAX_D); a backward at larger d takes the
//    CUDA-core route of flash_ce_bwd.cuh with bf16 rounding, which is right
//    at any d and slower.
//  * Determinism as in the fp32 kernels: se_x from per-tile partial sums in
//    a fixed order, dW written by one block per class row without atomics;
//    dne sums over the class tiles by 16-byte atomic adds.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_ce_common.cuh"

namespace hfa_ce {
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int MI = 2;            // a warp's m16 fragments
constexpr int WTM = 16 * MI;     // its tile's rows
constexpr int WTN = 64;          // its tile's columns
constexpr int NJ = WTN / 8;      // its n8 fragments
constexpr int WN = TILE_B / WTN; // warps side by side along 256 columns
constexpr int WM = TILE_C / WTM; // warps along a class tile's 128 rows
constexpr int NT = 32 * WM * WN; // threads of a block
constexpr int DP_ALIGN = 64;     // the embeddings' scratch depth is padded
                                 // to this (a warp tile's width)
constexpr int PB = 8;            // pad of a bf16 row in shared memory

// One stage of the cosines' ring, slices KS deep: 128 rows of w in fp32
// at a pitch of KS + 4 floats, and 256 rows of the rounded embeddings at
// KS + PB (both pitches put the 8 rows a warp reads at once on distinct
// banks).
template <int KS>
struct Slice {
  static constexpr int PW = KS + 4;
  static constexpr int PN = KS + PB;
  static constexpr int W_BYTES = TILE_C * PW * 4;
  static constexpr int BYTES = W_BYTES + TILE_B * PN * 2;
};

typedef float Acc[MI][NJ][4];

__host__ __device__ __forceinline__ int padded_depth(int d) {
  return (d + DP_ALIGN - 1) / DP_ALIGN * DP_ALIGN;
}

__host__ __device__ __forceinline__ int padded_rows(int B) {
  return (B + TILE_B - 1) / TILE_B * TILE_B;
}

// ---- the rounded embeddings -----------------------------------------------
// ne_bf[r][k] = bf16(ne[r][k]) for r < B, k < d; 0 up to (bp, dp).
static __global__ void round_embeddings_kernel(const float* __restrict__ ne,
                                               __nv_bfloat162* __restrict__ out,
                                               int B, int d, int bp, int dp) {
  const int64_t at = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (at >= (int64_t)bp * dp / 2) return;
  const int r = (int)(at / (dp / 2)), k = (int)(at % (dp / 2)) * 2;
  const float* row = ne + (int64_t)r * d;
  const float x = (r < B && k < d) ? row[k] : 0.0f;
  const float y = (r < B && k + 1 < d) ? row[k + 1] : 0.0f;
  out[at] = __floats2bfloat162_rn(x, y);
}

inline cudaError_t round_embeddings(const float* ne, void* ne_bf, int B,
                                    int d, cudaStream_t stream) {
  const int64_t n = (int64_t)padded_rows(B) * padded_depth(d) / 2;
  round_embeddings_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      ne, (__nv_bfloat162*)ne_bf, B, d, padded_rows(B), padded_depth(d));
  return cudaGetLastError();
}

// ---- fragments ------------------------------------------------------------
#ifndef HFA_HOST_REHEARSAL
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
#endif

// four 8 x 8 matrices of bf16; lane l gives the address of row l % 8 of
// matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
#ifdef HFA_HOST_REHEARSAL
  hfa_stub::ldmatrix_x4(r, p, false);
#else
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
#endif
}

// the same, each matrix transposed on the way
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
#ifdef HFA_HOST_REHEARSAL
  hfa_stub::ldmatrix_x4(r, p, true);
#else
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
#endif
}

// c += a (16 x 16, row) * b (16 x 8, col), bf16 operands, fp32 sums
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
#ifdef HFA_HOST_REHEARSAL
  hfa_stub::mma_m16n8k16_bf16(c, a, b0, b1);
#else
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
#endif
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void zero(Acc& acc) {
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
}

// Where a thread's sums lie in its warp's WTM x WTN tile: fragment (i, j),
// element e is row frag_row(i, e) and column frag_col(j, e).
__device__ __forceinline__ int frag_row(int i, int e) {
  return i * 16 + ((threadIdx.x & 31) >> 2) + (e >> 1) * 8;
}

__device__ __forceinline__ int frag_col(int j, int e) {
  return j * 8 + (threadIdx.x & 3) * 2 + (e & 1);
}

// acc += A (rows [m0, m0 + WTM), depth K) x B (columns [n0, n0 + WTN), depth
// K)^T in bf16 on the tensor cores, B held as [k][column] at pitch pb. AT
// false: A as [row][k] at pitch pa; true: as [k][row]. Both point at depth
// 0 of the product.
template <bool AT, int K>
__device__ __forceinline__ void mma_tile(const bf16* __restrict__ a, int pa,
                                         const bf16* __restrict__ b, int pb,
                                         int m0, int n0, Acc& acc) {
  const int lane = threadIdx.x & 31;
  const int r8 = lane & 7, h1 = (lane >> 3) & 1, h2 = lane >> 4;
#pragma unroll
  for (int kk = 0; kk < K; kk += 16) {
    uint32_t af[MI][4];
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      const int m = m0 + i * 16;
      // matrices: (rows 0-7, k 0-7), (rows 8-15, k 0-7), (rows 0-7, k
      // 8-15), (rows 8-15, k 8-15): the fragment's a0..a7 in order
      if (AT)
        ldsm_x4_t(af[i], a + (kk + r8 + h2 * 8) * pa + m + h1 * 8);
      else
        ldsm_x4(af[i], a + (m + r8 + h1 * 8) * pa + kk + h2 * 8);
    }
#pragma unroll
    for (int jp = 0; jp < NJ / 2; ++jp) {
      // matrices: (k 0-7, columns 0-7), (k 8-15, 0-7), (k 0-7, 8-15),
      // (k 8-15, 8-15), each transposed: b0b1 and b2b3 of two n8 fragments
      uint32_t bf[4];
      ldsm_x4_t(bf, b + (kk + r8 + h1 * 8) * pb + n0 + jp * 16 + h2 * 8);
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        mma_bf16(acc[i][2 * jp], af[i], bf[0], bf[1]);
        mma_bf16(acc[i][2 * jp + 1], af[i], bf[2], bf[3]);
      }
    }
  }
}

// acc += A x B^T over one slice of depth K (A [row][k] at pitch pa, B
// [column][k] at pitch pb), the slice's products summed on the tensor
// cores from zero and folded into acc by one fp32 add each. The tensor
// cores' fp32 accumulation does not round to nearest (published
// measurements of earlier generations find truncation), and a cosine
// summed over the whole depth inside mma.sync could drift by up to an ulp
// a step, all of one sign for the positive sums of a class centre and its
// own embeddings. Folded per slice, the long sum rounds to nearest.
template <int K>
__device__ __forceinline__ void mma_tile_fold(const bf16* __restrict__ a,
                                              int pa,
                                              const bf16* __restrict__ b,
                                              int pb, int m0, int n0,
                                              Acc& acc) {
  constexpr int KS = K / 16;
  const int lane = threadIdx.x & 31;
  const int r8 = lane & 7, h1 = (lane >> 3) & 1, h2 = lane >> 4;
  uint32_t af[KS][MI][4];
#pragma unroll
  for (int k = 0; k < KS; ++k)
#pragma unroll
    for (int i = 0; i < MI; ++i)
      ldsm_x4(af[k][i], a + (m0 + i * 16 + r8 + h1 * 8) * pa + k * 16 + h2 * 8);
#pragma unroll
  for (int jp = 0; jp < NJ / 2; ++jp) {
    const int n = n0 + jp * 16;
    uint32_t bf[KS][4];
#pragma unroll
    for (int k = 0; k < KS; ++k)
      ldsm_x4(bf[k], b + (n + r8 + h2 * 8) * pb + k * 16 + h1 * 8);
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      float t0[4] = {}, t1[4] = {};
#pragma unroll
      for (int k = 0; k < KS; ++k) {
        mma_bf16(t0, af[k][i], bf[k][0], bf[k][1]);
        mma_bf16(t1, af[k][i], bf[k][2], bf[k][3]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[i][2 * jp][e] += t0[e];
        acc[i][2 * jp + 1][e] += t1[e];
      }
    }
  }
}

// ---- ring fills -----------------------------------------------------------
// Rows [c0, c0 + TILE_C) x depth [k0, k0 + KS) of the fp32 table (C, d) as
// dst[row][k] at pitch KS + 4; zero beyond C and d. Scalar loads and stores
// when the rows are not 16-byte aligned (d % 4 != 0).
template <int KS>
__device__ __forceinline__ void fill_w(float* __restrict__ dst,
                                       const float* __restrict__ w, int64_t C,
                                       int d, int64_t c0, int k0, bool vec) {
  constexpr int QPR = KS / 4, PK = Slice<KS>::PW;
  static_assert(TILE_C * QPR % NT == 0, "whole rounds of copies");
#pragma unroll
  for (int rep = 0; rep < TILE_C * QPR / NT; ++rep) {
    const int item = threadIdx.x + rep * NT;
    const int row = item / QPR, kq = (item % QPR) * 4;
    const int64_t r = c0 + row;
    float* q = dst + row * PK + kq;
    if (vec) {
      const bool in = r < C && k0 + kq < d;
      cp_async_16(q, in ? w + r * (int64_t)d + k0 + kq : w, in);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        q[i] = (r < C && k0 + kq + i < d) ? w[r * (int64_t)d + k0 + kq + i]
                                         : 0.0f;
    }
  }
}

// Rows [r0, r0 + ROWS) x columns [k0, k0 + COLS) of the rounded embeddings
// (padded rows, pitch dp) as dst[row][column] at pitch COLS + PB; columns
// at or beyond dp are zero.
template <int ROWS, int COLS>
__device__ __forceinline__ void fill_ne(bf16* __restrict__ dst,
                                        const bf16* __restrict__ ne, int dp,
                                        int64_t r0, int k0) {
  constexpr int PIECES = COLS / 8;               // 16 bytes each
  static_assert(ROWS * PIECES % NT == 0, "whole rounds of copies");
#pragma unroll
  for (int rep = 0; rep < ROWS * PIECES / NT; ++rep) {
    const int item = threadIdx.x + rep * NT;
    const int row = item / PIECES, col = (item % PIECES) * 8;
    const bool in = k0 + col < dp;
    const bf16* src = in ? ne + (r0 + row) * dp + k0 + col : ne;
    cp_async_16(reinterpret_cast<float*>(dst + row * (COLS + PB) + col),
                reinterpret_cast<const float*>(src), in);
  }
}

// ---- the cosines' raw products ------------------------------------------
// acc = w_bf[c0 + warp rows] . ne_bf[b0 + warp columns] over the depth, for
// the class tile's 128 rows and the batch rows [b0, b0 + 256): warp
// (wm, wn) = (warp / WN, warp % WN) holds rows wm * WTM + frag_row and
// columns wn * WTN + frag_col. inv_s[m] = 1 / sqrt(sum of squares of the
// fp32 row c0 + m). `ring` holds NST stages of Slice<KS>::BYTES. PERSIST:
// `w_bf` keeps the whole rounded tile, [row][k] at pitch wp >= dp + PB;
// otherwise one slice at pitch KS + PB. `live` false: the warp's batch rows
// all lie beyond B and it skips its products. Ends with the block
// synchronised, inv_s visible and the ring free.
template <bool PERSIST, int NST, int KS>
__device__ __forceinline__ void cosine_tile(
    const float* __restrict__ w, const bf16* __restrict__ ne, int64_t C,
    int d, int dp, int64_t c0, int b0, bool vec, bool live,
    unsigned char* ring, bf16* w_bf, int wp, float* inv_s, Acc& acc) {
  using S = Slice<KS>;
  const int t = threadIdx.x, warp = t >> 5;
  const int wm = warp / WN, wn = warp % WN;
  constexpr int QPR = KS / 4;                    // 16-byte pieces of a row
  constexpr int SQ = TILE_C * QPR / NT;          // rows a thread squares
  float sumsq[SQ] = {};
  zero(acc);
  pipeline<NST>(
      dp / KS,
      [&](int s) {
        unsigned char* st = ring + (s % NST) * S::BYTES;
        fill_w<KS>(reinterpret_cast<float*>(st), w, C, d, c0, s * KS, vec);
        fill_ne<TILE_B, KS>(reinterpret_cast<bf16*>(st + S::W_BYTES), ne,
                            dp, b0, s * KS);
      },
      [&](int s) {
        const unsigned char* st = ring + (s % NST) * S::BYTES;
        const float* ws = reinterpret_cast<const float*>(st);
        bf16* a = w_bf + (PERSIST ? s * KS : 0);
        // the slice's one pass: squares for the norms, bf16 for the
        // products (thread t: piece t % QPR of rows t / QPR + h * NT / QPR)
#pragma unroll
        for (int h = 0; h < SQ; ++h) {
          const int row = t / QPR + h * (NT / QPR), kq = (t % QPR) * 4;
          const float4 q =
              *reinterpret_cast<const float4*>(ws + row * S::PW + kq);
          sumsq[h] += q.x * q.x + q.y * q.y + q.z * q.z + q.w * q.w;
          *reinterpret_cast<uint2*>(a + row * wp + kq) =
              make_uint2(pack_bf16(q.x, q.y), pack_bf16(q.z, q.w));
        }
        __syncthreads();
        if (live)
          mma_tile_fold<KS>(a, wp,
                            reinterpret_cast<const bf16*>(st + S::W_BYTES),
                            S::PN, wm * WTM, wn * WTN, acc);
      });
#pragma unroll
  for (int h = 0; h < SQ; ++h) {
    float v = sumsq[h];
#pragma unroll
    for (int m = 1; m < QPR; m *= 2) v += __shfl_xor_sync(0xffffffffu, v, m);
    if (t % QPR == 0) inv_s[t / QPR + h * (NT / QPR)] = 1.0f / sqrtf(v);
  }
  __syncthreads();
}

}  // namespace tc
}  // namespace hfa_ce
