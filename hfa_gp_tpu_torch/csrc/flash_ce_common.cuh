// Building blocks shared by the flash-CE forward (flash_ce.cu) and backward
// (flash_ce_bwd.cuh) kernels on Hopper. Every product is fp32 FMA on the
// CUDA cores (no tensor cores, no TF32), so the kernels are bound by the
// card's 67 TFLOP/s of fp32 FMA. What stands between a tiled product and
// that rate on the H100, as measured by timing the backward compiled with
// its parts removed one at a time: the wait for operands, shared memory's
// 128 bytes a clock (an 8 x 8 micro-tile reads 64 bytes for 64 FMAs, which
// keeps that port as busy as the FMA pipes), the instruction cache, and the
// barriers. The design:
//
//  * A block of 512 threads (16 warps, one block a multiprocessor, 128
//    registers a thread) owns a tile of 128 classes and works on up to 256
//    batch rows at once; each thread keeps an 8 x 8 micro-tile of the
//    output in registers. (TN = 16 gives 256 threads with 8 x 16
//    micro-tiles and fewer shared-memory bytes an FMA, but 8 warps hid the
//    copies, barriers and epilogues worse: 28 to 30 ms against 23 to 26.)
//  * Operand slices 32 deep travel from device memory (in practice L2) to a
//    ring of shared-memory stages by 16-byte `cp.async` copies, two or
//    three stages deep (what fits beside the 135 KB of draw), so the FMAs
//    of one slice run while the next arrive. One __syncthreads a slice;
//    nothing is staged through registers. (Slices 16 deep, four stages:
//    twice the barriers, 0.8 ms slower.)
//  * No transposition on the way in. An operand that memory holds as
//    [row][k] stays [row][k] in shared memory (pitch 36 floats, ≡ 4 mod 32,
//    so consecutive rows fall on distinct banks) and is read along k; one
//    that memory holds as [k][column] stays so and is read 16 bytes at a
//    time. A warp is 4 x 8 lanes: its 4 rows of a [row][k] operand are 4
//    small broadcast reads, its 8 x 4 columns of a [k][column] operand one
//    contiguous 128 bytes. Every product has one of two shapes, rows x
//    columns or columns x columns. (Both operands as [row][k], the warp's 8
//    rows of the second 80 bytes apart, measured twice as slow: 11.2 ms for
//    the cosines' FMAs against 5.5 and 5.8 ms for the gradient products.)
//    The cosines need the embeddings as [k][batch row], so the launcher
//    transposes those 512 KB once into scratch memory before the kernel.
//  * A product's loop is unrolled over two depth steps only (KU). Unrolled
//    over a whole slice it is 18 KB of straight-line code a product, which
//    the instruction cache did not hold: 26 ms against 24.
//  * Rows at or beyond the matrix's end and depths at or beyond d are
//    zero-filled by the copy itself (`cp.async` with a source size of 0).
//    When d % 4 != 0 the rows are not 16-byte aligned and the same ring is
//    filled by plain scalar loads and stores (the general, slower path).
//
// With `BF16` set the operands of a product are rounded to bfloat16 as they
// are read from shared memory and accumulated in fp32: the arithmetic of a
// bf16 matrix product with an fp32 accumulator. Row norms always come from
// the fp32 values. bf16 operands take the tensor-core kernels of
// flash_ce_bf16.cuh instead; only a backward with d > tc::BWD_MAX_D, whose
// class tile does not fit their shared memory, still runs this template
// with `BF16` set.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hfa_ce {

constexpr int TILE_C = 128;    // classes of a block's tile
constexpr int TILE_B = 256;    // batch rows a block holds at once
constexpr int TM = 8;          // a thread's rows: 4 apart, from the lane's ty
constexpr int TN = 8;          // its columns: groups of 4, 32 apart
constexpr int THREADS = TILE_C * TILE_B / (TM * TN);   // warps of 4 x 8 lanes
constexpr int WARP_COLS = 8 * TN;             // columns a warp covers
constexpr int WX = TILE_B / WARP_COLS;        // warps side by side on a tile
                                              // 256 columns wide
constexpr int KU = 2;          // depth steps unrolled in a product's loop
constexpr int KD = 32;         // depth of one operand slice
constexpr int PK = KD + 4;     // pitch of a [row][k] slice, in floats
// ring depths of the three products (the cosines', dW's, dne's): what a
// block's 227 KB of shared memory hold beside draw
constexpr int NST_RAW = 3;
constexpr int NST_DW = 2;
constexpr int NST_DNE = 3;

// ---- asynchronous copies --------------------------------------------------
// 16 bytes from global to shared memory; zero-fills when `pred` is false
// (`src` must still be a valid address).
__device__ __forceinline__ void cp_async_16(float* dst, const float* src,
                                            bool pred) {
#ifdef HFA_HOST_REHEARSAL
  hfa_stub::cp_async_16(dst, src, pred);
#else
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(n) : "memory");
#endif
}

__device__ __forceinline__ void cp_async_commit() {
#ifdef HFA_HOST_REHEARSAL
  hfa_stub::cp_async_commit();
#else
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

// Wait until at most N of this thread's committed groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
#ifdef HFA_HOST_REHEARSAL
  hfa_stub::cp_async_wait(N);
#else
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
#endif
}

// Run `compute(s)` for slices s = 0 .. n - 1, each after `fill(s)` has
// filled ring slot s % NST, with the fills of the next NST - 1 slices in
// flight meanwhile. `fill` may use asynchronous copies or plain stores. Ends with every copy landed and the block synchronised, so the
// ring (and whatever it aliases) may be reused at once.
template <int NST, class Fill, class Compute>
__device__ __forceinline__ void pipeline(int n, Fill fill,
                                         Compute compute) {
#pragma unroll
  for (int s = 0; s < NST - 1; ++s) {
    if (s < n) fill(s);
    cp_async_commit();
  }
  for (int s = 0; s < n; ++s) {
    cp_async_wait<NST - 2>();      // slice s has landed (this thread's part)
    __syncthreads();               // ... everyone's; slot (s - 1) is free
    if (s + NST - 1 < n) fill(s + NST - 1);
    cp_async_commit();
    compute(s);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// ---- ring fills -----------------------------------------------------------
// Rows [r0, r0 + ROWS) x depth [k0, k0 + KD) of a row-major (rows, d)
// matrix, depth contiguous in memory, as dst[row][k] at pitch PK.
template <int ROWS>
__device__ __forceinline__ void fill_rows_k(float* __restrict__ dst,
                                            const float* __restrict__ src,
                                            int64_t rows, int d, int64_t r0,
                                            int k0, bool vec) {
  static_assert(ROWS * (KD / 4) % THREADS == 0, "whole rounds of copies");
#pragma unroll
  for (int rep = 0; rep < ROWS * (KD / 4) / THREADS; ++rep) {
    const int item = threadIdx.x + rep * THREADS;
    const int row = item / (KD / 4), kq = (item % (KD / 4)) * 4;
    const int64_t r = r0 + row;
    float* q = dst + row * PK + kq;
    if (vec) {
      const bool in = r < rows && k0 + kq < d;
      cp_async_16(q, in ? src + r * (int64_t)d + k0 + kq : src, in);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        q[i] = (r < rows && k0 + kq + i < d)
                   ? src[r * (int64_t)d + k0 + kq + i] : 0.0f;
    }
  }
}

// Depth rows [k0, k0 + KD) x columns [n0, n0 + COLS) of a row-major
// (krows, d) matrix, columns contiguous in memory, as dst[k][col] at pitch
// COLS + 4.
template <int COLS>
__device__ __forceinline__ void fill_k_cols(float* __restrict__ dst,
                                            const float* __restrict__ src,
                                            int64_t krows, int d, int64_t k0,
                                            int n0, bool vec) {
  constexpr int QUADS = COLS / 4;
  static_assert(KD * QUADS % THREADS == 0, "whole rounds of copies");
#pragma unroll
  for (int rep = 0; rep < KD * QUADS / THREADS; ++rep) {
    const int item = threadIdx.x + rep * THREADS;
    const int kr = item / QUADS, col = (item % QUADS) * 4;
    const int64_t k = k0 + kr;
    float* q = dst + kr * (COLS + 4) + col;
    if (vec) {
      const bool in = k < krows && n0 + col < d;
      cp_async_16(q, in ? src + k * (int64_t)d + n0 + col : src, in);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        q[i] = (k < krows && n0 + col + i < d)
                   ? src[k * (int64_t)d + n0 + col + i] : 0.0f;
    }
  }
}

// ---- fragments ------------------------------------------------------------
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Four consecutive floats of a staged operand, rounded when BF16.
template <bool BF16>
__device__ __forceinline__ float4 ld4(const float* p) {
  float4 v = *reinterpret_cast<const float4*>(p);
  if (BF16) {
    v.x = round_bf16(v.x); v.y = round_bf16(v.y);
    v.z = round_bf16(v.z); v.w = round_bf16(v.w);
  }
  return v;
}

// A thread's place in the block: warp, and the lane's row (0..3) and column
// (0..7) inside the warp's 4 x 8 arrangement.
struct Lane {
  int warp, ty, tx;
  __device__ __forceinline__ Lane()
      : warp(threadIdx.x >> 5), ty((threadIdx.x >> 3) & 3),
        tx(threadIdx.x & 7) {}
};

// TN floats of a [k][col] operand's row: the thread's groups of 4 columns,
// 32 apart; `b` points at the first.
template <bool BF16>
__device__ __forceinline__ void ld_cols(const float* b, float (&v)[TN]) {
#pragma unroll
  for (int g = 0; g < TN / 4; ++g) {
    const float4 q = ld4<BF16>(b + g * 32);
    v[g * 4 + 0] = q.x; v[g * 4 + 1] = q.y;
    v[g * 4 + 2] = q.z; v[g * 4 + 3] = q.w;
  }
}

// acc[i][j] += sum over k < KD of a[i * 4 rows][k] * b[k][col_j]: `a` is
// [row][k] at pitch PA and points at the thread's first row (its 8 rows are
// 4 apart; the warp's 4 rows are 4 distinct reads on distinct banks); `b`
// is [k][col] at pitch pb and points at the thread's first column.
// ROUND_A says whether `a` still has to be rounded when BF16 is set.
template <bool BF16, bool ROUND_A, int PA>
__device__ __forceinline__ void fma_rows_cols(const float* __restrict__ a,
                                              const float* __restrict__ b,
                                              int pb, float (&acc)[TM][TN]) {
#pragma unroll 1
  for (int k0 = 0; k0 < KD; k0 += KU) {
#pragma unroll
    for (int kk = 0; kk < KU; kk += 2) {
      float b0[TN], b1[TN];
      ld_cols<BF16>(b + (k0 + kk) * pb, b0);
      ld_cols<BF16>(b + (k0 + kk + 1) * pb, b1);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        float2 av =
            *reinterpret_cast<const float2*>(a + i * 4 * PA + k0 + kk);
        if (BF16 && ROUND_A) {
          av.x = round_bf16(av.x);
          av.y = round_bf16(av.y);
        }
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av.x, b0[j], acc[i][j]);
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av.y, b1[j], acc[i][j]);
      }
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[TM][TN]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
}

// Columns of the padded, transposed embeddings: B rounded up to 4, so that
// every row of ne_t is 16-byte aligned.
__host__ __device__ __forceinline__ int padded_batch(int B) {
  return (B + 3) / 4 * 4;
}

// ne_t[k][b] = ne[b][k] for b < B, 0 for B <= b < padded_batch(B).
static __global__ void transpose_embeddings_kernel(const float* __restrict__ ne,
                                            float* __restrict__ ne_t, int B,
                                            int d) {
  const int bp = padded_batch(B);
  const int64_t at = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (at >= (int64_t)d * bp) return;
  const int k = (int)(at / bp), b = (int)(at % bp);
  ne_t[at] = b < B ? ne[(int64_t)b * d + k] : 0.0f;
}

inline cudaError_t transpose_embeddings(const float* ne, float* ne_t, int B,
                                        int d, cudaStream_t stream) {
  const int64_t n = (int64_t)d * padded_batch(B);
  transpose_embeddings_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      ne, ne_t, B, d);
  return cudaGetLastError();
}

// one stage of the cosine product: 128 rows of w as [row][k], and 16 depth
// rows of ne_t by 256 batch columns
constexpr int RAW_STAGE = TILE_C * PK + KD * (TILE_B + 4);

// The class tile's raw products for batch rows [b0, b0 + 256):
//   acc[i][j] = w[c0 + m_i] . ne[b0 + n_j] over the whole depth d, with
//   m_i = (warp / WX) * 32 + i * 4 + lane.ty and
//   n_j = (warp % WX) * WARP_COLS + (j / 4) * 32 + lane.tx * 4 + j % 4
//   (`raw_class` and `raw_row` below),
// and inv_s[m] = 1 / sqrt(sum of squares of the fp32 row c0 + m of w),
// correctly rounded rather than the 2-ulp rsqrtf. `ne_t` is the transposed
// embeddings (d, padded_batch(B)); `ring` holds NST_RAW * RAW_STAGE floats.
// Ends with the block synchronised, inv_s visible and the ring free.
__device__ __forceinline__ int raw_class(const Lane& ln, int i) {
  return (ln.warp / WX) * 32 + i * 4 + ln.ty;
}

__device__ __forceinline__ int raw_row(const Lane& ln, int j) {
  return (ln.warp % WX) * WARP_COLS + (j >> 2) * 32 + ln.tx * 4 + (j & 3);
}

template <bool BF16>
__device__ __forceinline__ void raw_tile(
    const float* __restrict__ w, const float* __restrict__ ne_t, int64_t C,
    int B, int d, int64_t c0, int b0, bool vec, float* ring, float* inv_s,
    float (&acc)[TM][TN]) {
  const Lane ln;
  const int t = threadIdx.x;
  const int a_off = raw_class(ln, 0) * PK;
  const int b_off = TILE_C * PK + raw_row(ln, 0);
  // a warp whose batch rows all lie beyond B has nothing to multiply
  const bool live = b0 + (ln.warp % WX) * WARP_COLS < B;
  constexpr int QPR = KD / 4;                    // 16-byte pieces of a row
  constexpr int SQ = TILE_C * QPR / THREADS;     // pieces of w a thread
  float sumsq[SQ] = {};                          // squares, one row each
  zero(acc);
  pipeline<NST_RAW>(
      (d + KD - 1) / KD,
      [&](int s) {
        float* st = ring + (s % NST_RAW) * RAW_STAGE;
        fill_rows_k<TILE_C>(st, w, C, d, c0, s * KD, vec);
        fill_k_cols<TILE_B>(st + TILE_C * PK, ne_t, d, padded_batch(B),
                            s * KD, b0, true);
      },
      [&](int s) {
        const float* st = ring + (s % NST_RAW) * RAW_STAGE;
        // thread t owns piece t % QPR of row t / QPR of w's slice (and of
        // the rows THREADS / QPR further on)
#pragma unroll
        for (int h = 0; h < SQ; ++h) {
          const float4 q = *reinterpret_cast<const float4*>(
              st + (h * (THREADS / QPR) + t / QPR) * PK + (t % QPR) * 4);
          sumsq[h] += q.x * q.x + q.y * q.y + q.z * q.z + q.w * q.w;
        }
        if (live)
          fma_rows_cols<BF16, true, PK>(st + a_off, st + b_off, TILE_B + 4,
                                        acc);
      });
#pragma unroll
  for (int h = 0; h < SQ; ++h) {
    float v = sumsq[h];
#pragma unroll
    for (int m = 1; m < QPR; m *= 2) v += __shfl_xor_sync(0xffffffffu, v, m);
    if (t % QPR == 0) inv_s[h * (THREADS / QPR) + t / QPR] = 1.0f / sqrtf(v);
  }
  __syncthreads();
}

// ---- the tensor-core route for bf16 operands --------------------------------
// flash_ce_bf16.cu and flash_ce_bwd_bf16.cu (design in flash_ce_bf16.cuh).
// `scratch` holds the embeddings rounded to bf16, padded to a multiple of
// 256 rows and 64 columns. Each returns a cudaError_t.
namespace tc {
constexpr int BWD_MAX_D = 512;   // the backward's class tile fits up to here
cudaError_t launch_fwd(const float* ne, const float* w, const int* lab,
                       float* partial, void* scratch, float* tgt_raw, int B,
                       int d, int64_t C, int64_t n_ctiles, float s,
                       cudaStream_t st);
int launch_bwd(const float* ne, const float* w, const int* lab,
               const float* ct_se, const float* ct_tgt, float* dw,
               float* dne, void* scratch, int B, int d, int64_t C, float s,
               cudaStream_t st);
}  // namespace tc

}  // namespace hfa_ce
