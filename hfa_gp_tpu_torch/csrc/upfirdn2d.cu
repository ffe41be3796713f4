// FIR (K9): EG3D's upfirdn2d — zero-stuffing by `up`, padding, a 2-D FIR of
// up to 4 x 4 taps and keeping every `down`-th output — in one pass; with
// the adjoint's geometry (the wrapper's `fir.adjoint`) it is its own
// backward. It replaces no TPU kernel: the JAX package leaves the FIR to
// XLA's convolution (hfa_gp_tpu/core/ops.py::upfirdn2d). The port's plain
// version (hfa_gp_tpu_torch/core/ops.py::upfirdn2d_plain) writes the
// zero-stuffed and the padded image to device memory and then runs a
// depthwise convolution (groups = channels) on them.
//
//   y[oy][ox] = Σ_{ty<kh, tx<kw} f[ty][tx]
//                 · u[oy·down + ty − py0][ox·down + tx − px0]
//   u[j][i]   = x[j/up][i/up] where up divides j and i and the point lies
//               in x; 0 elsewhere
//
// f: the flipped, gain-scaled taps, passed by value as a kernel argument,
// so a call copies nothing to the card and a CUDA graph keeps them in its
// kernel node. x: N x C x H x W at any strides with W adjacent in memory
// (NCHW, EG3D's synthesis) or C adjacent (channels-last: the encoder's
// blurs, and SR's first three channels of the channels-last feature
// image); y: contiguous in the same order. fp32 or bf16, summed in fp32.
//
// Bound on the H100: memory. A call reads x once and writes y once (at
// most 16 products an output, 4 with up = 2), so the design keeps
// device-memory traffic at those bytes:
//  * A block computes one tile of outputs. Its input with the halo the
//    taps need is staged in shared memory as fp32, read from device memory
//    once, with 16-byte loads along the adjacent axis. Padding and
//    zero-stuffing are indexing: a staged point outside x is written as 0
//    and never read from device memory, and a stuffed zero is never staged
//    at all.
//  * W adjacent: a tile is 32 columns x 64 rows of one plane (32 rows for
//    down = 2), a lane a column, a warp 8 rows (4). A tile row starts
//    anywhere (EG3D's odd widths, 2H + 1 after a transposed convolution),
//    so the loads are aligned to 16 bytes in memory and each element is
//    put in its place in shared memory; a vector that would leave x's row
//    takes its elements one by one.
//  * C adjacent: a tile is 32 channels x 8 columns x 16 rows (8 rows for
//    down = 2), a thread 4 channels (one float4 of shared memory) of
//    consecutive rows, 8 threads a pixel.
//  * up = 1: a thread walks down the input rows its outputs share and adds
//    each row into every output that reaches it: 11 rows read for 8
//    outputs of 4 x 4 taps, not 32.
//  * up = 2 (polyphase): an output reads only the taps that land on real
//    inputs, 2 x 2 of 4 x 4.
//  * Tiles are small, so batch 1 still puts thousands of blocks on 132 SMs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_TAPS = 4;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 4;           // staging loads in flight a thread

// W adjacent: output columns a tile and rows a thread (a taller tile reads
// fewer halo rows; down = 2 reads twice the rows)
constexpr int NC_TW = 32;
template <int DOWN>
constexpr int NC_ROWS = DOWN == 1 ? 8 : 4;
template <int DOWN>
constexpr int NC_TH = WARPS * NC_ROWS<DOWN>;

// channels-last: channels, channel groups (a float4 each), columns and row
// groups a tile
constexpr int CL_CT = 32;
constexpr int CL_CG = CL_CT / 4;
constexpr int CL_TW = 8;
constexpr int CL_RG = THREADS / CL_CG / CL_TW;

struct Taps {
  float k[MAX_TAPS * MAX_TAPS];   // row-major f, zero beyond (kh, kw)
};

struct Geometry {
  int64_t sn, sc, sh, sw;         // x's strides in elements
  int n, c, in_h, in_w, out_h, out_w;
  int kh, kw, py0, px0;
  int align;                      // x's address in elements, modulo a vector
};

// input points of one axis that a tile of `t` outputs from `o0` reads:
// [lo, lo + n)
template <int UP, int DOWN>
struct Span {
  int lo, n;
  __device__ __forceinline__ Span(int o0, int t, int k, int p0) {
    const int j_lo = o0 * DOWN - p0;
    const int j_hi = (o0 + t - 1) * DOWN + k - 1 - p0;
    lo = UP == 1 ? j_lo : (j_lo + 1) >> 1;        // ceil(j_lo / UP)
    n = (UP == 1 ? j_hi : j_hi >> 1) - lo + 1;    // floor(j_hi / UP) − lo + 1
  }
};

// the most points a tile of `t` outputs reads along one axis
template <int UP, int DOWN>
__host__ __device__ constexpr int span_max(int t) {
  return ((t - 1) * DOWN + MAX_TAPS + UP - 1) / UP;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// 16 bytes at p (aligned) as floats
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
// 4 consecutive values, p aligned to 4 elements
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 h[2] = {__floats2bfloat162_rn(v.x, v.y),
                         __floats2bfloat162_rn(v.z, v.w)};
  *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(h);
}

__device__ __forceinline__ float zero(float) { return 0.0f; }
__device__ __forceinline__ float4 zero(float4) {
  return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}
__device__ __forceinline__ float mad(float t, float v, float a) {
  return fmaf(t, v, a);
}
__device__ __forceinline__ float4 mad(float t, float4 v, float4 a) {
  return make_float4(fmaf(t, v.x, a.x), fmaf(t, v.y, a.y), fmaf(t, v.z, a.z),
                     fmaf(t, v.w, a.w));
}

// f[2·uy + py][2·ux + px] for the runtime phases py, px ∈ {0, 1}: four
// taps at constant indices and a select, so the taps stay in the kernel's
// argument space
__device__ __forceinline__ float phase_tap(const Taps& f, int uy, int ux,
                                           int py, int px) {
  const float* k = f.k + (2 * uy) * MAX_TAPS + 2 * ux;
  const float t0 = py ? k[MAX_TAPS] : k[0];
  const float t1 = py ? k[MAX_TAPS + 1] : k[1];
  return px ? t1 : t0;
}

// The FIR of ROWS consecutive outputs of one column from the staged tile:
// `read(row, col)` gives a staged value (float, or float4 of 4 channels);
// jy0, jx0: the stuffed input row and column under tap (0, 0) of the
// first output; (iy_lo, ix_lo): the tile's first input point.
template <int UP, int DOWN, int ROWS, typename V, typename Read>
__device__ __forceinline__ void fir_rows(V (&acc)[ROWS], const Read& read,
                                         const Taps& f, int kh, int kw,
                                         int jy0, int jx0, int iy_lo,
                                         int ix_lo) {
#pragma unroll
  for (int r = 0; r < ROWS; ++r) acc[r] = zero(V());
  if (UP == 1) {
    // every input row is real: walk down the rows the outputs share
    const int row0 = jy0 - iy_lo, col0 = jx0 - ix_lo;
    constexpr int SPAN = (ROWS - 1) * DOWN + MAX_TAPS;
#pragma unroll
    for (int q = 0; q < SPAN; ++q) {
      if (q < (ROWS - 1) * DOWN + kh) {
        V v[MAX_TAPS];
#pragma unroll
        for (int tx = 0; tx < MAX_TAPS; ++tx)
          v[tx] = tx < kw ? read(row0 + q, col0 + tx) : zero(V());
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const int ty = q - r * DOWN;
          if (ty >= 0 && ty < MAX_TAPS && ty < kh) {
#pragma unroll
            for (int tx = 0; tx < MAX_TAPS; ++tx)
              acc[r] = mad(f.k[ty * MAX_TAPS + tx], v[tx], acc[r]);
          }
        }
      }
    }
  } else {
    // polyphase: tap (ty, tx) lands on a real input where jy + ty and
    // jx + tx are even
    const int px = jx0 & 1;
    const int col = ((jx0 + px) >> 1) - ix_lo;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int jy = jy0 + r * DOWN;
      const int py = jy & 1;
      const int row = ((jy + py) >> 1) - iy_lo;
#pragma unroll
      for (int uy = 0; uy < MAX_TAPS / 2; ++uy) {
        if (2 * uy + py < kh) {
#pragma unroll
          for (int ux = 0; ux < MAX_TAPS / 2; ++ux) {
            if (2 * ux + px < kw)
              acc[r] = mad(phase_tap(f, uy, ux, py, px),
                           read(row + uy, col + ux), acc[r]);
          }
        }
      }
    }
  }
}

// -- rows (W adjacent in memory: NCHW): a tile of 32 columns x (64 or 32)
// rows of one plane ---------------------------------------------------------

template <typename T, int UP, int DOWN>
__global__ void __launch_bounds__(THREADS)
upfirdn2d_rows_kernel(const T* __restrict__ x, T* __restrict__ y,
                      const Taps f, const Geometry g) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int ROWS = NC_ROWS<DOWN>;
  constexpr int TH = NC_TH<DOWN>;
  constexpr int IN_TH = span_max<UP, DOWN>(TH);
  constexpr int IN_TW = span_max<UP, DOWN>(NC_TW);
  // the aligned vectors that cover a tile row, at most, and a thread's
  // vectors of a tile
  constexpr int ROW_VECS = (IN_TW + 2 * VEC - 2) / VEC;
  constexpr int ITEMS = (IN_TH * ROW_VECS + THREADS - 1) / THREADS;
  __shared__ float tile[IN_TH * IN_TW];

  const int tiles_x = (g.out_w + NC_TW - 1) / NC_TW;
  const int tiles_y = (g.out_h + TH - 1) / TH;
  int64_t b = blockIdx.x;
  const int ox0 = (int)(b % tiles_x) * NC_TW;
  b /= tiles_x;
  const int oy0 = (int)(b % tiles_y) * TH;
  const int64_t plane = b / tiles_y;
  const int64_t n = plane / g.c;
  const int64_t base = n * g.sn + (plane - n * g.c) * g.sc;
  const Span<UP, DOWN> sy(oy0, TH, g.kh, g.py0);
  const Span<UP, DOWN> sx(ox0, NC_TW, g.kw, g.px0);

  // -- stage: each tile row as the aligned 16-byte vectors that cover it,
  // zeros outside x
#pragma unroll
  for (int u = 0; u < ITEMS; ++u) {
    const int item = threadIdx.x + u * THREADS;
    const int r = item / ROW_VECS, v = item - r * ROW_VECS;
    if (r >= sy.n) continue;
    const int iy = sy.lo + r;
    const int64_t off = base + (int64_t)iy * g.sh + sx.lo;
    const int64_t a = ((off + g.align) & ~(int64_t)(VEC - 1)) - g.align
                      + (int64_t)v * VEC;
    const int first = (int)(a - off);   // tile column of the first element
    unsigned inside = 0u;               // the elements that lie in x's row
    if (iy >= 0 && iy < g.in_h) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const int col = first + e, ix = sx.lo + col;
        if (col >= 0 && col < sx.n && ix >= 0 && ix < g.in_w)
          inside |= 1u << e;
      }
    }
    float vals[VEC];
    const int ix0 = sx.lo + first;
    if (inside != 0u && ix0 >= 0 && ix0 + VEC <= g.in_w) {
      load16(x + a, vals);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        vals[e] = (inside >> e & 1u) ? to_float(x[a + e]) : 0.0f;
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const int col = first + e;
      if (col >= 0 && col < sx.n) tile[r * IN_TW + col] = vals[e];
    }
  }
  __syncthreads();

  // -- a lane a column, a warp ROWS consecutive rows
  const int lane = threadIdx.x & 31, rows0 = (threadIdx.x >> 5) * ROWS;
  const int ox = ox0 + lane, oy = oy0 + rows0;
  if (ox >= g.out_w || oy >= g.out_h) return;
  float acc[ROWS];
  const auto read = [&](int row, int col) { return tile[row * IN_TW + col]; };
  fir_rows<UP, DOWN, ROWS>(acc, read, f, g.kh, g.kw, oy * DOWN - g.py0,
                           ox * DOWN - g.px0, sy.lo, sx.lo);
  T* out = y + (plane * g.out_h + oy) * g.out_w + ox;
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
    if (oy + r < g.out_h) store(out + (int64_t)r * g.out_w, acc[r]);
}

// -- channels-last (C adjacent in memory): a tile of 32 channels x 8 columns
// x (16 or 8) rows ------------------------------------------------------

template <typename T, int UP, int DOWN, bool VEC_LOAD>
__global__ void __launch_bounds__(THREADS)
upfirdn2d_cl_kernel(const T* __restrict__ x, T* __restrict__ y,
                    const Taps f, const Geometry g) {
  constexpr int ROWS = DOWN == 1 ? 4 : 2;
  constexpr int TH = CL_RG * ROWS;
  constexpr int IN_TH = span_max<UP, DOWN>(TH);
  constexpr int IN_TW = span_max<UP, DOWN>(CL_TW);
  constexpr int LV = VEC_LOAD ? 16 / sizeof(T) : 1;   // channels a load
  constexpr int PER_PIXEL = CL_CT / LV;
  __shared__ float4 tile[IN_TH * IN_TW * CL_CG];

  const int chunks = (g.c + CL_CT - 1) / CL_CT;
  const int tiles_x = (g.out_w + CL_TW - 1) / CL_TW;
  const int tiles_y = (g.out_h + TH - 1) / TH;
  int64_t b = blockIdx.x;
  const int c0 = (int)(b % chunks) * CL_CT;
  b /= chunks;
  const int ox0 = (int)(b % tiles_x) * CL_TW;
  b /= tiles_x;
  const int oy0 = (int)(b % tiles_y) * TH;
  const int64_t n = b / tiles_y;
  const Span<UP, DOWN> sy(oy0, TH, g.kh, g.py0);
  const Span<UP, DOWN> sx(ox0, CL_TW, g.kw, g.px0);

  // -- stage: every pixel of the tile, LV channels a load
  float* staged = reinterpret_cast<float*>(tile);
  const int items = sy.n * sx.n * PER_PIXEL;
  for (int i0 = threadIdx.x; i0 < items; i0 += THREADS * UNROLL) {
    float vals[UNROLL][LV];
    int dest[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int item = i0 + u * THREADS;
      dest[u] = -1;
#pragma unroll
      for (int e = 0; e < LV; ++e) vals[u][e] = 0.0f;
      if (item >= items) continue;
      const int pix = item / PER_PIXEL, v = item - pix * PER_PIXEL;
      const int r = pix / sx.n, col = pix - r * sx.n;
      const int iy = sy.lo + r, ix = sx.lo + col, c = c0 + v * LV;
      dest[u] = (r * IN_TW + col) * CL_CT + v * LV;
      if (iy < 0 || iy >= g.in_h || ix < 0 || ix >= g.in_w || c >= g.c)
        continue;
      const T* p = x + n * g.sn + (int64_t)iy * g.sh + (int64_t)ix * g.sw + c;
      if (VEC_LOAD)
        load16(p, vals[u]);
      else
        vals[u][0] = to_float(*p);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (dest[u] < 0) continue;
#pragma unroll
      for (int e = 0; e < LV; ++e) staged[dest[u] + e] = vals[u][e];
    }
  }
  __syncthreads();

  // -- a thread 4 channels of ROWS consecutive rows of one column
  const int cg = threadIdx.x % CL_CG;
  const int px = threadIdx.x / CL_CG;
  const int ox = ox0 + px % CL_TW;
  const int oy = oy0 + (px / CL_TW) * ROWS;
  const int c = c0 + cg * 4;
  if (ox >= g.out_w || oy >= g.out_h || c >= g.c) return;
  float4 acc[ROWS];
  const auto read = [&](int row, int col) {
    return tile[(row * IN_TW + col) * CL_CG + cg];
  };
  fir_rows<UP, DOWN, ROWS>(acc, read, f, g.kh, g.kw, oy * DOWN - g.py0,
                           ox * DOWN - g.px0, sy.lo, sx.lo);
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (oy + r >= g.out_h) continue;
    T* out = y + ((n * g.out_h + oy + r) * g.out_w + ox) * g.c + c;
    if (g.c % 4 == 0) {
      store4(out, acc[r]);
    } else {
      const float a[4] = {acc[r].x, acc[r].y, acc[r].z, acc[r].w};
      for (int e = 0; e < 4 && c + e < g.c; ++e) store(out + e, a[e]);
    }
  }
}

template <typename T, int UP, int DOWN>
int launch(const void* x, void* y, const Taps& f, const Geometry& g,
           bool channels_last, cudaStream_t stream) {
  int64_t blocks;
  if (channels_last) {
    constexpr int TH = CL_RG * (DOWN == 1 ? 4 : 2);
    blocks = (int64_t)g.n * ((g.out_h + TH - 1) / TH)
             * ((g.out_w + CL_TW - 1) / CL_TW) * ((g.c + CL_CT - 1) / CL_CT);
  } else {
    blocks = (int64_t)g.n * g.c * ((g.out_h + NC_TH<DOWN> - 1) / NC_TH<DOWN>)
             * ((g.out_w + NC_TW - 1) / NC_TW);
  }
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  constexpr int LV = 16 / sizeof(T);
  if (!channels_last) {
    upfirdn2d_rows_kernel<T, UP, DOWN>
        <<<(unsigned)blocks, THREADS, 0, stream>>>(xt, yt, f, g);
  } else if ((uintptr_t)x % 16 == 0 && g.c % LV == 0 && g.sn % LV == 0
             && g.sh % LV == 0 && g.sw % LV == 0) {
    upfirdn2d_cl_kernel<T, UP, DOWN, true>
        <<<(unsigned)blocks, THREADS, 0, stream>>>(xt, yt, f, g);
  } else {
    upfirdn2d_cl_kernel<T, UP, DOWN, false>
        <<<(unsigned)blocks, THREADS, 0, stream>>>(xt, yt, f, g);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_factors(const void* x, void* y, const Taps& f, const Geometry& g,
                   bool channels_last, int up, int down, cudaStream_t s) {
  const bool cl = channels_last;
  if (up == 1 && down == 1) return launch<T, 1, 1>(x, y, f, g, cl, s);
  if (up == 2 && down == 1) return launch<T, 2, 1>(x, y, f, g, cl, s);
  if (up == 1 && down == 2) return launch<T, 1, 2>(x, y, f, g, cl, s);
  return launch<T, 2, 2>(x, y, f, g, cl, s);
}

}  // namespace

// x: N x C x H x W at strides (sn, sc, sh, sw) in elements, with W adjacent
// in memory (sw = 1) or, channels_last, C adjacent (sc = 1); y: contiguous
// N x C x out_h x out_w, or N x out_h x out_w x C in memory when
// channels_last; dtype 0 fp32, 1 bf16; taps: kh x kw floats on the host,
// row-major, the flipped and gain-scaled f; up, down ∈ {1, 2}; kh, kw ≤ 4.
extern "C" int hfa_upfirdn2d(const void* x, void* y, const void* taps,
                             int dtype, int channels_last, int n, int c,
                             int in_h, int in_w, int64_t sn, int64_t sc,
                             int64_t sh, int64_t sw, int out_h, int out_w,
                             int up, int down, int kh, int kw, int py0,
                             int px0, void* stream) {
  if ((up != 1 && up != 2) || (down != 1 && down != 2) || kh < 1 ||
      kh > MAX_TAPS || kw < 1 || kw > MAX_TAPS || (dtype != 0 && dtype != 1)
      || (channels_last ? sc : sw) != 1)
    return (int)cudaErrorInvalidValue;
  if (n <= 0 || c <= 0 || out_h <= 0 || out_w <= 0)
    return (int)cudaGetLastError();
  Taps f = {};
  for (int ty = 0; ty < kh; ++ty)
    for (int tx = 0; tx < kw; ++tx)
      f.k[ty * MAX_TAPS + tx] = static_cast<const float*>(taps)[ty * kw + tx];
  const size_t elem = dtype == 0 ? sizeof(float) : sizeof(__nv_bfloat16);
  Geometry g;
  g.sn = sn;
  g.sc = sc;
  g.sh = sh;
  g.sw = sw;
  g.n = n;
  g.c = c;
  g.in_h = in_h;
  g.in_w = in_w;
  g.out_h = out_h;
  g.out_w = out_w;
  g.kh = kh;
  g.kw = kw;
  g.py0 = py0;
  g.px0 = px0;
  g.align = (int)(((uintptr_t)x / elem) % (16 / elem));
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 0
      ? launch_factors<float>(x, y, f, g, channels_last != 0, up, down, s)
      : launch_factors<__nv_bfloat16>(x, y, f, g, channels_last != 0, up,
                                      down, s);
}
