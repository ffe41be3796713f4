// The tri-plane sampler's forward kernel as one template with five stage
// switches: triplane.cu instantiates it with every stage on, and
// triplane_probe.cu with each of the 32 masks, so the probe measures the
// kernel that runs and its full variant equals the sampler bit for bit by
// construction. The header comment of triplane.cu describes the function
// and the design; triplane_probe.cu what a removed stage leaves behind.
// The gather (`point_axes`, `plane_mean`) is shared with an overload of the
// kernel that runs the OSG decoder on each point's features before anything
// is stored (the decoder epilogue, at the end of this file).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "triplane_common.cuh"

namespace hfa {

constexpr int SAMPLER_THREADS = 256;

// VW channels of one texel: 16 bytes a lane where C % 4 == 0, else one float.
template <int VW>
struct Chan {
  float v[VW];
};

// A texel's channels through the read-only path, predicated rather than
// branched: with `pred` false nothing is read and the result is exactly 0,
// whatever lies at (or beside) the address.
template <int VW>
__device__ __forceinline__ Chan<VW> load_texel(const float* p, bool pred);

template <>
__device__ __forceinline__ Chan<4> load_texel<4>(const float* p, bool pred) {
  Chan<4> t;
#ifdef HFA_HOST_REHEARSAL
  for (int k = 0; k < 4; ++k) t.v[k] = pred ? p[k] : 0.0f;
#else
  asm("{\n\t"
      ".reg .pred q;\n\t"
      "setp.ne.b32 q, %5, 0;\n\t"
      "mov.f32 %0, 0f00000000;\n\t"
      "mov.f32 %1, 0f00000000;\n\t"
      "mov.f32 %2, 0f00000000;\n\t"
      "mov.f32 %3, 0f00000000;\n\t"
      "@q ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%4];\n\t"
      "}"
      : "=f"(t.v[0]), "=f"(t.v[1]), "=f"(t.v[2]), "=f"(t.v[3])
      : "l"(p), "r"((int)pred));
#endif
  return t;
}

template <>
__device__ __forceinline__ Chan<1> load_texel<1>(const float* p, bool pred) {
  Chan<1> t;
#ifdef HFA_HOST_REHEARSAL
  t.v[0] = pred ? p[0] : 0.0f;
#else
  asm("{\n\t"
      ".reg .pred q;\n\t"
      "setp.ne.b32 q, %2, 0;\n\t"
      "mov.f32 %0, 0f00000000;\n\t"
      "@q ld.global.nc.f32 %0, [%1];\n\t"
      "}"
      : "=f"(t.v[0])
      : "l"(p), "r"((int)pred));
#endif
  return t;
}

// The stand-in for a footprint axis when the WEIGHTS stage is removed:
// both texels valid at weight 1/2, the index from a clamped truncation.
__device__ __forceinline__ Axis axis_cheap(float u, int size) {
  Axis a;
  a.i = min(max((int)((u + 1.0f) * (0.5f * size)), 0), size - 2);
  a.lo = a.hi = 0.5f;
  a.v0 = a.v1 = true;
  return a;
}

// The four corner texels of one plane under the column axis `ax` and the
// row axis `ay`, in grid_sample's order nw, ne, sw, se. With GATHER off
// every corner reads the plane's first texel instead.
template <int VW, bool GATHER>
__device__ __forceinline__ void load_corners(const float* __restrict__ plane,
                                             const Axis& ax, const Axis& ay,
                                             int W, int C, int c,
                                             Chan<VW> (&t)[4]) {
  if constexpr (GATHER) {
    // offsets inside a plane fit 32 bits (the launcher checks)
    const float* p = plane + ((ay.i * W + ax.i) * C + c);
    const int row = W * C;
    t[0] = load_texel<VW>(p, ay.v0 && ax.v0);
    t[1] = load_texel<VW>(p + C, ay.v0 && ax.v1);
    t[2] = load_texel<VW>(p + row, ay.v1 && ax.v0);
    t[3] = load_texel<VW>(p + row + C, ay.v1 && ax.v1);
  } else {
    const Chan<VW> first = load_texel<VW>(plane + c, true);
    const Chan<VW> zero = {};
    t[0] = ay.v0 && ax.v0 ? first : zero;
    t[1] = ay.v0 && ax.v1 ? first : zero;
    t[2] = ay.v1 && ax.v0 ? first : zero;
    t[3] = ay.v1 && ax.v1 ? first : zero;
  }
}

// One channel's bilinear sum, in grid_sample's order and with its weights
// ww*wn, we*wn, ww*ws, we*ws.
__device__ __forceinline__ float bilinear_sum(float nw, float ne, float sw,
                                              float se, const Axis& ax,
                                              const Axis& ay) {
  float acc = 0.0f;
  acc += nw * (ax.lo * ay.lo);
  acc += ne * (ax.hi * ay.lo);
  acc += sw * (ax.lo * ay.hi);
  acc += se * (ax.hi * ay.hi);
  return acc;
}

// A point's three axis footprints: plane 0 spans (u, v) = (x, y), plane 1
// (x, z), plane 2 (z, x), so with H = W three axes (x, y, z) serve all three
// planes. With COORDS off the point is a fixed one, with WEIGHTS off the
// footprints are `axis_cheap`'s.
struct PointAxes {
  Axis xu, zu, xv, yv, zv;
};

template <bool COORDS, bool WEIGHTS>
__device__ __forceinline__ PointAxes point_axes(
    const float* __restrict__ coords, int64_t point, int H, int W,
    float scale) {
  float x, y, z;
  if constexpr (COORDS) {
    x = scale * __ldg(coords + point * 3 + 0);
    y = scale * __ldg(coords + point * 3 + 1);
    z = scale * __ldg(coords + point * 3 + 2);
  } else {
    x = scale * 0.0625f;
    y = scale * -0.125f;
    z = scale * 0.03125f;
  }
  PointAxes a;
  if constexpr (WEIGHTS) {
    a.xu = axis_footprint(x, W);
    a.zu = axis_footprint(z, W);
    a.yv = axis_footprint(y, H);
    if (H == W) {
      a.xv = a.xu;
      a.zv = a.zu;
    } else {
      a.xv = axis_footprint(x, H);
      a.zv = axis_footprint(z, H);
    }
  } else {
    a.xu = axis_cheap(x, W);
    a.zu = axis_cheap(z, W);
    a.yv = axis_cheap(y, H);
    a.xv = axis_cheap(x, H);
    a.zv = axis_cheap(z, H);
  }
  return a;
}

// The plane mean of channels [c, c + VW) at a point whose batch element's
// planes start at p0: all twelve corner reads are in flight before the
// first is used; the sums keep grid_sample's order, then / 3 (with
// EPILOGUE off, the bare sum).
template <int VW, bool GATHER, bool EPILOGUE>
__device__ __forceinline__ Chan<VW> plane_mean(const float* __restrict__ p0,
                                               int64_t plane_size,
                                               const PointAxes& a, int W,
                                               int C, int c) {
  Chan<VW> t0[4], t1[4], t2[4];
  load_corners<VW, GATHER>(p0, a.xu, a.yv, W, C, c, t0);
  load_corners<VW, GATHER>(p0 + plane_size, a.xu, a.zv, W, C, c, t1);
  load_corners<VW, GATHER>(p0 + 2 * plane_size, a.zu, a.xv, W, C, c, t2);
  Chan<VW> r;
#pragma unroll
  for (int k = 0; k < VW; ++k) {
    const float s =
        bilinear_sum(t0[0].v[k], t0[1].v[k], t0[2].v[k], t0[3].v[k], a.xu,
                     a.yv)
        + bilinear_sum(t1[0].v[k], t1[1].v[k], t1[2].v[k], t1[3].v[k], a.xu,
                       a.zv)
        + bilinear_sum(t2[0].v[k], t2[1].v[k], t2[2].v[k], t2[3].v[k], a.zu,
                       a.xv);
    if constexpr (EPILOGUE) {
      r.v[k] = s / 3.0f;
    } else {
      r.v[k] = s;
    }
  }
  return r;
}

// planes (B, 3, H, W, C), coords (B, M, 3), out (B, M, C). A point is
// served by 2^lp_shift consecutive lanes, each VW channels wide, striding
// over C; blockIdx.y is the batch element, so no point's index is divided.
template <int VW, bool COORDS, bool WEIGHTS, bool GATHER, bool EPILOGUE,
          bool STORE>
__global__ void __launch_bounds__(SAMPLER_THREADS)
triplane_sampler_kernel(const float* __restrict__ planes,
                        const float* __restrict__ coords,
                        float* __restrict__ out, int M, int H, int W, int C,
                        float scale, int lp_shift) {
  const int b = blockIdx.y;
  const int m = (int)((blockIdx.x * (unsigned)SAMPLER_THREADS + threadIdx.x)
                      >> lp_shift);
  if (m >= M) return;
  const int sub = threadIdx.x & ((1 << lp_shift) - 1);
  const int64_t point = (int64_t)b * M + m;
  const PointAxes a = point_axes<COORDS, WEIGHTS>(coords, point, H, W, scale);
  const int64_t plane_size = (int64_t)H * W * C;
  const float* p0 = planes + (int64_t)b * 3 * plane_size;
  for (int c = sub * VW; c < C; c += VW << lp_shift) {
    const Chan<VW> r =
        plane_mean<VW, GATHER, EPILOGUE>(p0, plane_size, a, W, C, c);
    bool store = true;
    if constexpr (!STORE) {
      // keep the result alive under a condition no finite feature meets
      store = point == 0 || r.v[0] == 3.0e38f;
    }
    if (store) {
      float* o = out + point * C + c;
      if constexpr (VW == 4) {
        *reinterpret_cast<float4*>(o) =
            make_float4(r.v[0], r.v[1], r.v[2], r.v[3]);
      } else {
        o[0] = r.v[0];
      }
    }
  }
}

// Launches the variant <COORDS, WEIGHTS, GATHER, EPILOGUE, STORE> at the
// channel width C allows: 16-byte lanes where C % 4 == 0 (C = 32: 8 lanes
// a point, 4 points a warp), one float a lane otherwise. With ANY_C false
// the one-float path is not compiled and such a C is refused (the probe:
// half the instantiations to build).
template <bool ANY_C, bool... S>
int launch_triplane_sampler(const float* planes, const float* coords,
                            float* out, int B, int M, int H, int W, int C,
                            float scale, cudaStream_t stream) {
  if (B <= 0 || M <= 0) return (int)cudaGetLastError();
  if (H < 2 || W < 2 || C < 1 || (int64_t)H * W * C > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const int vw = C % 4 == 0 ? 4 : 1;
  if (!ANY_C && vw == 1) return (int)cudaErrorInvalidValue;
  int lp_shift = 0;                    // lanes a point: the power of two that
  while (lp_shift < 5 && (vw << lp_shift) < C) ++lp_shift;   // covers C
  const int points = SAMPLER_THREADS >> lp_shift;            // a block
  const int64_t plane_size = (int64_t)H * W * C;
  for (int b0 = 0; b0 < B; b0 += 65535) {          // gridDim.y's limit
    const int nb = B - b0 < 65535 ? B - b0 : 65535;
    const dim3 grid((unsigned)((M + points - 1) / points), (unsigned)nb);
    const float* pl = planes + (int64_t)b0 * 3 * plane_size;
    const float* co = coords + (int64_t)b0 * M * 3;
    float* o = out + (int64_t)b0 * M * C;
    if (vw == 4)
      triplane_sampler_kernel<4, S...><<<grid, SAMPLER_THREADS, 0, stream>>>(
          pl, co, o, M, H, W, C, scale, lp_shift);
    else if constexpr (ANY_C)
      triplane_sampler_kernel<1, S...><<<grid, SAMPLER_THREADS, 0, stream>>>(
          pl, co, o, M, H, W, C, scale, lp_shift);
  }
  return (int)cudaGetLastError();
}

// -- the decoder epilogue: K1 with the OSG decoder fused --------------------
//
// The same gather, at C = 32 and eight lanes a point, followed by the OSG
// decoder in fp32 FFMA on the CUDA cores: fc0 (64 x 32), softplus, fc1
// (33 x 64), then sigma = out[0] and rgb = sigmoid(out[1:]) * 1.002 - 0.001.
// Only rgb (B·M, 32) and sigma (B·M) reach device memory; the features and
// the hidden layer stay on the SM. The arithmetic is the plain version's
// (triplane.decode_plain, which the renderer's decoder runs): each weight
// times its gain and each bias times lr_mul, rounded as the plain version
// rounds them; F.softplus (beta 1, threshold 20) and torch.sigmoid as
// PyTorch's CUDA kernels compute them (log1pf(expf(x)), 1 / (1 +
// expf(-x))); the products' sums in another order than cuBLAS's.
//
// Bound on the H100 (batch 8, 6.29 M points a pass): 8,320 FLOP a point,
// 52.3 GFLOP, 0.78 ms at the fp32 peak, against 1.1 GB of compulsory bytes
// (0.33 ms); softplus and sigmoid add ~2,600 instructions a point. What
// limits a kernel like this is instruction slots and shared-memory cycles, not
// bytes. A first design (eight lanes a point, features and hidden units
// exchanged by shuffles, one weight loaded for every FFMA) took 4.7 ms at
// batch 8: three instructions in four were not FFMA, and a 16-byte shared
// load that each quarter warp reads 128 distinct bytes of costs four
// cycles. This one is a block-level micro-tile (2.97 ms; PERF.md, K1):
//
//  * A block works in rounds of DECODER_TILE_POINTS points. The gather
//    (eight lanes a point, as K1) stages the round's features in shared
//    memory, channel-major; fc0 then runs as a tile product, each thread
//    DECODER_PT points x 8 hidden units, so per input channel three 16-byte
//    loads feed 32 FFMAs.
//  * Softplus is computed and then selected, not branched on, so its
//    constants stay in registers. The hidden layer goes back to shared
//    memory (over the features), and fc1 runs as DECODER_PT points x 4
//    colour logits a thread; sigma's 64-term sums are split over the eight
//    threads of a point group and joined by shuffles.
//  * The weights, gained, lie in shared memory once a block: fc0's
//    channel-major, fc1's transposed, so every read is a 16-byte row that
//    threads share; a quarter warp holds 2 point groups x 4 columns, so no
//    load costs more than two cycles. A point's 32 colours go out as eight
//    float4 stores from eight threads: one coalesced 128-byte row.
//  * A point past M is computed on the last point and not stored; every
//    thread runs every round, so the barriers are uniform.
//  * PT 4 at three blocks an SM beat PT 8 (64 accumulators) at two, 2.97
//    against 3.17 ms: the gather's latency wants the third block.
constexpr int OSG_IN = 32, OSG_HIDDEN = 64, OSG_OUT = 33;
constexpr int DECODER_PT = 4;                          // points a thread tile
constexpr int DECODER_TILE_POINTS = 32 * DECODER_PT;   // points a round
constexpr int DECODER_POINTS = 4 * DECODER_TILE_POINTS;  // points a block
constexpr int DECODER_LD = DECODER_TILE_POINTS + 4;    // a staged row, padded
constexpr unsigned FULL_WARP = 0xffffffffu;
// shared memory, in floats: fc0's weights [32][64], fc1's rgb weights
// [64][32], sigma's [64], the biases [64] and [1 + 3 + 32], then the
// staged tile: 32 feature rows, or 64 hidden rows, of DECODER_LD
constexpr int DECODER_SMEM_W0 = 0;
constexpr int DECODER_SMEM_W1 = DECODER_SMEM_W0 + OSG_IN * OSG_HIDDEN;
constexpr int DECODER_SMEM_WS = DECODER_SMEM_W1 + OSG_HIDDEN * (OSG_OUT - 1);
constexpr int DECODER_SMEM_B0 = DECODER_SMEM_WS + OSG_HIDDEN;
constexpr int DECODER_SMEM_B1 = DECODER_SMEM_B0 + OSG_HIDDEN;
constexpr int DECODER_SMEM_TILE = DECODER_SMEM_B1 + 36;
constexpr int DECODER_SMEM_FLOATS =
    DECODER_SMEM_TILE + OSG_HIDDEN * DECODER_LD;
constexpr size_t DECODER_SMEM_BYTES = DECODER_SMEM_FLOATS * sizeof(float);

struct OsgDecoder {
  const float* w0;     // fc0 weight (64, 32), row-major
  const float* b0;     // fc0 bias (64)
  const float* w1;     // fc1 weight (33, 64)
  const float* b1;     // fc1 bias (33)
  float w0_gain;       // lr_mul / sqrt(32)
  float w1_gain;       // lr_mul / sqrt(64)
  float b_gain;        // lr_mul
  float* rgb;          // (B·M, 32)
  float* sigma;        // (B·M)
};

// F.softplus(x), beta 1, threshold 20, without a branch
__device__ __forceinline__ float osg_softplus(float x) {
  const float y = log1pf(expf(x));
  return x > 20.0f ? x : y;
}

// torch.sigmoid(x) * (1 + 2 * 0.001) - 0.001, each op rounded
__device__ __forceinline__ float osg_color(float x) {
  const float s = 1.0f / (1.0f + expf(-x));
  return __fsub_rn(__fmul_rn(s, 1.002f), 0.001f);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// planes (B, 3, H, W, 32), coords (B, M, 3) → dec.rgb, dec.sigma. The
// batch element is blockIdx.y; block x serves points [x, x + 1) ·
// DECODER_POINTS of it. A template over the decoder's type only so that
// the sources including this header do not each define it.
template <typename Decoder>
__global__ void __launch_bounds__(SAMPLER_THREADS, 3)
triplane_sampler_kernel(const float* __restrict__ planes,
                        const float* __restrict__ coords, Decoder dec,
                        int M, int H, int W, float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* w0s = smem + DECODER_SMEM_W0;  // [k][u]: fc0 weight (u, k), gained
  float* w1s = smem + DECODER_SMEM_W1;  // [k][o]: fc1 weight (1 + o, k)
  float* wss = smem + DECODER_SMEM_WS;  // [k]: fc1 weight (0, k)
  float* b0s = smem + DECODER_SMEM_B0;
  float* b1s = smem + DECODER_SMEM_B1;
  float* tile = smem + DECODER_SMEM_TILE;  // [row][point], DECODER_LD apart
  const int t = threadIdx.x;
  for (int i = t; i < OSG_HIDDEN * OSG_IN; i += SAMPLER_THREADS)
    w0s[(i % OSG_IN) * OSG_HIDDEN + i / OSG_IN] =
        __fmul_rn(__ldg(dec.w0 + i), dec.w0_gain);
  for (int i = t; i < OSG_OUT * OSG_HIDDEN; i += SAMPLER_THREADS) {
    const int o = i / OSG_HIDDEN, k = i % OSG_HIDDEN;
    const float w = __fmul_rn(__ldg(dec.w1 + i), dec.w1_gain);
    if (o == 0)
      wss[k] = w;
    else
      w1s[k * (OSG_OUT - 1) + o - 1] = w;
  }
  if (t < OSG_HIDDEN) b0s[t] = __fmul_rn(__ldg(dec.b0 + t), dec.b_gain);
  if (t < OSG_OUT)   // sigma's at 0, the colours' from 4 (16-byte rows)
    b1s[t == 0 ? 0 : 3 + t] = __fmul_rn(__ldg(dec.b1 + t), dec.b_gain);

  const int b = blockIdx.y;
  const int64_t plane_size = (int64_t)H * W * OSG_IN;
  const float* p0 = planes + (int64_t)b * 3 * plane_size;
  const int sub = t & 7;    // gather: channels 4 sub .. 4 sub + 3
  // tiles: points grp · PT .. + PT of the round; fc0: hidden units 4 col + i
  // and 32 + 4 col + i; fc1: colour logits 4 col .. 4 col + 3. A quarter
  // warp holds 2 groups x 4 columns, so each of its 16-byte shared loads
  // reads at most 64 distinct bytes: two cycles, where a quarter of 8
  // columns' weights takes four
  const int q = (t >> 3) & 3, r = t & 7;
  const int grp = (t >> 5) * 4 + (q >> 1) * 2 + (r >> 2);
  const int col = (q & 1) * 4 + (r & 3);
  const int gather_slot = t >> 3;
  constexpr int PT = DECODER_PT;
  const int first = (int)blockIdx.x * DECODER_POINTS;
  const int end = min(M, first + DECODER_POINTS);
  for (int base = first; base < end; base += DECODER_TILE_POINTS) {
    __syncthreads();   // the weights are in; the last round's tile is read
    // gather: 32 points a pass, eight lanes each, channel-major into tile
#pragma unroll 1
    for (int j = 0; j < PT; ++j) {
      const int slot = j * 32 + gather_slot;
      const int m = min(base + slot, M - 1);
      const PointAxes a =
          point_axes<true, true>(coords, (int64_t)b * M + m, H, W, scale);
      const Chan<4> f =
          plane_mean<4, true, true>(p0, plane_size, a, W, OSG_IN, 4 * sub);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        tile[(4 * sub + i) * DECODER_LD + slot] = f.v[i];
    }
    __syncthreads();

    // fc0: points grp · PT + p, hidden units 4 col + i (h[p][i]) and
    // 32 + 4 col + i (h[p][4 + i])
    float h[PT][8];
#pragma unroll
    for (int p = 0; p < PT; ++p)
#pragma unroll
      for (int u = 0; u < 8; ++u) h[p][u] = 0.0f;
#pragma unroll 4
    for (int k = 0; k < OSG_IN; ++k) {
      float x[PT];
#pragma unroll
      for (int q = 0; q < PT / 4; ++q) {
        const float4 v = ld4(tile + k * DECODER_LD + grp * PT + 4 * q);
        x[4 * q] = v.x;
        x[4 * q + 1] = v.y;
        x[4 * q + 2] = v.z;
        x[4 * q + 3] = v.w;
      }
      const float4 lo = ld4(w0s + k * OSG_HIDDEN + 4 * col);
      const float4 hi = ld4(w0s + k * OSG_HIDDEN + 32 + 4 * col);
      const float w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
      for (int p = 0; p < PT; ++p)
#pragma unroll
        for (int u = 0; u < 8; ++u) h[p][u] = fmaf(x[p], w[u], h[p][u]);
    }
    {
      const float4 lo = ld4(b0s + 4 * col);
      const float4 hi = ld4(b0s + 32 + 4 * col);
      const float bias[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
      for (int p = 0; p < PT; ++p)
#pragma unroll
        for (int u = 0; u < 8; ++u)
          h[p][u] = osg_softplus(__fadd_rn(h[p][u], bias[u]));
    }
    __syncthreads();   // every thread has read its features
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      float* row = tile + ((u < 4 ? 0 : 32) + 4 * col + (u & 3)) * DECODER_LD
                   + grp * PT;
#pragma unroll
      for (int q = 0; q < PT / 4; ++q)
        *reinterpret_cast<float4*>(row + 4 * q) =
            make_float4(h[4 * q][u], h[4 * q + 1][u], h[4 * q + 2][u],
                        h[4 * q + 3][u]);
    }
    __syncthreads();

    // fc1: colour logits 4 col + j of points grp · PT + p
    float o[PT][4];
#pragma unroll
    for (int p = 0; p < PT; ++p)
#pragma unroll
      for (int j = 0; j < 4; ++j) o[p][j] = 0.0f;
#pragma unroll 4
    for (int k = 0; k < OSG_HIDDEN; ++k) {
      float x[PT];
#pragma unroll
      for (int q = 0; q < PT / 4; ++q) {
        const float4 v = ld4(tile + k * DECODER_LD + grp * PT + 4 * q);
        x[4 * q] = v.x;
        x[4 * q + 1] = v.y;
        x[4 * q + 2] = v.z;
        x[4 * q + 3] = v.w;
      }
      const float4 w = ld4(w1s + k * (OSG_OUT - 1) + 4 * col);
#pragma unroll
      for (int p = 0; p < PT; ++p) {
        o[p][0] = fmaf(x[p], w.x, o[p][0]);
        o[p][1] = fmaf(x[p], w.y, o[p][1]);
        o[p][2] = fmaf(x[p], w.z, o[p][2]);
        o[p][3] = fmaf(x[p], w.w, o[p][3]);
      }
    }
    // sigma: this thread's eighth of each point's sum (hidden units
    // col + 8 i), then the eight threads of the group (lanes apart by 1, 2
    // and 8) joined
    float sg[PT];
#pragma unroll
    for (int p = 0; p < PT; ++p) sg[p] = 0.0f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int k = col + 8 * i;
      const float w = wss[k];
#pragma unroll
      for (int q = 0; q < PT / 4; ++q) {
        const float4 v = ld4(tile + k * DECODER_LD + grp * PT + 4 * q);
        sg[4 * q] = fmaf(v.x, w, sg[4 * q]);
        sg[4 * q + 1] = fmaf(v.y, w, sg[4 * q + 1]);
        sg[4 * q + 2] = fmaf(v.z, w, sg[4 * q + 2]);
        sg[4 * q + 3] = fmaf(v.w, w, sg[4 * q + 3]);
      }
    }
#pragma unroll
    for (int bit = 1; bit <= 8; bit <<= 1) {
      if (bit == 4) continue;
#pragma unroll
      for (int p = 0; p < PT; ++p)
        sg[p] = __fadd_rn(sg[p], __shfl_xor_sync(FULL_WARP, sg[p], bit));
    }

    const float4 bias = ld4(b1s + 4 + 4 * col);
    const float s_bias = b1s[0];
#pragma unroll
    for (int p = 0; p < PT; ++p) {
      const int m = base + grp * PT + p;
      if (m < M) {
        const int64_t out = (int64_t)b * M + m;
        *reinterpret_cast<float4*>(dec.rgb + out * 32 + 4 * col) =
            make_float4(osg_color(__fadd_rn(o[p][0], bias.x)),
                        osg_color(__fadd_rn(o[p][1], bias.y)),
                        osg_color(__fadd_rn(o[p][2], bias.z)),
                        osg_color(__fadd_rn(o[p][3], bias.w)));
        if (col == p % 8) dec.sigma[out] = __fadd_rn(sg[p], s_bias);
      }
    }
  }
}

// Launches the decoder epilogue: C must be OSG_IN; the batch element is
// gridDim.y, so B is split at its limit as for the plain sampler.
inline int launch_triplane_sampler_decoder(const float* planes,
                                           const float* coords,
                                           const OsgDecoder& dec, int B,
                                           int M, int H, int W, int C,
                                           float scale, cudaStream_t stream) {
  if (B <= 0 || M <= 0) return (int)cudaGetLastError();
  if (H < 2 || W < 2 || C != OSG_IN || (int64_t)H * W * C > 2147483647LL
      || M > 2147483647 - DECODER_POINTS)
    return (int)cudaErrorInvalidValue;
  // above 48 KB shared memory is dynamic and asked for (on the current
  // device; a host call, also while a graph captures)
  const cudaError_t err = cudaFuncSetAttribute(
      triplane_sampler_kernel<OsgDecoder>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)DECODER_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const int64_t plane_size = (int64_t)H * W * C;
  for (int b0 = 0; b0 < B; b0 += 65535) {          // gridDim.y's limit
    const int nb = B - b0 < 65535 ? B - b0 : 65535;
    const dim3 grid((unsigned)((M + DECODER_POINTS - 1) / DECODER_POINTS),
                    (unsigned)nb);
    OsgDecoder d = dec;
    d.rgb += (int64_t)b0 * M * 32;
    d.sigma += (int64_t)b0 * M;
    triplane_sampler_kernel<OsgDecoder>
        <<<grid, SAMPLER_THREADS, DECODER_SMEM_BYTES, stream>>>(
            planes + (int64_t)b0 * 3 * plane_size,
            coords + (int64_t)b0 * M * 3, d, M, H, W, scale);
  }
  return (int)cudaGetLastError();
}

}  // namespace hfa
