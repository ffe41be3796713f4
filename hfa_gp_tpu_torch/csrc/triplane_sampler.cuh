// The tri-plane sampler's forward kernel as one template with five stage
// switches: triplane.cu instantiates it with every stage on, and
// triplane_probe.cu with each of the 32 masks, so the probe measures the
// kernel that runs and its full variant equals the sampler bit for bit by
// construction. The header comment of triplane.cu describes the function
// and the design; triplane_probe.cu what a removed stage leaves behind.

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
  // plane 0 spans (u, v) = (x, y), plane 1 (x, z), plane 2 (z, x): with
  // H = W three axis footprints serve all three planes
  Axis xu, zu, xv, yv, zv;
  if constexpr (WEIGHTS) {
    xu = axis_footprint(x, W);
    zu = axis_footprint(z, W);
    yv = axis_footprint(y, H);
    if (H == W) {
      xv = xu;
      zv = zu;
    } else {
      xv = axis_footprint(x, H);
      zv = axis_footprint(z, H);
    }
  } else {
    xu = axis_cheap(x, W);
    zu = axis_cheap(z, W);
    yv = axis_cheap(y, H);
    xv = axis_cheap(x, H);
    zv = axis_cheap(z, H);
  }
  const int64_t plane_size = (int64_t)H * W * C;
  const float* p0 = planes + (int64_t)b * 3 * plane_size;
  for (int c = sub * VW; c < C; c += VW << lp_shift) {
    // all twelve corner reads are in flight before the first is used
    Chan<VW> t0[4], t1[4], t2[4];
    load_corners<VW, GATHER>(p0, xu, yv, W, C, c, t0);
    load_corners<VW, GATHER>(p0 + plane_size, xu, zv, W, C, c, t1);
    load_corners<VW, GATHER>(p0 + 2 * plane_size, zu, xv, W, C, c, t2);
    Chan<VW> r;
#pragma unroll
    for (int k = 0; k < VW; ++k) {
      const float s =
          bilinear_sum(t0[0].v[k], t0[1].v[k], t0[2].v[k], t0[3].v[k], xu, yv)
          + bilinear_sum(t1[0].v[k], t1[1].v[k], t1[2].v[k], t1[3].v[k], xu,
                         zv)
          + bilinear_sum(t2[0].v[k], t2[1].v[k], t2[2].v[k], t2[3].v[k], zu,
                         xv);
      if constexpr (EPILOGUE) {
        r.v[k] = s / 3.0f;
      } else {
        r.v[k] = s;
      }
    }
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

}  // namespace hfa
