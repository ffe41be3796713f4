// Ablation probe of the tri-plane sampler: the forward kernel of
// triplane.cu with stages removed by compile-time switches, to show which
// stage owns its time on the H100. Replaces the TPU probes
// tools/probe_sampler.py::kernel and tools/probe_sampler2.py::make_kernel,
// which switch stages of the TPU sampler off the same way (do_txy, do_wbuild,
// do_dma / do_matmul, do_epi, do_out).
//
// Shapes and semantics are triplane.cu's. The stages and what removing each
// leaves in its place:
//   COORDS   the read of the point's coordinates   -> fixed coordinates
//   WEIGHTS  the bilinear footprint (floor, four weights, the zeros-padding
//            tests)                                -> weights 1/4, texel from
//                                                     a clamped truncation
//   GATHER   the 12 corner reads                   -> one fixed texel row
//   EPILOGUE the plane mean's division by 3        -> the bare sum
//   STORE    the output store                      -> point 0 only
// With every stage on, the arithmetic is triplane.cu's line for line, and the
// result equals it bit for bit. A removed stage changes the result; only the
// time of such a variant means anything. Results of removed stores are kept
// alive by a store under a condition no finite feature meets.

#include <cuda_runtime.h>
#include <stdint.h>

#include "triplane_common.cuh"

namespace {

template <bool WEIGHTS, bool GATHER>
__device__ __forceinline__ float bilinear(const float* __restrict__ plane,
                                          float u, float v, int H, int W,
                                          int C, int c) {
  if constexpr (WEIGHTS) {
    const hfa::Footprint f = hfa::footprint(u, v, H, W);
    const int xi = f.xi, yi = f.yi;
    float acc = 0.0f;
    if constexpr (GATHER) {
      if (f.y0 && f.x0)
        acc += plane[((size_t)yi * W + xi) * C + c] * (f.ww * f.wn);
      if (f.y0 && f.x1)
        acc += plane[((size_t)yi * W + xi + 1) * C + c] * (f.we * f.wn);
      if (f.y1 && f.x0)
        acc += plane[((size_t)(yi + 1) * W + xi) * C + c] * (f.ww * f.ws);
      if (f.y1 && f.x1)
        acc += plane[((size_t)(yi + 1) * W + xi + 1) * C + c] * (f.we * f.ws);
    } else {
      const float texel = plane[c];
      if (f.y0 && f.x0) acc += texel * (f.ww * f.wn);
      if (f.y0 && f.x1) acc += texel * (f.we * f.wn);
      if (f.y1 && f.x0) acc += texel * (f.ww * f.ws);
      if (f.y1 && f.x1) acc += texel * (f.we * f.ws);
    }
    return acc;
  } else {
    if constexpr (GATHER) {
      const int xi = min(max((int)((u + 1.0f) * (0.5f * W)), 0), W - 2);
      const int yi = min(max((int)((v + 1.0f) * (0.5f * H)), 0), H - 2);
      const float* p = plane + ((size_t)yi * W + xi) * C + c;
      return 0.25f * (p[0] + p[C] + p[(size_t)W * C] + p[(size_t)W * C + C]);
    } else {
      return plane[c] + 0.25f * (u + v);
    }
  }
}

template <bool COORDS, bool WEIGHTS, bool GATHER, bool EPILOGUE, bool STORE>
__global__ void triplane_probe_kernel(const float* __restrict__ planes,
                                      const float* __restrict__ coords,
                                      float* __restrict__ out, int B, int M,
                                      int H, int W, int C, float scale) {
  const int64_t point = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (point >= (int64_t)B * M) return;
  const int b = (int)(point / M);
  float x, y, z;
  if constexpr (COORDS) {
    x = scale * coords[point * 3 + 0];
    y = scale * coords[point * 3 + 1];
    z = scale * coords[point * 3 + 2];
  } else {
    x = scale * 0.0625f;
    y = scale * -0.125f;
    z = scale * 0.03125f;
  }
  const size_t plane_size = (size_t)H * W * C;
  const float* p0 = planes + (size_t)(b * 3 + 0) * plane_size;
  const float* p1 = p0 + plane_size;
  const float* p2 = p1 + plane_size;
  for (int c = lane; c < C; c += 32) {
    const float s = bilinear<WEIGHTS, GATHER>(p0, x, y, H, W, C, c)
                    + bilinear<WEIGHTS, GATHER>(p1, x, z, H, W, C, c)
                    + bilinear<WEIGHTS, GATHER>(p2, z, x, H, W, C, c);
    float r;
    if constexpr (EPILOGUE) {
      r = s / 3.0f;
    } else {
      r = s;
    }
    if constexpr (STORE) {
      out[point * C + c] = r;
    } else {
      if (point == 0 || r == 3.0e38f) out[point * C + c] = r;
    }
  }
}

template <bool... S>
int launch(const float* planes, const float* coords, float* out, int B, int M,
           int H, int W, int C, float scale, cudaStream_t stream) {
  const int threads = 256;                       // 8 points per block
  const int64_t warps = (int64_t)B * M;
  const int64_t blocks = (warps * 32 + threads - 1) / threads;
  if (blocks > 0) {
    triplane_probe_kernel<S...><<<(unsigned)blocks, threads, 0, stream>>>(
        planes, coords, out, B, M, H, W, C, scale);
  }
  return (int)cudaGetLastError();
}

// the stage mask's bits, lowest first: COORDS, WEIGHTS, GATHER, EPILOGUE,
// STORE; one instantiation for each of the 32 masks
template <int BIT, bool... S>
int dispatch(int stages, const float* planes, const float* coords, float* out,
             int B, int M, int H, int W, int C, float scale,
             cudaStream_t stream) {
  if constexpr (BIT == 5) {
    return launch<S...>(planes, coords, out, B, M, H, W, C, scale, stream);
  } else {
    if (stages & (1 << BIT))
      return dispatch<BIT + 1, S..., true>(stages, planes, coords, out, B, M,
                                           H, W, C, scale, stream);
    return dispatch<BIT + 1, S..., false>(stages, planes, coords, out, B, M, H,
                                          W, C, scale, stream);
  }
}

}  // namespace

// stages: bit 0 COORDS, 1 WEIGHTS, 2 GATHER, 3 EPILOGUE, 4 STORE (1 = the
// stage runs; 31 = the full sampler).
extern "C" int hfa_triplane_probe(const void* planes, const void* coords,
                                  void* out, int B, int M, int H, int W, int C,
                                  float scale, int stages, void* stream) {
  if (stages < 0 || stages > 31) return (int)cudaErrorInvalidValue;
  return dispatch<0>(stages, (const float*)planes, (const float*)coords,
                     (float*)out, B, M, H, W, C, scale, (cudaStream_t)stream);
}
