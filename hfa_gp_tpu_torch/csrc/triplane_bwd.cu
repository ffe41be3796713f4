// Tri-plane sampler backward: d planes of the plane-averaged bilinear
// lookup of triplane.cu. Replaces the TPU kernels
// hfa_gp_tpu/core/pallas/triplane.py::_sampler_bwd_kernel_vmem (via
// _sample_blocked_bwd_vmem) and ::_sampler_bwd_kernel_hbm (via
// _sample_blocked_bwd_hbm). Those two compute the same function; they
// differ only in where the TPU keeps the accumulator (VMEM or HBM), which
// is no question here, so one kernel replaces both.
//
//   g      (B, M, C)       fp32 cotangent of the plane-averaged features
//   coords (B, M, 3)       fp32 world points (they get no gradient)
//   grad   (B, 3, H, W, C) fp32, zeroed by the caller; every point adds
//                          g / 3 x bilinear weight to its in-bounds corner
//                          rows on each of the three planes
//
// Texels, weights and the zeros-padding rule are the forward's
// (triplane_common.cuh).
//
// Bound on the H100: bytes in principle (read g and coords once, write the
// gradient once), contention in practice. Design: the direct form, not the
// TPU's block plan: one warp per point, one lane per channel, so each of
// the 12 corner updates is one coalesced 128-byte row of fire-and-forget
// atomic adds (red.global.add.f32), resolved in L2. Neighbouring depth
// samples of a ray land on the same texels, so those rows contend. The sum
// order changes from run to run, and with it the last bits of the result.

#include <cuda_runtime.h>
#include <stdint.h>

#include "triplane_common.cuh"

namespace {

__device__ __forceinline__ void scatter(float* __restrict__ plane, float u,
                                        float v, int H, int W, int C, int c,
                                        float g) {
  const hfa::Footprint f = hfa::footprint(u, v, H, W);
  const int xi = f.xi, yi = f.yi;
  if (f.y0 && f.x0)
    atomicAdd(plane + ((size_t)yi * W + xi) * C + c, g * (f.ww * f.wn));
  if (f.y0 && f.x1)
    atomicAdd(plane + ((size_t)yi * W + xi + 1) * C + c, g * (f.we * f.wn));
  if (f.y1 && f.x0)
    atomicAdd(plane + ((size_t)(yi + 1) * W + xi) * C + c,
              g * (f.ww * f.ws));
  if (f.y1 && f.x1)
    atomicAdd(plane + ((size_t)(yi + 1) * W + xi + 1) * C + c,
              g * (f.we * f.ws));
}

__global__ void triplane_mean_bwd_kernel(const float* __restrict__ g,
                                         const float* __restrict__ coords,
                                         float* __restrict__ grad, int B,
                                         int M, int H, int W, int C,
                                         float scale) {
  const int64_t point = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (point >= (int64_t)B * M) return;
  const int b = (int)(point / M);
  const float x = scale * coords[point * 3 + 0];
  const float y = scale * coords[point * 3 + 1];
  const float z = scale * coords[point * 3 + 2];
  const size_t plane_size = (size_t)H * W * C;
  float* p0 = grad + (size_t)(b * 3 + 0) * plane_size;
  float* p1 = p0 + plane_size;
  float* p2 = p1 + plane_size;
  for (int c = lane; c < C; c += 32) {
    const float gc = g[point * C + c] / 3.0f;
    scatter(p0, x, y, H, W, C, c, gc);
    scatter(p1, x, z, H, W, C, c, gc);
    scatter(p2, z, x, H, W, C, c, gc);
  }
}

}  // namespace

extern "C" int hfa_triplane_mean_bwd(const void* g, const void* coords,
                                     void* grad, int B, int M, int H, int W,
                                     int C, float scale, void* stream) {
  const int threads = 256;                       // 8 points per block
  const int64_t warps = (int64_t)B * M;
  const int64_t blocks = (warps * 32 + threads - 1) / threads;
  if (blocks > 0) {
    triplane_mean_bwd_kernel<<<(unsigned)blocks, threads, 0,
                               (cudaStream_t)stream>>>(
        (const float*)g, (const float*)coords, (float*)grad, B, M, H, W, C,
        scale);
  }
  return (int)cudaGetLastError();
}
