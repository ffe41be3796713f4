// Tri-plane sampler: bilinear lookup on the three EG3D feature planes,
// averaged over the planes. Replaces the TPU kernel
// hfa_gp_tpu/core/pallas/triplane.py::_sampler_kernel (reached through
// _sample_blocked_impl) together with the plane mean the JAX renderer runs
// right after it.
//
//   planes (B, 3, H, W, C) fp32, channel-last, contiguous
//   coords (B, M, 3)       fp32 world points
//   out    (B, M, C)       fp32 = mean over p of grid_sample(plane p, uv_p)
//
// Semantics are F.grid_sample's: bilinear, padding_mode="zeros",
// align_corners=False, with uv = (2 / box_warp) * (projection of the point
// onto plane p): plane 0 spans (x, y), plane 1 (x, z), plane 2 (z, x)
// (renderer._PLANE_INV).
//
// Bound on the H100: gather bytes. Every point reads 3 planes x 4 corners
// x C floats (12 x 128 B at C = 32), about 9.7 GB per pass at batch 8 before
// L2 reuse, against ~0.8 GB of output. Design: one warp per point and one
// lane per channel, so each corner read is one coalesced 128-byte row;
// the projection and the bilinear weights are computed once per warp (by
// every lane, from broadcast loads), and neighbouring points of a ray land
// on neighbouring texels, which L2 (50 MB) serves. The TPU kernel's slabs,
// quad packing and one-hot matmuls existed only because TPU gathers are
// issue-bound; none of them is needed here.
//
// The source coordinate is computed with non-contracting intrinsics
// (no FMA), in the order grid_sample uses: ((u + 1) * W - 1) / 2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float unnormalize(float u, int size) {
  // ((u + 1) * size - 1) / 2 without FMA contraction
  return __fmul_rn(__fsub_rn(__fmul_rn(__fadd_rn(u, 1.0f), (float)size),
                             1.0f), 0.5f);
}

__device__ __forceinline__ float bilinear(const float* __restrict__ plane,
                                          float u, float v, int H, int W,
                                          int C, int c) {
  const float ix = unnormalize(u, W);
  const float iy = unnormalize(v, H);
  const float fx = floorf(ix);
  const float fy = floorf(iy);
  const float we = ix - fx, ww = (fx + 1.0f) - ix;   // east / west column
  const float ws = iy - fy, wn = (fy + 1.0f) - iy;   // south / north row
  // validity on the float coordinates: NaN or huge values never reach
  // the integer conversion
  const bool x0 = fx >= 0.0f && fx < (float)W;
  const bool x1 = fx + 1.0f >= 0.0f && fx + 1.0f < (float)W;
  const bool y0 = fy >= 0.0f && fy < (float)H;
  const bool y1 = fy + 1.0f >= 0.0f && fy + 1.0f < (float)H;
  const int xi = x0 || x1 ? (int)fx : 0;
  const int yi = y0 || y1 ? (int)fy : 0;
  // grid_sample's order: nw, ne, sw, se
  float acc = 0.0f;
  if (y0 && x0) acc += plane[((size_t)yi * W + xi) * C + c] * (ww * wn);
  if (y0 && x1) acc += plane[((size_t)yi * W + xi + 1) * C + c] * (we * wn);
  if (y1 && x0) acc += plane[((size_t)(yi + 1) * W + xi) * C + c] * (ww * ws);
  if (y1 && x1) acc += plane[((size_t)(yi + 1) * W + xi + 1) * C + c]
                       * (we * ws);
  return acc;
}

__global__ void triplane_mean_kernel(const float* __restrict__ planes,
                                     const float* __restrict__ coords,
                                     float* __restrict__ out, int B, int M,
                                     int H, int W, int C, float scale) {
  const int64_t point = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (point >= (int64_t)B * M) return;
  const int b = (int)(point / M);
  const float x = scale * coords[point * 3 + 0];
  const float y = scale * coords[point * 3 + 1];
  const float z = scale * coords[point * 3 + 2];
  const size_t plane_size = (size_t)H * W * C;
  const float* p0 = planes + (size_t)(b * 3 + 0) * plane_size;
  const float* p1 = p0 + plane_size;
  const float* p2 = p1 + plane_size;
  for (int c = lane; c < C; c += 32) {
    const float s = bilinear(p0, x, y, H, W, C, c)
                    + bilinear(p1, x, z, H, W, C, c)
                    + bilinear(p2, z, x, H, W, C, c);
    out[point * C + c] = s / 3.0f;
  }
}

}  // namespace

extern "C" int hfa_triplane_mean(const void* planes, const void* coords,
                                 void* out, int B, int M, int H, int W, int C,
                                 float scale, void* stream) {
  const int threads = 256;                       // 8 points per block
  const int64_t warps = (int64_t)B * M;
  const int64_t blocks = (warps * 32 + threads - 1) / threads;
  if (blocks > 0) {
    triplane_mean_kernel<<<(unsigned)blocks, threads, 0,
                           (cudaStream_t)stream>>>(
        (const float*)planes, (const float*)coords, (float*)out, B, M, H, W,
        C, scale);
  }
  return (int)cudaGetLastError();
}
