// Ray marcher: EG3D's MipRayMarcher2 compositing, forward (white_back =
// False; the backward is raymarch_bwd.cu). Replaces the TPU kernel
// hfa_gp_tpu/core/pallas/raymarch.py::_march_kernel (via pallas_ray_march).
//
//   colors    (B·R, N, C) fp32     densities, depths (B·R, N) fp32
//   rgb       (B·R, C)   = 2·Σ_k w_k·(c_k + c_k+1)/2 − 1
//   depth_raw (B·R)      = Σ_k w_k·mid_k / max(Σ_k w_k, 1e-10)
//   weights   (B·R, N−1) w_k = α_k·T_k, α_k = 1 − exp(−softplus(σ̄_k − 1)·δ_k),
//                        T_k = Π_{j<k} (1 − α_j + 1e-10)
//
// The clip of depth to the whole batch's depth range stays in the wrapper,
// as in the JAX package (raymarch.py:136).
//
// Bound on the H100: memory. One pass reads the colors once (B·R·N·C·4
// bytes, 1.6 GB for the unified pass at batch 8) and writes little. Design:
// one warp per ray and one lane per channel (a second grid axis takes
// channels beyond 32), so each sample's colour row is one coalesced
// 128-byte read; the transmittance is a running product in a register,
// walked sequentially over the N−1 midpoints as the TPU kernel's fori_loop
// does. No (B, R, N−1, ·) intermediate is ever written except the weights
// the importance sampler needs.

#include <cuda_runtime.h>
#include <stdint.h>

#include "raymarch_common.cuh"

namespace {

__global__ void ray_march_kernel(const float* __restrict__ colors,
                                 const float* __restrict__ densities,
                                 const float* __restrict__ depths,
                                 float* __restrict__ rgb,
                                 float* __restrict__ depth_raw,
                                 float* __restrict__ weights, int rays, int N,
                                 int C) {
  const int64_t ray = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (ray >= rays) return;
  const int c = blockIdx.y * 32 + lane;
  const bool has_c = c < C;
  const bool leader = blockIdx.y == 0 && lane == 0;
  const float* col = colors + ray * N * C;
  const float* sig = densities + ray * N;
  const float* dep = depths + ray * N;

  float trans = 1.0f, acc = 0.0f, dacc = 0.0f, wsum = 0.0f;
  float d0 = dep[0], s0 = sig[0], c0 = has_c ? col[c] : 0.0f;
  for (int k = 0; k < N - 1; ++k) {
    const float d1 = dep[k + 1], s1 = sig[k + 1];
    const float c1 = has_c ? col[(int64_t)(k + 1) * C + c] : 0.0f;
    const float sigma = hfa::softplus((s0 + s1) * 0.5f - 1.0f);
    const float alpha = 1.0f - expf(-(sigma * (d1 - d0)));
    const float w = alpha * trans;
    if (leader) weights[ray * (N - 1) + k] = w;
    acc += w * ((c0 + c1) * 0.5f);
    dacc += w * ((d0 + d1) * 0.5f);
    wsum += w;
    trans *= 1.0f - alpha + 1e-10f;
    d0 = d1;
    s0 = s1;
    c0 = c1;
  }
  if (has_c) rgb[ray * C + c] = acc * 2.0f - 1.0f;
  if (leader) depth_raw[ray] = dacc / fmaxf(wsum, 1e-10f);
}

}  // namespace

extern "C" int hfa_ray_march(const void* colors, const void* densities,
                             const void* depths, void* rgb, void* depth_raw,
                             void* weights, int rays, int N, int C,
                             void* stream) {
  const int threads = 256;                       // 8 rays per block
  const int64_t blocks = ((int64_t)rays * 32 + threads - 1) / threads;
  if (blocks > 0 && N > 0) {
    dim3 grid((unsigned)blocks, (unsigned)((C + 31) / 32));
    ray_march_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
        (const float*)colors, (const float*)densities, (const float*)depths,
        (float*)rgb, (float*)depth_raw, (float*)weights, rays, N, C);
  }
  return (int)cudaGetLastError();
}
