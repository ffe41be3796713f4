// Ray marcher backward: d colors and d densities of raymarch.cu's
// compositing. The TPU kernel it belongs to,
// hfa_gp_tpu/core/pallas/raymarch.py::_march_kernel (via pallas_ray_march),
// has no backward: the JAX package trains through the automatic
// differentiation of renderer.ray_march. Depths get no gradient.
//
//   colors (B·R, N, C), densities, depths (B·R, N)        fp32, as forward
//   g_rgb (B·R, C), g_depth (B·R), g_weights (B·R, N−1)   cotangents of rgb,
//       depth_raw (before the wrapper's clip) and weights; a null pointer
//       stands for zeros
//   d_colors (B·R, N, C), d_densities (B·R, N)
//
// With w_k = α_k·T_k, T_k = Π_{j<k} q_j, q_j = 1 − α_j + 1e-10 and
// G_k = dL/dw_k = Σ_c g_rgb_c·(c_k + c_k+1)_c
//                 + g_depth·(mid_k/Wc − [W ≥ 1e-10]·D/Wc²) + g_weights_k
// (W = Σ w, D = Σ w·mid, Wc = max(W, 1e-10)):
//   dL/dα_k = T_k·(G_k − R_k),  R_k = Σ_{j>k} G_j·α_j·Π_{k<i<j} q_i,
// where R runs backwards as R_{k−1} = G_k·α_k + q_k·R_k: no division by a
// transmittance that may have reached zero. Then α = 1 − exp(−s·δ),
// s = softplus(σ̄ − 1): dα/dσ̄ = δ·exp(−s·δ)·sigmoid(σ̄ − 1), half of it to
// each of the midpoint's two densities, and
// d colors_k = g_rgb·(w_{k−1} + w_k).
//
// Bound on the H100: memory. One pass reads the colours once and writes
// d colors once (2·B·R·N·C·4 bytes). Design: one warp per ray. Lanes take
// midpoints for α (independent), channels for the colour dot products
// (one coalesced 128-byte row per sample, a shuffle reduction each) and
// for the d colors rows; the two walks that are sequential in k (T forward,
// R backward) run on per-warp arrays in shared memory (7·N floats a warp).

#include <cuda_runtime.h>
#include <stdint.h>

#include "raymarch_common.cuh"

namespace {

constexpr int kArrays = 7;             // per-warp shared arrays of N floats
constexpr int kMaxShared = 48 * 1024;  // static limit, no opt-in needed

__global__ void ray_march_bwd_kernel(
    const float* __restrict__ colors, const float* __restrict__ densities,
    const float* __restrict__ depths, const float* __restrict__ g_rgb,
    const float* __restrict__ g_depth, const float* __restrict__ g_weights,
    float* __restrict__ d_colors, float* __restrict__ d_densities, int rays,
    int N, int C) {
  extern __shared__ float shared[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t ray = (int64_t)blockIdx.x * (blockDim.x >> 5) + warp;
  if (ray >= rays) return;               // whole warps leave together
  float* alpha = shared + (size_t)warp * kArrays * N;
  float* dalpha = alpha + N;             // dα/dσ̄ (pre-softplus midpoint)
  float* mid = dalpha + N;               // midpoint depth
  float* trans = mid + N;                // T_k
  float* wgt = trans + N;                // w_k
  float* dmid = wgt + N;                 // dL/dσ̄_k
  float* dot = dmid + N;                 // Σ_c g_rgb_c·c_k,c, per sample
  const float* col = colors + ray * N * C;
  const float* sig = densities + ray * N;
  const float* dep = depths + ray * N;
  const float* grgb = g_rgb ? g_rgb + ray * C : nullptr;

  // per midpoint, lanes in parallel
  for (int k = lane; k < N - 1; k += 32) {
    const float x = (sig[k] + sig[k + 1]) * 0.5f - 1.0f;
    const float delta = dep[k + 1] - dep[k];
    const float e = expf(-(hfa::softplus(x) * delta));
    alpha[k] = 1.0f - e;
    dalpha[k] = delta * e * (1.0f / (1.0f + expf(-x)));
    mid[k] = (dep[k] + dep[k + 1]) * 0.5f;
  }
  // per sample, lanes over channels: the colours' only read
  for (int k = 0; k < N; ++k) {
    float part = 0.0f;
    if (grgb) {
      for (int c = lane; c < C; c += 32)
        part += grgb[c] * col[(int64_t)k * C + c];
      for (int off = 16; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
    }
    if (lane == 0) dot[k] = part;
  }
  __syncwarp();

  // forward walk (every lane the same arithmetic, as in raymarch.cu)
  float t = 1.0f, wsum = 0.0f, dacc = 0.0f;
  for (int k = 0; k < N - 1; ++k) {
    const float a = alpha[k];
    const float w = a * t;
    if (lane == 0) {
      trans[k] = t;
      wgt[k] = w;
    }
    dacc += w * mid[k];
    wsum += w;
    t *= 1.0f - a + 1e-10f;
  }
  const float gd = g_depth ? g_depth[ray] : 0.0f;
  const float wc = fmaxf(wsum, 1e-10f);
  const float gd_mid = gd / wc;
  const float gd_all = wsum >= 1e-10f ? gd * dacc / (wc * wc) : 0.0f;
  const float* gw = g_weights ? g_weights + ray * (N - 1) : nullptr;
  __syncwarp();

  // reverse walk
  float r = 0.0f;
  for (int k = N - 2; k >= 0; --k) {
    const float a = alpha[k];
    const float gk = dot[k] + dot[k + 1] + (gd_mid * mid[k] - gd_all)
                     + (gw ? gw[k] : 0.0f);
    if (lane == 0) dmid[k] = trans[k] * (gk - r) * dalpha[k];
    r = gk * a + (1.0f - a + 1e-10f) * r;
  }
  __syncwarp();

  for (int k = lane; k < N; k += 32) {
    const float lo = k > 0 ? dmid[k - 1] : 0.0f;
    const float hi = k < N - 1 ? dmid[k] : 0.0f;
    d_densities[ray * N + k] = 0.5f * (lo + hi);
  }
  float* dcol = d_colors + ray * N * C;
  for (int k = 0; k < N; ++k) {
    const float w2 = (k > 0 ? wgt[k - 1] : 0.0f)
                     + (k < N - 1 ? wgt[k] : 0.0f);
    for (int c = lane; c < C; c += 32)
      dcol[(int64_t)k * C + c] = grgb ? grgb[c] * w2 : 0.0f;
  }
}

}  // namespace

extern "C" int hfa_ray_march_bwd(const void* colors, const void* densities,
                                 const void* depths, const void* g_rgb,
                                 const void* g_depth, const void* g_weights,
                                 void* d_colors, void* d_densities, int rays,
                                 int N, int C, void* stream) {
  if (rays <= 0 || N <= 0) return (int)cudaGetLastError();
  const size_t per_warp = (size_t)kArrays * N * sizeof(float);
  int warps = (int)(kMaxShared / per_warp);
  if (warps < 1) return (int)cudaErrorInvalidValue;   // N above 1755
  if (warps > 8) warps = 8;
  const int64_t blocks = ((int64_t)rays + warps - 1) / warps;
  ray_march_bwd_kernel<<<(unsigned)blocks, warps * 32, warps * per_warp,
                         (cudaStream_t)stream>>>(
      (const float*)colors, (const float*)densities, (const float*)depths,
      (const float*)g_rgb, (const float*)g_depth, (const float*)g_weights,
      (float*)d_colors, (float*)d_densities, rays, N, C);
  return (int)cudaGetLastError();
}
