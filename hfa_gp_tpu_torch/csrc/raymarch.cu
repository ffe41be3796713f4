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
// bytes, 403 MB for the unified pass at batch 2) and writes little. A
// sequential walk over the midpoints (the TPU kernel's fori_loop) makes
// every step wait on the last one's loads, so the design takes the walk
// apart (one warp a ray, the fast path for C % 4 == 0, C ≤ 128 and
// N ≤ 1024):
//
//  * Densities and depths are read coalesced, a midpoint a lane; the lanes
//    compute σ̄, δ, α and mid of their midpoints in parallel.
//  * The transmittance T_k is an exclusive product scan over the warp
//    (five __shfl_up_sync steps a chunk of 32 midpoints, a carry across
//    chunks; raymarch_common.cuh, which the backward calls too), so
//    w_k = α_k·T_k is written coalesced by all lanes, and Σw,
//    Σw·mid come from warp sums. The product is taken in another order
//    than the sequential walk: a few ulp of T apart.
//  * rgb = 2·Σ_j a_j·c_j − 1 with a_j = (w_{j−1} + w_j)/2 (w_{−1} =
//    w_{N−1} = 0): the same sum regrouped by sample, so each colour row is
//    read once. The a_j go to a per-warp shared array; then lanes read
//    colour rows 16 bytes a lane (eight lanes a row of 32 channels, four
//    rows a warp instruction), eight loads in flight a lane, and the
//    partial sums of the rows fold together with __shfl_xor_sync.
// Any other shape takes the general path, the sequential walk: one warp a
// ray, a lane a channel (a second grid axis takes channels beyond 32).

#include <cuda_runtime.h>
#include <stdint.h>

#include "raymarch_common.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int MARCH_THREADS = 256;           // 8 rays a block
constexpr int MARCH_WARPS = MARCH_THREADS / 32;
constexpr int MAX_SAMPLES = 1024;            // the fast path's per-warp array
constexpr int ROW_LOADS = 8;                 // colour loads in flight a lane

// the fast path; lanes a colour row: 2^lp_shift, 16 bytes each
__global__ void __launch_bounds__(MARCH_THREADS)
ray_march_warp_kernel(const float* __restrict__ colors,
                      const float* __restrict__ densities,
                      const float* __restrict__ depths,
                      float* __restrict__ rgb, float* __restrict__ depth_raw,
                      float* __restrict__ weights, int rays, int N, int C,
                      int lp_shift) {
  extern __shared__ float march_smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t ray = (int64_t)blockIdx.x * MARCH_WARPS + warp;
  if (ray >= rays) return;               // whole warps leave together
  float* a = march_smem + warp * N;      // a_j, sample j's colour weight
  const float* sig = densities + ray * N;
  const float* dep = depths + ray * N;
  float* w_out = weights + ray * (N - 1);

  // -- transmittance and weights, 32 midpoints a step
  float carry = 1.0f;        // T before this chunk
  float w_last = 0.0f;       // w of the previous chunk's last midpoint
  float wsum = 0.0f, dsum = 0.0f;
  for (int k0 = 0; k0 < N; k0 += 32) {
    const int k = k0 + lane;
    const bool mid_k = k < N - 1;        // midpoint k exists
    float alpha = 0.0f, mid = 0.0f;
    if (mid_k) {
      const hfa::Midpoint m = hfa::midpoint(sig[k], sig[k + 1], dep[k],
                                            dep[k + 1]);
      alpha = m.alpha;
      mid = m.mid;
    }
    const float w = alpha * hfa::transmittance_scan(
        mid_k ? 1.0f - alpha + 1e-10f : 1.0f, carry);
    if (mid_k) w_out[k] = w;
    wsum += w;
    dsum += w * mid;
    float w_prev = __shfl_up_sync(FULL, w, 1);
    if (lane == 0) w_prev = w_last;
    if (k < N) a[k] = (w_prev + w) * 0.5f;
    w_last = __shfl_sync(FULL, w, 31);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    wsum += __shfl_xor_sync(FULL, wsum, off);
    dsum += __shfl_xor_sync(FULL, dsum, off);
  }
  if (lane == 0) depth_raw[ray] = dsum / fmaxf(wsum, 1e-10f);
  __syncwarp();

  // -- colours: each row read once, 16 bytes a lane
  const int rows = 32 >> lp_shift;       // rows a warp instruction
  const int slot = lane >> lp_shift;
  const int c = (lane & ((1 << lp_shift) - 1)) * 4;
  const float* col = colors + ray * N * C;
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (c < C) {
    for (int j0 = slot; j0 < N; j0 += ROW_LOADS * rows) {
      float4 x[ROW_LOADS];
      float aw[ROW_LOADS];
#pragma unroll
      for (int u = 0; u < ROW_LOADS; ++u) {
        const int j = j0 + u * rows;
        const bool ok = j < N;
        x[u] = ok ? __ldg(reinterpret_cast<const float4*>(
                        col + (int64_t)j * C + c))
                  : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        aw[u] = ok ? a[j] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < ROW_LOADS; ++u) {
        acc.x += aw[u] * x[u].x;
        acc.y += aw[u] * x[u].y;
        acc.z += aw[u] * x[u].z;
        acc.w += aw[u] * x[u].w;
      }
    }
  }
  for (int off = 1 << lp_shift; off < 32; off <<= 1) {
    acc.x += __shfl_xor_sync(FULL, acc.x, off);
    acc.y += __shfl_xor_sync(FULL, acc.y, off);
    acc.z += __shfl_xor_sync(FULL, acc.z, off);
    acc.w += __shfl_xor_sync(FULL, acc.w, off);
  }
  if (slot == 0 && c < C)
    *reinterpret_cast<float4*>(rgb + ray * C + c) =
        make_float4(acc.x * 2.0f - 1.0f, acc.y * 2.0f - 1.0f,
                    acc.z * 2.0f - 1.0f, acc.w * 2.0f - 1.0f);
}

// the general path: the sequential walk, a lane a channel
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
    const float alpha = hfa::midpoint(s0, s1, d0, d1).alpha;
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
  if (rays <= 0 || N <= 0) return (int)cudaGetLastError();
  if (C % 4 == 0 && C <= 128 && N <= MAX_SAMPLES) {
    int lp_shift = 0;                  // lanes a row: the power of two that
    while ((4 << lp_shift) < C) ++lp_shift;        // covers C
    const int64_t blocks = ((int64_t)rays + MARCH_WARPS - 1) / MARCH_WARPS;
    ray_march_warp_kernel<<<(unsigned)blocks, MARCH_THREADS,
                            (size_t)MARCH_WARPS * N * sizeof(float),
                            (cudaStream_t)stream>>>(
        (const float*)colors, (const float*)densities, (const float*)depths,
        (float*)rgb, (float*)depth_raw, (float*)weights, rays, N, C,
        lp_shift);
  } else {
    const int threads = 256;                     // 8 rays per block
    const int64_t blocks = ((int64_t)rays * 32 + threads - 1) / threads;
    dim3 grid((unsigned)blocks, (unsigned)((C + 31) / 32));
    ray_march_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
        (const float*)colors, (const float*)densities, (const float*)depths,
        (float*)rgb, (float*)depth_raw, (float*)weights, rays, N, C);
  }
  return (int)cudaGetLastError();
}
