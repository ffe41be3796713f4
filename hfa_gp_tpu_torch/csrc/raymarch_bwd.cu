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
// d colors once (2·B·R·N·C·4 bytes, 805 MB of the 860 MB a launch moves
// at (2, 16384, 96, 32)). Everything else is a few floats a sample. The
// fast path (C % 4 == 0, C ≤ 128, N ≤ 1024, 16-byte aligned rows: the
// forward's limits) is one warp a ray in three passes (at C 32 no lane
// idle):
//
//  1. Midpoints a lane each, 32 a chunk: densities and depths read
//     coalesced, α and q in parallel, T_k by the forward's exclusive warp
//     product scan (raymarch_common.cuh: the same T and w as the forward,
//     bit for bit), Σw and Σw·mid by warp sums. Per-warp shared memory
//     keeps w_{j−1} + w_j a sample and T_k a midpoint.
//  2. The colour rows, each read once, 16 bytes a lane (8 lanes a row of
//     32 channels, 4 rows a warp instruction, 8 loads in flight a lane);
//     each lane keeps its 4 channels of g_rgb in registers. In the same
//     loop the row's dot product g_rgb·c_j folds over the row's lanes with
//     __shfl_xor_sync (3 steps at C 32) into shared memory, and
//     d colors_j = g_rgb·(w_{j−1} + w_j) is stored as float4.
//  3. The reverse recurrence as a suffix scan. R_{k−1} = f_k(R_k) with the
//     affine map f_k(x) = q_k·x + G_k·α_k, so R_k = f_{k+1} ∘ … ∘ f_{N−2}(0):
//     pairs (q, b) compose as (q, b) ∘ (q', b') = (q·q', q·b' + b), five
//     __shfl_down_sync steps a chunk, chunks from the last, carrying R
//     across them. α, dα/dσ̄ and mid are recomputed from the densities and
//     depths (L1 and L2 hold them), T read back from shared memory. Every
//     lane writes d densities_{k+1} = (dσ̄_k + dσ̄_{k+1})/2, coalesced,
//     taking dσ̄_{k+1} from its neighbour by a shuffle.
// Shared memory: 3·N floats a warp (8 warps a block up to N 512, 4 beyond).
//
// Order of the sums: T and w are the forward's, a few ulp from `cumprod`
// (raymarch.cu). The suffix scan composes R in a tree where the walk went
// one midpoint at a time: the same products and sums in another order, and
// nothing divided. Against autograd of the plain march (`cumprod`, sums in
// sample order) both gradients are within 4.3e-7 of their scale at
// (2, 16384, 96, 32) on an H100 (chip_smoke.py [3]), 5.6e-6 on the other
// routes.
//
// Any other shape takes the general path, the first design: one warp a
// ray, lanes over channels for the dot products and d colors, the two
// walks sequential on 7·N floats a warp. Those live in shared memory while
// they fit in 48 KB (N ≤ 1755); beyond, in a global scratch buffer that
// the caller gives (scratch_warps · 7·N floats), with each warp taking
// rays in a grid stride.

#include <cuda_runtime.h>
#include <stdint.h>

#include "raymarch_common.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_SAMPLES = 1024;      // the fast path's largest N
constexpr int FAST_ARRAYS = 3;         // w2, dot, trans: N floats each
constexpr int ROW_LOADS = 8;           // colour loads in flight a lane
constexpr int GENERAL_ARRAYS = 7;      // the general path's N-float arrays
constexpr int kMaxShared = 48 * 1024;  // static limit, no opt-in needed

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// the fast path; lanes a colour row: 2^lp_shift, 16 bytes each
__global__ void __launch_bounds__(256)
ray_march_bwd_warp_kernel(const float* __restrict__ colors,
                          const float* __restrict__ densities,
                          const float* __restrict__ depths,
                          const float* __restrict__ g_rgb,
                          const float* __restrict__ g_depth,
                          const float* __restrict__ g_weights,
                          float* __restrict__ d_colors,
                          float* __restrict__ d_densities, int rays, int N,
                          int C, int lp_shift) {
  extern __shared__ float bwd_smem[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t ray = (int64_t)blockIdx.x * warps + warp;
  if (ray >= rays) return;               // whole warps leave together
  float* w2 = bwd_smem + (size_t)warp * FAST_ARRAYS * N;  // w_{j−1} + w_j
  float* dot = w2 + N;                   // g_rgb · c_j
  float* trans = dot + N;                // T_k
  const float* sig = densities + ray * N;
  const float* dep = depths + ray * N;

  // -- 1. transmittance and weights, 32 midpoints a step
  float carry = 1.0f, w_last = 0.0f, wsum = 0.0f, dsum = 0.0f;
  for (int k0 = 0; k0 < N; k0 += 32) {
    const int k = k0 + lane;
    const bool mid_k = k < N - 1;
    float alpha = 0.0f, mid = 0.0f;
    if (mid_k) {
      const hfa::Midpoint m = hfa::midpoint(sig[k], sig[k + 1], dep[k],
                                            dep[k + 1]);
      alpha = m.alpha;
      mid = m.mid;
    }
    const float t = hfa::transmittance_scan(
        mid_k ? 1.0f - alpha + 1e-10f : 1.0f, carry);
    const float w = alpha * t;
    wsum += w;
    dsum += w * mid;
    float w_prev = __shfl_up_sync(FULL, w, 1);
    if (lane == 0) w_prev = w_last;
    if (k < N) w2[k] = w_prev + w;
    if (mid_k) trans[k] = t;
    w_last = __shfl_sync(FULL, w, 31);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    wsum += __shfl_xor_sync(FULL, wsum, off);
    dsum += __shfl_xor_sync(FULL, dsum, off);
  }
  const float gd = g_depth ? g_depth[ray] : 0.0f;
  const float wc = fmaxf(wsum, 1e-10f);
  const float gd_mid = gd / wc;
  const float gd_all = wsum >= 1e-10f ? gd * dsum / (wc * wc) : 0.0f;
  __syncwarp();

  // -- 2. colour rows: read once, d colors written once, 16 bytes a lane
  const int lp = 1 << lp_shift;          // lanes a row
  const int rows = 32 >> lp_shift;       // rows a warp instruction
  const int slot = lane >> lp_shift;
  const int c = (lane & (lp - 1)) * 4;
  const bool has_c = c < C;
  const bool read = has_c && g_rgb != nullptr;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const float4 g4 = read ? __ldg(reinterpret_cast<const float4*>(
                               g_rgb + ray * C + c))
                         : zero;
  const float* col = colors + ray * N * C;
  float* dcol = d_colors + ray * N * C;
  for (int j0 = 0; j0 < N; j0 += ROW_LOADS * rows) {   // uniform in the warp
    float4 x[ROW_LOADS];
#pragma unroll
    for (int u = 0; u < ROW_LOADS; ++u) {
      const int j = j0 + u * rows + slot;
      x[u] = read && j < N ? __ldg(reinterpret_cast<const float4*>(
                                 col + (int64_t)j * C + c))
                           : zero;
    }
#pragma unroll
    for (int u = 0; u < ROW_LOADS; ++u) {
      const int j = j0 + u * rows + slot;
      float part = g4.x * x[u].x + g4.y * x[u].y + g4.z * x[u].z
                   + g4.w * x[u].w;
      for (int off = 1; off < lp; off <<= 1)
        part += __shfl_xor_sync(FULL, part, off);
      if (j < N) {
        if (has_c) {
          const float a = w2[j];
          *reinterpret_cast<float4*>(dcol + (int64_t)j * C + c) =
              make_float4(g4.x * a, g4.y * a, g4.z * a, g4.w * a);
        }
        if (c == 0) dot[j] = part;
      }
    }
  }
  __syncwarp();

  // -- 3. R by a suffix scan of affine maps, chunks from the last
  const float* gw = g_weights ? g_weights + ray * (N - 1) : nullptr;
  float* dd = d_densities + ray * N;
  if (N == 1) {
    if (lane == 0) dd[0] = 0.0f;
    return;
  }
  float r_carry = 0.0f;                  // R at the chunk's last midpoint
  float dsig_next = 0.0f;                // dσ̄ of the next chunk's first
  for (int k0 = ((N - 2) >> 5) << 5; k0 >= 0; k0 -= 32) {
    const int k = k0 + lane;
    const bool mid_k = k < N - 1;
    float q = 1.0f, b = 0.0f, gk = 0.0f, dalpha = 0.0f;
    if (mid_k) {
      const hfa::Midpoint m = hfa::midpoint(sig[k], sig[k + 1], dep[k],
                                            dep[k + 1]);
      dalpha = m.delta * m.e * sigmoid(m.x);
      gk = dot[k] + dot[k + 1] + (gd_mid * m.mid - gd_all)
           + (gw ? gw[k] : 0.0f);
      q = 1.0f - m.alpha + 1e-10f;
      b = gk * m.alpha;
    }
    // inclusive: lane l holds f_l ∘ … ∘ f_31 of the chunk
    float qs = q, bs = b;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float qo = __shfl_down_sync(FULL, qs, off);
      const float bo = __shfl_down_sync(FULL, bs, off);
      if (lane + off < 32) {
        bs = qs * bo + bs;
        qs *= qo;
      }
    }
    // exclusive: f_{l+1} ∘ … ∘ f_31, applied to R after the chunk
    float qx = __shfl_down_sync(FULL, qs, 1);
    float bx = __shfl_down_sync(FULL, bs, 1);
    if (lane == 31) {
      qx = 1.0f;
      bx = 0.0f;
    }
    const float r = qx * r_carry + bx;   // R_k
    const float dsig = mid_k ? trans[k] * (gk - r) * dalpha : 0.0f;
    r_carry = __shfl_sync(FULL, qs, 0) * r_carry + __shfl_sync(FULL, bs, 0);
    float next = __shfl_down_sync(FULL, dsig, 1);
    if (lane == 31) next = dsig_next;
    if (k + 1 < N) dd[k + 1] = 0.5f * (dsig + next);
    if (k == 0) dd[0] = 0.5f * dsig;
    dsig_next = __shfl_sync(FULL, dsig, 0);
  }
}

// the general path: the sequential walks, a lane a channel; per-warp
// arrays in shared memory, or in `scratch` (a slice of 7·N floats for each
// warp of the grid, which then strides over the rays)
__global__ void ray_march_bwd_kernel(
    const float* __restrict__ colors, const float* __restrict__ densities,
    const float* __restrict__ depths, const float* __restrict__ g_rgb,
    const float* __restrict__ g_depth, const float* __restrict__ g_weights,
    float* __restrict__ d_colors, float* __restrict__ d_densities,
    float* __restrict__ scratch, int rays, int N, int C) {
  extern __shared__ float shared[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t first = (int64_t)blockIdx.x * warps + warp;
  float* alpha = scratch ? scratch + first * GENERAL_ARRAYS * N
                         : shared + (size_t)warp * GENERAL_ARRAYS * N;
  float* dalpha = alpha + N;             // dα/dσ̄ (pre-softplus midpoint)
  float* mid = dalpha + N;               // midpoint depth
  float* trans = mid + N;                // T_k
  float* wgt = trans + N;                // w_k
  float* dmid = wgt + N;                 // dL/dσ̄_k
  float* dot = dmid + N;                 // Σ_c g_rgb_c·c_k,c, per sample
  for (int64_t ray = first; ray < rays;  // whole warps stride together
       ray += (int64_t)gridDim.x * warps) {
    const float* col = colors + ray * N * C;
    const float* sig = densities + ray * N;
    const float* dep = depths + ray * N;
    const float* grgb = g_rgb ? g_rgb + ray * C : nullptr;

    // per midpoint, lanes in parallel
    for (int k = lane; k < N - 1; k += 32) {
      const hfa::Midpoint m = hfa::midpoint(sig[k], sig[k + 1], dep[k],
                                            dep[k + 1]);
      alpha[k] = m.alpha;
      dalpha[k] = m.delta * m.e * sigmoid(m.x);
      mid[k] = m.mid;
    }
    // per sample, lanes over channels: the colours' only read
    for (int k = 0; k < N; ++k) {
      float part = 0.0f;
      if (grgb) {
        for (int c = lane; c < C; c += 32)
          part += grgb[c] * col[(int64_t)k * C + c];
        for (int off = 16; off > 0; off >>= 1)
          part += __shfl_xor_sync(FULL, part, off);
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
    __syncwarp();                        // the arrays serve the next ray
  }
}

}  // namespace

// scratch: null, or scratch_warps · 7·N floats for the general path where
// its arrays do not fit in shared memory (7·N·4 bytes > 48 KB); the
// wrapper allocates it (raymarch.py). Returns a cudaError_t.
extern "C" int hfa_ray_march_bwd(const void* colors, const void* densities,
                                 const void* depths, const void* g_rgb,
                                 const void* g_depth, const void* g_weights,
                                 void* d_colors, void* d_densities,
                                 void* scratch, int scratch_warps, int rays,
                                 int N, int C, void* stream) {
  if (rays <= 0 || N <= 0) return (int)cudaGetLastError();
  const cudaStream_t st = (cudaStream_t)stream;
  const bool aligned = (((uintptr_t)colors | (uintptr_t)g_rgb
                         | (uintptr_t)d_colors) & 15) == 0;
  if (C % 4 == 0 && C <= 128 && N <= MAX_SAMPLES && aligned) {
    int lp_shift = 0;                    // lanes a row: the power of two
    while ((4 << lp_shift) < C) ++lp_shift;          // that covers C
    const size_t per_warp = (size_t)FAST_ARRAYS * N * sizeof(float);
    const int warps = per_warp * 8 <= (size_t)kMaxShared ? 8 : 4;
    const int64_t blocks = ((int64_t)rays + warps - 1) / warps;
    ray_march_bwd_warp_kernel<<<(unsigned)blocks, warps * 32,
                                warps * per_warp, st>>>(
        (const float*)colors, (const float*)densities, (const float*)depths,
        (const float*)g_rgb, (const float*)g_depth, (const float*)g_weights,
        (float*)d_colors, (float*)d_densities, rays, N, C, lp_shift);
    return (int)cudaGetLastError();
  }
  const size_t per_warp = (size_t)GENERAL_ARRAYS * N * sizeof(float);
  int warps = 8;
  int64_t blocks;
  size_t smem = 0;
  if (per_warp <= (size_t)kMaxShared) {
    warps = (int)(kMaxShared / per_warp);
    if (warps > 8) warps = 8;
    blocks = ((int64_t)rays + warps - 1) / warps;
    smem = warps * per_warp;
    scratch = nullptr;
  } else {
    if (scratch == nullptr || scratch_warps < warps)
      return (int)cudaErrorInvalidValue;
    blocks = scratch_warps / warps;
    const int64_t need = ((int64_t)rays + warps - 1) / warps;
    if (blocks > need) blocks = need;
  }
  ray_march_bwd_kernel<<<(unsigned)blocks, warps * 32, smem, st>>>(
      (const float*)colors, (const float*)densities, (const float*)depths,
      (const float*)g_rgb, (const float*)g_depth, (const float*)g_weights,
      (float*)d_colors, (float*)d_densities, (float*)scratch, rays, N, C);
  return (int)cudaGetLastError();
}
