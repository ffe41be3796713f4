// Arithmetic shared by the ray marcher's forward (raymarch.cu) and
// backward (raymarch_bwd.cu) kernels: the density of a midpoint and the
// warp scan of the transmittance. Both kernels call these, so the backward
// recomputes the forward's T and w bit for bit, in the same order.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace hfa {

__device__ __forceinline__ float softplus(float x) {
  // log(1 + e^x), stable for any x (jax.nn.softplus's form)
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

// Midpoint k of a ray (densities s0 = σ_k, s1 = σ_k+1, depths d0, d1):
// x = σ̄ − 1, α = 1 − e with e = exp(−softplus(x)·δ), mid = (d0 + d1)/2.
struct Midpoint {
  float x, delta, e, alpha, mid;
};

__device__ __forceinline__ Midpoint midpoint(float s0, float s1, float d0,
                                             float d1) {
  Midpoint m;
  m.x = (s0 + s1) * 0.5f - 1.0f;
  m.delta = d1 - d0;
  m.e = expf(-(softplus(m.x) * m.delta));
  m.alpha = 1.0f - m.e;
  m.mid = (d0 + d1) * 0.5f;
  return m;
}

// The transmittance of a chunk of 32 midpoints, a lane each: returns
// T_k = carry · Π_{j<k in the chunk} q_j, q_j = 1 − α_j + 1e-10 (the
// caller passes q = 1 for a lane without a midpoint), by an inclusive
// product scan of five __shfl_up_sync steps; carry then moves past the
// chunk. Every lane of the warp must call it.
__device__ __forceinline__ float transmittance_scan(float q, float& carry) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  float incl = q;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(full, incl, off);
    if (lane >= off) incl *= o;
  }
  float excl = __shfl_up_sync(full, incl, 1);
  if (lane == 0) excl = 1.0f;
  const float t = carry * excl;
  carry *= __shfl_sync(full, incl, 31);
  return t;
}

}  // namespace hfa
