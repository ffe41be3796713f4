// Density arithmetic shared by the ray marcher's forward (raymarch.cu) and
// backward (raymarch_bwd.cu) kernels.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace hfa {

__device__ __forceinline__ float softplus(float x) {
  // log(1 + e^x), stable for any x (jax.nn.softplus's form)
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

}  // namespace hfa
