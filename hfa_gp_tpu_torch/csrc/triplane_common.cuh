// Coordinate arithmetic shared by the tri-plane sampler's forward
// (triplane_sampler.cuh) and backward (triplane_bwd.cu) kernels, so that
// both see exactly the same texels, weights and zeros-padding rule.
//
// Semantics are F.grid_sample's: bilinear, padding_mode="zeros",
// align_corners=False. The source coordinate is computed with
// non-contracting intrinsics (no FMA), in the order grid_sample uses:
// ((u + 1) * W - 1) / 2.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace hfa {

__device__ __forceinline__ float unnormalize(float u, int size) {
  // ((u + 1) * size - 1) / 2 without FMA contraction
  return __fmul_rn(__fsub_rn(__fmul_rn(__fadd_rn(u, 1.0f), (float)size),
                             1.0f), 0.5f);
}

// The four texels under one sample of one plane: the north-west texel
// (xi, yi), the column weights (west ww, east we) and row weights (north
// wn, south ws), and which columns (x0 west, x1 east) and rows (y0 north,
// y1 south) lie inside the plane. A corner outside contributes nothing.
// grid_sample's corner order is nw, ne, sw, se, with weights ww*wn, we*wn,
// ww*ws, we*ws.
struct Footprint {
  int xi, yi;
  float ww, we, wn, ws;
  bool x0, x1, y0, y1;
};

__device__ __forceinline__ Footprint footprint(float u, float v, int H,
                                               int W) {
  const float ix = unnormalize(u, W);
  const float iy = unnormalize(v, H);
  const float fx = floorf(ix);
  const float fy = floorf(iy);
  Footprint f;
  f.we = ix - fx;
  f.ww = (fx + 1.0f) - ix;
  f.ws = iy - fy;
  f.wn = (fy + 1.0f) - iy;
  // validity on the float coordinates: NaN or huge values never reach
  // the integer conversion
  f.x0 = fx >= 0.0f && fx < (float)W;
  f.x1 = fx + 1.0f >= 0.0f && fx + 1.0f < (float)W;
  f.y0 = fy >= 0.0f && fy < (float)H;
  f.y1 = fy + 1.0f >= 0.0f && fy + 1.0f < (float)H;
  f.xi = f.x0 || f.x1 ? (int)fx : 0;
  f.yi = f.y0 || f.y1 ? (int)fy : 0;
  return f;
}

// One axis of a footprint: the lower texel index i, the weights of the
// lower and the upper texel, and which of the two lie inside [0, size). The
// same arithmetic as `footprint`, one coordinate at a time: where H = W a
// point's three plane footprints are made of three of these (x, y, z).
struct Axis {
  int i;
  float lo, hi;
  bool v0, v1;
};

__device__ __forceinline__ Axis axis_footprint(float u, int size) {
  const float ix = unnormalize(u, size);
  const float fx = floorf(ix);
  Axis a;
  a.hi = ix - fx;
  a.lo = (fx + 1.0f) - ix;
  a.v0 = fx >= 0.0f && fx < (float)size;
  a.v1 = fx + 1.0f >= 0.0f && fx + 1.0f < (float)size;
  a.i = a.v0 || a.v1 ? (int)fx : 0;
  return a;
}

}  // namespace hfa
