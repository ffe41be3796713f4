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
// x C floats (12 x 128 B at C = 32): 2.4 GB a pass at batch 2 and 9.7 GB at
// batch 8, served by L1 and L2 (the planes themselves are 25 MB a batch
// element), against 0.2 and 0.8 GB of output. The compulsory bytes (each
// plane byte once) are a thirtieth of that, so the byte bound is out of a
// gather's reach; what the design can do is make the gather with as few
// instructions and warps as possible and let neighbouring points share
// lines (the kernel is triplane_sampler.cuh):
//
//  * Several points a warp, 16 bytes a lane. At C = 32 eight lanes cover a
//    texel with one float4 each, so a warp holds four consecutive points:
//    neighbouring depth samples of one ray, which often share texel rows,
//    so the coalescer and L1 merge them. A quarter of the warps, load
//    instructions and per-warp arithmetic of one warp a point. Any C with
//    C % 4 == 0 takes this path at the power of two of lanes that covers
//    it; any other C runs one float a lane (the general, slower path).
//  * The footprint once: with H = W a point's three plane footprints are
//    three axis footprints (x, y, z), not six; the batch element is the
//    grid's second dimension, so no index is divided.
//  * All twelve corner reads are in flight before the first is used,
//    through the read-only path (ld.global.nc), predicated and not
//    branched. An out-of-plane corner contributes exactly 0, also beside a
//    texel that is not finite: its read does not happen.
//  * The sums keep grid_sample's order (nw, ne, sw, se; planes 0, 1, 2;
//    then / 3).
// The TPU kernel's slabs, quad packing and one-hot matmuls existed only
// because a TPU gather costs an instruction a row; none is needed here.
//
// The coordinate arithmetic (texels, weights, zeros padding) lives in
// triplane_common.cuh, shared with the backward kernel.
//
// hfa_triplane_mean_decode: the same lookup with the renderer's OSG decoder
// fused (the kernel's decoder overload, triplane_sampler.cuh): at C = 32,
// planes and points in, rgb (B, M, 32) and sigma (B, M, 1) out. It replaces
// no TPU kernel (the JAX package leaves the decoder to XLA after the
// sampler); it exists because on the card the decoder's GEMMs and
// elementwise passes moved ~18 GB a pass at batch 8 through device memory
// for ~1.1 GB of inputs and outputs.

#include "triplane_sampler.cuh"

extern "C" int hfa_triplane_mean(const void* planes, const void* coords,
                                 void* out, int B, int M, int H, int W, int C,
                                 float scale, void* stream) {
  return hfa::launch_triplane_sampler<true, true, true, true, true, true>(
      (const float*)planes, (const float*)coords, (float*)out, B, M, H, W, C,
      scale, (cudaStream_t)stream);
}

extern "C" int hfa_triplane_mean_decode(const void* planes, const void* coords,
                                        const void* w0, const void* b0,
                                        const void* w1, const void* b1,
                                        void* rgb, void* sigma, int B, int M,
                                        int H, int W, int C, float scale,
                                        float w0_gain, float w1_gain,
                                        float b_gain, void* stream) {
  const hfa::OsgDecoder dec{(const float*)w0, (const float*)b0,
                            (const float*)w1, (const float*)b1,
                            w0_gain,          w1_gain,
                            b_gain,           (float*)rgb,
                            (float*)sigma};
  return hfa::launch_triplane_sampler_decoder(
      (const float*)planes, (const float*)coords, dec, B, M, H, W, C, scale,
      (cudaStream_t)stream);
}
