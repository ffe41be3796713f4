// Ablation probe of the tri-plane sampler: the forward kernel of
// triplane.cu (the template of triplane_sampler.cuh, which both sources
// instantiate) with stages removed by compile-time switches, to show which
// stage owns its time on the H100 (the card's machine has no kernel
// profiler; the sampler is bound by its gather, and the probe says how much
// of its time the gather is). Replaces the TPU probes
// tools/probe_sampler.py::kernel and tools/probe_sampler2.py::make_kernel,
// which switch stages of the TPU sampler off the same way (do_txy, do_wbuild,
// do_dma / do_matmul, do_epi, do_out).
//
// Shapes and semantics are triplane.cu's. The stages and what removing each
// leaves in its place:
//   COORDS   the read of the point's coordinates   -> fixed coordinates
//   WEIGHTS  the axis footprints (floor, weights, the zeros-padding tests)
//                                                  -> weights 1/4, texel from
//                                                     a clamped truncation
//   GATHER   the 12 corner reads                   -> a plane's first texel
//   EPILOGUE the plane mean's division by 3        -> the bare sum
//   STORE    the output store                      -> point 0 only
// With every stage on, the kernel is the very instantiation triplane.cu
// launches, and the result equals it bit for bit. A removed stage changes
// the result; only the time of such a variant means anything. Results of
// removed stores are kept alive by a store under a condition no finite
// feature meets.

#include "triplane_sampler.cuh"

namespace {

// the stage mask's bits, lowest first: COORDS, WEIGHTS, GATHER, EPILOGUE,
// STORE; one instantiation for each of the 32 masks
template <int BIT, bool... S>
int dispatch(int stages, const float* planes, const float* coords, float* out,
             int B, int M, int H, int W, int C, float scale,
             cudaStream_t stream) {
  if constexpr (BIT == 5) {
    return hfa::launch_triplane_sampler<false, S...>(planes, coords, out, B, M,
                                                     H, W, C, scale, stream);
  } else {
    if (stages & (1 << BIT))
      return dispatch<BIT + 1, S..., true>(stages, planes, coords, out, B, M,
                                           H, W, C, scale, stream);
    return dispatch<BIT + 1, S..., false>(stages, planes, coords, out, B, M, H,
                                          W, C, scale, stream);
  }
}

}  // namespace

// stages: bit 0 COORDS, 1 WEIGHTS, 2 GATHER, 3 EPILOGUE, 4 STORE (1 = the
// stage runs; 31 = the full sampler). C must be a multiple of 4.
extern "C" int hfa_triplane_probe(const void* planes, const void* coords,
                                  void* out, int B, int M, int H, int W, int C,
                                  float scale, int stages, void* stream) {
  if (stages < 0 || stages > 31) return (int)cudaErrorInvalidValue;
  return dispatch<0>(stages, (const float*)planes, (const float*)coords,
                     (float*)out, B, M, H, W, C, scale, (cudaStream_t)stream);
}
