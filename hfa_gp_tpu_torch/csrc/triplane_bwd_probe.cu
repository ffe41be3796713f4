// Ablation probe of the tri-plane sampler's backward kernel: the template
// of triplane_bwd.cuh (which triplane_bwd.cu instantiates with every stage
// on) with stages removed by compile-time switches, at a tile the caller
// chooses, to show on the H100 what each stage costs (the card's machine
// has no kernel profiler). The variants:
//   0  the whole kernel (the kernel of triplane_bwd.cu at the same tile)
//   1  global reductions replaced by plain stores: what the reductions'
//      contention costs
//   2  without the read of g (a constant in its place)
//   3  without the coordinate reads (one fixed point)
//   4  without the sorted path: every plane reduces straight into grad,
//      four points a warp and 16 bytes a lane and corner (the previous
//      design's traffic)
//   5  4 with plain stores in place of the reductions
//   6  without the sorted path's texel adds (its sums are kept alive)
// A variant with a stage removed computes something else; only its time
// means anything. C must be a multiple of 4, at most 32. Driven by
// hfa_gp_tpu_torch/tools/probe_sampler.py --backward.

#include "triplane_bwd.cuh"

namespace {

using namespace hfa;

using Launch = int (*)(const float*, const float*, float*, int, int, int, int,
                       int, float, int, int, int, int, int, int, cudaStream_t);

const Launch VARIANTS[] = {
    launch_triplane_bwd<false, BWD_ALL>,
    launch_triplane_bwd<false, BWD_ALL & ~BWD_GLOBAL_RED>,
    launch_triplane_bwd<false, BWD_ALL & ~BWD_GREAD>,
    launch_triplane_bwd<false, BWD_ALL & ~BWD_COORDS>,
    launch_triplane_bwd<false, BWD_ALL & ~BWD_SORT>,
    launch_triplane_bwd<false, BWD_ALL & ~BWD_SORT & ~BWD_GLOBAL_RED>,
    launch_triplane_bwd<false, BWD_ALL & ~BWD_FLUSH>,
};

}  // namespace

// Arguments as hfa_triplane_mean_bwd's, then the tile (th x tw rays x tn
// samples, clamped to the layout, at most 256 points) and the variant.
extern "C" int hfa_triplane_bwd_probe(const void* g, const void* coords,
                                      void* grad, int B, int M, int H, int W,
                                      int C, float scale, int lh, int lw,
                                      int ln, int th, int tw, int tn,
                                      int variant, void* stream) {
  if (variant < 0 || variant >= (int)(sizeof(VARIANTS) / sizeof(Launch)))
    return (int)cudaErrorInvalidValue;
  return VARIANTS[variant]((const float*)g, (const float*)coords,
                           (float*)grad, B, M, H, W, C, scale, lh, lw, ln, th,
                           tw, tn, (cudaStream_t)stream);
}
