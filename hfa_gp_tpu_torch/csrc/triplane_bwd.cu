// Tri-plane sampler backward: d planes of the plane-averaged bilinear
// lookup of triplane.cu. Replaces the TPU kernels
// hfa_gp_tpu/core/pallas/triplane.py::_sampler_bwd_kernel_vmem (via
// _sample_blocked_bwd_vmem) and ::_sampler_bwd_kernel_hbm (via
// _sample_blocked_bwd_hbm). Those two compute the same function; they
// differ only in where the TPU keeps the accumulator (VMEM or HBM), which
// is no question here, so one kernel replaces both.
//
//   g      (B, M, C)       fp32 cotangent of the plane-averaged features
//   coords (B, M, 3)       fp32 world points (they get no gradient)
//   grad   (B, 3, H, W, C) fp32, zeroed by the caller; every point adds
//                          g / 3 x bilinear weight to its in-bounds corner
//                          rows on each of the three planes
//   layout (lh, lw, ln)    optional: the points of a batch element are
//                          lh x lw rays, row-major, of ln samples each
//                          (lh * lw * ln == M); (1, 1, M) without one
//
// Texels, weights and the zeros-padding rule are the forward's
// (triplane_common.cuh): an out-of-plane corner adds nothing and is never
// addressed.
//
// Bound on the H100: bytes in principle (read g and coords once, write the
// gradient once), the texel updates in practice. A point adds to 12 texel
// rows; at the coarse pass of batch 2 that is 17.7 M rows of 128 B (2.27 GB
// of reductions) into a 50 MB gradient, about 80 updates a row. On an
// H100 80GB HBM3 at 700 W, at batch 2: the previous design sent each of
// them to L2 as 32 scalar atomics (1.05 ms); as 16-byte reductions they
// take 0.90 ms, and as plain stores of the same bytes still 0.61 ms
// (device time, timed by compiling the kernel with its reductions as
// stores): the traffic itself costs, so it is summed on chip first.
// Neighbouring rays and samples share texels: over a screen tile of 8 x 8
// rays x 4 samples the 12 rows of every point fall on a few hundred texels
// a plane. Summing
// them in a shared window with shared-memory float atomics, as the TPU
// kernel sums into its VMEM accumulator, was slower than no window at all
// (1.48 against 0.85 ms, a call at a time: the float atomics, and windows
// so large that two blocks a multiprocessor could not hide the read of g);
// gathering each texel from sorted points was issue-bound (0.66 ms). The design (the template is
// triplane_bwd.cuh):
//
//  * A block takes a tile of one batch element's points: 8 x 8 rays x 4
//    samples when the caller passes the layout, else a run of 256
//    contiguous points. The batch element is the grid's second dimension.
//  * A thread a point: its three axis footprints, once; its weights and
//    the bucket of its north-west corner on each plane; each plane's
//    bucket box from a block max reduction. The tile's g comes into shared
//    memory in one pass, all of a thread's loads in flight.
//  * A plane whose box has at most 768 buckets is sorted: a counting sort
//    of the tile's points by bucket (integer shared atomics, native on the
//    card, and a block scan), each point's weights stored beside its index.
//    Then a group of lanes (eight lanes of 16 bytes at C = 32) sweeps a
//    bucket row west to east: it sums each bucket's points into its four
//    corners in registers, adds the nw sums and the west bucket's ne sums
//    to the texel row of the bucket's own row, and the sw and west se sums
//    to the row below, dividing by 3, with one 16-byte reduction
//    (red.global.add.v4.f32) a texel and row: each point is read once and
//    each texel row takes at most two reductions. No float atomic touches
//    shared memory; texels outside the plane are never addressed.
//  * Any other plane (grazing poses, shuffled points) takes the direct
//    pass: four points a warp, a 16-byte reduction a lane and corner, with
//    K1's mapping. C % 4 != 0 or C > 32 takes only this pass (one float a
//    lane where C % 4 != 0).
// The sums change order from run to run, and with them the last bits of
// the result.

#include "triplane_bwd.cuh"

namespace {

// the tile with a layout (rays x rays x samples) and the run of points
// without one; settled on the H100 by timing the kernel at other tiles
constexpr int TILE_ROWS = 8, TILE_COLS = 8, TILE_SAMPLES = 4;
constexpr int RUN_POINTS = 256;

}  // namespace

extern "C" int hfa_triplane_mean_bwd(const void* g, const void* coords,
                                     void* grad, int B, int M, int H, int W,
                                     int C, float scale, int lh, int lw,
                                     int ln, void* stream) {
  const bool layout = lh > 1 || lw > 1;
  return hfa::launch_triplane_bwd(
      (const float*)g, (const float*)coords, (float*)grad, B, M, H, W, C,
      scale, lh, lw, ln, layout ? TILE_ROWS : 1, layout ? TILE_COLS : 1,
      layout ? TILE_SAMPLES : RUN_POINTS, (cudaStream_t)stream);
}
