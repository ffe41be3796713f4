// Flash cross-entropy statistics, backward. Replaces the TPU kernel
// hfa_gp_tpu/parallel/pallas_ce.py::_bwd_kernel (reached through
// _stats_bwd, the VJP of flash_ce_stats).
//
// Inputs as the forward's (flash_ce.cu), and the cotangents ct_se, ct_tgt
// (B,) fp32 of se_x and tgt_raw. With raw = w . ne, inv = 1 / |w_j|,
// li = raw * inv, e = exp(s * clip(li) - s):
//   dl   = ct_tgt[b] at the target column, ct_se[b] * s * e elsewhere, and
//          0 where li is outside [-1, 1]
//   draw = dl * inv
//   dW   = draw . ne - (sum_b dl * raw) * inv^3 * w        (C, d)
//   dne  = draw^T . w                                      (B, d)
//
// Bound on the H100: operations. Three products (the cosines are recomputed,
// as the forward computes them), 0.79 TFLOP of fp32 FMA at B 256, d 512,
// C 1,000,000 (11.8 ms at 67 TFLOP/s) against 4.1 GB that must move
// (1.2 ms). So the design's whole aim is to keep the FMA pipes fed and to
// move nothing twice (the kernel is flash_ce_bwd.cuh, its parts
// flash_ce_common.cuh):
//
//  * One pass over the batch. A block owns 128 classes and holds the tile's
//    draw for 256 batch rows in shared memory (135 KB, [batch row][class]
//    at a pitch of 132 floats; one block a multiprocessor). Neither the
//    cosines nor draw ever reach device memory. For B <= 256 each dW
//    element is summed over the whole batch in registers, gets the norm's
//    term -(sum dl * raw) * inv^3 * w in the same epilogue, and is written
//    once and never read. Only for B > 256 do later groups of 256 rows add
//    to the block's own rows.
//  * Operands arrive in slices 32 deep through rings of two or three
//    stages filled by `cp.async`, so loads and FMAs overlap, and none is
//    transposed in the kernel: w as
//    [row][k] and the embeddings, transposed once by the launcher, as
//    [k][batch row] for the cosines; ne as [k = batch row][column] for dW;
//    w as [k = class][column] for dne; draw's one layout serves dW as
//    [k][class] and dne as [row][k = class].
//  * With one resident block a multiprocessor, the 132 tiles of w in flight
//    (34 MB) stay in L2 between the three products that read them.
//  * dW rows belong to one block, which writes them without atomics: dW is
//    the same bit for bit from run to run. dne sums over all class tiles,
//    which run in parallel: 16-byte fp32 atomic adds into a zeroed buffer,
//    so dne's last bits change from run to run with the order of the adds.
//    What the atomics cost does not show: the kernel compiled without
//    them was no faster.
//  * What is left above the bound (23 ms against 11.8) is the FMA loops
//    themselves: each product runs at 57 to 70 % of the FMA peak, as the
//    library's fp32 product does, because an 8 x 8 micro-tile keeps the
//    shared-memory port as busy as the FMA pipes.
//
// With bf16 set, ne, w and draw are rounded to bfloat16 as operands of the
// products; norms, dl, the sum dl * raw and dW's second term stay fp32.
// Those products run on the tensor cores (flash_ce_bwd_bf16.cu) up to d
// 512; above, this kernel rounds each operand as it reads it.

#include "flash_ce_bwd.cuh"

// dne must be zeroed by the caller; dw is written in full; ne_t is scratch
// of d * ceil(B / 4) * 4 floats (the embeddings, transposed and padded),
// and for bf16 operands at d <= 512, which take the tensor-core kernel of
// flash_ce_bwd_bf16.cu, of ceil(B / 256) * 256 * ceil(d / 64) * 64 bf16
// (rounded and padded).
extern "C" int hfa_flash_ce_bwd(const void* ne, const void* w,
                                const void* lab, const void* ct_se,
                                const void* ct_tgt, void* dw, void* dne,
                                void* ne_t, int B, int d, int64_t C, float s,
                                int bf16, void* stream) {
  if (B <= 0 || C <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  if (bf16 && d <= hfa_ce::tc::BWD_MAX_D)
    return hfa_ce::tc::launch_bwd(
        (const float*)ne, (const float*)w, (const int*)lab,
        (const float*)ct_se, (const float*)ct_tgt, (float*)dw, (float*)dne,
        ne_t, B, d, C, s, (cudaStream_t)stream);
  if (bf16)          // the class tile does not fit: the CUDA-core route
    return hfa_ce::launch_flash_ce_bwd<true>(
        ne, w, lab, ct_se, ct_tgt, dw, dne, ne_t, B, d, C, s, stream);
  return hfa_ce::launch_flash_ce_bwd<false>(
      ne, w, lab, ct_se, ct_tgt, dw, dne, ne_t, B, d, C, s, stream);
}
