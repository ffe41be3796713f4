// Ablation probe of the flash-CE backward kernel: flash_ce_bwd.cuh with
// parts removed by compile-time switches, to show on the H100 what each
// part costs (the card's machine has no kernel profiler). The variants:
//   0  the whole kernel (equal to hfa_flash_ce_bwd)
//   1  without dne's atomic adds
//   2  without dW's store
//   3  without the FMAs of the recomputed cosines
//   4  without the FMAs of dW's product
//   5  without the FMAs of dne's product
//   6  without any FMA, store or atomic: the operands' copies, the
//      barriers and the exp epilogue alone
//   7  without the operands' copies (the FMAs run on whatever the rings
//      hold)
//   8  without the copies, dW's store and dne's atomics: the FMAs, the
//      barriers and the exp epilogue alone
//   9  without the barrier of each slice (the warps run out of step and
//      read slices that have not landed)
// A variant with a part removed computes something else; only its time
// means anything. fp32 operands only. Driven by
// hfa_gp_tpu_torch/tools/profile_arcface.py.

#include "flash_ce_bwd.cuh"

namespace {

using namespace hfa_ce;

using Launch = int (*)(const void*, const void*, const void*, const void*,
                       const void*, void*, void*, void*, int, int, int64_t,
                       float, void*);

const Launch VARIANTS[] = {
    launch_flash_ce_bwd<false, 0>,
    launch_flash_ce_bwd<false, NO_ATOMICS>,
    launch_flash_ce_bwd<false, NO_DW_STORE>,
    launch_flash_ce_bwd<false, NO_FMA_RAW>,
    launch_flash_ce_bwd<false, NO_FMA_DW>,
    launch_flash_ce_bwd<false, NO_FMA_DNE>,
    launch_flash_ce_bwd<false, NO_ATOMICS | NO_DW_STORE | NO_FMA_RAW |
                                   NO_FMA_DW | NO_FMA_DNE>,
    launch_flash_ce_bwd<false, NO_COPIES>,
    launch_flash_ce_bwd<false, NO_COPIES | NO_ATOMICS | NO_DW_STORE>,
    launch_flash_ce_bwd<false, NO_BARRIERS>,
};

}  // namespace

// Arguments as hfa_flash_ce_bwd's, with `variant` in place of `bf16`.
extern "C" int hfa_flash_ce_bwd_probe(const void* ne, const void* w,
                                      const void* lab, const void* ct_se,
                                      const void* ct_tgt, void* dw, void* dne,
                                      void* ne_t, int B, int d, int64_t C,
                                      float s, int variant, void* stream) {
  if (variant < 0 || variant >= (int)(sizeof(VARIANTS) / sizeof(Launch)))
    return (int)cudaErrorInvalidValue;
  return VARIANTS[variant](ne, w, lab, ct_se, ct_tgt, dw, dne, ne_t, B, d, C,
                           s, stream);
}
