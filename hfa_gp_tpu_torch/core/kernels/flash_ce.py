"""Flash cross-entropy statistics of the margin softmax: dispatching
wrapper, plain versions and launch counts.

Replaces the TPU kernels of `hfa_gp_tpu/parallel/pallas_ce.py`:
`_fwd_kernel` (via `_stats_fwd`) by `csrc/flash_ce.cu` and `_bwd_kernel`
(via `_stats_bwd`) by `csrc/flash_ce_bwd.cu` (the kernel itself is the
template of `csrc/flash_ce_bwd.cuh`). With bf16 operands the same entry
points launch the tensor-core kernels of `csrc/flash_ce_bf16.cu` and
`csrc/flash_ce_bwd_bf16.cu` (design in `csrc/flash_ce_bf16.cuh`; the
backward above d 512 keeps the CUDA-core template). Each source's header
says what bounds it on the H100 and how the design answers that.

    se_x[b]    = Σ_{j ≠ lab[b]} exp(s·clip(cos_bj, ±1) − s)
    tgt_raw[b] = clip(cos_{b, lab[b]}), 0 where lab[b] is outside [0, C)
    cos_bj     = (w_j · ne_b) / ‖w_j‖

The target column is left out of the sum: the caller adds the margined
term back with its own exp (`parallel/partial_fc.py`), so the softmax
denominator can never fall below the target's term. The shift is fixed at
`s`, the largest possible scaled cosine.

On CUDA `flash_ce_stats` is one `torch.autograd.Function` over the two
kernels, differentiable in `norm_emb` and `w`; the (B, C) cosines never
reach device memory. On the CPU it is `flash_ce_stats_plain`, which
materialises them and whose gradient is autograd's.
"""

from __future__ import annotations

import torch

from . import build

# Launches of the CUDA kernels in this process: forward (one per
# `flash_ce_stats` call) and backward (one per gradient taken through it).
LAUNCHES = 0
LAUNCHES_BWD = 0

CLASS_TILE = 128   # classes per block: TILE_C of csrc/flash_ce_common.cuh
# the bf16 route's copy of the embeddings: rows padded to a batch group,
# columns to a warp tile (csrc/flash_ce_bf16.cuh); its backward runs up to
# d 512 (tc::BWD_MAX_D of csrc/flash_ce_common.cuh)
BF16_ROWS, BF16_DEPTH, BF16_BWD_MAX_D = 256, 64, 512


def _round_operand(x: torch.Tensor, mm_dtype) -> torch.Tensor:
    """An operand of a product: rounded to `mm_dtype` and carried in fp32,
    so the product accumulates in fp32 on every device."""
    return x if mm_dtype is None else x.to(mm_dtype).to(torch.float32)


def flash_ce_stats_plain(norm_emb: torch.Tensor, w: torch.Tensor,
                         local_lab: torch.Tensor, s: float, mm_dtype=None
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version: materialises the (B, C) cosines.
    Differentiable in `norm_emb` and `w` by autograd; the clip passes a
    gradient only for pre-clip cosines inside [−1, 1]."""
    c = w.shape[0]
    inv = torch.rsqrt((w * w).sum(1))                       # fp32 norms
    raw = _round_operand(norm_emb, mm_dtype) @ _round_operand(w, mm_dtype).T
    logit = torch.clamp(raw * inv[None, :], -1.0, 1.0)
    lab = local_lab.long()
    hit = torch.arange(c, device=w.device)[None, :] == lab[:, None]
    e = torch.exp(logit * s - s)
    se_x = torch.where(hit, torch.zeros_like(e), e).sum(1)
    tgt_raw = torch.where(hit, logit, torch.zeros_like(logit)).sum(1)
    return se_x, tgt_raw


def flash_ce_stats_backward_plain(norm_emb, w, local_lab, s, mm_dtype,
                                  ct_se, ct_tgt):
    """The plain version of the backward kernel: (d norm_emb, d w) for the
    cotangents of (se_x, tgt_raw), by autograd through the plain forward."""
    with torch.enable_grad():
        ne = norm_emb.detach().requires_grad_(True)
        wl = w.detach().requires_grad_(True)
        out = flash_ce_stats_plain(ne, wl, local_lab, s, mm_dtype)
        return torch.autograd.grad(out, (ne, wl), (ct_se, ct_tgt))


def _mm_flag(mm_dtype) -> int:
    if mm_dtype is None:
        return 0
    if mm_dtype == torch.bfloat16:
        return 1
    raise ValueError(f"flash_ce_stats: mm_dtype must be None or "
                     f"torch.bfloat16, got {mm_dtype}")


def _check_cuda_inputs(fn: str, norm_emb, w, local_lab, extra: dict) -> None:
    dev = norm_emb.device
    if dev.type != "cuda":
        raise ValueError(f"{fn}: the kernel needs CUDA tensors, got {dev}")
    if norm_emb.ndim != 2 or w.ndim != 2 or norm_emb.shape[1] != w.shape[1] \
            or local_lab.shape != (norm_emb.shape[0],):
        raise ValueError(f"{fn}: norm_emb {tuple(norm_emb.shape)}, w "
                         f"{tuple(w.shape)}, local_lab "
                         f"{tuple(local_lab.shape)}")
    if local_lab.device != dev or local_lab.dtype != torch.int32 \
            or not local_lab.is_contiguous():
        raise ValueError(f"{fn}: local_lab must be a contiguous int32 "
                         f"tensor on {dev}")
    for name, t in {"norm_emb": norm_emb, "w": w, **extra}.items():
        if t.device != dev or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be a contiguous fp32 "
                             f"tensor on {dev}")
    if min(norm_emb.shape[0], w.shape[0], w.shape[1]) < 1:
        raise ValueError(f"{fn}: empty input")


def transposed_scratch(norm_emb: torch.Tensor) -> torch.Tensor:
    """Scratch for the kernels' transposed copy of the embeddings: (d, B
    rounded up to 4), so that each of its rows is 16-byte aligned."""
    b, d = norm_emb.shape
    return torch.empty((d, -(-b // 4) * 4), dtype=torch.float32,
                       device=norm_emb.device)


def scratch(norm_emb: torch.Tensor, flag: int, backward: bool
            ) -> torch.Tensor:
    """Scratch for the kernels' copy of the embeddings. fp32 operands (flag
    0), and a backward with bf16 operands above d 512: the transposed copy.
    bf16 operands otherwise: the rows rounded to bf16, (B rounded up to
    256, d rounded up to 64)."""
    b, d = norm_emb.shape
    if not flag or (backward and d > BF16_BWD_MAX_D):
        return transposed_scratch(norm_emb)
    return torch.empty((-(-b // BF16_ROWS) * BF16_ROWS,
                        -(-d // BF16_DEPTH) * BF16_DEPTH),
                       dtype=torch.bfloat16, device=norm_emb.device)


def _launch_forward(norm_emb, w, local_lab, s: float, mm_dtype):
    flag = _mm_flag(mm_dtype)
    _check_cuda_inputs("flash_ce_stats", norm_emb, w, local_lab, {})
    (b, d), c, dev = norm_emb.shape, w.shape[0], norm_emb.device
    n_tiles = -(-c // CLASS_TILE)
    partial = torch.empty((n_tiles, b), dtype=torch.float32, device=dev)
    se_x = torch.empty((b,), dtype=torch.float32, device=dev)
    tgt_raw = torch.zeros((b,), dtype=torch.float32, device=dev)
    lib = build.library()
    global LAUNCHES
    with torch.cuda.device(dev):
        err = lib.hfa_flash_ce_fwd(
            norm_emb.data_ptr(), w.data_ptr(), local_lab.data_ptr(),
            partial.data_ptr(), scratch(norm_emb, flag, False).data_ptr(),
            se_x.data_ptr(), tgt_raw.data_ptr(), b, d, c, float(s), flag,
            torch.cuda.current_stream().cuda_stream)
    build.check(err, "hfa_flash_ce_fwd")
    LAUNCHES += 1
    return se_x, tgt_raw


def flash_ce_stats_backward(norm_emb, w, local_lab, s: float, mm_dtype,
                            ct_se, ct_tgt):
    """(d norm_emb (B, d), d w (C, d)) for the cotangents (B,) of
    `flash_ce_stats`. CPU tensors go to `flash_ce_stats_backward_plain`;
    CUDA tensors launch the backward kernel (fp32, contiguous) or raise.
    d norm_emb is summed over class tiles with atomics, so its last bits
    change from run to run; d w does not."""
    if norm_emb.device.type == "cpu":
        return flash_ce_stats_backward_plain(norm_emb, w, local_lab, s,
                                             mm_dtype, ct_se, ct_tgt)
    if norm_emb.device.type != "cuda":
        raise ValueError(f"flash_ce_stats_backward: unsupported device "
                         f"{norm_emb.device}")
    flag = _mm_flag(mm_dtype)
    _check_cuda_inputs("flash_ce_stats_backward", norm_emb, w, local_lab,
                       {"ct_se": ct_se, "ct_tgt": ct_tgt})
    (b, d), c = norm_emb.shape, w.shape[0]
    if ct_se.shape != (b,) or ct_tgt.shape != (b,):
        raise ValueError(f"flash_ce_stats_backward: cotangents "
                         f"{tuple(ct_se.shape)}, {tuple(ct_tgt.shape)}, "
                         f"expected {(b,)}")
    dw = torch.empty_like(w)
    dne = torch.zeros_like(norm_emb)
    lib = build.library()
    global LAUNCHES_BWD
    with torch.cuda.device(norm_emb.device):
        err = lib.hfa_flash_ce_bwd(
            norm_emb.data_ptr(), w.data_ptr(), local_lab.data_ptr(),
            ct_se.data_ptr(), ct_tgt.data_ptr(), dw.data_ptr(),
            dne.data_ptr(), scratch(norm_emb, flag, True).data_ptr(), b, d, c,
            float(s), flag,
            torch.cuda.current_stream().cuda_stream)
    build.check(err, "hfa_flash_ce_bwd")
    LAUNCHES_BWD += 1
    return dne, dw


class _FlashCEStats(torch.autograd.Function):
    """The forward kernel with the backward kernel as its gradient."""

    @staticmethod
    def forward(ctx, norm_emb, w, local_lab, s, mm_dtype):
        ctx.save_for_backward(norm_emb, w, local_lab)
        ctx.s, ctx.mm_dtype = s, mm_dtype
        return _launch_forward(norm_emb, w, local_lab, s, mm_dtype)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, ct_se, ct_tgt):
        norm_emb, w, local_lab = ctx.saved_tensors
        dne, dw = flash_ce_stats_backward(
            norm_emb, w, local_lab, ctx.s, ctx.mm_dtype,
            ct_se.contiguous(), ct_tgt.contiguous())
        return dne, dw, None, None, None


def flash_ce_stats(norm_emb: torch.Tensor, w: torch.Tensor,
                   local_lab: torch.Tensor, s: float, mm_dtype=None,
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(se_x, tgt_raw), two (B,) fp32 tensors, differentiable in `norm_emb`
    (B, d; unit rows) and `w` (C, d; raw class centres). `local_lab` (B,)
    int32 is each row's column in `w`, or negative for none. `mm_dtype` is
    None or torch.bfloat16 (the products' operands rounded, fp32
    accumulation).

    CPU tensors go to `flash_ce_stats_plain`; CUDA tensors launch the
    kernels at any B, d and C (fp32, contiguous) or raise."""
    if norm_emb.device.type == "cpu":
        _mm_flag(mm_dtype)
        return flash_ce_stats_plain(norm_emb, w, local_lab, s, mm_dtype)
    if norm_emb.device.type != "cuda":
        raise ValueError(f"flash_ce_stats: unsupported device "
                         f"{norm_emb.device}")
    return flash_ce_stats_cuda(norm_emb, w, local_lab, s, mm_dtype)


def flash_ce_stats_cuda(norm_emb, w, local_lab, s: float, mm_dtype=None):
    """`flash_ce_stats` through the kernels only: raises on tensors that
    are not on a CUDA device instead of taking the plain version."""
    return _FlashCEStats.apply(norm_emb, w, local_lab, float(s), mm_dtype)

