"""The port's flash-CE module (core/kernels/flash_ce.py): its plain version,
values and gradients, against the JAX package's Pallas kernel in interpret
mode and against `jax.grad` of `_ce_stats_direct`; the dispatch of the
wrapper; and (marked `gpu`, card only) the CUDA kernels against the plain
version.

Tolerances. Values rtol 1e-5: one fp32 product of depth ≤ 128 and one exp.
Gradients rtol/atol 1e-4: per-tile fp32 sums in another order than the
one-shot product, and s = 64 amplifies the exp path's rounding by ~s·e (the
JAX package's own bound, tests/test_partial_fc.py). With bf16 operands the
kernel rounds `draw` before the backward products where autograd of the
plain version does not: 2⁻⁸ relative, held to 2e-2 of the gradient's scale
(and the loss to atol 0.3 / rtol 0.05, the bound of
tests/test_arcface.py::test_partial_fc_bf16_matmul_close_to_fp32). On the
card the kernels are held to the plain version at rtol 1e-4 for se_x (a
cosine error of 1e-7 is 6e-6 relative after exp(64·cos)), atol 1e-6 for
tgt_raw and 1e-4 of each gradient's scale (max abs); d norm_emb is summed
with atomics, which the same bound covers. With bf16 operands the card's
kernels sum their products on the tensor cores, 16 at a time, in another
order than the plain version's fp32 product (cuBLAS), and two fp32 sums of
512 positive products near a cosine of 1 differ by up to ~1e-6 however
each is taken: measured on the H100, the kernel's tgt_raw lay 2.3e-7 from
the float64 value and the plain version's 8.4e-7. So the bf16 route's
se_x and tgt_raw are held, at the same rtol 1e-4 and atol 1e-6, to the
float64 value of the same function of the rounded operands.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hfa_gp_tpu.parallel import partial_fc as jpfc
from hfa_gp_tpu.parallel.pallas_ce import flash_ce_stats as jax_flash
from hfa_gp_tpu_torch.core.kernels import flash_ce
from hfa_gp_tpu_torch.parallel import partial_fc as tpfc

# One intra-op thread: the suite runs several worker processes side by
# side, and a thread pool per worker as wide as the machine makes them wait
# on each other (the port's CPU tests: 468 s with the default, 216 s so).
torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(seed=11, b=128, dim=128, c=96):
    rng = np.random.default_rng(seed)
    ne = rng.standard_normal((b, dim)).astype(np.float32)
    ne /= np.linalg.norm(ne, axis=1, keepdims=True)
    w = rng.standard_normal((c, dim)).astype(np.float32)
    lab = rng.integers(-1, c, b).astype(np.int32)
    return ne, w, lab


def _scalarize(se, tgt, mod):
    return mod.sum(mod.log(se) * mod.cos(tgt))


def _torch_value_and_grads(fn, ne, w):
    ne_t = torch.from_numpy(ne).requires_grad_(True)
    w_t = torch.from_numpy(w).requires_grad_(True)
    se, tgt = fn(ne_t, w_t)
    g_ne, g_w = torch.autograd.grad(_scalarize(se, tgt, torch), (ne_t, w_t))
    return se.detach().numpy(), tgt.detach().numpy(), g_ne.numpy(), g_w.numpy()


S = 64.0


def test_plain_matches_jax_pallas_kernel_interpret():
    """B 128, d 128, C 96, labels in [−1, C), forward/backward tiles 32/16
    on the JAX side."""
    ne, w, lab = _inputs()
    flash = lambda a, b: jax_flash(a, b, jnp.asarray(lab), S, None, 32, 16,
                                   True)
    se_j, tgt_j = flash(jnp.asarray(ne), jnp.asarray(w))
    g_j = jax.grad(lambda a, b: _scalarize(*flash(a, b), jnp),
                   argnums=(0, 1))(jnp.asarray(ne), jnp.asarray(w))
    se, tgt, g_ne, g_w = _torch_value_and_grads(
        lambda a, b: flash_ce.flash_ce_stats(a, b, torch.from_numpy(lab), S),
        ne, w)
    np.testing.assert_allclose(se, np.asarray(se_j), rtol=1e-5)
    np.testing.assert_allclose(tgt, np.asarray(tgt_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(g_ne, np.asarray(g_j[0]), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(g_w, np.asarray(g_j[1]), rtol=1e-4, atol=1e-4)
    assert (lab < 0).any() and (tgt[lab < 0] == 0).all()
    assert float(np.abs(g_w).max()) > 1e-3


def _direct_stats(mod, ne, w, lab, mm_dtype=None):
    """(se_x, tgt_raw) rebuilt from the margin-free `_ce_stats_direct` of
    either package: its sum holds the target's term, which comes out
    again here (the test's cosines stay far from 1, so nothing cancels)."""
    xp = jnp if mod is jpfc else torch
    local_max, se, tgt_logit = mod._ce_stats_direct(ne, w, lab, S, 1.0, 0.0,
                                                    0.0, mm_dtype)
    has = lab >= 0
    se_x = se * xp.exp(local_max - S) - xp.where(
        has, xp.exp(tgt_logit - S), 0.0 * tgt_logit)
    return se_x, tgt_logit / S


def test_plain_matches_jax_grad_of_ce_stats_direct():
    ne, w, lab = _inputs(seed=12, b=24, dim=32, c=40)
    want = _direct_stats(jpfc, jnp.asarray(ne), jnp.asarray(w),
                         jnp.asarray(lab))
    g_j = jax.grad(lambda a, b: _scalarize(
        *_direct_stats(jpfc, a, b, jnp.asarray(lab)), jnp), argnums=(0, 1))(
        jnp.asarray(ne), jnp.asarray(w))
    se, tgt, g_ne, g_w = _torch_value_and_grads(
        lambda a, b: flash_ce.flash_ce_stats(a, b, torch.from_numpy(lab), S),
        ne, w)
    np.testing.assert_allclose(se, np.asarray(want[0]), rtol=1e-4)
    np.testing.assert_allclose(tgt, np.asarray(want[1]), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(g_ne, np.asarray(g_j[0]), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(g_w, np.asarray(g_j[1]), rtol=1e-4, atol=1e-4)
    # and the port's own _ce_stats_direct says the same
    se_d, tgt_d, g_ne_d, g_w_d = _torch_value_and_grads(
        lambda a, b: _direct_stats(tpfc, a, b, torch.from_numpy(lab)), ne, w)
    np.testing.assert_allclose(se_d, se, rtol=1e-4)
    np.testing.assert_allclose(g_w_d, g_w, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(g_ne_d, g_ne, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("mm", ["fp32", "bf16"])
def test_plain_mm_dtype_matches_jax_kernel(mm):
    ne, w, lab = _inputs(seed=13)
    jdt, tdt = (None, None) if mm == "fp32" else (jnp.bfloat16,
                                                  torch.bfloat16)
    se_j, tgt_j = jax_flash(jnp.asarray(ne), jnp.asarray(w),
                            jnp.asarray(lab), S, jdt, 32, 16, True)
    se, tgt = flash_ce.flash_ce_stats(torch.from_numpy(ne),
                                      torch.from_numpy(w),
                                      torch.from_numpy(lab), S, tdt)
    # the same bf16-rounded operands, fp32 accumulation in another order
    np.testing.assert_allclose(se.numpy(), np.asarray(se_j), rtol=1e-4)
    np.testing.assert_allclose(tgt.numpy(), np.asarray(tgt_j), rtol=1e-5,
                               atol=1e-6)
    if mm == "bf16":
        se32, _ = flash_ce.flash_ce_stats(torch.from_numpy(ne),
                                          torch.from_numpy(w),
                                          torch.from_numpy(lab), S)
        assert not np.allclose(se.numpy(), se32.numpy(), rtol=1e-4, atol=0.0)
        np.testing.assert_allclose(np.log(se.numpy()), np.log(se32.numpy()),
                                   atol=0.3, rtol=0.05)


def _memorised(seed=14, b=16, dim=32, c=48):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((c, dim)).astype(np.float32)
    lab = rng.permutation(c)[:b].astype(np.int32)
    emb = (3.0 * w[lab]).astype(np.float32)     # each row is its centre
    return emb, w, lab


def test_memorised_rows_loss_is_nonnegative_and_equals_jax():
    """Each embedding equals its class centre, so the target cosine is 1:
    the loss built from the statistics must stay ≥ 0 (a sum that held the
    target's term and had it subtracted again could fall below it)."""
    emb, w, lab = _memorised()
    m = (1.0, 0.5, 0.0)
    got = tpfc._margin_softmax_ce(torch.from_numpy(emb), torch.from_numpy(w),
                                  torch.from_numpy(lab), S, *m)
    ne = emb / np.linalg.norm(emb, axis=1, keepdims=True)
    se_x, tgt_raw = flash_ce.flash_ce_stats(torch.from_numpy(ne),
                                            torch.from_numpy(w),
                                            torch.from_numpy(lab), S)
    np.testing.assert_allclose(tgt_raw.numpy(), 1.0, atol=1e-6)
    se_j, tgt_j = jax_flash(jnp.asarray(ne), jnp.asarray(w),
                            jnp.asarray(lab), S, None, 16, 16, True)
    tgt_m = jpfc.combined_margin(tgt_j, *m)
    want = jnp.mean(jnp.log(se_j + jnp.exp(tgt_m * S - S))
                    - (tgt_m * S - S))
    assert float(got) >= 0.0
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    # without a margin the memorised rows' loss is log(1 + se_x·e^{s−s·t}):
    # tiny, and non-negative up to the rounding of log(exp(a)) − a in fp32
    plain = tpfc._margin_softmax_ce(
        torch.from_numpy(emb), torch.from_numpy(w), torch.from_numpy(lab), S,
        1.0, 0.0, 0.0)
    assert -1e-6 <= float(plain) < 1e-3
    np.testing.assert_allclose(
        float(plain), float(torch.log1p(se_x).mean()), rtol=1e-4, atol=1e-6)


def test_labels_outside_the_table_read_zero():
    ne, w, lab = _inputs(seed=15, b=8, dim=16, c=10)
    lab[:] = [-1, 0, 9, 10, 11, -5, 3, 3]
    se, tgt = flash_ce.flash_ce_stats(torch.from_numpy(ne),
                                      torch.from_numpy(w),
                                      torch.from_numpy(lab), S)
    assert (tgt.numpy()[[0, 3, 4, 5]] == 0).all()
    assert (tgt.numpy()[[1, 2, 6, 7]] != 0).all()
    full = np.exp(S * np.clip(ne @ (w / np.linalg.norm(
        w, axis=1, keepdims=True)).T, -1, 1) - S)
    np.testing.assert_allclose(se.numpy()[0], full[0].sum(), rtol=1e-5)
    np.testing.assert_allclose(se.numpy()[1], full[1, 1:].sum(), rtol=1e-5)


def test_wrapper_dispatch_on_the_cpu():
    """A CPU tensor takes the plain version, the backward wrapper too; an
    explicit request for the kernel on the CPU raises; an unknown product
    type raises."""
    ne, w, lab = (torch.from_numpy(a) for a in _inputs(seed=16, b=8, dim=16,
                                                       c=10))
    n0, n1 = flash_ce.LAUNCHES, flash_ce.LAUNCHES_BWD
    got = flash_ce.flash_ce_stats(ne, w, lab, S)
    want = flash_ce.flash_ce_stats_plain(ne, w, lab, S)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    ct = (torch.ones(8), torch.ones(8))
    got = flash_ce.flash_ce_stats_backward(ne, w, lab, S, None, *ct)
    want = flash_ce.flash_ce_stats_backward_plain(ne, w, lab, S, None, *ct)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (flash_ce.LAUNCHES, flash_ce.LAUNCHES_BWD) == (n0, n1)
    with pytest.raises(ValueError, match="CUDA"):
        flash_ce.flash_ce_stats_cuda(ne, w, lab, S)
    with pytest.raises(ValueError, match="mm_dtype"):
        flash_ce.flash_ce_stats(ne, w, lab, S, torch.float16)
    with pytest.raises(ValueError, match="unsupported device"):
        flash_ce.flash_ce_stats(ne.to("meta"), w.to("meta"), lab.to("meta"),
                                S)


# -- card only ---------------------------------------------------------------


def _card_inputs(dev, b, dim, c, seed=0):
    ne, w, lab = _inputs(seed=seed, b=b, dim=dim, c=c)
    lab[::5] = -1
    w *= 0.01
    # a few nearly memorised rows, so that some exp terms are not tiny
    for i in range(1, b, 7):
        if lab[i] >= 0:
            w[lab[i]] = 0.02 * ne[i] + 5e-4 * w[lab[i]]
    return tuple(torch.from_numpy(a).to(dev) for a in (ne, w, lab))


def _exact_stats_of_rounded_operands(ne, w, lab):
    """(se_x, tgt_raw) of bf16-rounded operands, the products and every
    later step in float64: the value both the kernel and the plain version
    approximate in fp32."""
    raw = ne.to(torch.bfloat16).double() @ w.to(torch.bfloat16).double().T
    inv = torch.rsqrt((w.double() ** 2).sum(1))
    logit = torch.clamp(raw * inv[None, :], -1.0, 1.0)
    hit = torch.arange(w.shape[0], device=w.device)[None, :] \
        == lab.long()[:, None]
    e = torch.exp(logit * S - S)
    return (torch.where(hit, torch.zeros_like(e), e).sum(1),
            torch.where(hit, logit, torch.zeros_like(logit)).sum(1))


@pytest.mark.gpu
@pytest.mark.parametrize("mm", [None, torch.bfloat16])
@pytest.mark.parametrize("b,dim,c", [(256, 512, 10007), (130, 20, 300),
                                     (5, 7, 3), (300, 128, 1000),
                                     (384, 510, 3001), (8, 72, 1000),
                                     (40, 700, 501)])
def test_kernels_match_plain(cuda, b, dim, c, mm):
    ne, w, lab = _card_inputs(cuda, b, dim, c)
    n0, n1 = flash_ce.LAUNCHES, flash_ce.LAUNCHES_BWD
    ne_k, w_k = ne.clone().requires_grad_(True), w.clone().requires_grad_(True)
    se, tgt = flash_ce.flash_ce_stats(ne_k, w_k, lab, S, mm)
    ne_p, w_p = ne.clone().requires_grad_(True), w.clone().requires_grad_(True)
    se_p, tgt_p = flash_ce.flash_ce_stats_plain(ne_p, w_p, lab, S, mm)
    if mm is None:
        torch.testing.assert_close(se, se_p, rtol=1e-4, atol=0.0)
        torch.testing.assert_close(tgt, tgt_p, rtol=0.0, atol=1e-6)
    else:
        se_x, tgt_x = _exact_stats_of_rounded_operands(ne, w, lab)
        torch.testing.assert_close(se.double(), se_x, rtol=1e-4, atol=0.0)
        torch.testing.assert_close(tgt.double(), tgt_x, rtol=0.0, atol=1e-6)
    assert (tgt[lab < 0] == 0).all()
    g = torch.Generator().manual_seed(1)
    ct_se = (torch.randn(b, generator=g).to(cuda) / se_p).detach()
    ct_tgt = torch.randn(b, generator=g).to(cuda)
    got = torch.autograd.grad((se, tgt), (ne_k, w_k), (ct_se, ct_tgt))
    want = torch.autograd.grad((se_p, tgt_p), (ne_p, w_p), (ct_se, ct_tgt))
    torch.cuda.synchronize()
    assert (flash_ce.LAUNCHES, flash_ce.LAUNCHES_BWD) == (n0 + 1, n1 + 1)
    bound = 1e-4 if mm is None else 2e-2
    for name, x, y in zip(("d norm_emb", "d w"), got, want):
        rel = (x - y).abs().max().item() / y.abs().max().item()
        assert rel <= bound, (name, rel)


# (b, c, dim, mm): every pairing of three batches, three depths and both
# operand types, and with bf16 operands a depth below the tensor-core
# route's 64-column padding too (at fp32 and d 72 these inputs hold a
# cosine within 2 ulps of the clip, where kernel and plain version may
# round to different sides)
BWD_CASES = [(b, c, dim, mm) for mm in (None, torch.bfloat16)
             for dim in (64, 510, 512)
             for b, c in ((8, 1001), (256, 3003), (384, 2049))] + [
    (8, 1001, 72, torch.bfloat16), (384, 2049, 72, torch.bfloat16)]


@pytest.mark.gpu
@pytest.mark.parametrize("b,c,dim,mm", BWD_CASES)
def test_backward_kernel_matches_plain_and_repeats_d_w(cuda, b, c, dim, mm):
    """The backward kernel alone at batches below, at and above the 256
    rows a block holds at once, ragged class tiles, depths that are and are
    not multiples of 4 and of the slice depth: against the plain version,
    and d w equal bit for bit in two launches."""
    ne, w, lab = _card_inputs(cuda, b, dim, c)
    se_p, _ = flash_ce.flash_ce_stats_plain(ne, w, lab, S, mm)
    g = torch.Generator().manual_seed(2)
    ct_se = (torch.randn(b, generator=g).to(cuda) / se_p).contiguous()
    ct_tgt = torch.randn(b, generator=g).to(cuda)
    n1 = flash_ce.LAUNCHES_BWD
    got = flash_ce.flash_ce_stats_backward(ne, w, lab, S, mm, ct_se, ct_tgt)
    again = flash_ce.flash_ce_stats_backward(ne, w, lab, S, mm, ct_se, ct_tgt)
    want = flash_ce.flash_ce_stats_backward_plain(ne, w, lab, S, mm, ct_se,
                                                  ct_tgt)
    torch.cuda.synchronize()
    assert flash_ce.LAUNCHES_BWD == n1 + 2
    assert torch.equal(got[1], again[1])
    bound = 1e-4 if mm is None else 2e-2
    for name, x, y in zip(("d norm_emb", "d w"), got, want):
        rel = (x - y).abs().max().item() / y.abs().max().item()
        assert rel <= bound, (name, rel)


@pytest.mark.gpu
def test_forward_is_the_same_from_run_to_run(cuda):
    """se_x comes from per-tile partial sums added in a fixed order, d w
    from one block per row: both equal bit for bit across runs (d norm_emb
    uses atomics and may not)."""
    ne, w, lab = _card_inputs(cuda, 256, 64, 5000)
    ct = (torch.ones(256, device=cuda), torch.ones(256, device=cuda))
    a = flash_ce.flash_ce_stats(ne, w, lab, S)
    ga = flash_ce.flash_ce_stats_backward(ne, w, lab, S, None, *ct)
    b = flash_ce.flash_ce_stats(ne, w, lab, S)
    gb = flash_ce.flash_ce_stats_backward(ne, w, lab, S, None, *ct)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert torch.equal(ga[1], gb[1])
    torch.testing.assert_close(ga[0], gb[0], rtol=1e-4, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("b,dim,c", [(256, 512, 5000), (384, 510, 3001),
                                     (8, 72, 1000)])
def test_bf16_route_is_the_same_from_run_to_run(cuda, b, dim, c):
    """With bf16 operands, at a batch of more than one group of rows and a
    depth below a warp tile's 64 columns too, each with a ragged class
    tile: the gradients against the plain version, and se_x and tgt_raw
    (a fixed-order sum and one writer) and d w (one block per row) equal
    bit for bit across runs."""
    ne, w, lab = _card_inputs(cuda, b, dim, c)
    se_p, _ = flash_ce.flash_ce_stats_plain(ne, w, lab, S, torch.bfloat16)
    g = torch.Generator().manual_seed(3)
    ct = ((torch.randn(b, generator=g).to(cuda) / se_p).contiguous(),
          torch.randn(b, generator=g).to(cuda))
    bf = torch.bfloat16
    a = flash_ce.flash_ce_stats(ne, w, lab, S, bf)
    ga = flash_ce.flash_ce_stats_backward(ne, w, lab, S, bf, *ct)
    again = flash_ce.flash_ce_stats(ne, w, lab, S, bf)
    gb = flash_ce.flash_ce_stats_backward(ne, w, lab, S, bf, *ct)
    want = flash_ce.flash_ce_stats_backward_plain(ne, w, lab, S, bf, *ct)
    assert torch.equal(a[0], again[0]) and torch.equal(a[1], again[1])
    assert torch.equal(ga[1], gb[1])
    for name, x, y in zip(("d norm_emb", "d w"), ga, want):
        rel = (x - y).abs().max().item() / y.abs().max().item()
        assert rel <= 2e-2, (name, rel)


@pytest.mark.gpu
def test_kernel_wrapper_rejects_what_the_kernels_do_not_take(cuda):
    ne, w, lab = _card_inputs(cuda, 16, 32, 50)
    with pytest.raises(ValueError, match="contiguous fp32"):
        flash_ce.flash_ce_stats(ne.double(), w, lab, S)
    with pytest.raises(ValueError, match="contiguous fp32"):
        flash_ce.flash_ce_stats(ne, w.t().contiguous().t(), lab, S)
    with pytest.raises(ValueError, match="int32"):
        flash_ce.flash_ce_stats(ne, w, lab.long(), S)
    with pytest.raises(ValueError, match="norm_emb"):
        flash_ce.flash_ce_stats(ne[:, :16].contiguous(), w, lab, S)
    with pytest.raises(ValueError, match="contiguous fp32"):
        flash_ce.flash_ce_stats(ne, w.cpu(), lab, S)
    with pytest.raises(ValueError, match="mm_dtype"):
        flash_ce.flash_ce_stats(ne, w, lab, S, torch.float16)
    with pytest.raises(ValueError, match="cotangents"):
        flash_ce.flash_ce_stats_backward(
            ne, w, lab, S, None, torch.ones(3, device=cuda),
            torch.ones(16, device=cuda))


@pytest.mark.gpu
def test_partial_fc_on_the_card_goes_through_the_kernels(cuda):
    """`PartialFC.loss` and `loss_sampled` on CUDA tensors launch K5 and
    K6 once each and agree with the CPU's plain path."""
    rng = np.random.default_rng(3)
    c, dim, b = 3000, 64, 48
    w = (rng.standard_normal((c, dim)) * 0.01).astype(np.float32)
    emb = rng.standard_normal((b, dim)).astype(np.float32)
    lab = rng.integers(0, c, b)
    lab[::6] = -1
    pfc = tpfc.PartialFC(c, dim, sample_rate=0.1)
    dense = tpfc.PartialFC(c, dim)
    index = pfc.sample_indices(torch.from_numpy(lab),
                               torch.Generator().manual_seed(0))
    out = {}
    for dev in ("cpu", cuda):
        n0, n1 = flash_ce.LAUNCHES, flash_ce.LAUNCHES_BWD
        w_t = torch.from_numpy(w).to(dev).requires_grad_(True)
        e_t = torch.from_numpy(emb).to(dev).requires_grad_(True)
        l_t = torch.from_numpy(lab).to(dev)
        loss = dense.loss(w_t, e_t, l_t)
        gw, ge = torch.autograd.grad(loss, (w_t, e_t))
        w_sub = pfc.take_rows(w_t.detach(), index.to(dev)) \
            .requires_grad_(True)
        loss_s = pfc.loss_sampled(w_sub, e_t, l_t, index.to(dev))
        gs, = torch.autograd.grad(loss_s, w_sub)
        launched = (flash_ce.LAUNCHES - n0, flash_ce.LAUNCHES_BWD - n1)
        assert launched == ((0, 0) if dev == "cpu" else (2, 2))
        out[str(dev)] = [t.detach().cpu() for t in (loss, gw, ge, loss_s, gs)]
    for x, y in zip(out["cuda"], out["cpu"]):
        assert (x - y).abs().max() <= 1e-4 * y.abs().max()
