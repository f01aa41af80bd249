"""Gated SSD scan of the PyTorch port against the JAX package, on the CPU:
the port's plain version (what the CUDA kernels are held against on the
card) vs the Pallas kernels in interpret mode, the accounting the two
packages share, and the gate checks.

Shapes B 2, H 4, P 8, N 8, chunk 8, at S 24 and at S 21 (the pad path);
random p_f / p_o / p_s gates, compaction bounds below B·H (at the live
counts) and at B·H. Inputs come from numpy seeds and go through both
packages. Tolerances, float32: y and prevs 1e-5, gradients 1e-4 (JAX's own
kernel tolerance, ``tests/test_block_kernels.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import d2ft_ssd as jax_ssd
from repro.kernels import ops as jax_ops
from repro_torch.kernels import contract, d2ft_ssd, ops

FWD_TOL = 1e-5
GRAD_TOL = 1e-4
B, H, P, N, CHUNK = 2, 4, 8, 8, 8


def _operands(rng, S):
    """x, da (negative log-decay), Bm, Cm, dy; the distributions of the JAX
    package's block-kernel tests."""
    x = rng.normal(size=(B, S, H, P)).astype(np.float32)
    da = -np.log1p(np.exp(rng.normal(size=(B, S, H)))).astype(np.float32)
    Bm = (rng.normal(size=(B, S, N)) * 0.5).astype(np.float32)
    Cm = (rng.normal(size=(B, S, N)) * 0.5).astype(np.float32)
    dy = rng.normal(size=(B, S, H, P)).astype(np.float32)
    return x, da, Bm, Cm, dy


def _gates(rng):
    """Every op present: (g_f, g_b) with g_b <= g_f."""
    ops_ = rng.permutation(np.arange(B * H) % 3).reshape(B, H)
    return ((ops_ != 2).astype(np.float32), (ops_ == 0).astype(np.float32))


@pytest.mark.parametrize("S", [24, 21])
@pytest.mark.parametrize("bounds", ["live", "all"])
def test_plain_version_matches_jax_kernel(S, bounds):
    rng = np.random.default_rng(S + len(bounds))
    x, da, Bm, Cm, dy = _operands(rng, S)
    g_f, g_b = _gates(rng)
    live = (int(g_f.sum()), int(g_b.sum())) if bounds == "live" \
        else (B * H, B * H)
    assert live[0] < B * H or bounds == "all"

    tx, tda, tB, tC = (torch.tensor(a, requires_grad=True)
                       for a in (x, da, Bm, Cm))
    y = ops.gated_ssd_scan(tx, tda, tB, tC, torch.from_numpy(g_f),
                           torch.from_numpy(g_b), chunk=CHUNK,
                           live_fwd=live[0], live_bwd=live[1])
    y.backward(torch.from_numpy(dy))
    mine = [y.detach().numpy()] + [t.grad.numpy()
                                   for t in (tx, tda, tB, tC)]

    def jax_kernel(x, da, Bm, Cm):
        return jax_ops.gated_ssd_scan(x, da, Bm, Cm, jnp.asarray(g_f),
                                      jnp.asarray(g_b), chunk=CHUNK,
                                      live_fwd=live[0], live_bwd=live[1],
                                      interpret=True)

    jy, vjp = jax.vjp(jax_kernel, *map(jnp.asarray, (x, da, Bm, Cm)))
    theirs = [np.asarray(jy)] + [np.asarray(g)
                                 for g in vjp(jnp.asarray(dy))]
    np.testing.assert_allclose(mine[0], theirs[0], atol=FWD_TOL, rtol=0)
    for name, a, b in zip(("dx", "ddA", "dB", "dC"), mine[1:], theirs[1:]):
        np.testing.assert_allclose(a, b, atol=GRAD_TOL, rtol=0,
                                   err_msg=name)
    # exact zeros: y on g_f == 0 heads, dx and ddA on g_b == 0 heads
    assert np.all(mine[0].transpose(0, 2, 1, 3)[g_f == 0] == 0)
    assert np.all(mine[1].transpose(0, 2, 1, 3)[g_b == 0] == 0)
    assert np.all(mine[2].transpose(0, 2, 1)[g_b == 0] == 0)


@pytest.mark.parametrize("S", [24, 21])
def test_prevs_match_jax_kernel_residual(S):
    """The forward kernel's second output, the state entering each chunk,
    on the padded length, zeros on g_f == 0 slices."""
    rng = np.random.default_rng(100 + S)
    x, da, Bm, Cm, _ = _operands(rng, S)
    g_f, _ = _gates(rng)
    Q, Sp = ops._scan_pad(S, CHUNK)
    pad = ((0, 0), (0, Sp - S))
    xp = np.pad(x, pad + ((0, 0), (0, 0)))
    dap = np.pad(da, pad + ((0, 0),))
    Bp, Cp = (np.pad(a, pad + ((0, 0),)) for a in (Bm, Cm))
    _, jprevs = jax_ssd._forward(*map(jnp.asarray, (xp, dap, Bp, Cp)),
                                 jnp.asarray(g_f), chunk=Q, interpret=True,
                                 live=int(g_f.sum()))
    mine = d2ft_ssd.gated_ssd_prevs_ref(
        *map(torch.from_numpy, (xp, dap, Bp, Cp)), torch.from_numpy(g_f),
        chunk=Q)
    assert tuple(mine.shape) == (B * H, Sp // Q, P, N)
    np.testing.assert_allclose(mine.numpy(), np.asarray(jprevs),
                               atol=FWD_TOL, rtol=0)
    assert np.all(mine.numpy()[g_f.reshape(-1) == 0] == 0)


def test_masked_path_gradient_stays_finite_where_decay_overflows():
    """A chunk whose decay sums past ~88 overflows exp above the diagonal;
    the plain version's where-before-exp keeps its gradient finite (the
    JAX package's where-after-exp gives NaN ddA there), and its values
    equal the JAX kernel's."""
    S, chunk = 64, 64
    rng = np.random.default_rng(7)
    x, _, Bm, Cm, dy = _operands(rng, S)
    da = np.full((B, S, H), -3.0, np.float32)
    g = np.ones((B, H), np.float32)
    tx, tda = (torch.tensor(a, requires_grad=True) for a in (x, da))
    y = d2ft_ssd.gated_ssd_ref(tx, tda, torch.from_numpy(Bm),
                               torch.from_numpy(Cm), torch.from_numpy(g),
                               torch.from_numpy(g), chunk=chunk)
    y.backward(torch.from_numpy(dy))
    assert torch.isfinite(tda.grad).all() and torch.isfinite(tx.grad).all()
    jy, vjp = jax.vjp(
        lambda x, da: jax_ops.gated_ssd_scan(
            x, da, jnp.asarray(Bm), jnp.asarray(Cm), jnp.asarray(g),
            chunk=chunk, interpret=True), jnp.asarray(x), jnp.asarray(da))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               atol=FWD_TOL, rtol=0)
    np.testing.assert_allclose(tda.grad.numpy(),
                               np.asarray(vjp(jnp.asarray(dy))[1]),
                               atol=GRAD_TOL, rtol=0)


def test_gb_gt_gf_rejected():
    rng = np.random.default_rng(0)
    x, da, Bm, Cm, _ = (torch.from_numpy(a) for a in _operands(rng, 16))
    g_f = torch.ones((B, H))
    g_f[0, 1] = 0.0
    with pytest.raises(ValueError, match="g_b <= g_f"):
        ops.gated_ssd_scan(x, da, Bm, Cm, g_f, torch.ones((B, H)), chunk=8)


def test_undersized_live_bound_rejected():
    rng = np.random.default_rng(0)
    x, da, Bm, Cm, _ = (torch.from_numpy(a) for a in _operands(rng, 16))
    g = torch.ones((B, H))
    with pytest.raises(ValueError, match="live_fwd"):
        ops.gated_ssd_scan(x, da, Bm, Cm, g, g, chunk=8, live_fwd=B * H - 1)
    with pytest.raises(ValueError, match="live_bwd"):
        ops.gated_ssd_scan(x, da, Bm, Cm, g, g, chunk=8, live_bwd=3)


@pytest.mark.parametrize("S", [24, 21, 2048])
def test_flop_accounting_matches_jax(S):
    rng = np.random.default_rng(S)
    g_f, g_b = _gates(rng)
    for chunk, p, n in ((CHUNK, P, N), (256, 64, 128)):
        assert d2ft_ssd.gated_ssd_flops(g_f, g_b, S, p, n, chunk=chunk) == \
            jax_ssd.gated_ssd_flops(g_f, g_b, S, p, n, chunk=chunk)


def test_needed_work_counts_cb_once_per_sample():
    """The bound's operation count: CB once per (sample, chunk) of a sample
    with a live head, the causal half of each Q x Q product; so it is below
    the JAX package's executed count, which has CB per (slice, chunk) on
    full tiles."""
    g = np.ones((8, 24), np.float32)
    S, Pm, Nm, Q = 2048, 64, 128, 256
    fwd, bwd = d2ft_ssd.needed_flops(g, g, S, Pm, Nm, chunk=Q)
    tri = Q * (Q + 1) // 2
    nc = S // Q
    assert fwd == 8 * 24 * nc * 2 * (tri * Pm + 2 * Q * Pm * Nm) \
        + 8 * nc * 2 * tri * Nm
    jf, jb = jax_ssd.gated_ssd_flops(g, g, S, Pm, Nm, chunk=Q)
    assert fwd < jf and bwd < jb
    g[3] = 0.0                                  # a sample with no live head
    assert d2ft_ssd.needed_flops(g, g, S, Pm, Nm, chunk=Q)[0] < fwd
    g = np.ones((8, 24), np.float32)
    fb, bb = d2ft_ssd.needed_bytes(g, g, S, Pm, Nm, chunk=Q)
    # every slice live: x, da, B, C read and y, prevs written once forward;
    # x, da, B, C, prevs, dy read and dx, ddA, dB, dC written once backward
    state = nc * Pm * Nm
    assert fb == 4 * (8 * 24 * (S * Pm + S + S * Pm + state) + 8 * 2 * S * Nm)
    assert bb == 4 * (8 * 24 * (2 * S * Pm + S + state + S * Pm + S)
                      + 8 * 2 * S * Nm + 8 * 2 * S * Nm)


def test_counter_kinds_include_ssd_steps():
    tc = contract.TileCounter("cpu")
    assert tc.read() == {"fwd": 0, "bwd_dkdv": 0, "bwd_dq": 0,
                         "ssd_fwd": 0, "ssd_bwd": 0}
