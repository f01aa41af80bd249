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
from repro.kernels import ref as jax_ref
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
                         "ssd_fwd": 0, "ssd_bwd": 0, "rglru_fwd": 0,
                         "rglru_bwd": 0, "moe_fwd": 0, "moe_bwd": 0}


# ------------------------------------------- the CUDA kernels, emulated
def _tf32(x):
    """``cvt.rna.tf32.f32``'s rounding, on float32 bits (the kernels'
    split): 10 mantissa bits, to nearest, ties away from zero."""
    bits = np.ascontiguousarray(x, np.float32).view(np.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(np.float32)


def _tf32_read(x):
    """A float32 as the tensor core reads a tf32 operand."""
    bits = np.ascontiguousarray(x, np.float32).view(np.int32)
    return (bits & ~0x1FFF).view(np.float32)


def _ksteps(acc, a, b):
    """acc + a @ b the way ``tf32x3::mma3`` takes it: per k-step of 8, the
    split operands' three products (small·big, big·small, big·big) into a
    fresh float32 accumulator, added to acc in IEEE float32, in k order."""
    acc = np.array(acc, np.float32)
    for k in range(0, a.shape[1], 8):
        ak, bk = a[:, k:k + 8], b[k:k + 8]
        a_big, b_big = _tf32(ak), _tf32(bk)
        t = (_tf32_read(ak - a_big) @ b_big + a_big @ _tf32_read(bk - b_big)
             + a_big @ b_big)
        acc = (acc + t).astype(np.float32)
    return acc


def _kernels_emulated(x, da, Bm, Cm, dy, g, Q, group):
    """y, prevs, dx, ddA, dB, dC as the CUDA kernels compute them, every
    slice live, in their order: the in-chunk decays summed in float32 row
    by row; C.B^T once per (sample, chunk); the chunk states, the pass
    over chunks, y = (C.B^T o L) x + e^cum C prev^T; backward the state
    cotangents and their reverse pass, the q role's dC (summed over the
    heads of a group in one accumulator, in head order) and dcum row
    parts, the k role's dB (likewise), dx and column parts, ddA's reverse
    cumulative sum in float64, and the groups' dB / dC partials summed in
    group order in float64. Every product by ``_ksteps``."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    nc = S // Q
    f32 = np.float32
    y = np.zeros_like(x)
    prevs = np.zeros((Bsz * H, nc, P, N), f32)
    dx, dda = np.zeros_like(x), np.zeros_like(da)
    dB, dC = np.zeros_like(Bm), np.zeros_like(Cm)
    causal = np.tril(np.ones((Q, Q), bool))
    for b in range(Bsz):
        cum = np.stack([np.cumsum(da[b, c * Q:(c + 1) * Q], axis=0,
                                  dtype=f32) for c in range(nc)])
        rows = [slice(c * Q, (c + 1) * Q) for c in range(nc)]
        Cc = [Cm[b, r] for r in rows]
        Bc = [Bm[b, r] for r in rows]
        CB = [_ksteps(np.zeros((Q, Q)), Cc[c], Bc[c].T) for c in range(nc)]
        L = [np.where(causal[:, :, None], np.exp(np.where(
            causal[:, :, None], cum[c][:, None] - cum[c][None], 0), dtype=f32),
            f32(0)) for c in range(nc)]                     # [Q, Q, H]
        parts_b, parts_c = [], []
        for h0 in range(0, H, group):
            acc_b = [np.zeros((Q, N), f32) for _ in range(nc)]
            acc_c = [np.zeros((Q, N), f32) for _ in range(nc)]
            for h in range(h0, min(H, h0 + group)):
                s = b * H + h
                if g[b, h] == 0:
                    continue
                xs = [x[b, r, h] for r in rows]
                dys = [dy[b, r, h] for r in rows]
                tot = [cum[c][-1, h] for c in range(nc)]
                d2e = [np.exp(tot[c] - cum[c][:, h], dtype=f32)
                       for c in range(nc)]
                e = [np.exp(cum[c][:, h], dtype=f32) for c in range(nc)]
                run = np.zeros((P, N), f32)
                for c in range(nc):                    # forward
                    st = _ksteps(np.zeros((P, N)), (xs[c] * d2e[c][:, None]).T,
                                 Bc[c])
                    prevs[s, c] = run
                    run = (run * np.exp(tot[c], dtype=f32) + st).astype(f32)
                    yi = _ksteps(np.zeros((Q, P)), Cc[c], prevs[s, c].T)
                    ya = _ksteps(np.zeros((Q, P)), CB[c] * L[c][:, :, h],
                                 xs[c])
                    y[b, rows[c], h] = ya + yi * e[c][:, None]
                ds = np.zeros((nc, P, N), f32)
                run = np.zeros((P, N), f32)
                for c in range(nc - 1, -1, -1):       # state cotangents
                    v = _ksteps(np.zeros((P, N)), (dys[c] * e[c][:, None]).T,
                                Cc[c])
                    ds[c] = run
                    run = (np.exp(tot[c], dtype=f32) * run + v).astype(f32)
                for c in range(nc):                    # the chunk's rows
                    Lh = L[c][:, :, h]
                    yi = _ksteps(np.zeros((Q, P)), Cc[c], prevs[s, c].T)
                    rowp = np.sum(dys[c] * (yi * e[c][:, None]), axis=1,
                                  dtype=np.float64)
                    acc_c[c] = _ksteps(acc_c[c], dys[c] * e[c][:, None],
                                       prevs[s, c])
                    t = _ksteps(np.zeros((Q, Q)), dys[c], xs[c].T) * Lh
                    rowp += np.sum(t * CB[c], axis=1, dtype=np.float64)
                    acc_c[c] = _ksteps(acc_c[c], t, Bc[c])
                    z = _ksteps(np.zeros((Q, P)), Bc[c], ds[c].T)
                    w = (np.sum(z * xs[c], axis=1, dtype=f32) * d2e[c]
                         ).astype(np.float64)
                    acc_b[c] = _ksteps(acc_b[c], xs[c] * d2e[c][:, None],
                                       ds[c])
                    tk = _ksteps(np.zeros((Q, Q)), xs[c], dys[c].T) * Lh.T
                    colp = np.sum(tk * CB[c].T, axis=1, dtype=np.float64)
                    acc_b[c] = _ksteps(acc_b[c], tk, Cc[c])
                    dx[b, rows[c], h] = _ksteps(z * d2e[c][:, None],
                                                (CB[c] * Lh).T, dys[c])
                    dsprev = np.sum(ds[c].astype(np.float64)
                                    * prevs[s, c].astype(np.float64))
                    dtot = float(np.exp(tot[c], dtype=f32)) * dsprev \
                        + np.sum(w)
                    dcum = rowp - colp - w
                    dda[b, rows[c], h] = (np.cumsum(dcum[::-1])[::-1]
                                          + dtot).astype(f32)
            parts_b.append(np.concatenate(acc_b))
            parts_c.append(np.concatenate(acc_c))
        dB[b] = np.sum(np.stack(parts_b).astype(np.float64), axis=0)
        dC[b] = np.sum(np.stack(parts_c).astype(np.float64), axis=0)
    return y, prevs, dx, dda, dB, dC


@pytest.mark.parametrize("p,n", [(16, 16), (64, 128)])
def test_kernel_arithmetic_emulated_matches_jax(p, n):
    """The CUDA kernels' 3xTF32 products and summation order, emulated in
    numpy on two live slices of one sample over two chunks of Q 64 (so the
    inter-chunk terms and the head sum of dB / dC take part), against
    ``ref.gated_ssd_ref`` under ``jax.jit`` (y and the gradients) and the
    JAX forward kernel in interpret mode (prevs), each within 1e-5
    (forward) or 1e-4 (gradients) x max(1, max |reference|)."""
    rng = np.random.default_rng(p + n)
    Bsz, Hh, S, Q = 1, 2, 128, 64
    x = rng.normal(size=(Bsz, S, Hh, p)).astype(np.float32)
    da = -np.log1p(np.exp(rng.normal(size=(Bsz, S, Hh)))).astype(np.float32)
    Bm = (rng.normal(size=(Bsz, S, n)) * 0.5).astype(np.float32)
    Cm = (rng.normal(size=(Bsz, S, n)) * 0.5).astype(np.float32)
    dy = rng.normal(size=(Bsz, S, Hh, p)).astype(np.float32)
    g = np.ones((Bsz, Hh), np.float32)
    mine = _kernels_emulated(x, da, Bm, Cm, dy, g, Q, d2ft_ssd.HEAD_GROUP)

    fn = jax.jit(lambda *a: jax_ref.gated_ssd_ref(
        *a, jnp.asarray(g), jnp.asarray(g), chunk=Q))
    jy, vjp = jax.vjp(fn, *map(jnp.asarray, (x, da, Bm, Cm)))
    _, jprevs = jax_ssd._forward(*map(jnp.asarray, (x, da, Bm, Cm)),
                                 jnp.asarray(g), chunk=Q, interpret=True)
    theirs = [np.asarray(jy), np.asarray(jprevs)] + [
        np.asarray(t) for t in vjp(jnp.asarray(dy))]
    for name, a, r, tol in zip(("y", "prevs", "dx", "ddA", "dB", "dC"),
                               mine, theirs, (FWD_TOL,) * 2 + (GRAD_TOL,) * 4):
        scale = max(1.0, float(np.abs(r).max()))
        np.testing.assert_allclose(a, r, atol=tol * scale, rtol=0,
                                   err_msg=name)


def _runs_mask_emulation(gate, n_disp, s0, cnt, threads=256):
    """``gating::runs_mask`` (``csrc/slice_gate.cuh``): which of slices
    s0 .. s0 + cnt - 1 a backward block runs, from one block-wide count of
    the live gates before s0 (in chunks of one block's threads) and a walk
    over its own."""
    n = len(gate)
    before = 0 if n_disp >= n else sum(
        int(np.count_nonzero(gate[i0:min(i0 + threads, s0)]))
        for i0 in range(0, s0, threads))
    runs = set()
    for s in range(s0, s0 + cnt):
        if gate[s] != 0 and (n_disp >= n or before < n_disp):
            runs.add(s)
        before += gate[s] != 0
    return runs


@pytest.mark.parametrize("n_live,bound", [(40, 12), (40, 40), (40, 55),
                                          (300, 170), (300, None)])
def test_kernel_run_rule_runs_the_compaction_tables_live_slices(n_live,
                                                                bound):
    """The slices the SSD kernels run, each block (a slice's, or a head
    group's walking its heads in order) deciding from the gates, are the
    live slices among the first n_disp entries of ``live_permutation``,
    for bounds below, at and above the live count; B 16 x H 24 crosses a
    block's 256 threads."""
    rng = np.random.default_rng(n_live + (bound or 0))
    Bsz, Hh = 16, 24
    gate = np.zeros(Bsz * Hh, np.float32)
    gate[rng.choice(Bsz * Hh, n_live, replace=False)] = 1.0
    n_disp = contract.dispatch_count(bound, Bsz * Hh)
    perm = contract.live_permutation(torch.from_numpy(gate), n_disp).numpy()
    want = {int(s) for s in perm if gate[s] != 0}
    groups = set()
    for b in range(Bsz):
        for h0 in range(0, Hh, d2ft_ssd.HEAD_GROUP):
            cnt = min(d2ft_ssd.HEAD_GROUP, Hh - h0)
            groups |= _runs_mask_emulation(gate, n_disp, b * Hh + h0, cnt)
    single = set()
    for s in range(Bsz * Hh):
        single |= _runs_mask_emulation(gate, n_disp, s, 1)
    assert groups == single == want
    assert len(want) == min(n_disp, n_live)
