"""Gated RG-LRU scan and block of the PyTorch port against the JAX package,
on the CPU: the port's plain version (what the CUDA kernels are held
against on the card) vs the Pallas kernels in interpret mode and the JAX
plain version, the ungated doubling scan vs ``jax.lax.associative_scan``,
the block and its init, the accounting the two packages share, the gate
checks, the W % G refusal and the hybrid layout's weight carry-over; and
the CUDA kernels' own order, emulated: their segment-and-combine
arithmetic against jitted JAX, and the slices they run, each block
deciding for its own from the gates, against JAX's compaction
permutation.

Scan shapes B 2, W 128 (the recurrentgemma smoke config's LRU width),
chunk 8, at S 24 and at S 21 (the pad path), G 1 and 4; random p_f / p_o /
p_s gates, compaction bounds at the live counts and at B·G. Operands from
numpy seeds, in the JAX block-kernel tests' distributions (la =
-softplus(N(0, 1)), b and the cotangent N(0, 1)), go through both
packages. Tolerances, float32: h 1e-5, dla and db 1e-4 (JAX's own kernel
tolerance, ``tests/test_block_kernels.py``), the doubling scan 1e-5.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import recurrentgemma_2b as jax_rg
from repro.configs.base import RGLRUConfig as JaxRGLRUConfig
from repro.kernels import contract as jax_contract
from repro.kernels import d2ft_rglru as jax_rglru
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.models import rglru as jax_rglru_mod
from repro.models.transformer import forward as jax_forward
from repro.models.transformer import init_model as jax_init_model
from repro_torch.configs import recurrentgemma_2b
from repro_torch.configs.base import RGLRUConfig
from repro_torch.interop import params_from_jax
from repro_torch.kernels import contract, d2ft_rglru, ops
from repro_torch.models import rglru
from repro_torch.models.transformer import forward, init_model

FWD_TOL = 1e-5
GRAD_TOL = 1e-4
B, W, CHUNK = 2, 128, 8


def _operands(rng, S, width=W):
    la = -np.log1p(np.exp(rng.normal(size=(B, S, width)))).astype(np.float32)
    b = rng.normal(size=(B, S, width)).astype(np.float32)
    dy = rng.normal(size=(B, S, width)).astype(np.float32)
    return la, b, dy


def _gates(rng, G):
    """(g_f, g_b) with g_b <= g_f; every op present when B·G >= 3."""
    ops_ = rng.permutation(np.arange(B * G) % 3).reshape(B, G)
    return ((ops_ != 2).astype(np.float32), (ops_ == 0).astype(np.float32))


def _gated_scan_f64(la, b, dy, g_f, g_b):
    """The gated scan and its gradients in float64, row by row: h_t =
    exp(la_t) h_{t-1} + b_t per channel, times g_f per band; the cotangent
    reaches only g_b != 0 bands (g_b <= g_f). Returns [h, dla, db]."""
    Bsz, S, Wd = la.shape
    G = g_f.shape[1]
    band = np.repeat(np.arange(G), Wd // G)
    a = np.exp(la.astype(np.float64))
    h = np.zeros((Bsz, S, Wd))
    prev = np.zeros((Bsz, Wd))
    for t in range(S):
        prev = a[:, t] * prev + b[:, t]
        h[:, t] = prev
    g = np.zeros((Bsz, S, Wd))
    carry = np.zeros((Bsz, Wd))
    dyb = dy.astype(np.float64) * g_b[:, band][:, None, :]
    for t in range(S - 1, -1, -1):
        carry = dyb[:, t] + carry
        g[:, t] = carry
        carry = a[:, t] * carry
    h_prev = np.concatenate([np.zeros((Bsz, 1, Wd)), h[:, :-1]], axis=1)
    return [h * g_f[:, band][:, None, :], g * a * h_prev, g]


@pytest.mark.parametrize("S", [24, 21])
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("bounds", ["live", "all"])
def test_plain_version_matches_jax_kernel_and_ref(S, G, bounds):
    rng = np.random.default_rng(S + 10 * G + len(bounds))
    la, b, dy = _operands(rng, S)
    g_f, g_b = _gates(rng, G)
    live = (int(g_f.sum()), int(g_b.sum())) if bounds == "live" \
        else (B * G, B * G)

    tla, tb = (torch.tensor(a, requires_grad=True) for a in (la, b))
    h = ops.gated_rglru_scan(tla, tb, torch.from_numpy(g_f),
                             torch.from_numpy(g_b), chunk=CHUNK,
                             live_fwd=live[0], live_bwd=live[1])
    h.backward(torch.from_numpy(dy))
    mine = [h.detach().numpy(), tla.grad.numpy(), tb.grad.numpy()]

    def jax_kernel(la, b):
        return jax_ops.gated_rglru_scan(la, b, jnp.asarray(g_f),
                                        jnp.asarray(g_b), chunk=CHUNK,
                                        live_fwd=live[0], live_bwd=live[1],
                                        interpret=True)

    Q, Sp = ops._scan_pad(S, CHUNK)

    def jax_plain(la, b):
        pad = ((0, 0), (0, Sp - S), (0, 0))
        return jax_ref.gated_rglru_ref(jnp.pad(la, pad), jnp.pad(b, pad),
                                       jnp.asarray(g_f), jnp.asarray(g_b),
                                       chunk=Q)[:, :S]

    sides = {"the port's plain version": mine}
    for name, fn in (("the JAX kernel (interpret)", jax_kernel),
                     ("jax_ref.gated_rglru_ref", jax_plain)):
        jy, vjp = jax.vjp(fn, jnp.asarray(la), jnp.asarray(b))
        sides[name] = [np.asarray(jy)] + [np.asarray(g)
                                          for g in vjp(jnp.asarray(dy))]
    # each side against a float64 evaluation of the same scan first, so
    # that a failure names the side that drifted
    exact = _gated_scan_f64(la, b, dy, g_f, g_b)
    for side, outs in sides.items():
        for what, a, r, tol in zip(("h", "dla", "db"), outs, exact,
                                   (FWD_TOL, GRAD_TOL, GRAD_TOL)):
            np.testing.assert_allclose(
                a, r, atol=tol, rtol=0,
                err_msg=f"{side} vs the float64 scan: {what}")
    for theirs in list(sides.values())[1:]:
        np.testing.assert_allclose(mine[0], theirs[0], atol=FWD_TOL, rtol=0)
        for name, a, c in zip(("dla", "db"), mine[1:], theirs[1:]):
            np.testing.assert_allclose(a, c, atol=GRAD_TOL, rtol=0,
                                       err_msg=name)
    # exact zeros: h on g_f == 0 bands, dla and db on g_b == 0 bands
    Wg = W // G
    for out, gate in ((mine[0], g_f), (mine[1], g_b), (mine[2], g_b)):
        bands = out.reshape(B, S, G, Wg).transpose(0, 2, 1, 3)
        assert np.all(bands[gate == 0] == 0)


@pytest.mark.parametrize("precision", ["high", "medium"])
def test_plain_scan_takes_no_matmul_setting(precision):
    """The plain version's h does not depend on the process's float32
    matmul setting: with its in-chunk sum as a batched matmul, "medium"
    (bf16 products on a CPU with bf16 units) moved h by ~1.3e-2 against
    the float64 scan (ROADMAP §C). It is bitwise the result under the
    default setting and within 1e-5 of the float64 scan."""
    rng = np.random.default_rng(34)
    la, b, dy = _operands(rng, 24)
    ones = np.ones((B, 1), np.float32)

    def scan():
        return d2ft_rglru.rglru_scan_ref(torch.from_numpy(la),
                                         torch.from_numpy(b), CHUNK)
    want = scan()
    old = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision(precision)
        got = scan()
    finally:
        torch.set_float32_matmul_precision(old)
    assert torch.equal(got, want)
    np.testing.assert_allclose(got.numpy(),
                               _gated_scan_f64(la, b, dy, ones, ones)[0],
                               atol=FWD_TOL, rtol=0)


# The CUDA kernels' tile geometry (csrc/d2ft_rglru_common.cuh): each
# thread folds KERNEL_ROWS rows, a warp holds 32 / 8 = 4 segments of each
# of its 8 channel columns, a block 8 warps: tiles of 4 x 4 x 8 = 128 rows
KERNEL_ROWS, KERNEL_SEGS_PER_WARP, KERNEL_WARPS = 4, 4, 8


def _fma(a, b, c):
    """fmaf in float32 (the product exact in float64, one rounding of the
    sum but for double rounding's rare ulp)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def _kernel_tile(a, x, carry, reverse):
    """One tile of the RG-LRU kernels' arithmetic over [rows, C] float32
    operands (a = exp(la)): each segment of KERNEL_ROWS rows folded into a
    map (A, C) from a zero start; the segments of a warp combined by a
    Kogge-Stone scan (from the right in the backward); each warp's total
    folded in order onto the tile's entering ``carry`` for the warps after
    it (before it, backward); each segment's rows walked again from its
    entering state. Forward: the rows' h. Backward (x = dy): the rows' g,
    the cotangent of h, which is db. Returns (rows' outputs, the carry
    the tile passes on)."""
    R, S_, W_ = KERNEL_ROWS, KERNEL_SEGS_PER_WARP, KERNEL_WARPS
    C = a.shape[1]
    a = a.reshape(W_ * S_, R, C)
    x = x.reshape(W_ * S_, R, C)
    rows = range(R - 1, -1, -1) if reverse else range(R)
    A = np.ones((W_ * S_, C), np.float32)
    M = np.zeros((W_ * S_, C), np.float32)
    for i in rows:
        A = A * a[:, i]
        M = a[:, i] * (x[:, i] + M) if reverse else _fma(a[:, i], M, x[:, i])
    A, M = A.reshape(W_, S_, C), M.reshape(W_, S_, C)
    off = 1
    while off < S_:                                  # Kogge-Stone
        A2, M2 = A.copy(), M.copy()
        for j in range(S_):
            src = j + off if reverse else j - off
            if 0 <= src < S_:
                M2[:, j] = _fma(A[:, j], M[:, src], M[:, j])
                A2[:, j] = A[:, j] * A[:, src]
        A, M = A2, M2
        off *= 2
    total = 0 if reverse else -1                     # a warp's whole map
    order = range(W_ - 1, -1, -1) if reverse else range(W_)
    nxt = carry
    for w in order:
        nxt = _fma(A[w, total], nxt, M[w, total])
    out = np.empty((W_ * S_, R, C), np.float32)
    for w in range(W_):
        hs = carry
        for w2 in order:
            if (w2 > w) if reverse else (w2 < w):
                hs = _fma(A[w2, total], hs, M[w2, total])
        for j in range(S_):
            prev = j + 1 if reverse else j - 1
            k = _fma(A[w, prev], hs, M[w, prev]) if 0 <= prev < S_ else hs
            for i in rows:
                if reverse:
                    out[w * S_ + j, i] = x[w * S_ + j, i] + k
                    k = a[w * S_ + j, i] * out[w * S_ + j, i]
                else:
                    k = _fma(a[w * S_ + j, i], k, x[w * S_ + j, i])
                    out[w * S_ + j, i] = k
    return out.reshape(-1, C), nxt


def kernel_emulation(la, b, dy):
    """h, dla, db of one slice's channels [S, C] as the kernels compute
    them: the sequence in tiles (the last one's rows past S the identity
    map), the forward from the first tile, the backward from the last,
    dla = g · a · h_{t-1}."""
    S, C = la.shape
    tile = KERNEL_ROWS * KERNEL_SEGS_PER_WARP * KERNEL_WARPS
    Sp = -(-S // tile) * tile

    def pad(t):
        return np.concatenate([t, np.zeros((Sp - S, C), np.float32)])
    a = np.exp(pad(la)).astype(np.float32)
    h = np.empty((Sp, C), np.float32)
    g = np.empty((Sp, C), np.float32)
    carry = np.zeros(C, np.float32)
    for t0 in range(0, Sp, tile):
        h[t0:t0 + tile], carry = _kernel_tile(
            a[t0:t0 + tile], pad(b)[t0:t0 + tile], carry, False)
    carry = np.zeros(C, np.float32)
    for t0 in range(Sp - tile, -1, -tile):
        g[t0:t0 + tile], carry = _kernel_tile(
            a[t0:t0 + tile], pad(dy)[t0:t0 + tile], carry, True)
    h, g = h[:S], g[:S]
    h_prev = np.concatenate([np.zeros((1, C), np.float32), h[:-1]])
    return h, (a[:S] * g) * h_prev, g


def test_kernel_segment_order_matches_jax_ref():
    """The CUDA kernels' segment-and-combine order, emulated in float32,
    against jitted JAX ``gated_rglru_ref`` and its gradients at S 600
    (five 128-row tiles, the last ragged), G 4 under a p_f / p_o / p_s
    mix: h within 1e-5, dla and db within 1e-4; gated bands exact
    zeros."""
    rng = np.random.default_rng(21)
    S, G = 600, 4
    la, b, dy = _operands(rng, S, width=16)
    g_f, g_b = _gates(rng, G)
    f = jax.jit(lambda la, b: jax_ref.gated_rglru_ref(
        la, b, jnp.asarray(g_f), jnp.asarray(g_b), chunk=CHUNK))
    jy, vjp = jax.vjp(f, jnp.asarray(la), jnp.asarray(b))
    theirs = [np.asarray(t) for t in (jy, *vjp(jnp.asarray(dy)))]
    Wg = 16 // G
    mine = [np.zeros_like(la) for _ in range(3)]
    for s in range(B * G):
        i, j = divmod(s, G)
        band = slice(j * Wg, (j + 1) * Wg)
        h, dla, db = kernel_emulation(la[i, :, band], b[i, :, band],
                                      dy[i, :, band])
        if g_f[i, j]:
            mine[0][i, :, band] = h
        if g_b[i, j]:
            mine[1][i, :, band], mine[2][i, :, band] = dla, db
    for name, a, c, tol in zip(("h", "dla", "db"), mine, theirs,
                               (FWD_TOL, GRAD_TOL, GRAD_TOL)):
        np.testing.assert_allclose(a, c, atol=tol, rtol=0, err_msg=name)
    for out, gate in ((mine[0], g_f), (mine[1], g_b), (mine[2], g_b)):
        bands = out.reshape(B, S, G, Wg).transpose(0, 2, 1, 3)
        assert np.all(bands[gate == 0] == 0)


def slice_runs_emulation(gate, n_disp, s, threads=256):
    """``gating::slice_runs`` (``csrc/slice_gate.cuh``): whether block s
    (slice s) runs, its gate live and, under a dispatch bound, fewer than
    n_disp live gates before it, counted in chunks of one block's
    threads."""
    if gate[s] == 0:
        return False
    if n_disp >= len(gate):
        return True
    before = sum(int(np.count_nonzero(gate[i0:min(i0 + threads, s)]))
                 for i0 in range(0, s, threads))
    return before < n_disp


@pytest.mark.parametrize("n,live", [(8, None), (8, 3), (40, 30), (40, 40),
                                    (300, 120)])
def test_kernel_slice_rule_runs_the_compaction_tables_live_slices(n, live):
    """The slices the kernels run, each block deciding for its own slice
    from the gates (no table built by the launcher), are the live slices
    among the first n_disp entries of JAX's ``live_permutation``; every
    other block writes zeros. n 300 crosses a block's 256 threads; with
    gates 60 % live, bounds 3 and 120 fall below the live count."""
    rng = np.random.default_rng(n + (live or 0))
    gate = (rng.random(n) < 0.6).astype(np.float32)
    n_disp = contract.dispatch_count(live, n)
    perm = np.asarray(jax_contract.live_permutation(jnp.asarray(gate),
                                                    n_disp))
    runs = {s for s in range(n) if slice_runs_emulation(gate, n_disp, s)}
    assert runs == {int(s) for s in perm if gate[s] != 0}
    assert len(runs) == min(n_disp, int(np.count_nonzero(gate)))


def test_gb_zero_everywhere_gives_exact_zero_gradients():
    rng = np.random.default_rng(5)
    la, b, dy = _operands(rng, 21)
    g_f = np.ones((B, 4), np.float32)
    g_b = np.zeros((B, 4), np.float32)
    tla, tb = (torch.tensor(a, requires_grad=True) for a in (la, b))
    h = ops.gated_rglru_scan(tla, tb, torch.from_numpy(g_f),
                             torch.from_numpy(g_b), chunk=CHUNK)
    (h * torch.from_numpy(dy)).sum().backward()
    assert torch.count_nonzero(tla.grad) == 0
    assert torch.count_nonzero(tb.grad) == 0
    assert torch.count_nonzero(h) > 0


@pytest.mark.parametrize("S", [1, 21, 24, 64])
def test_doubling_scan_matches_associative_scan(S):
    """The ungated path's log-depth doubling scan against JAX's
    associative scan on the RG-LRU's own operands (a in (0, 1))."""
    rng = np.random.default_rng(S)
    la, b, _ = _operands(rng, S)
    a = np.exp(la)
    mine = rglru._assoc_scan(torch.from_numpy(a), torch.from_numpy(b))
    theirs = jax_rglru_mod._assoc_scan(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(mine.numpy(), np.asarray(theirs),
                               atol=FWD_TOL, rtol=0)


@functools.lru_cache(maxsize=None)
def _block(d_model=128):
    """JAX RG-LRU block params of the smoke width, seed 0, and the port's
    block with the same values."""
    cfg = jax_rg.smoke_config().rglru
    p = jax_rglru_mod.init_rglru(jax.random.PRNGKey(0), d_model, cfg,
                                 jnp.float32)
    mine = rglru.init_rglru(torch.Generator().manual_seed(0), d_model,
                            recurrentgemma_2b.smoke_config().rglru,
                            torch.float32)
    with torch.no_grad():
        for name, t in mine.named_parameters():
            t.copy_(torch.from_numpy(np.array(p[name])))
    return p, mine


@pytest.mark.parametrize("gated", [False, True])
def test_apply_rglru_matches_jax(gated):
    """The block's output and its gradients, ungated (the doubling scan)
    and gated on the masked path, at S 21."""
    p, mine = _block()
    cfg = jax_rg.smoke_config().rglru
    rng = np.random.default_rng(11 + gated)
    x = rng.normal(size=(B, 21, 128)).astype(np.float32)
    dy = rng.normal(size=(B, 21, 128)).astype(np.float32)
    gates = _gates(rng, 4) if gated else None

    def jfn(p, x):
        g = None if gates is None else tuple(map(jnp.asarray, gates))
        return jax_rglru_mod.apply_rglru(p, x, cfg, gates=g)

    jy, vjp = jax.vjp(jfn, p, jnp.asarray(x))
    jgp, jgx = vjp(jnp.asarray(dy))
    tx = torch.tensor(x, requires_grad=True)
    tg = None if gates is None else tuple(map(torch.from_numpy, gates))
    for t in mine.parameters():
        t.grad = None
    y = rglru.apply_rglru(mine, tx, recurrentgemma_2b.smoke_config().rglru,
                          gates=tg)
    y.backward(torch.from_numpy(dy))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               atol=FWD_TOL, rtol=0)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx),
                               atol=FWD_TOL, rtol=0)
    for name, t in mine.named_parameters():
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jgp[name]),
                                   atol=FWD_TOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("width", [128, 2560])
def test_lambda_init_matches_jax(width):
    """Lambda = log(expm1(-log(linspace(0.9, 0.999, W)) / 8)) in float32.
    JAX's jitted float32 linspace lands an ulp away from torch's on about a
    quarter of the entries, and d Lambda / d lin ~ -1 / (8 lin y) with y =
    -log(lin) / 8 magnifies that ulp about a thousandfold near 0.999; the
    decays the model uses, a = exp(-8 softplus(Lambda)), agree within
    1e-6, Lambda itself within 1e-4."""
    p = jax.jit(jax_rglru_mod.init_rglru, static_argnums=(1, 2, 3))(
        jax.random.PRNGKey(0), 64, JaxRGLRUConfig(lru_width=width),
        jnp.float32)
    theirs = np.asarray(p["Lambda"])
    mine = rglru.lambda_init(width).numpy()
    np.testing.assert_allclose(mine, theirs, atol=1e-4, rtol=0)

    def decay(lam):
        return np.exp(-8.0 * np.logaddexp(lam.astype(np.float64), 0.0))
    np.testing.assert_allclose(decay(mine), decay(theirs), atol=1e-6,
                               rtol=0)
    model = rglru.init_rglru(torch.Generator().manual_seed(0), 64,
                             RGLRUConfig(lru_width=width), torch.float32)
    assert torch.equal(model.Lambda.detach(), rglru.lambda_init(width))


def test_params_from_jax_carries_the_hybrid_layout():
    """8 layers at the smoke widths: 2 cycles of (RG-LRU, RG-LRU, local
    attention) stacked in ``cycles`` and 2 RG-LRU layers in ``rest`` —
    recurrentgemma-2b's layout (8 cycles, then rest/0-1 as layers 24-25)
    at a quarter of its depth. Cycle c, position j -> layer 3c + j; rest i
    -> layer 6 + i; every port parameter covered with the JAX leaf's
    values, and both packages count the same parameters."""
    jcfg = jax_rg.smoke_config().replace(n_layers=8)
    params = jax.jit(jax_init_model, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, params)
    assert len(tree["cycles"]) == 3 and len(tree["rest"]) == 2
    cfg = recurrentgemma_2b.smoke_config().replace(n_layers=8)
    model = init_model(torch.Generator().manual_seed(0), cfg)
    state = params_from_jax(tree)
    assert set(state) == set(model.state_dict())
    model.load_state_dict(state)
    assert cfg.layer_kinds == ("rglru", "rglru", "attn_local") * 2 + \
        ("rglru", "rglru")
    for i, kind in enumerate(cfg.layer_kinds):
        c, j = divmod(i, 3)
        src = tree["cycles"][j] if c < 2 else tree["rest"][i - 6]
        pick = (lambda a: a[c]) if c < 2 else (lambda a: a)
        if kind == "rglru":
            for leaf in ("w_a", "conv_w", "Lambda", "w_out"):
                np.testing.assert_array_equal(
                    getattr(model.layers[i].rglru, leaf).detach().numpy(),
                    pick(src["rglru"][leaf]))
        else:
            np.testing.assert_array_equal(
                model.layers[i].attn.wq.detach().numpy(),
                pick(src["attn"]["wq"]))
        np.testing.assert_array_equal(
            model.layers[i].mlp.w_down.detach().numpy(),
            pick(src["mlp"]["w_down"]))
    n_jax = sum(int(a.size) for a in jax.tree.leaves(tree))
    assert sum(t.numel() for t in model.parameters()) == n_jax


def test_full_config_counts_3_549_934_080_parameters():
    """recurrentgemma-2b at full width and depth, counted from the JAX
    ``init_model``'s shapes without materialising them."""
    shapes = jax.eval_shape(lambda k: jax_init_model(k, jax_rg.CONFIG),
                            jax.random.PRNGKey(0))
    assert sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes)) \
        == 3_549_934_080
    assert recurrentgemma_2b.CONFIG.layer_kinds.count("rglru") == 18


def test_width_not_divisible_rejected():
    rng = np.random.default_rng(0)
    la, b, _ = (torch.from_numpy(a) for a in _operands(rng, 16, width=9))
    g = torch.ones((B, 2))
    with pytest.raises(ValueError, match="not divisible by G=2"):
        ops.gated_rglru_scan(la, b, g, g, chunk=8)
    with pytest.raises(ValueError, match="not divisible by G=2"):
        d2ft_rglru.gated_rglru_scan(la, b, g, g, chunk=8)


def test_width_not_tiling_groups_reports_its_fallback():
    """An LRU width of 126 does not tile into the G = 4 gate groups that
    the smoke config's 4 heads and 256 FFN columns take: the kernel path
    takes JAX's coarse block-granularity mix on the RG-LRU layers and says
    so through on_fallback, as JAX does; the logits agree."""
    jcfg = jax_rg.smoke_config().replace(
        rglru=JaxRGLRUConfig(lru_width=126, conv_width=4))
    params = jax.jit(jax_init_model, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg)
    cfg = recurrentgemma_2b.smoke_config().replace(
        rglru=RGLRUConfig(lru_width=126, conv_width=4))
    model = init_model(torch.Generator().manual_seed(0), cfg)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg.vocab_size, (B, 21)).astype(np.int32)
    ops_ = rng.integers(0, 3, (cfg.n_layers, B, 4))
    g_f, g_b = (ops_ != 2).astype(np.float32), (ops_ == 0).astype(np.float32)
    seen, jseen = [], []
    contract.on_fallback = lambda kind, why: seen.append((kind, why))
    jax_contract.on_fallback = lambda kind, why: jseen.append((kind, why))
    try:
        with torch.no_grad():
            logits, _ = forward(model, cfg, torch.from_numpy(tokens),
                                gates=(torch.from_numpy(g_f),
                                       torch.from_numpy(g_b)),
                                use_kernel=True)
        jlogits, _ = jax.jit(lambda p: jax_forward(
            p, jcfg, tokens=jnp.asarray(tokens),
            gates=(jnp.asarray(g_f), jnp.asarray(g_b)),
            use_kernel=True))(params)
    finally:
        contract.on_fallback = None
        jax_contract.on_fallback = None
    assert seen == jseen and len(seen) == 2
    assert seen[0] == ("rglru", "lru width=126 not divisible by G=4 gate "
                                "groups")
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=FWD_TOL, rtol=0)


def test_gb_gt_gf_rejected():
    rng = np.random.default_rng(0)
    la, b, _ = (torch.from_numpy(a) for a in _operands(rng, 16))
    g_f = torch.ones((B, 4))
    g_f[0, 1] = 0.0
    with pytest.raises(ValueError, match="g_b <= g_f"):
        ops.gated_rglru_scan(la, b, g_f, torch.ones((B, 4)), chunk=8)


def test_undersized_live_bound_rejected():
    rng = np.random.default_rng(0)
    la, b, _ = (torch.from_numpy(a) for a in _operands(rng, 16))
    g = torch.ones((B, 4))
    with pytest.raises(ValueError, match="live_fwd"):
        ops.gated_rglru_scan(la, b, g, g, chunk=8, live_fwd=B * 4 - 1)
    with pytest.raises(ValueError, match="live_bwd"):
        ops.gated_rglru_scan(la, b, g, g, chunk=8, live_bwd=3)


@pytest.mark.parametrize("S", [24, 21, 512])
def test_flop_accounting_matches_jax(S):
    rng = np.random.default_rng(S)
    for G in (1, 4, 10):
        ops_ = rng.integers(0, 3, (4, G))
        g_f, g_b = (ops_ != 2).astype(np.float32), \
            (ops_ == 0).astype(np.float32)
        for chunk, wg in ((CHUNK, 32), (128, 256)):
            assert d2ft_rglru.gated_rglru_flops(g_f, g_b, S, wg,
                                                chunk=chunk) == \
                jax_rglru.gated_rglru_flops(g_f, g_b, S, wg, chunk=chunk)


def test_needed_work_counts_each_operand_once():
    """The bound's numerators at the fine-tune's shapes (B 4, G 10, Wg 256,
    S 512): la and b of the live slices read and h written for all
    forward; la, h and dy of the g_b-live slices read and dla, db written
    for all backward; a few operations per element, far below the TPU
    form's 2·Q²·Wg per chunk."""
    g_f = np.ones((4, 10), np.float32)
    g_b = np.ones((4, 10), np.float32)
    g_b[:, ::4] = 0.0                         # 12 p_o slices of 40
    S, Wg = 512, 256
    fb, bb = d2ft_rglru.needed_bytes(g_f, g_b, S, Wg)
    assert fb == 4 * (2 * 40 + 40) * S * Wg
    assert bb == 4 * (3 * 28 + 2 * 40) * S * Wg
    ff, bf = d2ft_rglru.needed_flops(g_f, g_b, S, Wg)
    assert (ff, bf) == (3 * 40 * S * Wg, 5 * 28 * S * Wg)
    jf, jb = jax_rglru.gated_rglru_flops(g_f, g_b, S, Wg, chunk=128)
    assert ff < jf and bf < jb


def test_launcher_runs_recurrentgemma_on_the_cpu(capsys):
    """The launcher's D2FT kernel path at the smoke config on the CPU (the
    kernels' plain versions); without --device and without a card it
    refuses rather than carry on on the CPU."""
    from repro_torch.launch import train as launcher
    log = launcher.main(["--arch", "recurrentgemma-2b", "--d2ft", "--kernel",
                         "--steps", "2", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "arch=recurrentgemma-2b layers=3 d_model=128 device=cpu"
    assert len(log.losses) == 2 and np.isfinite(log.losses).all()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            launcher.main(["--arch", "recurrentgemma-2b", "--d2ft",
                           "--kernel", "--steps", "2"])
