"""Gated flash attention of the PyTorch port against the JAX package, on the
CPU: the port's plain version (what the CUDA kernels are held against on
the card) vs the Pallas kernels in interpret mode and the JAX plain
version, the accounting the two packages share, and the gate checks.

Inputs come from numpy seeds and go through both packages. Tolerances are
JAX's own kernel tolerance split by kind (``tests/test_kernel_grads.py``):
forward 1e-5, gradients 1e-4, float32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import contract as jax_contract
from repro.kernels import d2ft_attention as jax_d2a
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro_torch.kernels import contract, d2ft_attention as d2a, ops

FWD_TOL = 1e-5
GRAD_TOL = 1e-4


def _gates(rng, B, H):
    """Random p_f / p_o / p_s mix with every op present: (g_f, g_b)."""
    ops_ = rng.permutation(np.arange(B * H) % 3).reshape(B, H)
    return ((ops_ != 2).astype(np.float32), (ops_ == 0).astype(np.float32))


# bidirectional, causal and window masks; S = 37 (the JAX pad path) and 32;
# with and without compaction bounds (a bound above the live count)
@pytest.mark.parametrize("causal,window,S,bounded", [
    (False, 0, 37, False), (False, 0, 32, True), (True, 0, 37, True),
    (True, 8, 32, False)])
def test_plain_version_matches_jax_kernel_and_reference(causal, window, S,
                                                        bounded):
    B, H, hd = 2, 4, 16
    rng = np.random.default_rng(S * 10 + window + causal)
    q, k, v, do = (rng.normal(size=(B, H, S, hd)).astype(np.float32)
                   for _ in range(4))
    g_f, g_b = _gates(rng, B, H)
    live = (int(g_f.sum()) + 1, int(g_b.sum()) + 1) if bounded \
        else (None, None)

    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = ops.gated_attention(tq, tk, tv, torch.from_numpy(g_f),
                              torch.from_numpy(g_b), causal=causal,
                              window=window, live_fwd=live[0],
                              live_bwd=live[1])
    out.backward(torch.from_numpy(do))
    mine = [out.detach().numpy()] + [t.grad.numpy() for t in (tq, tk, tv)]

    def jax_kernel(q, k, v):
        return jax_ops.gated_attention(
            q, k, v, jnp.asarray(g_f), jnp.asarray(g_b), causal=causal,
            window=window, interpret=True, live_fwd=live[0],
            live_bwd=live[1])

    def jax_plain(q, k, v):
        return jax_ref.gated_attention_ref(q, k, v, jnp.asarray(g_f),
                                           jnp.asarray(g_b), causal=causal,
                                           window=window)

    for fn in (jax_kernel, jax_plain):
        o, vjp = jax.vjp(jax.jit(fn), jnp.asarray(q), jnp.asarray(k),
                         jnp.asarray(v))
        theirs = [o] + list(vjp(jnp.asarray(do)))
        for name, a, b, tol in zip(("o", "dq", "dk", "dv"), mine, theirs,
                                   (FWD_TOL,) + (GRAD_TOL,) * 3):
            np.testing.assert_allclose(a, np.asarray(b), atol=tol, rtol=0,
                                       err_msg=f"{fn.__name__} {name}")
    dead_f, dead_b = g_f == 0, g_b == 0
    assert np.all(mine[0][dead_f] == 0)
    for grad in mine[1:]:
        assert np.all(grad[dead_b] == 0)


@pytest.mark.parametrize("S,bq,bk", [(197, 128, 128), (37, 128, 128),
                                     (256, 128, 64), (257, 128, 128),
                                     (96, 64, 64), (1, 128, 128)])
def test_tile_accounting_equals_jax(S, bq, bk):
    assert d2a.select_blocks(S, bq, bk) == jax_d2a.select_blocks(S, bq, bk)
    bq_, bk_, Sp = d2a.select_blocks(S, bq, bk)
    for causal, window in ((False, 0), (True, 0), (True, 40)):
        assert d2a.live_block_count(Sp, bq_, bk_, causal, window, S) == \
            jax_d2a.live_block_count(Sp, bq_, bk_, causal, window, S)
        rng = np.random.default_rng(S)
        g_f, g_b = _gates(rng, 3, 4)
        assert d2a.gated_attention_flops(
            g_f, g_b, S, 16, causal=causal, window=window, block_q=bq,
            block_k=bk) == jax_d2a.gated_attention_flops(
            g_f, g_b, S, 16, causal=causal, window=window, block_q=bq,
            block_k=bk)
    x = np.random.default_rng(0).normal(size=(1, 2, S, 8)).astype(np.float32)
    mine = d2a.pad_to_blocks(*(torch.from_numpy(x),) * 3, bq, bk)
    theirs = jax_d2a.pad_to_blocks(*(jnp.asarray(x),) * 3, bq, bk)
    assert mine[3:] == theirs[3:]
    np.testing.assert_array_equal(mine[0].numpy(), np.asarray(theirs[0]))


def test_kernel_tiling_accounting():
    """The CUDA kernels' tiles at the head dims (16, 32, 64, 80, 96, 128,
    256): the forward's 64 query rows against 64 key rows up to hd 64 and
    32 above; the backward's 64 resident rows (queries in dQ, keys in
    dK/dV) against 64 walked rows, or 32 at hd 256. ViT-small's S = 197 is
    4 x 4 tiles in every kernel, the last ragged; a causal or windowed mask
    skips whole tiles as JAX's predicate does (gemma3-1b's S 1024: 272
    causal 64 x 32 tiles in the forward and in each backward role, 216
    under its 512 window; stablelm-3b's hd 80 at S 1024: 272 forward and
    136 causal 64 x 64 tiles a backward role); FLOPs and bytes scale with
    the live slices only."""
    assert d2a.KERNEL_HEAD_DIMS == (16, 32, 64, 80, 96, 128, 256)
    assert [d2a.kernel_block(hd) for hd in d2a.KERNEL_HEAD_DIMS] == \
        [(64, 64)] * 3 + [(64, 32)] * 4
    assert [d2a.kernel_block(hd, "bwd_dq") for hd in d2a.KERNEL_HEAD_DIMS] \
        == [(64, 64)] * 6 + [(64, 32)]
    assert [d2a.kernel_block(hd, "bwd_dkdv")
            for hd in d2a.KERNEL_HEAD_DIMS] == [(64, 64)] * 6 + [(32, 64)]
    for hd in (80, 96):
        assert d2a.kernel_live_tiles(1024, True, 0, hd) == 272
        assert d2a.kernel_live_tiles(1024, True, 0, hd, "bwd_dq") == 136
        assert d2a.kernel_live_tiles(1024, True, 0, hd, "bwd_dkdv") == 136
    with pytest.raises(ValueError, match="unknown kernel"):
        d2a.kernel_block(64, "bwd")
    assert d2a.kernel_live_tiles(197, False, 0, 64) == 16
    assert d2a.kernel_live_tiles(256, True, 0, 128) == 20
    assert d2a.kernel_live_tiles(197, False, 0, 128) == 28
    assert d2a.kernel_live_tiles(512, True, 128, 64) == 21
    assert d2a.kernel_live_tiles(1, False, 0, 16) == 1
    assert d2a.kernel_live_tiles(1024, True, 0, 256) == 272
    assert d2a.kernel_live_tiles(1024, True, 512, 256) == 216
    for kind in ("bwd_dq", "bwd_dkdv"):
        assert d2a.kernel_live_tiles(197, False, 0, 64, kind) == 16
        assert d2a.kernel_live_tiles(1024, True, 0, 256, kind) == 272
        assert d2a.kernel_live_tiles(1024, True, 512, 256, kind) == 216
        assert d2a.kernel_live_tiles(512, True, 2048, 256, kind) == 72
    # the two backward kernels' counts differ where the ragged edge meets
    # the window
    assert d2a.kernel_live_tiles(197, True, 40, 256, "bwd_dq") == 13
    assert d2a.kernel_live_tiles(197, True, 40, 256, "bwd_dkdv") == 12
    f, b = d2a.kernel_flops(8, 4, 1024, 256, causal=True, window=512)
    assert (f, b) == (8 * 216 * 2 * 2 * 64 * 32 * 256,
                      4 * 216 * (3 + 4) * 2 * 64 * 32 * 256)
    f, b = d2a.kernel_flops(192, 144, 197, 64, causal=False, window=0)
    assert f == 192 * 16 * 2 * 2 * 64 * 64 * 64
    assert b == 144 * 16 * 7 * 2 * 64 * 64 * 64
    full = d2a.kernel_bytes(240, 240, 240, 240, 197, 64, causal=False,
                            window=0)
    part = d2a.kernel_bytes(192, 144, 192, 144, 197, 64, causal=False,
                            window=0)
    assert part[0] == pytest.approx(full[0] * 0.8)
    assert part[1] == pytest.approx(full[1] * 0.6)
    full = d2a.kernel_bytes(16, 16, 16, 16, 1024, 256, causal=True,
                            window=512)
    part = d2a.kernel_bytes(16, 12, 16, 12, 1024, 256, causal=True,
                            window=512)
    assert part[1] == pytest.approx(full[1] * 0.75)


@pytest.mark.parametrize("hd", d2a.KERNEL_HEAD_DIMS)
def test_kernel_live_tiles_hold_a_live_element(hd):
    """At each head dim, every kernel's live tile count equals the number
    of its (q tile, k tile) pairs that hold an unmasked in-bounds entry,
    counted from the element mask (the kernels' elem_live) under
    bidirectional, causal and windowed masks at ragged and whole S."""
    for S in (1, 63, 197, 256):
        for causal, window in ((False, 0), (True, 0), (True, 40)):
            mask = d2a._mask(S, causal, window, "cpu")
            for kind in d2a.KERNEL_KINDS:
                bq, bk = d2a.kernel_block(hd, kind)
                want = sum(bool(mask[i:i + bq, j:j + bk].any())
                           for i in range(0, S, bq)
                           for j in range(0, S, bk))
                assert d2a.kernel_live_tiles(S, causal, window, hd,
                                             kind) == want, (S, kind)


@pytest.mark.parametrize("live", [None, 0, 3, 7, 8, 20])
def test_dispatch_and_permutation_equal_jax(live):
    rng = np.random.default_rng(live or 0)
    g = (rng.random(8) < 0.5).astype(np.float32)
    n = contract.dispatch_count(live, 8)
    assert n == jax_contract.dispatch_count(live, 8)
    np.testing.assert_array_equal(
        contract.live_permutation(torch.from_numpy(g), n).numpy(),
        np.asarray(jax_contract.live_permutation(jnp.asarray(g), n)))


@pytest.mark.parametrize("case", ["gb_above_gf", "small_live_fwd",
                                  "small_live_bwd", "shape"])
def test_gated_attention_refuses_broken_gate_contracts(case):
    q = torch.zeros((2, 3, 5, 16))
    g_f = torch.tensor([[1., 1, 0], [1, 0, 1]])
    g_b = torch.tensor([[1., 0, 0], [0, 0, 1]])
    kw = {}
    if case == "gb_above_gf":
        g_b = g_b.clone()
        g_b[0, 2] = 1.0
    elif case == "small_live_fwd":
        kw["live_fwd"] = 3
    elif case == "small_live_bwd":
        kw["live_bwd"] = 1
    else:
        g_f = g_f[:, :2]
    with pytest.raises(ValueError):
        ops.gated_attention(q, q, q, g_f, g_b, **kw)
    with pytest.raises(ValueError):
        jax_ops.gated_attention(*(jnp.asarray(q.numpy()),) * 3,
                                jnp.asarray(g_f.numpy()),
                                jnp.asarray(g_b.numpy()), interpret=True,
                                **kw)


def test_forward_only_references_equal_jax():
    """``attention_ref`` and the forward-gated ``d2ft_attention_ref``."""
    rng = np.random.default_rng(11)
    q, k, v = (rng.normal(size=(2, 3, 19, 16)).astype(np.float32)
               for _ in range(3))
    g = np.array([[1, 0, 1], [0, 1, 1]], np.float32)
    for causal, window in ((True, 0), (False, 0), (True, 5)):
        np.testing.assert_allclose(
            d2a.d2ft_attention_ref(*map(torch.from_numpy, (q, k, v, g)),
                                   causal=causal, window=window).numpy(),
            np.asarray(jax_ref.d2ft_attention_ref(
                *map(jnp.asarray, (q, k, v, g)), causal=causal,
                window=window)), atol=FWD_TOL, rtol=0)
