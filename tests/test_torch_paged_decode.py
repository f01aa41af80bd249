"""Paged flash decode: the port's plain version vs the JAX package's Pallas
kernel (interpret mode on the CPU, as ``tests/test_serving.py`` runs it)
and vs its gather reference, the CUDA kernel's split-KV arithmetic emulated
on the CPU, and the JAX wrapper's argument errors. The CUDA kernel itself
is held against the plain version on a card, in
``tests/test_torch_kernels_gpu.py``.

Tolerance 1e-5 abs in float32: the same softmax over the same positions,
summed in another order (online across pages in the kernels, in one pass
in the references)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ops import paged_decode_attention as jax_paged_decode
from repro.serving.paged_decode import paged_attention_ref as jax_gather_ref
from repro_torch.kernels.ops import paged_decode_attention
from repro_torch.kernels.paged_decode import (NEG_INF, KV_SPLIT, n_splits,
                                              paged_decode_ref, split_len)
from repro_torch.serving.paged_decode import paged_attention_ref

TOL = 1e-5


def _case(seed, B, H, n_kv, hd, ps, n_pages, n_pmax, lengths, gated=None):
    """Random pools and queries; each slot's table holds distinct random
    pages up to its length and is null-padded (page 0) past it."""
    rs = np.random.RandomState(seed)
    q = rs.randn(B, H, hd).astype(np.float32)
    kp = rs.randn(n_pages, ps, n_kv, hd).astype(np.float32)
    vp = rs.randn(n_pages, ps, n_kv, hd).astype(np.float32)
    perm = rs.permutation(np.arange(1, n_pages))
    table = np.zeros((B, n_pmax), np.int32)
    for b, t in enumerate(lengths):
        n = t // ps + 1
        table[b, :n] = perm[b * n_pmax:b * n_pmax + n]
    g = np.ones((B, H), np.float32)
    for b, h in gated or ():
        g[b, h] = 0.0
    return q, kp, vp, table, np.asarray(lengths, np.int32), g


CASES = {
    # name: (B, H, n_kv, hd, ps, n_pages, n_pmax, lengths, gated heads)
    "gqa4_padded": (3, 4, 1, 32, 4, 64, 8, [3, 9, 22], None),
    "gqa2_boundaries": (4, 4, 2, 32, 8, 64, 6, [7, 8, 15, 40], None),
    "gated_heads": (3, 4, 1, 32, 4, 64, 8, [5, 17, 30],
                    [(0, 0), (0, 1), (0, 2), (0, 3), (1, 2)]),
    "mha": (2, 2, 2, 16, 4, 32, 5, [0, 19], [(1, 0)]),
    # recurrentgemma-2b's 10 query heads on 1 KV head (two head groups of
    # 5 in the kernel); stablelm-3b's head_dim 80 and phi3-vision-42b's 96
    "rep10": (2, 10, 1, 32, 4, 32, 8, [6, 29], [(0, 9), (1, 4)]),
    "hd80": (2, 4, 2, 80, 4, 32, 6, [11, 22], [(1, 1)]),
    "hd96": (2, 4, 1, 96, 4, 32, 6, [3, 20], None),
}


@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_jax_pallas_kernel(name, window):
    """Window 0 and 8, GQA up to 10 query heads on one KV head, head dims
    16 to 96, null-padded tables, lengths at and around page boundaries
    and past the window, a slot with every head gated off and a slot with
    one."""
    q, kp, vp, table, lengths, g = _case(0, *CASES[name])
    ref = np.asarray(jax_paged_decode(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(lengths), g_f=jnp.asarray(g), window=window))
    out = paged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(table), torch.from_numpy(lengths),
        g_f=torch.from_numpy(g), window=window).numpy()
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=TOL)
    dead = g == 0
    assert np.all(out[dead] == 0.0), "gated-off heads must be exact zeros"


@pytest.mark.parametrize("window", [0, 8])
def test_gather_refs_match_jax(window):
    """Both plain paths (the kernel's and the serving gather reference)
    against the JAX gather reference, ungated."""
    q, kp, vp, table, lengths, g = _case(1, *CASES["gqa4_padded"])
    ref = np.asarray(jax_gather_ref(
        jnp.asarray(q)[:, None], jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(table), jnp.asarray(lengths), window=window))[:, 0]
    tq, tk, tv, tt, tln = map(torch.from_numpy, (q, kp, vp, table, lengths))
    gathered = paged_attention_ref(tq[:, None], tk, tv, tt, tln,
                                   window=window)[:, 0].numpy()
    plain = paged_decode_ref(tq, tk, tv, tt, tln, torch.from_numpy(g),
                             window=window).numpy()
    np.testing.assert_allclose(gathered, ref, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(plain, ref, atol=TOL, rtol=TOL)


def split_kv_emulation(q, kp, vp, table, lengths, g_f, *, window=0,
                       tile=64):
    """The arithmetic of ``csrc/paged_decode.cu`` in float32: each (slot,
    head)'s history in runs of the launcher's ``split_len(page_size)``
    positions; inside a run, tiles of 64 positions with an online softmax
    (the run's max m, exp-sum l and unnormalised accumulator); a run with
    no live position is the empty partial (m = -2^30, l = 0); then the runs
    merged in split order (rescaled to the global max, summed, divided by
    the sum, times the gate). Gated heads and slots with no live position
    are exact zeros."""
    B, H, hd = q.shape
    _, ps, n_kv, _ = kp.shape
    n_pmax = table.shape[1]
    run, n_split = split_len(ps), n_splits(n_pmax, ps)
    rep = H // n_kv
    qs = q * torch.tensor(1.0 / hd ** 0.5, dtype=torch.float32)
    out = torch.zeros_like(q)
    for b in range(B):
        t = int(lengths[b])
        for h in range(H):
            if float(g_f[b, h]) == 0.0:
                continue
            parts = []
            for sp in range(n_split):
                lo = max(sp * run, max(0, t - window + 1) if window else 0)
                hi = min(t, n_pmax * ps - 1, sp * run + run - 1)
                m = torch.tensor(NEG_INF, dtype=torch.float32)
                l = torch.tensor(0.0, dtype=torch.float32)
                acc = torch.zeros(hd)
                for tile0 in range(lo, hi + 1, tile):
                    pos = torch.arange(tile0, min(tile0 + tile, hi + 1))
                    pages = table[b, pos // ps].long()
                    keys = kp[pages, pos % ps, h // rep]
                    vals = vp[pages, pos % ps, h // rep]
                    s_ = keys @ qs[b, h]
                    m_new = torch.maximum(m, s_.max())
                    p = torch.exp(s_ - m_new)
                    corr = torch.exp(m - m_new)
                    l = l * corr + p.sum()
                    acc = acc * corr + p @ vals
                    m = m_new
                parts.append((m, l, acc))
            live = [(m, l, acc) for m, l, acc in parts if float(l) > 0]
            if not live:
                continue
            mx = max(float(m) for m, _, _ in live)
            mx = torch.tensor(mx, dtype=torch.float32)
            tot = torch.tensor(0.0, dtype=torch.float32)
            num = torch.zeros(hd)
            for m, l, acc in live:             # in split order
                w = torch.exp(m - mx)
                tot = tot + w * l
                num = num + w * acc
            out[b, h] = num / tot * g_f[b, h]
    return out


SPLIT_CASES = {
    # name: (B, H, n_kv, hd, ps, n_pages, n_pmax, lengths, gated heads,
    # window); three runs of KV_SPLIT = 64 positions a table
    "run_boundaries": (4, 4, 1, 32, 8, 100, 24, [63, 64, 127, 128], None, 0),
    "window_cuts_runs": (3, 4, 2, 32, 8, 80, 24, [100, 150, 191], None, 40),
    "padded_past_runs": (3, 4, 1, 32, 16, 48, 12, [10, 70, 5],
                         [(1, 1)], 0),
    "slot_gated": (3, 4, 1, 32, 8, 80, 24, [90, 130, 20],
                   [(1, 0), (1, 1), (1, 2), (1, 3)], 64),
    "rep8": (2, 8, 1, 32, 8, 64, 24, [77, 140], [(0, 5)], 0),
    "batch1": (1, 4, 2, 64, 4, 64, 40, [129], None, 100),
    "rep10": (2, 10, 1, 32, 8, 64, 24, [70, 150], [(1, 3), (1, 8)], 0),
    "hd80": (2, 4, 2, 80, 8, 64, 24, [64, 140], [(0, 2)], 40),
    "hd96": (2, 4, 1, 96, 8, 64, 24, [127, 5], None, 0),
}


@pytest.mark.parametrize("name", list(SPLIT_CASES))
def test_split_kv_arithmetic_matches_plain_and_jax(name):
    """The split-KV kernel's arithmetic at the launcher's run length
    against the plain version and the JAX Pallas kernel: lengths exactly at
    a run's end (63, 127) and one past (64, 128), a window that cuts a run,
    tables null-padded over whole runs, a slot whose heads are all gated,
    rep 8, rep 10, head dims 80 and 96 and B 1. Gated heads are exact
    zeros."""
    *shape, window = SPLIT_CASES[name]
    q, kp, vp, table, lengths, g = _case(3, *shape)
    assert split_len(shape[4]) == KV_SPLIT
    tq, tk, tv, tt, tln, tg = map(torch.from_numpy,
                                  (q, kp, vp, table, lengths, g))
    emu = split_kv_emulation(tq, tk, tv, tt, tln, tg, window=window).numpy()
    plain = paged_decode_ref(tq, tk, tv, tt, tln, tg, window=window).numpy()
    ref = np.asarray(jax_paged_decode(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(lengths), g_f=jnp.asarray(g), window=window))
    np.testing.assert_allclose(emu, plain, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(emu, ref, atol=TOL, rtol=TOL)
    assert np.all(emu[g == 0] == 0.0), "gated-off heads must be exact zeros"


def test_split_geometry():
    """Runs hold whole pages and whole kernel tiles; their count comes from
    the table's width (gemma3-1b serving: 129 pages of 16, 33 runs)."""
    assert [split_len(ps) for ps in (1, 4, 16, 64, 5, 128)] == \
        [64, 64, 64, 64, 320, 128]
    assert n_splits(129, 16) == 33
    assert n_splits(24, 8) == 3
    assert n_splits(1, 4) == 1


def test_rejects_bad_tables():
    B, H, n_kv, hd, ps = 1, 2, 2, 8, 4
    q = torch.zeros((B, H, hd))
    pools = torch.zeros((8, ps, n_kv, hd))
    lengths = torch.zeros((B,), dtype=torch.int32)
    for bad in (99, -1):                           # out of range
        table = torch.full((B, 2), bad, dtype=torch.int32)
        with pytest.raises(ValueError, match="valid page ids"):
            paged_decode_attention(q, pools, pools, table, lengths)


@pytest.mark.parametrize("what", ["head_dim", "pools", "batch", "gates"])
def test_rejects_bad_shapes(what):
    B, H, n_kv, hd, ps = 2, 4, 2, 8, 4
    q = torch.zeros((B, H, hd))
    kp = vp = torch.zeros((8, ps, n_kv, hd))
    table = torch.zeros((B, 3), dtype=torch.int32)
    lengths = torch.zeros((B,), dtype=torch.int32)
    g = None
    if what == "head_dim":
        q, match = torch.zeros((B, H, hd + 1)), "head_dim"
    elif what == "pools":
        vp, match = torch.zeros((8, ps, n_kv, hd + 1)), "pool shapes"
    elif what == "batch":
        lengths, match = torch.zeros((B + 1,), dtype=torch.int32), "batch"
    else:
        g, match = torch.ones((B, H + 1)), "g_f must be"
    with pytest.raises(ValueError, match=match):
        paged_decode_attention(q, kp, vp, table, lengths, g_f=g)
