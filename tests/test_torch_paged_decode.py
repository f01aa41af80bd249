"""Paged flash decode: the port's plain version vs the JAX package's Pallas
kernel (interpret mode on the CPU, as ``tests/test_serving.py`` runs it)
and vs its gather reference, and the JAX wrapper's argument errors. The CUDA
kernel itself is held against the plain version on a card, in
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
from repro_torch.kernels.paged_decode import paged_decode_ref
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
}


@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_jax_pallas_kernel(name, window):
    """Window 0 and 8, GQA, null-padded tables, lengths at and around page
    boundaries and past the window, a slot with every head gated off and a
    slot with one."""
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
