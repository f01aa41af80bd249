"""The MoE slice of the PyTorch port against the JAX package on the CPU.

* The MoE expert FFN core: ``ops.gated_moe_ffn`` (its CPU route: the plain
  version on the kernels' own grids) against JAX's ``ops.gated_moe_ffn``
  (Pallas, interpret mode) and ``gated_moe_ffn_ref``, outputs and the four
  gradients within JAX's own kernel tolerance 1e-4
  (``tests/test_block_kernels.py``), at E 4, D 16, F 32, C 64 and 57 (the
  pad path), block_c 16, silu and gelu; exact zeros on dead blocks; the
  value checks; the launched grids under the two truncation bounds equal
  JAX's ``on_dispatch`` grids.
* The backward computes only the weight gradients autograd asks for: for
  each pattern of ``requires_grad`` on (w_up, w_gate, w_down), ``moe_bwd``
  is asked for exactly those and returns None for the others, and the
  gradients returned equal the all-three call's bit for bit and the
  jitted JAX reference's within 1e-4.
* ``apply_moe`` against JAX's: the dispatch (order, positions, kept slots,
  the capacity buffer and both slot masks) exactly, y within 1e-5 and the
  aux losses within 1e-6, without gates and under a p_f / p_o / p_s mix,
  at a capacity factor that drops slots, with a zero router (all ties)
  and with one shared expert.
* Serving refuses MoE blocks instead of skipping their FFN.

The olmoe-1b-7b smoke model (forward, scores, fine-tune, launcher,
per-expert LoRA) is in ``tests/test_torch_olmoe.py``.
"""
import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MoEConfig as JaxMoEConfig
from repro.kernels import d2ft_moe as jax_d2m
from repro.kernels import ops as jax_ops
from repro.kernels.ref import gated_moe_ffn_ref as jax_moe_ref
from repro.models import moe as jax_moe
from repro.models.layers import _act as jax_act
from repro_torch.configs import olmoe_1b_7b
from repro_torch.configs.base import MoEConfig
from repro_torch.kernels import d2ft_moe, ops
from repro_torch.models import moe
from repro_torch.models.transformer import (forward, init_model,
                                            prefill_forward)
from repro_torch.serving.engine import Request, make_engine
from repro_torch.serving.paged_decode import (init_paged_pools,
                                              paged_decode_step)

TOL = 1e-4             # JAX's MoE kernel tolerance
STEP_TOL = 1e-5
AUX_TOL = 1e-6
TRAJ_TOL = 1e-4
B, S = 4, 21


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


# ============================================================ the FFN core
def _core_operands(seed, E, C, D, F):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((E, C, D)).astype(np.float32),
            (rng.standard_normal((E, D, F)) / np.sqrt(D)).astype(np.float32),
            (rng.standard_normal((E, D, F)) / np.sqrt(D)).astype(np.float32),
            (rng.standard_normal((E, F, D)) / np.sqrt(F)).astype(np.float32),
            rng.standard_normal((E, C, D)).astype(np.float32))


def _slot_masks(rng, E, C):
    """Random slot masks with bwd <= fwd (float {0, 1})."""
    op = rng.integers(0, 3, (E, C))
    return ((op != 2).astype(np.float32), (op == 0).astype(np.float32))


def _block_masks(fs, bs, C, block_c):
    bc = min(block_c, C)
    Cp = -(-C // bc) * bc
    pad = ((0, 0), (0, Cp - C))
    fm = np.pad(fs, pad).reshape(fs.shape[0], -1, bc)
    bm = np.pad(bs, pad).reshape(bs.shape[0], -1, bc)
    return ((fm.sum(-1) > 0).astype(np.float32),
            (bm.sum(-1) > 0).astype(np.float32), bc)


def _port_core(ops_args, fs, bs, dy, **kw):
    """Output and (dx, dw_up, dw_gate, dw_down) of ``ops.gated_moe_ffn``."""
    ins = [_t(a).requires_grad_() for a in ops_args]
    y = ops.gated_moe_ffn(*ins, _t(fs), _t(bs), **kw)
    y.backward(_t(dy))
    return y.detach().numpy(), [t.grad.numpy() for t in ins]


@pytest.mark.parametrize("C,block_c", [(64, 16), (57, 16)])
@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_moe_core_matches_jax_kernel_and_reference(C, block_c, act):
    E, D, F = 4, 16, 32
    xb, wu, wg, wd, dy = _core_operands(C, E, C, D, F)
    fs, bs = _slot_masks(np.random.default_rng(C + 1), E, C)
    fm, bm, bc = _block_masks(fs, bs, C, block_c)
    w = tuple(map(jnp.asarray, (xb, wu, wg, wd)))
    out_k, vjp_k = jax.vjp(
        lambda *a: jax_ops.gated_moe_ffn(*a, jnp.asarray(fs),
                                         jnp.asarray(bs), act=act,
                                         block_c=block_c, interpret=True),
        *w)
    out_r, vjp_r = jax.vjp(
        lambda *a: jax_moe_ref(*a, jnp.asarray(fm), jnp.asarray(bm),
                               act=jax_act(act), block_c=bc), *w)
    y, grads = _port_core((xb, wu, wg, wd), fs, bs, dy, act=act,
                          block_c=block_c)
    ins = [_t(a).requires_grad_() for a in (xb, wu, wg, wd)]
    y_ref = d2ft_moe.gated_moe_ffn_ref(*ins, _t(fm), _t(bm), act=act,
                                       block_c=bc)
    y_ref.backward(_t(dy))
    for theirs, gs in ((out_k, vjp_k(jnp.asarray(dy))),
                       (out_r, vjp_r(jnp.asarray(dy)))):
        np.testing.assert_allclose(y, np.asarray(theirs), atol=TOL, rtol=TOL)
        for name, a, b in zip(("dx", "dwu", "dwg", "dwd"), grads, gs):
            np.testing.assert_allclose(a, np.asarray(b), atol=TOL, rtol=TOL,
                                       err_msg=name)
    np.testing.assert_allclose(y_ref.detach().numpy(), np.asarray(out_r),
                               atol=TOL, rtol=TOL)
    for name, a, b in zip(("dx", "dwu", "dwg", "dwd"), ins,
                          vjp_r(jnp.asarray(dy))):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), atol=TOL,
                                   rtol=TOL, err_msg=name)


# D2FT-LoRA's step wants dW_up alone (its merged w_gate and w_down are
# frozen); scoring and full fine-tuning want all three
NEEDS = list(itertools.product((False, True), repeat=3))


@functools.cache
def _need_case():
    """Operands, slot masks and the jitted JAX reference's (y, dx, dw_up,
    dw_gate, dw_down) at E 4, C 57 (the pad path), D 16, F 32, block_c
    16."""
    E, C, D, F = 4, 57, 16, 32
    xb, wu, wg, wd, dy = _core_operands(19, E, C, D, F)
    fs, bs = _slot_masks(np.random.default_rng(19), E, C)
    fm, bm, bc = _block_masks(fs, bs, C, 16)

    @jax.jit
    def ref(*a):
        y, vjp = jax.vjp(lambda *w: jax_moe_ref(
            *w, jnp.asarray(fm), jnp.asarray(bm), act=jax_act("silu"),
            block_c=bc), *a)
        return (y, *vjp(jnp.asarray(dy)))
    return (xb, wu, wg, wd, dy, fs, bs,
            [np.asarray(t) for t in ref(*map(jnp.asarray,
                                             (xb, wu, wg, wd)))])


def _grads_with_need(need):
    """(y, [dx, dw_up, dw_gate, dw_down] as .grad, the ``need`` each
    ``moe_bwd`` call got) of ``ops.gated_moe_ffn`` with requires_grad on
    xb and on the weights ``need`` names."""
    xb, wu, wg, wd, dy, fs, bs, _ = _need_case()
    asked = []
    orig = d2ft_moe.moe_bwd

    def spy(*a, **k):
        out = orig(*a, **k)
        asked.append((k["need"], [g is None for g in out[1:]]))
        return out
    ins = [_t(xb).requires_grad_()] + [
        _t(w).requires_grad_(n) for w, n in zip((wu, wg, wd), need)]
    d2ft_moe.moe_bwd = spy
    try:
        y = ops.gated_moe_ffn(*ins, _t(fs), _t(bs), act="silu", block_c=16)
        y.backward(_t(dy))
    finally:
        d2ft_moe.moe_bwd = orig
    return y.detach(), [t.grad for t in ins], asked


@pytest.mark.parametrize("need", NEEDS, ids=lambda n: "".join(
    "ugd"[i] if w else "-" for i, w in enumerate(n)))
def test_moe_backward_computes_only_the_wanted_weight_gradients(need):
    y, grads, asked = _grads_with_need(need)
    _, full, _ = _grads_with_need((True, True, True))
    ref = _need_case()[-1]
    assert asked == [(tuple(need), [not n for n in need])]
    np.testing.assert_allclose(y.numpy(), ref[0], atol=TOL, rtol=TOL)
    assert torch.equal(grads[0], full[0])
    np.testing.assert_allclose(grads[0].numpy(), ref[1], atol=TOL, rtol=TOL)
    for name, n, got, all3, theirs in zip(("dw_up", "dw_gate", "dw_down"),
                                          need, grads[1:], full[1:],
                                          ref[2:]):
        if not n:
            assert got is None, name
            continue
        assert torch.equal(got, all3), name
        np.testing.assert_allclose(got.numpy(), theirs, atol=TOL, rtol=TOL,
                                   err_msg=name)


def test_moe_dead_blocks_are_exact_zeros():
    """Expert 0: only its first block backward-live, its third forward-dead;
    expert 1: forward-live, backward-dead throughout."""
    E, C, D, F, bc = 2, 32, 8, 16, 8
    xb, wu, wg, wd, dy = _core_operands(1, E, C, D, F)
    fs = np.ones((E, C), np.float32)
    fs[0, 2 * bc:3 * bc] = 0.0
    bs = np.zeros((E, C), np.float32)
    bs[0, :bc] = 1.0
    y, (dx, dwu, dwg, dwd) = _port_core((xb, wu, wg, wd), fs, bs, dy,
                                        block_c=bc)
    assert np.all(y[0, 2 * bc:3 * bc] == 0.0)
    assert float(np.abs(y[1]).max()) > 0.0
    assert np.all(dx[1] == 0.0) and np.all(dx[0, bc:] == 0.0)
    assert float(np.abs(dx[0, :bc]).max()) > 0.0
    for g in (dwu, dwg, dwd):
        assert np.all(g[1] == 0.0) and float(np.abs(g[0]).max()) > 0.0


def test_moe_value_checks():
    E, C, D, F = 2, 16, 4, 8
    args = tuple(map(_t, _core_operands(0, E, C, D, F)[:4]))
    ones, zeros = torch.ones((E, C)), torch.zeros((E, C))
    with pytest.raises(ValueError, match="bwd_slots <= fwd_slots"):
        ops.gated_moe_ffn(*args, zeros, ones)
    with pytest.raises(ValueError, match="live_slots=4 is below"):
        ops.gated_moe_ffn(*args, ones, ones, live_slots=4)
    with pytest.raises(ValueError, match="live_bwd_slots=4 is below"):
        ops.gated_moe_ffn(*args, ones, ones, live_bwd_slots=4)
    with pytest.raises(ValueError, match="slot masks must be"):
        ops.gated_moe_ffn(*args, ones[:, :8])


def test_moe_truncated_grids_match_jax_dispatch():
    """40 forward-live and 18 backward-live slots of 64, block_c 16: the
    forward launches ceil(40/16) = 3 capacity blocks and the backward
    ceil(18/16) = 2, as JAX's ``on_dispatch`` reports; the result equals
    the untruncated call's and JAX's, and the masks handed over cover the
    launched grids."""
    E, C, D, F, bc = 2, 64, 4, 8, 16
    xb, wu, wg, wd, dy = _core_operands(11, E, C, D, F)
    fs = np.zeros((E, C), np.float32)
    fs[:, :40] = 1.0
    bs = np.zeros((E, C), np.float32)
    bs[:, :18] = 1.0

    def jax_run(bwd_slots):
        grids = {}
        jax_d2m.on_dispatch = lambda kind, grid: grids.__setitem__(kind,
                                                                   grid)
        jax.clear_caches()
        try:
            _, vjp = jax.vjp(
                lambda *w: jax_ops.gated_moe_ffn(
                    *w, jnp.asarray(fs), jnp.asarray(bs), block_c=bc,
                    live_slots=40, live_bwd_slots=bwd_slots,
                    interpret=True),
                *map(jnp.asarray, (xb, wu, wg, wd)))
            grads = vjp(jnp.asarray(dy))
        finally:
            jax_d2m.on_dispatch = None
        return grids, grads

    def port_run(bwd_slots):
        seen = {}
        d2ft_moe.dispatch = lambda kind, grid, mask: seen.__setitem__(
            kind, (grid, mask.clone()))
        try:
            y, grads = _port_core((xb, wu, wg, wd), fs, bs, dy, block_c=bc,
                                  live_slots=40, live_bwd_slots=bwd_slots)
        finally:
            d2ft_moe.dispatch = None
        return seen, y, grads

    for bound, want in ((18, ((E, 3), (E, 2))), (None, ((E, 3), (E, 3)))):
        jgrids, jgrads = jax_run(bound)
        seen, y, grads = port_run(bound)
        assert (jgrids["fwd"], jgrids["bwd"]) == want
        assert (seen["fwd"][0], seen["bwd"][0]) == want
        assert torch.equal(seen["fwd"][1], torch.ones(want[0]))
        assert float(seen["bwd"][1].sum()) == E * 2
        for a, b in zip(grads, jgrads):
            np.testing.assert_allclose(a, np.asarray(b), atol=TOL, rtol=TOL)
        if bound is None:
            for a, b in zip(grads, grads_t):
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
        grads_t = grads


def test_moe_accounting_matches_jax():
    """The FLOP and dispatched-byte mirrors equal the JAX package's; the
    bytes the function needs count each live tile's x (and dy) once."""
    rng = np.random.default_rng(2)
    fm = (rng.random((64, 3)) < 0.7).astype(np.float32)
    bm = fm * (rng.random((64, 3)) < 0.6)
    assert d2ft_moe.gated_moe_flops(fm, bm, 128, 2048, 1024) == \
        jax_d2m.gated_moe_flops(fm, bm, 128, 2048, 1024)
    assert d2ft_moe.gated_moe_dispatched_bytes(64, 3, 128, 2048, 1024,
                                               n_cb_bwd=2) == \
        jax_d2m.gated_moe_dispatched_bytes(64, 3, 128, 2048, 1024,
                                           n_cb_bwd=2)
    fwd, bwd = d2ft_moe.needed_bytes(fm, bm, 128, 16, 8)
    tile, w = 128 * 16, 3 * 16 * 8
    assert fwd == 4 * (fm.any(1).sum() * w + fm.sum() * tile + 192 * tile)
    assert bwd == 4 * (bm.any(1).sum() * w + 2 * bm.sum() * tile
                       + 192 * tile + 64 * w)


# ========================================================= the MoE layer
def _jax_route(x, p, cfg, gates):
    """JAX's dispatch, line for line from ``repro/models/moe.py``: the
    sorted order, positions, kept slots (and their backward-live part)."""
    Bn, Sn, D = x.shape
    T, E, K = Bn * Sn, cfg.n_experts, cfg.top_k
    logits = (x.reshape(T, D) @ p["router"]).astype(jnp.float32)
    top_w, top_e = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), K)
    e_flat = top_e.reshape(T * K)
    tok_flat = jnp.repeat(jnp.arange(T), K)
    if gates is None:
        order = jnp.argsort(e_flat, stable=True)
        counts = jnp.bincount(e_flat, length=E)
        live_a = bwd_a = jnp.ones((T * K,), bool)
    else:
        gf_t = jnp.repeat(gates[0].reshape(Bn), Sn)
        gb_t = jnp.repeat(gates[1].reshape(Bn), Sn)
        live_a, bwd_a = gf_t[tok_flat] > 0, gb_t[tok_flat] > 0
        key = jnp.where(live_a, 2 * e_flat + (1 - bwd_a.astype(e_flat.dtype)),
                        2 * E)
        order = jnp.argsort(key, stable=True)
        counts = jnp.bincount(jnp.where(live_a, e_flat, E),
                              length=E + 1)[:E]
    e_s = e_flat[order]
    pos = jnp.arange(T * K) - (jnp.cumsum(counts) - counts)[e_s]
    keep = (pos < int(max(1, round(T * K / E * cfg.capacity_factor)))) & \
        live_a[order]
    return (np.asarray(order), np.asarray(pos), np.asarray(keep),
            np.asarray(keep & bwd_a[order]))


MOE_CASES = {
    # name: (MoEConfig kwargs, gated, zero router)
    "ungated": (dict(), False, False),
    "gated": (dict(), True, False),
    "drops": (dict(capacity_factor=0.5), True, False),
    "ties": (dict(), True, True),
    "shared": (dict(n_shared_experts=1), True, False),
}


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_apply_moe_matches_jax(case, monkeypatch):
    kw, gated, zero_router = MOE_CASES[case]
    Bn, Sn, D, E, K, F = 4, 13, 16, 4, 2, 32
    jcfg = JaxMoEConfig(n_experts=E, top_k=K, d_ff=F, **kw)
    cfg = MoEConfig(n_experts=E, top_k=K, d_ff=F, **kw)
    jp = jax_moe.init_moe(jax.random.PRNGKey(7), D, jcfg, jnp.float32)
    if zero_router:
        jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    tree = jax.tree.map(np.asarray, jp)
    p = moe.MoE(*(_t(tree[k]) for k in ("router", "w_up", "w_gate",
                                        "w_down")),
                shared=None if "shared_up" not in tree else tuple(
                    _t(tree[k]) for k in ("shared_up", "shared_gate",
                                          "shared_down")))
    rng = np.random.default_rng(5)
    x = rng.standard_normal((Bn, Sn, D)).astype(np.float32)
    gates = None
    if gated:
        op = np.array([0, 1, 2, 0])          # p_f, p_o, p_s, p_f samples
        gates = ((op != 2).astype(np.float32), (op == 0).astype(np.float32))

    # JAX's own kernel call records its capacity buffer and slot masks
    calls = {}
    orig = jax_ops.gated_moe_ffn

    def record(buf, *a, **k):
        calls["jax"] = (np.asarray(buf), np.asarray(a[3]), np.asarray(a[4]),
                        k["live_slots"], k["live_bwd_slots"])
        return orig(buf, *a, **k)
    monkeypatch.setattr(jax_ops, "gated_moe_ffn", record)
    jg = None if gates is None else tuple(map(jnp.asarray, gates))
    live = (3 * Sn, 2 * Sn) if gated else (None, None)
    jy, jaux = jax_moe.apply_moe(jp, jnp.asarray(x), jcfg, gates=jg,
                                 use_kernel=gated, live_tokens=live[0],
                                 live_bwd_tokens=live[1], block_c=16)

    orig_impl = ops._gated_moe_impl

    def record_port(buf, *a, **k):
        calls["port"] = (buf.detach().numpy(), a[3].numpy(), a[4].numpy(),
                         k["live_slots"], k["live_bwd_slots"])
        return orig_impl(buf, *a, **k)
    monkeypatch.setattr(ops, "_gated_moe_impl", record_port)
    tg = None if gates is None else tuple(map(_t, gates))
    y, aux = moe.apply_moe(p, _t(x), cfg, gates=tg, use_kernel=gated,
                           live_tokens=live[0], live_bwd_tokens=live[1],
                           block_c=16)

    # the dispatch, exactly
    xt = _t(x).reshape(Bn * Sn, D)
    probs = torch.softmax(xt @ p.router, dim=-1)
    top_w, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    d = moe.route(top_e[:, :K], top_w[:, :K], cfg, tg, Sn)
    order, pos, keep, keep_b = _jax_route(jnp.asarray(x), jp, jcfg, jg)
    np.testing.assert_array_equal(d.order.numpy(), order)
    np.testing.assert_array_equal(d.pos.numpy(), pos)
    np.testing.assert_array_equal(d.keep.numpy(), keep)
    if gated:
        np.testing.assert_array_equal(d.keep_b.numpy(), keep_b)
        for mine, theirs in zip(calls["port"], calls["jax"]):
            np.testing.assert_array_equal(mine, theirs)
    if case == "drops":
        assert 0.0 < float(aux["drop_frac"]) < 1.0
    if case == "ties":
        assert set(top_e[:, :K].flatten().tolist()) == {0, 1}
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               atol=STEP_TOL, rtol=0)
    for k in ("load_balance", "router_z", "drop_frac"):
        np.testing.assert_allclose(float(aux[k].detach()), float(jaux[k]),
                                   atol=AUX_TOL, rtol=0, err_msg=k)


# ================================================================ serving
def test_serving_refuses_moe_blocks():
    """Serving never skips an MoE block's FFN. It once refused MoE blocks;
    since the MoE families are served it runs them: the prefill's logits
    are ``forward``'s, and they move when the experts' weights are zeroed
    (so the FFN ran); the paged decode step and the engine answer."""
    cfg = olmoe_1b_7b.smoke_config()
    model = init_model(torch.Generator().manual_seed(0), cfg)
    tokens = torch.randint(0, cfg.vocab_size, (1, 5),
                           generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        logits, cache = prefill_forward(model, cfg, tokens, raw_kv=True)
        ref, _ = forward(model, cfg, tokens)
        np.testing.assert_allclose(logits.numpy(), ref.numpy(), atol=1e-5,
                                   rtol=0)
        pools = init_paged_pools(cfg, n_pages=4, page_size=4, max_slots=1,
                                 device="cpu")
        step, _ = paged_decode_step(model, pools, cfg, tokens[:, :1],
                                    torch.zeros((1, 2), dtype=torch.int32),
                                    torch.zeros((1,), dtype=torch.int32),
                                    page_size=4)
        assert tuple(step.shape) == (1, 1, cfg.vocab_size)
        assert torch.isfinite(step).all()
        for layer in model.layers:
            layer.moe.w_down.zero_()
        off, _ = prefill_forward(model, cfg, tokens, raw_kv=True)
        assert float((off - logits).abs().max()) > 1e-3
    engine = make_engine(cfg, seed=0, device="cpu", page_size=4, n_pages=9,
                         max_slots=2, max_seq_len=16)
    out = engine.run([Request(uid=0, prompt=np.zeros(5, np.int32),
                              max_new_tokens=2)])
    assert len(out[0]) == 7
