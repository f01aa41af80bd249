"""The packed D2FT path of the PyTorch port against the JAX package on the
CPU: ``_kv_slices`` in its three branches; ``packed_forward`` and
``packed_forward_mb`` (logits and parameter gradients) against jitted JAX
on ``tests/test_d2ft.py``'s config (4 layers, d 64, 4 heads on 2 KV heads,
causal) and on the gemma3 smoke config (7 layers, d 128, 4 heads on 1 KV
head, window 8) at S 16 (the window mask) and S 32 (block-local), within
1e-5 on logits and 1e-4 on gradients; the port's packed forms against its
own masked path; an unbalanced table where JAX's micro-batch path gives a
p_o micro-batch gradients and the port's does not; a 3-step
``finetune(packed=True)`` against JAX's; remat; the refusals. The FLOPs
of a packed step and the two examples are in
``tests/test_torch_packed_examples.py``.
"""
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gemma3_1b as jax_gemma
from repro.configs.base import D2FTConfig as JaxD2FTConfig
from repro.configs.base import ModelConfig as JaxModelConfig
from repro.core import d2ft as jax_d2ft
from repro.core.schedule import Schedule as JaxSchedule
from repro.core.schedule import gates_from_schedule as jax_gates
from repro.core.schedule import packed_indices as jax_packed_indices
from repro.models.transformer import forward as jax_forward
from repro.models.transformer import init_model as jax_init_model
from repro.optim.optimizers import adamw as jax_adamw
from repro.train.loop import finetune as jax_finetune
from repro_torch.configs import gemma3_1b, get_smoke_config
from repro_torch.configs.base import D2FTConfig, ModelConfig
from repro_torch.core import d2ft
from repro_torch.core.schedule import (P_F, P_O, P_S, Schedule,
                                       gates_from_schedule, packed_indices)
from repro_torch.data.synthetic import lm_batches, microbatch_assignment
from repro_torch.interop import params_from_jax
from repro_torch.models.transformer import forward, init_model
from repro_torch.optim.optimizers import adamw
from repro_torch.train.loop import finetune

LOGIT_TOL = 1e-5
GRAD_TOL = 1e-4
TRAJ_TOL = 1e-4
# tests/test_d2ft.py's config
CFG = dict(name="t", arch_type="dense", n_layers=4, d_model=64, n_heads=4,
           n_kv_heads=2, d_ff=128, vocab_size=97)
CONFIGS = {"d2ft": (JaxModelConfig(**CFG), ModelConfig(**CFG)),
           "gemma3": (jax_gemma.smoke_config(), gemma3_1b.smoke_config())}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """torch's intra-op threads at 1 for this file's tests, the old count
    restored after: its small CPU ops run faster on one thread than across
    threads beside the other test processes."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@functools.lru_cache(maxsize=None)
def _jax_params(name):
    jcfg = CONFIGS[name][0]
    params = jax.jit(jax_init_model, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg)
    return params, jax.tree.map(np.asarray, params)


def _port(name):
    cfg = CONFIGS[name][1]
    model = init_model(torch.Generator().manual_seed(0), cfg)
    model.load_state_dict(params_from_jax(_jax_params(name)[1]))
    return model


def _flat(tree):
    return {k: v.numpy() for k, v in params_from_jax(tree).items()}


def _schedule(L, G, N, n_pf, n_po, seed=0):
    """tests/test_d2ft.py's knapsack schedule: positive scores, so every
    subnet gets the same counts."""
    rng = np.random.default_rng(seed)
    d2 = D2FTConfig(n_microbatches=N, n_pf=n_pf, n_po=n_po)
    bw = np.repeat(rng.random((L * G, 1)) + .1, N, 1)
    fw = rng.random((L * G, N)) + .1
    return d2ft.plan_schedule(d2, bw, fw, L, G)


def _jax_sched(sched):
    return JaxSchedule(sched.table, sched.n_layers, sched.n_groups)


def _grads(model, loss):
    named = list(model.named_parameters())
    gs = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)
    return {n: np.zeros(p.shape, np.float32) if g is None else g.numpy()
            for (n, p), g in zip(named, gs)}


def _assert_grads(mine, theirs, tol=GRAD_TOL):
    for name, g in mine.items():
        np.testing.assert_allclose(g, theirs[name], atol=tol, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("H,n_kv,G", [(4, 2, 2), (4, 1, 4), (8, 2, 4),
                                      (6, 4, 3)])
def test_kv_slices_match_jax(H, n_kv, G):
    """n_kv % G == 0 (column slices), G % n_kv == 0 (one KV head a group:
    gemma3's 1 KV head for 4 groups is a view of the weight) and the
    replicate fallback (4 KV heads, 3 groups)."""
    hd, D = 8, 16
    rng = np.random.default_rng(H + n_kv + G)
    wk = rng.standard_normal((D, n_kv * hd)).astype(np.float32)
    wv = rng.standard_normal((D, n_kv * hd)).astype(np.float32)
    jk, jv, jkv = jax_d2ft._kv_slices({"wk": jnp.asarray(wk),
                                       "wv": jnp.asarray(wv)}, G, n_kv, hd)
    tk, tv = torch.from_numpy(wk), torch.from_numpy(wv)
    k, v, kv = d2ft._kv_slices(types.SimpleNamespace(wk=tk, wv=tv), G, n_kv,
                               hd)
    assert kv == jkv
    np.testing.assert_array_equal(k.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    # a view of the weight but where groups take one of several KV heads
    copies = n_kv % G != 0 and G % n_kv == 0 and n_kv > 1
    assert (k.data_ptr() == tk.data_ptr()) != copies


# (config, S, form): both forms on the global causal layers of
# tests/test_d2ft.py's config, and on gemma3's the window-mask (S 16) and
# block-local (S 32) branches of its local layers, which the two forms
# share
CASES = [("d2ft", 16, "sample"), ("d2ft", 16, "mb"),
         ("gemma3", 16, "sample"), ("gemma3", 32, "mb")]


def _plans(cfg, form, S, seed=0):
    """(port forward, JAX forward, port masked gates, JAX masked gates,
    tokens) of a balanced knapsack table: 3 p_f + 1 p_o of 5 micro-batches
    of 2 samples per sample, 2 p_f + 1 p_o of 4 micro-batches of 3 per
    micro-batch."""
    L, G = cfg.n_layers, cfg.n_heads
    if form == "sample":
        M, B, n_pf, n_po = 5, 10, 3, 1
    else:
        M, B, n_pf, n_po = 4, 12, 2, 1
    sched = _schedule(L, G, M, n_pf, n_po, seed)
    mb_of = microbatch_assignment(B, M)
    rng = np.random.default_rng(seed + 1)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    if form == "sample":
        plan = packed_indices(sched, mb_of)[:3]
        jplan = tuple(map(jnp.asarray, jax_packed_indices(
            _jax_sched(sched), mb_of)[:3]))

        def mine(model, toks, **kw):
            return d2ft.packed_forward(model, cfg, toks, plan, **kw)

        def theirs(p, jcfg):
            return jax_d2ft.packed_forward(p, jcfg, jnp.asarray(tokens),
                                           jplan)
    else:
        plan = d2ft.mb_packed_indices(sched, M)
        jplan = tuple(map(jnp.asarray, jax_d2ft.mb_packed_indices(
            _jax_sched(sched), M)))

        def mine(model, toks, **kw):
            return d2ft.packed_forward_mb(model, cfg, toks, plan, M, **kw)

        def theirs(p, jcfg):
            return jax_d2ft.packed_forward_mb(p, jcfg, jnp.asarray(tokens),
                                              jplan, M)
    return sched, mb_of, tokens, mine, theirs


@pytest.mark.parametrize("name,S,form", CASES)
def test_packed_forward_matches_jax(name, S, form):
    jcfg, cfg = CONFIGS[name]
    params, _ = _jax_params(name)
    sched, mb_of, tokens, mine, theirs = _plans(cfg, form, S)
    def jloss_fn(p):
        logits = theirs(p, jcfg)[0]
        return jnp.mean(logits ** 2), logits

    (jloss, jlog), jgrads = jax.jit(jax.value_and_grad(
        jloss_fn, has_aux=True))(params)

    model = _port(name)
    logits, aux = mine(model, torch.from_numpy(tokens))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlog),
                               atol=LOGIT_TOL, rtol=0)
    assert float(aux["aux_loss"]) == 0.0
    loss = torch.mean(logits ** 2)
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               atol=LOGIT_TOL, rtol=0)
    _assert_grads(_grads(model, loss), _flat(jax.tree.map(np.asarray,
                                                          jgrads)))


@pytest.mark.parametrize("form", ["sample", "mb"])
def test_packed_equals_masked(form):
    """The port's packed forms against its own masked path on the same
    weights and table (tests/test_d2ft.py:43-66 and :126-150)."""
    cfg = CONFIGS["d2ft"][1]
    sched, mb_of, tokens, mine, _ = _plans(cfg, form, 16, seed=3)
    model = _port("d2ft")
    toks = torch.from_numpy(tokens)
    gates = gates_from_schedule(sched, mb_of, "cpu")
    lm, _ = forward(model, cfg, toks, gates=gates)
    lp, _ = mine(model, toks)
    np.testing.assert_allclose(lp.detach().numpy(), lm.detach().numpy(),
                               atol=LOGIT_TOL, rtol=0)
    _assert_grads(_grads(model, torch.mean(lp ** 2)),
                  _grads(model, torch.mean(lm ** 2)), LOGIT_TOL)


# 2 layers, d 32, 2 heads, G 2, M 4, B 8: subnet (0, 0) runs [p_o, p_f,
# p_s, p_s], every other [p_f, p_f, p_o, p_s]; n_pf is 2, so the reference
# puts subnet (0, 0)'s p_o micro-batch in its p_f part
UNBALANCED = dict(name="u", arch_type="dense", n_layers=2, d_model=32,
                  n_heads=2, n_kv_heads=2, d_ff=64, vocab_size=53)


def test_unbalanced_table_keeps_the_masked_semantics():
    jcfg, cfg = JaxModelConfig(**UNBALANCED), ModelConfig(**UNBALANCED)
    table = np.tile(np.array([P_F, P_F, P_O, P_S], np.int8), (4, 1))
    table[0] = [P_O, P_F, P_S, P_S]
    sched = Schedule(table, 2, 2)
    M, B, S = 4, 8, 8
    mb_of = microbatch_assignment(B, M)
    tokens = np.random.default_rng(5).integers(0, 53, (B, S)).astype(
        np.int32)
    params = jax.jit(jax_init_model, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg)
    jg = tuple(map(jnp.asarray, jax_gates(_jax_sched(sched), mb_of)))
    jplan = tuple(map(jnp.asarray, jax_d2ft.mb_packed_indices(
        _jax_sched(sched), M)))
    jt = jnp.asarray(tokens)
    jm = jax.jit(jax.grad(lambda p: jnp.mean(
        jax_forward(p, jcfg, tokens=jt, gates=jg)[0] ** 2)))(params)
    jp = jax.jit(jax.grad(lambda p: jnp.mean(jax_d2ft.packed_forward_mb(
        p, jcfg, jt, jplan, M)[0] ** 2)))(params)
    jm, jp = (_flat(jax.tree.map(np.asarray, g)) for g in (jm, jp))
    # the reference's fault, shown: its micro-batch path is off the masked
    # path's gradients where the p_o micro-batch sits in the p_f part
    assert max(np.abs(jp[k] - jm[k]).max() for k in jm) > 1e-2

    model = init_model(torch.Generator().manual_seed(0), cfg)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    toks = torch.from_numpy(tokens)
    lp, _ = d2ft.packed_forward_mb(model, cfg, toks,
                                   d2ft.mb_packed_indices(sched, M), M)
    lm, _ = forward(model, cfg, toks,
                    gates=gates_from_schedule(sched, mb_of, "cpu"))
    np.testing.assert_allclose(lp.detach().numpy(), lm.detach().numpy(),
                               atol=LOGIT_TOL, rtol=0)
    mine = _grads(model, torch.mean(lp ** 2))
    _assert_grads(mine, _grads(model, torch.mean(lm ** 2)), LOGIT_TOL)
    _assert_grads(mine, jm)


def test_packed_finetune_trajectory_matches_jax():
    """3 steps of ``finetune(packed=True)`` on the gemma3 smoke config:
    scores and knapsack on the first batch, then per batch the gather plan
    of ``packed_indices``, the mean token cross-entropy, AdamW, clipping."""
    jcfg, cfg = CONFIGS["gemma3"]
    params, _ = _jax_params("gemma3")
    d2 = dict(n_microbatches=4, n_pf=2, n_po=1, head_groups=4)
    jp, _, jlog = jax_finetune(
        params, jcfg, JaxD2FTConfig(**d2), jax_adamw(1e-3),
        lm_batches(0, cfg.vocab_size, 8, 16, 3), steps=3, packed=True)
    model, state, log = finetune(
        _port("gemma3"), cfg, D2FTConfig(**d2), adamw(1e-3),
        lm_batches(0, cfg.vocab_size, 8, 16, 3), steps=3, packed=True)
    assert state["step"] == 3 and len(log.step_times) == 3
    np.testing.assert_allclose(log.losses, jlog.losses, atol=TRAJ_TOL,
                               rtol=0)
    for k in ("ce", "grad_norm"):
        np.testing.assert_allclose([m[k] for m in log.metrics],
                                   [m[k] for m in jlog.metrics],
                                   atol=TRAJ_TOL, rtol=0, err_msg=k)
    theirs = _flat(jax.tree.map(np.asarray, jp))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), theirs[name],
                                   atol=TRAJ_TOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("form", ["sample", "mb", "masked"])
def test_remat_gives_the_same_values_and_gradients(form):
    cfg = CONFIGS["gemma3"][1]
    sched, mb_of, tokens, mine, _ = _plans(cfg, "sample" if form == "masked"
                                           else form, 32)
    model = _port("gemma3")
    toks = torch.from_numpy(tokens)
    gates = gates_from_schedule(sched, mb_of, "cpu")

    def run(remat):
        if form == "masked":
            logits, _ = forward(model, cfg, toks, gates=gates, remat=remat)
        else:
            logits, _ = mine(model, toks, remat=remat)
        return logits, _grads(model, torch.mean(logits ** 2))

    (l0, g0), (l1, g1) = run(False), run(True)
    np.testing.assert_array_equal(l1.detach().numpy(), l0.detach().numpy())
    # the recomputed backward may add a gradient's terms in another order
    _assert_grads(g1, g0, 1e-6)


def test_packed_path_refuses_what_it_would_drop():
    """An MoE FFN (olmoe-1b-7b's smoke config), biased q / k / v
    projections and non-attention blocks raise, where the reference skips
    the FFN, ignores the biases or asserts."""
    toks = torch.zeros((4, 8), dtype=torch.long)
    for cfg, match in (
            (get_smoke_config("olmoe-1b-7b"), "MoE FFN"),
            (ModelConfig(**dict(CFG, qkv_bias=True)), "biases"),
            (get_smoke_config("mamba2-130m"), "attention blocks only")):
        model = init_model(torch.Generator().manual_seed(0), cfg)
        G = max(cfg.n_heads, 1)
        sched = _schedule(cfg.n_layers, G, 4, 2, 1)
        plan = packed_indices(sched, microbatch_assignment(4, 4))[:3]
        with pytest.raises(ValueError, match=match):
            d2ft.packed_forward(model, cfg, toks, plan)
        with pytest.raises(ValueError, match=match):
            d2ft.packed_forward_mb(model, cfg, toks,
                                   d2ft.mb_packed_indices(sched, 4), 4)
