"""olmoe-1b-7b's smoke config (2 layers, d 128, 4 heads of 32, 4 experts
top-2 of d_ff 64, vocab 512) in the PyTorch port against the JAX package
on the CPU (the MoE kernel core and layer are in
``tests/test_torch_moe.py``):

* ``params_from_jax``; ``forward`` and ``lm_loss`` at G 1 and 4, gated or
  not, on the masked and the kernel path, within 1e-5; the scores and the
  schedule they give;
* a 3-step SGD ``finetune`` within 1e-4 (losses, aux included, metrics
  and parameters), the launcher on the CPU;
* per-expert LoRA adapters (``init_lora`` keeps the leading dims): the
  adapter counts at the smoke config and, by shapes, at full olmoe
  (26,738,688 at rank 8 on wq/wk/wv/w_up), and a 3-step D2FT-LoRA
  trajectory within 1e-4 of the JAX step of ``tests/test_parity_matrix.py``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import olmoe_1b_7b as jax_olmoe
from repro.configs.base import D2FTConfig as JaxD2FTConfig
from repro.core import lora as jax_lora
from repro.core.d2ft import plan_schedule as jax_plan_schedule
from repro.core.scores import compute_scores as jax_compute_scores
from repro.core.scores import transformer_blocks as jax_transformer_blocks
from repro.models.transformer import forward as jax_forward
from repro.models.transformer import init_model as jax_init_model
from repro.models.transformer import lm_loss as jax_lm_loss
from repro.optim.optimizers import sgd as jax_sgd
from repro.train.loop import finetune as jax_finetune
from repro_torch.configs import get_config, olmoe_1b_7b
from repro_torch.configs.base import D2FTConfig
from repro_torch.core.lora import init_lora, lora_param_count
from repro_torch.core.scores import compute_scores, transformer_blocks
from repro_torch.data.synthetic import lm_batches, split_microbatches
from repro_torch.examples import lora_finetune as example
from repro_torch.interop import lora_from_jax, params_from_jax
from repro_torch.launch import train as launcher
from repro_torch.models.transformer import forward, init_model, lm_loss
from repro_torch.optim.optimizers import sgd
from repro_torch.train.loop import finetune, plan_from_scores

from test_torch_moe import AUX_TOL, B, S, STEP_TOL, TRAJ_TOL, _t


# ================================================ olmoe-1b-7b smoke model
@functools.lru_cache(maxsize=None)
def _carried():
    params = jax.jit(jax_init_model, static_argnums=1)(
        jax.random.PRNGKey(0), jax_olmoe.smoke_config())
    return params, jax.tree.map(np.asarray, params)


def _port(tree):
    model = init_model(torch.Generator().manual_seed(0),
                       olmoe_1b_7b.smoke_config())
    model.load_state_dict(params_from_jax(tree))
    return model


def _flat(tree):
    return {k: v.numpy() for k, v in params_from_jax(tree).items()}


def test_params_from_jax_carries_moe_leaves():
    _, tree = _carried()
    state = params_from_jax(tree)
    model = init_model(torch.Generator().manual_seed(0),
                       olmoe_1b_7b.smoke_config())
    assert set(state) == set(model.state_dict())
    model.load_state_dict(state)
    for i in range(2):
        for leaf in ("router", "w_up", "w_gate", "w_down"):
            np.testing.assert_array_equal(
                getattr(model.layers[i].moe, leaf).detach().numpy(),
                tree["cycles"][0]["moe"][leaf][i])
    assert tuple(model.layers[0].moe.w_up.shape) == (4, 128, 64)
    assert not hasattr(model.layers[0], "mlp")


@pytest.mark.parametrize("G,gated,use_kernel", [
    (1, False, False), (1, True, False), (1, True, True), (4, True, False),
    (4, True, True)])
def test_forward_and_lm_loss_match_jax(G, gated, use_kernel):
    params, tree = _carried()
    cfg, jcfg = olmoe_1b_7b.smoke_config(), jax_olmoe.smoke_config()
    rng = np.random.default_rng(G * 10 + gated + 2 * use_kernel)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    gates = bounds = None
    if gated:
        op = rng.integers(0, 3, (cfg.n_layers, B, G))
        op[:, 0, 0] = 0                        # a backward-live sample
        gates = ((op != 2).astype(np.float32), (op == 0).astype(np.float32))
        if use_kernel:
            bounds = (int((gates[0] != 0).sum(axis=(1, 2)).max()),
                      int((gates[1] != 0).sum(axis=(1, 2)).max()))
    jg = None if gates is None else tuple(map(jnp.asarray, gates))
    jlogits, jaux = jax.jit(
        lambda p: jax_forward(p, jcfg, tokens=jnp.asarray(tokens), gates=jg,
                              use_kernel=use_kernel, live_bounds=bounds)
    )(params)
    (jl, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jax_lm_loss(p, jcfg, jnp.asarray(tokens),
                              jnp.asarray(labels), gates=jg,
                              use_kernel=use_kernel, live_bounds=bounds),
        has_aux=True))(params)

    model = _port(tree)
    tg = None if gates is None else tuple(map(_t, gates))
    with torch.no_grad():
        logits, aux = forward(model, cfg, _t(tokens), gates=tg,
                              use_kernel=use_kernel, live_bounds=bounds)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=STEP_TOL, rtol=0)
    np.testing.assert_allclose(float(aux["aux_loss"]),
                               float(jaux["aux_loss"]), atol=AUX_TOL, rtol=0)
    assert float(aux["aux_loss"]) > 0.0
    loss, metrics = lm_loss(model, cfg, _t(tokens), _t(labels), gates=tg,
                            use_kernel=use_kernel, live_bounds=bounds)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl),
                               atol=STEP_TOL, rtol=0)
    np.testing.assert_allclose(float(metrics["aux"]),
                               float(jaux["aux_loss"]), atol=AUX_TOL, rtol=0)
    theirs = _flat(jax.tree.map(np.asarray, jgrads))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), theirs[name],
                                   atol=STEP_TOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("G", [1, 4])
def test_scores_give_the_jax_schedule(G):
    params, tree = _carried()
    cfg, jcfg = olmoe_1b_7b.smoke_config(), jax_olmoe.smoke_config()
    d2 = dict(n_microbatches=4, n_pf=2, n_po=1, head_groups=G)
    batch = next(lm_batches(3, cfg.vocab_size, 8, 16, 1))
    jmbs = split_microbatches({k: jnp.asarray(v) for k, v in batch.items()},
                              4)
    jscores = jax_compute_scores(
        lambda p, mb: jax_lm_loss(p, jcfg, mb["tokens"], mb["labels"])[0],
        params, lambda t: jax_transformer_blocks(t, jcfg), jmbs, G)
    jsched = jax_plan_schedule(JaxD2FTConfig(**d2), *jscores, cfg.n_layers,
                               G)
    model = _port(tree)
    params_t = dict(model.named_parameters())
    mbs = split_microbatches({k: _t(v) for k, v in batch.items()}, 4)

    def loss(p, mb):
        return lm_loss(model, cfg, mb["tokens"], mb["labels"])[0]

    scores = compute_scores(loss, params_t, transformer_blocks, mbs, G)
    for mine, theirs in zip(scores, jscores):
        np.testing.assert_allclose(mine, theirs, rtol=1e-4)
    sched = plan_from_scores(cfg, D2FTConfig(**d2), params_t, mbs, loss)
    np.testing.assert_array_equal(sched.table, jsched.table)


@pytest.mark.parametrize("G,use_kernel", [(1, True), (4, False), (4, True)])
def test_finetune_trajectory_matches_jax(G, use_kernel):
    """3 SGD steps of the launcher's loop: scores and knapsack on the first
    batch, then the gates (and on the kernel path the bounds) per batch,
    clipping; losses (aux included), metrics and parameters."""
    params, tree = _carried()
    cfg = olmoe_1b_7b.smoke_config()
    d2 = dict(n_microbatches=4, n_pf=2, n_po=1, head_groups=G)
    jp, _, jlog = jax_finetune(
        params, jax_olmoe.smoke_config(), JaxD2FTConfig(**d2),
        jax_sgd(0.1), lm_batches(0, cfg.vocab_size, 8, 16, 3), steps=3,
        use_kernel=use_kernel)
    model, state, log = finetune(
        _port(tree), cfg, D2FTConfig(**d2), sgd(0.1),
        lm_batches(0, cfg.vocab_size, 8, 16, 3), steps=3,
        use_kernel=use_kernel)
    np.testing.assert_allclose(log.losses, jlog.losses, atol=TRAJ_TOL,
                               rtol=0)
    for k in ("ce", "aux", "grad_norm"):
        np.testing.assert_allclose([m[k] for m in log.metrics],
                                   [m[k] for m in jlog.metrics],
                                   atol=TRAJ_TOL, rtol=0, err_msg=k)
    theirs = _flat(jax.tree.map(np.asarray, jp))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), theirs[name],
                                   atol=TRAJ_TOL, rtol=0, err_msg=name)


def test_launcher_runs_olmoe_on_the_cpu(capsys):
    log = launcher.main(["--arch", "olmoe-1b-7b", "--d2ft", "--kernel",
                         "--batch", "8", "--seq", "16", "--steps", "2",
                         "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "arch=olmoe-1b-7b layers=2 d_model=128 device=cpu"
    assert len(log.losses) == 2 and np.isfinite(log.losses).all()


# ============================================================ per-expert LoRA
TARGETS = ("wq", "wk", "wv", "w_up")


def _meta_params(shapes):
    """The port's parameter names for a JAX shape tree (the unstacking rule
    of ``params_from_jax``), as meta tensors: shapes without memory."""
    out = {}
    for path, s in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        if keys[0] == "cycles":
            for c in range(s.shape[0]):
                out[".".join(map(str, ["layers", c] + keys[2:]))] = \
                    torch.empty(s.shape[1:], device="meta")
        else:
            out[".".join(map(str, keys))] = torch.empty(s.shape,
                                                        device="meta")
    return out


def test_lora_adapters_are_per_expert():
    """Smoke: one adapter per expert of w_up, the same names, shapes and
    count as JAX's; full olmoe-1b-7b (by shapes): 26,738,688 parameters at
    rank 8 on wq/wk/wv/w_up, as ``jax.eval_shape`` of JAX's init_lora."""
    params, tree = _carried()
    cfg = olmoe_1b_7b.smoke_config()
    jl = jax_lora.init_lora(jax.random.PRNGKey(3), params, rank=2,
                            targets=TARGETS)
    mine = init_lora(torch.Generator().manual_seed(3),
                     dict(_port(tree).named_parameters()), rank=2,
                     targets=TARGETS)
    carried = lora_from_jax(jax.tree.map(np.asarray, jl), cfg)
    assert {n: {k: tuple(t.shape) for k, t in ab.items()}
            for n, ab in mine.items()} == \
        {n: {k: tuple(t.shape) for k, t in ab.items()}
         for n, ab in carried.items()}
    assert mine["layers.1.moe.w_up"]["a"].shape == (4, 128, 2)
    assert lora_param_count(mine) == jax_lora.lora_param_count(jl)

    jcfg = jax_olmoe.CONFIG
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(
        functools.partial(jax_init_model, cfg=jcfg), key)
    want = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(
        jax.eval_shape(lambda k: jax_lora.init_lora(k, shapes, rank=8,
                                                    targets=TARGETS), key)))
    full = init_lora(torch.Generator().manual_seed(0),
                     _meta_params(shapes), rank=8, targets=TARGETS)
    assert lora_param_count(full) == want == 26_738_688
    assert sum(t.numel() for t in _meta_params(shapes).values()) == \
        6_919_096_320 == sum(t.numel() for t in (
            torch.empty(s.shape, device="meta")
            for s in jax.tree.leaves(shapes)))
    assert get_config("olmoe-1b-7b").moe.n_experts == 64


def _jax_lora_step(base, opt, use_kernel, cfg):
    """``tests/test_parity_matrix.py``'s ``_make_lora_step``."""
    def step(lora_p, st, batch, gates):
        def loss(lp):
            merged = jax_lora.merge_lora(base, lp, 1.0)
            return jax_lm_loss(merged, cfg, batch["tokens"], batch["labels"],
                               gates=gates, use_kernel=use_kernel)[0]
        return opt.update(jax.grad(loss)(lora_p), st, lora_p)
    return jax.jit(step)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_lora_trajectory_matches_jax(use_kernel):
    """3 SGD steps of D2FT-LoRA with per-expert w_up adapters (rank 2),
    gates from a p_f / p_o / p_s mix, JAX's adapters carried over: the
    port's ``make_lora_step`` against the JAX parity matrix's step."""
    params, tree = _carried()
    cfg, jcfg = olmoe_1b_7b.smoke_config(), jax_olmoe.smoke_config()
    rng = np.random.default_rng(13)
    op = rng.integers(0, 3, (cfg.n_layers, 8, 4))
    op[0, 0, 0] = 0
    gates = ((op != 2).astype(np.float32), (op == 0).astype(np.float32))
    batch = next(lm_batches(0, cfg.vocab_size, 8, 16, 1))
    jl = jax_lora.init_lora(jax.random.PRNGKey(3), params, rank=2,
                            targets=TARGETS)
    jl = jax.tree.map(lambda a: a + 0.01, jl)      # non-zero B: live deltas
    opt = jax_sgd(1e-2)
    jstep = _jax_lora_step(params, opt, use_kernel, jcfg)
    p, st = jl, opt.init(jl)
    for _ in range(3):
        p, st = jstep(p, st, {k: jnp.asarray(v) for k, v in batch.items()},
                      tuple(map(jnp.asarray, gates)))

    model = _port(tree)
    lora = lora_from_jax(jax.tree.map(np.asarray, jl), cfg)
    port_opt = sgd(1e-2)
    state = port_opt.init({f"{n}.{k}": ab[k] for n, ab in lora.items()
                           for k in ("a", "b")})
    step = example.make_lora_step(model, cfg, port_opt,
                                  use_kernel=use_kernel)
    tb = {k: _t(v) for k, v in batch.items()}
    for _ in range(3):
        step(lora, state, tb, tuple(map(_t, gates)))
    theirs = lora_from_jax(jax.tree.map(np.asarray, p), cfg)
    assert set(lora) == set(theirs)
    for n, ab in lora.items():
        for k in ("a", "b"):
            np.testing.assert_allclose(ab[k].detach().numpy(),
                                       theirs[n][k].detach().numpy(),
                                       atol=TRAJ_TOL, rtol=0,
                                       err_msg=f"{n}.{k}")
