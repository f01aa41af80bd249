"""Every arch of the config zoo in the PyTorch port against jitted JAX on
the CPU, at each arch's smoke config (2 to 7 layers, d 128, hd 32; MoE 4
experts), with the JAX params carried over by ``params_from_jax`` (q / k /
v biases, which JAX initialises to zero, set to N(0, 0.1) values first, so
that they count) and the features crossed as numpy arrays:

* the registry: ``ARCH_IDS`` in JAX's order, ``SKIPS``, ``live_pairs`` and
  every full and smoke config field for field;
* ungated ``forward`` logits, ``lm_loss`` and every gradient (B 2, S 16:
  16 text tokens, or 8 patches + 8 text tokens, or 16 audio frames);
* the gated loss and gradients with ``use_kernel=True`` (the kernels'
  plain versions on the CPU) and the schedule's live-slice bounds, on
  ``tests/test_config_zoo.py``'s mixed p_f / p_o / p_s schedule (G 4, N 2,
  B 2, S 16), against JAX's masked gated path, with ``contract.
  on_fallback`` armed: no arch takes a non-kernel route;
* the batched prefill and three ``decode_step``s, for every arch but
  hubert-xlarge and phi-3-vision-4.2b (JAX's own ``tests/test_archs.py``
  leaves them out).

One JAX compile per arch (``_jax_outputs``) computes everything JAX
contributes. Tolerances: 1e-5 for one forward and its gradients, 1e-4 over
a prefill and decode steps (f32 sums in another order).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.core.schedule import Schedule as JaxSchedule
from repro.core.schedule import gates_from_schedule as jax_gates
from repro.data.synthetic import microbatch_assignment
from repro.models import transformer as jax_tf
from repro_torch import configs
from repro_torch.core.schedule import (P_F, P_O, P_S, Schedule,
                                       gates_from_schedule,
                                       live_slice_bounds)
from repro_torch.interop import params_from_jax
from repro_torch.kernels import contract
from repro_torch.models import transformer as tf

OP_TOL = 1e-5
TRAJ_TOL = 1e-4
B, S = 2, 16
G, N = 4, 2            # the zoo test's gate groups and micro-batches
DECODE_ARCHS = [a for a in configs.ARCH_IDS
                if a not in ("hubert-xlarge", "phi-3-vision-4.2b")]


def _batch(cfg):
    """numpy {"tokens"?, "features"?, "labels"} of B x S positions."""
    rng = np.random.default_rng(7)
    batch = {}
    n_text = S
    if cfg.frontend == "audio_stub":
        batch["features"] = rng.standard_normal(
            (B, S, cfg.frontend_dim)).astype(np.float32)
        n_text = 0
    elif cfg.frontend == "vision_stub":
        batch["features"] = rng.standard_normal(
            (B, cfg.frontend_tokens, cfg.frontend_dim)).astype(np.float32)
        n_text = S - cfg.frontend_tokens
    if n_text:
        batch["tokens"] = rng.integers(0, cfg.vocab_size,
                                       (B, n_text)).astype(np.int32)
    batch["labels"] = rng.integers(0, cfg.vocab_size,
                                   (B, n_text or S)).astype(np.int32)
    return batch


def _mixed_table(L):
    """``tests/test_config_zoo.py``'s schedule: every op in one step."""
    rng = np.random.default_rng(11)
    table = rng.choice([P_F, P_O, P_S], size=(L * G, N),
                       p=[.4, .3, .3]).astype(np.int8)
    table[0, 0] = P_F
    return table


@functools.lru_cache(maxsize=None)
def _carried(arch):
    """(JAX params with random q / k / v biases, their numpy tree)."""
    jcfg = jax_configs.get_smoke_config(arch)
    params = jax.jit(jax_tf.init_model, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(3)

    def biased(path, leaf):
        name = getattr(path[-1], "key", None)
        if name in ("bq", "bk", "bv"):
            return jnp.asarray(0.1 * rng.standard_normal(leaf.shape),
                               leaf.dtype)
        return leaf
    params = jax.tree_util.tree_map_with_path(biased, params)
    return params, jax.tree.map(np.asarray, params)


@functools.lru_cache(maxsize=None)
def _jax_outputs(arch):
    """Everything JAX contributes for ``arch``, in one jitted call: the
    ungated logits, loss and gradients; the masked gated loss and
    gradients; for a decoder the prefill logits and three decode steps'."""
    params, _ = _carried(arch)
    jcfg = jax_configs.get_smoke_config(arch)
    batch = {k: jnp.asarray(v) for k, v in _batch(jcfg).items()}
    gates = jax_gates(JaxSchedule(_mixed_table(jcfg.n_layers),
                                  jcfg.n_layers, G),
                      microbatch_assignment(B, N))
    decode = arch in DECODE_ARCHS

    def loss(p, g):
        return jax_tf.lm_loss(p, jcfg, batch.get("tokens"), batch["labels"],
                              features=batch.get("features"), gates=g)[0]

    def run(p):
        logits, _ = jax_tf.forward(p, jcfg, tokens=batch.get("tokens"),
                                   features=batch.get("features"))
        out = {"logits": logits}
        out["loss"], out["grads"] = jax.value_and_grad(loss)(p, None)
        out["gated_loss"], out["gated_grads"] = jax.value_and_grad(loss)(
            p, gates)
        if decode:
            toks = batch["tokens"]
            lg, cache = jax_tf.prefill_forward(p, jcfg, toks[:, :12], 16)
            steps = [lg]
            for t in range(12, 15):
                lg, cache = jax_tf.decode_step(p, cache, jcfg,
                                               toks[:, t:t + 1],
                                               jnp.int32(t))
                steps.append(lg)
            out["decode"] = steps
        return out
    return jax.tree.map(np.asarray, jax.jit(run)(params))


def _port(arch):
    cfg = configs.get_smoke_config(arch)
    model = tf.init_model(torch.Generator().manual_seed(0), cfg)
    model.load_state_dict(params_from_jax(_carried(arch)[1]))
    return cfg, model


def _t(batch, key):
    return None if key not in batch else torch.from_numpy(batch[key])


def _check_grads(model, theirs, tol):
    flat = {k: v.numpy() for k, v in params_from_jax(theirs).items()}
    assert {n for n, _ in model.named_parameters()} == set(flat)
    for name, p in model.named_parameters():
        # hubert-xlarge's encoder never reads its token table
        mine = np.zeros_like(flat[name]) if p.grad is None else p.grad.numpy()
        np.testing.assert_allclose(mine, flat[name], atol=tol, rtol=0,
                                   err_msg=name)


def test_registry_matches_jax():
    assert configs.ARCH_IDS == jax_configs.ARCH_IDS
    assert configs.ARCH_MODULES == jax_configs.ARCH_MODULES
    assert configs.SKIPS == jax_configs.SKIPS
    assert list(configs.live_pairs()) == list(jax_configs.live_pairs())


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_config_equals_jax(arch):
    for get in ("get_config", "get_smoke_config"):
        mine = dataclasses.asdict(getattr(configs, get)(arch))
        theirs = dataclasses.asdict(getattr(jax_configs, get)(arch))
        assert mine == theirs, get


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_forward_loss_and_grads_match_jax(arch):
    ref = _jax_outputs(arch)
    cfg, model = _port(arch)
    batch = _batch(cfg)
    with torch.no_grad():
        logits, aux = tf.forward(model, cfg, _t(batch, "tokens"),
                                 features=_t(batch, "features"))
    assert logits.shape == (B, S, cfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), ref["logits"], atol=OP_TOL,
                               rtol=0)
    loss, _ = tf.lm_loss(model, cfg, _t(batch, "tokens"),
                         _t(batch, "labels"), features=_t(batch, "features"))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), ref["loss"],
                               atol=OP_TOL, rtol=0)
    _check_grads(model, ref["grads"], OP_TOL)


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_gated_kernel_route_matches_jax_masked_path(arch):
    """The zoo's mixed schedule through ``use_kernel=True`` with the
    launcher's compaction bounds: loss and gradients of JAX's masked
    path, and no ``on_fallback`` report."""
    ref = _jax_outputs(arch)
    cfg, model = _port(arch)
    batch = _batch(cfg)
    sched = Schedule(_mixed_table(cfg.n_layers), cfg.n_layers, G)
    mb_of = microbatch_assignment(B, N)
    gates = gates_from_schedule(sched, mb_of, "cpu")
    fallbacks = []
    contract.on_fallback = lambda kind, why: fallbacks.append((kind, why))
    try:
        loss, _ = tf.lm_loss(model, cfg, _t(batch, "tokens"),
                             _t(batch, "labels"),
                             features=_t(batch, "features"), gates=gates,
                             use_kernel=True,
                             live_bounds=live_slice_bounds(sched, mb_of))
        loss.backward()
    finally:
        contract.on_fallback = None
    assert not fallbacks, fallbacks
    np.testing.assert_allclose(float(loss.detach()), ref["gated_loss"],
                               atol=OP_TOL, rtol=0)
    _check_grads(model, ref["gated_grads"], OP_TOL)


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_prefill_and_decode_steps_match_jax(arch):
    ref = _jax_outputs(arch)
    cfg, model = _port(arch)
    toks = torch.from_numpy(_batch(cfg)["tokens"]).long()
    with torch.inference_mode():
        lg, cache = tf.prefill_forward(model, cfg, toks[:, :12], 16)
        steps = [lg]
        for t in range(12, 15):
            lg, cache = tf.decode_step(model, cache, cfg, toks[:, t:t + 1], t)
            steps.append(lg)
    for i, (mine, theirs) in enumerate(zip(steps, ref["decode"])):
        np.testing.assert_allclose(mine.numpy(), theirs, atol=TRAJ_TOL,
                                   rtol=0, err_msg=f"call {i}")
