"""The cases of the LLM fine-tune slice's CPU tests, shared by
``tests/test_torch_lm_train.py`` (scores, fine-tune, the launcher) and
``tests/test_torch_lm_forward.py`` (forward and loss), which split one
file so that no file holds a test worker for long: the smoke configs, the
JAX weights carried over, and the bodies of the forward / loss, scores and
fine-tune trajectory tests.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import gemma3_1b as jax_gemma
from repro.configs import mamba2_130m as jax_mamba
from repro.configs import recurrentgemma_2b as jax_rg
from repro.configs.base import D2FTConfig as JaxD2FTConfig
from repro.core.d2ft import plan_schedule as jax_plan_schedule
from repro.core.scores import compute_scores as jax_compute_scores
from repro.core.scores import transformer_blocks as jax_transformer_blocks
from repro.models.transformer import forward as jax_forward
from repro.models.transformer import init_model as jax_init_model
from repro.models.transformer import lm_loss as jax_lm_loss
from repro.optim.optimizers import adamw as jax_adamw
from repro.train.loop import finetune as jax_finetune
from repro_torch.configs import gemma3_1b, mamba2_130m, recurrentgemma_2b
from repro_torch.configs.base import D2FTConfig
from repro_torch.core.scores import compute_scores, transformer_blocks
from repro_torch.data.synthetic import lm_batches, split_microbatches
from repro_torch.interop import params_from_jax
from repro_torch.models.transformer import forward, init_model, lm_loss
from repro_torch.optim.optimizers import adamw
from repro_torch.train.loop import finetune, plan_from_scores

STEP_TOL = 1e-5
TRAJ_TOL = 1e-4
B, S = 4, 21           # S 21: the scan's pad path (chunk 8), past window 8
# smoke configs: arch -> (JAX config module, port config module)
ARCHS = {"mamba2": (jax_mamba, mamba2_130m), "gemma3": (jax_gemma, gemma3_1b),
         "recurrentgemma": (jax_rg, recurrentgemma_2b)}


@functools.lru_cache(maxsize=None)
def _carried(arch):
    """(JAX params, their numpy tree) of the arch's smoke model, seed 0."""
    cfg = ARCHS[arch][0].smoke_config()
    params = jax.jit(jax_init_model, static_argnums=1)(
        jax.random.PRNGKey(0), cfg)
    return params, jax.tree.map(np.asarray, params)


def _port(tree, arch="mamba2"):
    model = init_model(torch.Generator().manual_seed(0),
                       ARCHS[arch][1].smoke_config())
    model.load_state_dict(params_from_jax(tree))
    return model


def _flat(tree):
    return {k: v.numpy() for k, v in params_from_jax(tree).items()}


def _gates(rng, L, G):
    ops_ = rng.integers(0, 3, (L, B, G))
    return (ops_ != 2).astype(np.float32), (ops_ == 0).astype(np.float32)


def forward_case(arch, G, gated, use_kernel):
    params, tree = _carried(arch)
    jmod, mod = ARCHS[arch]
    cfg = mod.smoke_config()
    rng = np.random.default_rng(G * 10 + gated + 2 * use_kernel)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    gates = bounds = None
    if gated:
        g_f, g_b = _gates(rng, cfg.n_layers, G)
        gates = (g_f, g_b)
        if use_kernel:
            bounds = (int((g_f != 0).sum(axis=(1, 2)).max()),
                      int((g_b != 0).sum(axis=(1, 2)).max()))

    jcfg = jmod.smoke_config()
    jg = None if gates is None else tuple(map(jnp.asarray, gates))
    jlogits, _ = jax.jit(
        lambda p: jax_forward(p, jcfg, tokens=jnp.asarray(tokens), gates=jg,
                              use_kernel=use_kernel, live_bounds=bounds)
    )(params)
    (jl, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jax_lm_loss(p, jcfg, jnp.asarray(tokens),
                              jnp.asarray(labels), gates=jg,
                              use_kernel=use_kernel, live_bounds=bounds),
        has_aux=True))(params)

    model = _port(tree, arch)
    tg = None if gates is None else tuple(map(torch.from_numpy, gates))
    tt = torch.from_numpy(tokens)
    with torch.no_grad():
        logits, aux = forward(model, cfg, tt, gates=tg,
                              use_kernel=use_kernel, live_bounds=bounds)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=STEP_TOL, rtol=0)
    assert float(aux["aux_loss"]) == 0.0
    loss, metrics = lm_loss(model, cfg, tt, torch.from_numpy(labels),
                            gates=tg, use_kernel=use_kernel,
                            live_bounds=bounds)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl),
                               atol=STEP_TOL, rtol=0)
    assert float(metrics["ce"].detach()) == float(loss.detach())
    theirs = _flat(jax.tree.map(np.asarray, jgrads))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), theirs[name],
                                   atol=STEP_TOL, rtol=0, err_msg=name)



def scores_case(arch, G):
    """Fisher / weight-magnitude scores of the SSD or attention blocks over
    ``transformer_blocks`` of the flat layers (rtol 1e-4), then the
    knapsack: the same schedule as JAX's."""
    params, tree = _carried(arch)
    jmod, mod = ARCHS[arch]
    cfg = mod.smoke_config()
    d2 = dict(n_microbatches=4, n_pf=2, n_po=1, head_groups=G)
    batch = next(lm_batches(3, cfg.vocab_size, 8, 16, 1))
    jcfg = jmod.smoke_config()
    jmbs = split_microbatches({k: jnp.asarray(v) for k, v in batch.items()},
                              4)

    def jloss(p, mb):
        return jax_lm_loss(p, jcfg, mb["tokens"], mb["labels"])[0]

    jscores = jax_compute_scores(jloss, params,
                                 lambda t: jax_transformer_blocks(t, jcfg),
                                 jmbs, G)
    jsched = jax_plan_schedule(JaxD2FTConfig(**d2), *jscores, cfg.n_layers,
                               G)
    model = _port(tree, arch)
    params_t = dict(model.named_parameters())
    mbs = split_microbatches({k: torch.from_numpy(v)
                              for k, v in batch.items()}, 4)

    def loss(p, mb):
        return lm_loss(model, cfg, mb["tokens"], mb["labels"])[0]

    scores = compute_scores(loss, params_t, transformer_blocks, mbs, G)
    for mine, theirs in zip(scores, jscores):
        assert mine.shape == (cfg.n_layers * G, 4)
        np.testing.assert_allclose(mine, theirs, rtol=1e-4)
    sched = plan_from_scores(cfg, D2FTConfig(**d2), params_t, mbs, loss)
    assert len(transformer_blocks(params_t)) == cfg.n_layers
    assert (sched.n_layers, sched.n_groups) == (cfg.n_layers, G)
    np.testing.assert_array_equal(sched.table, jsched.table)



def finetune_case(arch, use_kernel):
    """3 steps of the launcher's loop: scores and knapsack on the first
    batch, then per batch the gates (and, on the kernel path, the
    compaction bounds), AdamW, clipping."""
    params, tree = _carried(arch)
    jmod, mod = ARCHS[arch]
    cfg = mod.smoke_config()
    d2 = dict(n_microbatches=4, n_pf=2, n_po=1, head_groups=4)
    jp, _, jlog = jax_finetune(
        params, jmod.smoke_config(), JaxD2FTConfig(**d2),
        jax_adamw(1e-3), lm_batches(0, cfg.vocab_size, 8, 16, 3), steps=3,
        use_kernel=use_kernel)
    model = _port(tree, arch)
    model, state, log = finetune(
        model, cfg, D2FTConfig(**d2), adamw(1e-3),
        lm_batches(0, cfg.vocab_size, 8, 16, 3), steps=3,
        use_kernel=use_kernel)
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
