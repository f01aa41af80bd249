"""The LLM fine-tune slice of the PyTorch port against the JAX package on
the CPU, at the mamba2 smoke config (2 SSD layers, d 128, 16 heads of
P 16, state 16, chunk 8, vocab 512): weights carried over with
``params_from_jax``; ``forward`` and ``lm_loss`` with and without gates,
at G = 1 (the launcher's ``head_groups = max(n_heads, 1)``) and G = 4
(4 heads per group), on the masked path and on the kernel path (whose CPU
route is the kernels' plain version), logits, loss and gradients within
1e-5; the scores over ``transformer_blocks`` and the schedule they give;
a 3-step D2FT ``finetune`` within 1e-4 of JAX's, losses and parameters;
the H % G != 0 branch's fallback report; the launcher on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import mamba2_130m as jax_mamba
from repro.configs.base import D2FTConfig as JaxD2FTConfig
from repro.core.d2ft import plan_schedule as jax_plan_schedule
from repro.core.scores import compute_scores as jax_compute_scores
from repro.core.scores import transformer_blocks as jax_transformer_blocks
from repro.kernels import contract as jax_contract
from repro.models.transformer import forward as jax_forward
from repro.models.transformer import init_model as jax_init_model
from repro.models.transformer import lm_loss as jax_lm_loss
from repro.optim.optimizers import adamw as jax_adamw
from repro.train.loop import finetune as jax_finetune
from repro_torch.configs import mamba2_130m
from repro_torch.configs.base import D2FTConfig
from repro_torch.core.scores import compute_scores, transformer_blocks
from repro_torch.data.synthetic import lm_batches, split_microbatches
from repro_torch.interop import params_from_jax
from repro_torch.kernels import contract
from repro_torch.launch import train as launcher
from repro_torch.models.transformer import forward, init_model, lm_loss
from repro_torch.optim.optimizers import adamw
from repro_torch.train.loop import finetune, plan_from_scores

STEP_TOL = 1e-5
TRAJ_TOL = 1e-4
B, S = 4, 21                      # S 21: the scan's pad path (chunk 8)


@pytest.fixture(scope="module")
def carried():
    """(JAX params, their numpy tree) of the mamba2 smoke model, seed 0."""
    cfg = jax_mamba.smoke_config()
    params = jax.jit(jax_init_model, static_argnums=1)(
        jax.random.PRNGKey(0), cfg)
    return params, jax.tree.map(np.asarray, params)


def _port(tree):
    model = init_model(torch.Generator().manual_seed(0),
                       mamba2_130m.smoke_config())
    model.load_state_dict(params_from_jax(tree))
    return model


def _flat(tree):
    return {k: v.numpy() for k, v in params_from_jax(tree).items()}


def _gates(rng, L, G):
    ops_ = rng.integers(0, 3, (L, B, G))
    return (ops_ != 2).astype(np.float32), (ops_ == 0).astype(np.float32)


def test_params_from_jax_carries_ssd_blocks(carried):
    _, tree = carried
    state = params_from_jax(tree)
    model = init_model(torch.Generator().manual_seed(0),
                       mamba2_130m.smoke_config())
    assert set(state) == set(model.state_dict())
    model.load_state_dict(state)
    for i in range(2):
        for leaf in ("w_in", "conv_w", "A_log", "norm_scale", "w_out"):
            np.testing.assert_array_equal(
                getattr(model.layers[i].ssd, leaf).detach().numpy(),
                tree["cycles"][0]["ssd"][leaf][i])
    assert not hasattr(model.layers[0], "norm2")        # mamba2: no FFN


# (G, gated, use_kernel): ungated; the launcher's G = 1; 4 heads per group
@pytest.mark.parametrize("G,gated,use_kernel", [
    (1, False, False), (1, True, False), (1, True, True), (4, True, False),
    (4, True, True)])
def test_forward_and_lm_loss_match_jax(carried, G, gated, use_kernel):
    params, tree = carried
    cfg = mamba2_130m.smoke_config()
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

    jcfg = jax_mamba.smoke_config()
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

    model = _port(tree)
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


@pytest.mark.parametrize("G", [1, 4])
def test_scores_give_the_jax_schedule(carried, G):
    """Fisher / weight-magnitude scores of the SSD blocks over
    ``transformer_blocks`` of the flat layers (rtol 1e-4), then the
    knapsack: the same schedule as JAX's."""
    params, tree = carried
    cfg = mamba2_130m.smoke_config()
    d2 = dict(n_microbatches=4, n_pf=2, n_po=1, head_groups=G)
    batch = next(lm_batches(3, cfg.vocab_size, 8, 16, 1))
    jcfg = jax_mamba.smoke_config()
    jmbs = split_microbatches({k: jnp.asarray(v) for k, v in batch.items()},
                              4)

    def jloss(p, mb):
        return jax_lm_loss(p, jcfg, mb["tokens"], mb["labels"])[0]

    jscores = jax_compute_scores(jloss, params,
                                 lambda t: jax_transformer_blocks(t, jcfg),
                                 jmbs, G)
    jsched = jax_plan_schedule(JaxD2FTConfig(**d2), *jscores, cfg.n_layers,
                               G)
    model = _port(tree)
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
    assert len(transformer_blocks(params_t)) == 2
    assert (sched.n_layers, sched.n_groups) == (2, G)
    np.testing.assert_array_equal(sched.table, jsched.table)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_finetune_trajectory_matches_jax(carried, use_kernel):
    """3 steps of the launcher's loop: scores and knapsack on the first
    batch, then per batch the gates (and, on the kernel path, the
    compaction bounds), AdamW, clipping."""
    params, tree = carried
    cfg = mamba2_130m.smoke_config()
    d2 = dict(n_microbatches=4, n_pf=2, n_po=1, head_groups=4)
    jp, _, jlog = jax_finetune(
        params, jax_mamba.smoke_config(), JaxD2FTConfig(**d2),
        jax_adamw(1e-3), lm_batches(0, cfg.vocab_size, 8, 16, 3), steps=3,
        use_kernel=use_kernel)
    model = _port(tree)
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


def test_heads_not_tiling_groups_report_their_fallback(carried):
    """G = 3 does not divide the 16 SSD heads: the kernel path takes JAX's
    coarse block-granularity mix and says so through on_fallback."""
    params, tree = carried
    cfg = mamba2_130m.smoke_config()
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    g_f, g_b = _gates(rng, cfg.n_layers, 3)
    seen, jseen = [], []
    contract.on_fallback = lambda kind, why: seen.append((kind, why))
    jax_contract.on_fallback = lambda kind, why: jseen.append((kind, why))
    try:
        with torch.no_grad():
            logits, _ = forward(_port(tree), cfg, torch.from_numpy(tokens),
                                gates=(torch.from_numpy(g_f),
                                       torch.from_numpy(g_b)),
                                use_kernel=True)
        jlogits, _ = jax_forward(params, jax_mamba.smoke_config(),
                                 tokens=jnp.asarray(tokens),
                                 gates=(jnp.asarray(g_f), jnp.asarray(g_b)),
                                 use_kernel=True)
    finally:
        contract.on_fallback = None
        jax_contract.on_fallback = None
    assert seen == jseen and len(seen) == cfg.n_layers
    assert seen[0] == ("ssd", "H=16 not divisible by G=3 gate groups")
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=STEP_TOL, rtol=0)


def test_launcher_runs_the_fine_tune_on_the_cpu(capsys):
    log = launcher.main(["--arch", "mamba2-130m", "--d2ft", "--kernel",
                         "--n-pf", "2", "--n-po", "1", "--batch", "8",
                         "--seq", "16", "--steps", "2", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "arch=mamba2-130m layers=2 d_model=128 device=cpu"
    assert out[1] == ("D2FT: 2 p_f + 1 p_o of 4 micro-batches "
                      "(compute 60%)")
    assert out[2].startswith("2 steps in ")
    assert len(log.losses) == 2 and np.isfinite(log.losses).all()


@pytest.mark.parametrize("flag", ["--distributed", "--elastic", "--packed",
                                  "--mesh=data=2", "--faults=f.json",
                                  "--resume-from=c.npz", "--ckpt=c.npz"])
def test_launcher_refuses_what_is_not_ported(flag):
    with pytest.raises(SystemExit, match="not ported yet"):
        launcher.main(["--arch", "mamba2-130m", flag, "--device", "cpu"])


def test_launcher_without_device_refuses_silent_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launcher.main(["--arch", "mamba2-130m", "--steps", "1"])
