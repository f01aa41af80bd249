"""The D2FT-LoRA slice of the PyTorch port against the JAX package on the
CPU: ``lora_from_jax`` (the cycle and remainder rule), ``merge_lora`` and
the model run on merged weights (zero-B identity within 1e-6, adapter-only
gradients within 1e-5 of ``jax.grad``, exact zeros under g_b = 0), the
fused ``ops.lora_linear`` (plain version here) against JAX's
``lora_linear`` (Pallas, interpret mode) within 1e-5, the counts at the
full gemma3-1b config, and a 3-step D2FT-LoRA trajectory of the example's
loop within 1e-4 of JAX's on the masked and the kernel paths.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gemma3_1b as jax_gemma
from repro.configs.base import D2FTConfig as JaxD2FTConfig
from repro.configs.base import ModelConfig as JaxModelConfig
from repro.core import lora as jax_lora
from repro.core.d2ft import plan_schedule as jax_plan_schedule
from repro.core.schedule import gates_from_schedule as jax_gates
from repro.core.schedule import live_slice_bounds as jax_live_bounds
from repro.core.scores import compute_scores as jax_compute_scores
from repro.core.scores import transformer_blocks as jax_transformer_blocks
from repro.data.synthetic import microbatch_assignment
from repro.data.synthetic import split_microbatches as jax_split
from repro.kernels.ops import lora_linear as jax_lora_linear
from repro.models.transformer import forward as jax_forward
from repro.models.transformer import init_model as jax_init_model
from repro.models.transformer import lm_loss as jax_lm_loss
from repro.optim.optimizers import sgd as jax_sgd
from repro_torch.configs import get_config, gemma3_1b
from repro_torch.configs.base import ModelConfig
from repro_torch.core.lora import (LORA_TARGETS, call_with_weights,
                                   init_lora, lora_flops_fraction,
                                   lora_param_count, lora_params, merge_lora)
from repro_torch.data.synthetic import lm_batches
from repro_torch.examples import lora_finetune as example
from repro_torch.interop import lora_from_jax, params_from_jax
from repro_torch.kernels import ops
from repro_torch.kernels.lora_matmul import (lora_matmul, lora_matmul_ref,
                                             needed_bytes, needed_flops)
from repro_torch.models.transformer import forward, init_model, lm_loss

EXACT_TOL = 1e-6
STEP_TOL = 1e-5
TRAJ_TOL = 1e-4

# the JAX LoRA tests' model: 4 layers, GQA 4:2
_CFG = dict(name="t", arch_type="dense", n_layers=4, d_model=64, n_heads=4,
            n_kv_heads=2, d_ff=128, vocab_size=97)
JCFG, CFG = JaxModelConfig(**_CFG), ModelConfig(**_CFG)


def _carry(jcfg, cfg, lora_shift=0.0):
    """(JAX params, JAX lora, port model, port lora) from seeds 0 and 1."""
    params = jax_init_model(jax.random.PRNGKey(0), jcfg)
    lora = jax_lora.init_lora(jax.random.PRNGKey(1), params, rank=4)
    lora = jax.tree.map(lambda a: a + lora_shift, lora)
    model = init_model(torch.Generator().manual_seed(0), cfg)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return params, lora, model, lora_from_jax(
        jax.tree.map(np.asarray, lora), cfg)


@pytest.mark.parametrize("arch", ["gemma3-smoke", "gqa-4layer"])
def test_lora_from_jax_carries_every_adapter(arch):
    """gemma3's smoke model: one cycle of 6 plus one remainder layer, 21
    adapters; the JAX tests' 4-layer model: 4 cycles of 1, 12 adapters.
    Same names and shapes as the port's own ``init_lora``, same values as
    the JAX leaves."""
    if arch == "gemma3-smoke":
        jcfg, cfg = jax_gemma.smoke_config(), gemma3_1b.smoke_config()
    else:
        jcfg, cfg = JCFG, CFG
    params, lora, model, mine = _carry(jcfg, cfg)
    own = init_lora(torch.Generator().manual_seed(1),
                    dict(model.named_parameters()), rank=4)
    assert len(mine) == 3 * cfg.n_layers
    assert {n: {k: tuple(t.shape) for k, t in ab.items()}
            for n, ab in mine.items()} == \
        {n: {k: tuple(t.shape) for k, t in ab.items()}
         for n, ab in own.items()}
    P = len(cfg.block_pattern)
    n_cycles = cfg.n_layers // P
    for path, ab in lora.items():
        group, idx, _, leaf = path.split("/")
        for k in ("a", "b"):
            theirs = np.asarray(ab[k])
            if group == "cycles":
                for c in range(n_cycles):
                    np.testing.assert_array_equal(
                        mine[f"layers.{c * P + int(idx)}.attn.{leaf}"][k]
                        .detach().numpy(), theirs[c])
            else:
                np.testing.assert_array_equal(
                    mine[f"layers.{n_cycles * P + int(idx)}.attn.{leaf}"][k]
                    .detach().numpy(), theirs)
    assert all(t.requires_grad for t in lora_params(mine).values())


def test_zero_b_is_identity():
    """B = 0 at init: the model on ``merge_lora(params, lora, 2.0)`` gives
    the base model's logits within 1e-6, and JAX's merged model's within
    the per-op parity tolerance 1e-5 (float32 sums in another order)."""
    params, lora, model, mine = _carry(JCFG, CFG)
    toks = np.random.default_rng(2).integers(0, 97, (2, 8)).astype(np.int32)
    tt = torch.from_numpy(toks)
    with torch.no_grad():
        l0, _ = forward(model, CFG, tt)
        merged = merge_lora(dict(model.named_parameters()), mine, 2.0)
        l1, _ = call_with_weights(forward, model, merged, CFG, tt)
    jl1, _ = jax_forward(jax_lora.merge_lora(params, lora, 2.0), JCFG,
                         tokens=jnp.asarray(toks))
    np.testing.assert_allclose(l1.numpy(), l0.numpy(), atol=EXACT_TOL,
                               rtol=0)
    np.testing.assert_allclose(l1.numpy(), np.asarray(jl1), atol=STEP_TOL,
                               rtol=0)


def _jax_adapter_grads(params, lora, toks, gates=None):
    def loss(lr):
        merged = jax_lora.merge_lora(params, lr, 1.0)
        return jax_lm_loss(merged, JCFG, toks, toks, gates=gates)[0]
    return jax.value_and_grad(loss)(lora)


def _port_adapter_grads(model, mine, toks, gates=None):
    merged = merge_lora(dict(model.named_parameters()), mine, 1.0)
    t = torch.from_numpy(toks)
    loss, _ = call_with_weights(lm_loss, model, merged, CFG, t, t,
                                gates=gates)
    loss.backward()
    return loss


def test_adapter_only_gradients_match_jax():
    """Non-trivial adapters (+0.01, as the JAX test makes them): the loss and
    every adapter gradient within 1e-5 of ``jax.grad``'s; the frozen base
    gets no gradient at all."""
    params, lora, model, mine = _carry(JCFG, CFG, lora_shift=0.01)
    toks = np.random.default_rng(3).integers(0, 97, (4, 8)).astype(np.int32)
    jl, jgrads = _jax_adapter_grads(params, lora, jnp.asarray(toks))
    loss = _port_adapter_grads(model, mine, toks)
    np.testing.assert_allclose(float(loss.detach()), float(jl),
                               atol=STEP_TOL, rtol=0)
    theirs = lora_from_jax(jax.tree.map(np.asarray, jgrads), CFG)
    gn = 0.0
    for name, ab in mine.items():
        for k in ("a", "b"):
            np.testing.assert_allclose(ab[k].grad.numpy(),
                                       theirs[name][k].detach().numpy(),
                                       atol=STEP_TOL, rtol=0,
                                       err_msg=f"{name}.{k}")
            gn += float(ab[k].grad.abs().sum())
    assert gn > 0
    assert all(p.grad is None for p in model.parameters())


def test_d2ft_lora_gating_blocks_adapter_grads():
    """Every subnet forward-only (g_b = 0): exactly zero adapter gradients,
    as in the JAX package."""
    params, lora, model, mine = _carry(JCFG, CFG, lora_shift=0.01)
    toks = np.random.default_rng(2).integers(0, 97, (10, 8)).astype(np.int32)
    L, B, G = 4, 10, 4
    g_f, g_b = np.ones((L, B, G), np.float32), np.zeros((L, B, G), np.float32)
    _, jgrads = _jax_adapter_grads(params, lora, jnp.asarray(toks),
                                   (jnp.asarray(g_f), jnp.asarray(g_b)))
    assert max(float(jnp.abs(g).max()) for g in jax.tree.leaves(jgrads)) \
        < 1e-12
    _port_adapter_grads(model, mine, toks,
                        (torch.from_numpy(g_f), torch.from_numpy(g_b)))
    for t in lora_params(mine).values():
        assert t.grad is not None and float(t.grad.abs().max()) == 0.0


@pytest.mark.parametrize("M,K,r", [(128, 64, 1), (128, 96, 8), (256, 64, 8),
                                   (256, 96, 1)])
@pytest.mark.parametrize("three_d", [False, True])
def test_lora_linear_matches_jax(M, K, r, three_d):
    """The fused op's plain version (what CPU tensors take) and
    ``lora_matmul_ref`` against JAX's Pallas ``lora_linear`` (interpret
    mode), N 128, scale 0.7, on 2-D [M, K] and 3-D [2, M/2, K] N(0, 1)
    inputs (the JAX test's), where outputs reach ~100: within 1e-5 x
    max(1, max |JAX|), the limit the card holds the kernel to."""
    N = 128
    rng = np.random.default_rng(M + K + r)
    x, w, a, b = (rng.standard_normal(s).astype(np.float32)
                  for s in ((M, K), (K, N), (K, r), (r, N)))
    xs = x.reshape(2, M // 2, K) if three_d else x
    theirs = np.asarray(jax_lora_linear(*map(jnp.asarray, (xs, w, a, b)),
                                        0.7))
    t = [torch.from_numpy(v) for v in (xs, w, a, b)]
    mine = ops.lora_linear(*t, 0.7)
    assert tuple(mine.shape) == theirs.shape == (*xs.shape[:-1], N)
    tol = STEP_TOL * max(1.0, float(np.abs(theirs).max()))
    np.testing.assert_allclose(mine.numpy(), theirs, atol=tol, rtol=0)
    ref = lora_matmul_ref(*(torch.from_numpy(v) for v in (x, w, a, b)), 0.7)
    np.testing.assert_allclose(ref.numpy(), theirs.reshape(M, N), atol=tol,
                               rtol=0)


def test_lora_linear_is_forward_only_and_refuses_what_it_does_not_take():
    x, w = torch.zeros((4, 8)), torch.zeros((8, 6))
    a, b = torch.zeros((8, 2)), torch.zeros((2, 6))
    with pytest.raises(ValueError, match="requires grad"):
        ops.lora_linear(x, w, a.requires_grad_(), b)
    with pytest.raises(ValueError, match="2-D or 3-D"):
        ops.lora_linear(x[None, None], w, a.detach(), b)
    with pytest.raises(ValueError, match="CUDA tensors"):
        lora_matmul(x, w, a.detach(), b)


def test_counts_at_gemma3_1b_equal_jax():
    """Pure arithmetic at the full config: 26 x (1152·8 + 8·1024 +
    2·(1152·8 + 8·256)) adapter parameters; the flop fraction of the QKV matmuls;
    the kernel's needed work at the D2FT-LoRA run's wq shape."""
    cfg, jcfg = get_config("gemma3-1b"), jax_gemma.CONFIG
    shapes = jax.eval_shape(
        lambda k: jax_lora.init_lora(k, jax_init_model(k, jcfg), 8),
        jax.random.PRNGKey(0))
    hd, d = cfg.resolved_head_dim, cfg.d_model
    outs = {"wq": cfg.n_heads * hd, "wk": cfg.n_kv_heads * hd,
            "wv": cfg.n_kv_heads * hd}
    meta = {f"layers.{i}.attn.{t}": {
        "a": torch.empty((d, 8), device="meta"),
        "b": torch.empty((8, outs[t]), device="meta")}
        for i in range(cfg.n_layers) for t in LORA_TARGETS}
    assert lora_param_count(meta) == jax_lora.lora_param_count(shapes) \
        == 1_038_336
    for rank in (1, 8, 60, 200, 240):
        assert lora_flops_fraction(cfg, rank) == \
            jax_lora.lora_flops_fraction(jcfg, rank)
    assert needed_flops(4096, 1152, 1024, 8) == 9_806_282_752
    assert needed_bytes(4096, 1152, 1024, 8) == 4 * 10_109_952


def _jax_example(steps, use_kernel):
    """The JAX example's loop (``examples/lora_finetune.py``) for ``steps``
    batches, with the kernel route and its compaction bounds as the port's
    ``--kernel`` adds them. Returns (schedule table, losses, final lora)."""
    jcfg = JaxModelConfig(**{f: getattr(example.CFG, f) for f in (
        "name", "arch_type", "n_layers", "d_model", "n_heads", "n_kv_heads",
        "d_ff", "vocab_size")})
    base = jax_init_model(jax.random.PRNGKey(0), jcfg)
    lora = jax_lora.init_lora(jax.random.PRNGKey(1), base, rank=8)
    d2 = JaxD2FTConfig(n_microbatches=4, n_pf=3, n_po=0, head_groups=4)
    opt = jax_sgd(0.1)
    state = opt.init(lora)
    batches = list(lm_batches(0, jcfg.vocab_size, 8, 64, steps))
    mbs = jax_split({k: jnp.asarray(v) for k, v in batches[0].items()}, 4)

    def loss_fn(p, mb):
        return jax_lm_loss(p, jcfg, mb["tokens"], mb["labels"])[0]
    bw, fw = jax_compute_scores(loss_fn, jax_lora.merge_lora(base, lora, 1.0),
                                lambda t: jax_transformer_blocks(t, jcfg),
                                mbs, G=4)
    sched = jax_plan_schedule(d2, bw, fw, jcfg.n_layers, 4)
    mb_of = microbatch_assignment(8, 4)
    gates = jax_gates(sched, mb_of)
    bounds = jax_live_bounds(sched, mb_of) if use_kernel else None

    @jax.jit
    def step(lora_p, st, batch):
        def loss(lr):
            merged = jax_lora.merge_lora(base, lr, 1.0)
            return jax_lm_loss(merged, jcfg, batch["tokens"],
                               batch["labels"], gates=gates,
                               use_kernel=use_kernel,
                               live_bounds=bounds)[0]
        lval, g = jax.value_and_grad(loss)(lora_p)
        lora_p, st = opt.update(g, st, lora_p)
        return lora_p, st, lval

    losses = []
    for batch in batches:
        lora, state, lval = step(lora, state,
                                 {k: jnp.asarray(v) for k, v in batch.items()})
        losses.append(float(lval))
    return sched.table, losses, jax.tree.map(np.asarray, lora), base


@pytest.mark.parametrize("use_kernel", [False, True])
def test_d2ft_lora_trajectory_matches_jax(use_kernel):
    """3 steps of the example's loop from the JAX weights and adapters: the
    scores on the merged model give JAX's schedule, and the losses and the
    final adapters agree within 1e-4; the base stays bit-identical."""
    table, jlosses, jlora, base = _jax_example(3, use_kernel)
    cfg = example.CFG
    model = init_model(torch.Generator().manual_seed(0), cfg)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, base)))
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    mine = lora_from_jax(jax.tree.map(np.asarray, jax_lora.init_lora(
        jax.random.PRNGKey(1), base, rank=8)), cfg)
    batches = list(lm_batches(0, cfg.vocab_size, 8, 64, 3))
    sched = example.plan_lora(model, cfg, mine, example.D2, batches[0])
    np.testing.assert_array_equal(sched.table, table)
    mine, state, log = example.finetune_lora(
        model, cfg, mine, example.sgd(example.LR), batches, steps=3,
        sched=sched, use_kernel=use_kernel)
    assert state["step"] == 3 and len(log.step_times) == 3
    np.testing.assert_allclose(log.losses, jlosses, atol=TRAJ_TOL, rtol=0)
    theirs = lora_from_jax(jlora, cfg)
    for name, ab in mine.items():
        for k in ("a", "b"):
            np.testing.assert_allclose(ab[k].detach().numpy(),
                                       theirs[name][k].detach().numpy(),
                                       atol=TRAJ_TOL, rtol=0,
                                       err_msg=f"{name}.{k}")
    for n, p in model.named_parameters():
        assert torch.equal(p.detach(), before[n]), n


def test_example_runs_on_the_cpu(capsys):
    log = example.main(["--device", "cpu", "--steps", "2"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "adapters: 24576 trainable params (12 targets)"
    assert out[1] == "fused lora_linear output: (128, 128)"
    assert out[2].startswith("D2FT-LoRA loss: ")
    assert len(log.losses) == 2 and np.isfinite(log.losses).all()
