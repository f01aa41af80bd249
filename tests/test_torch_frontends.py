"""The feature frontends, the feature batches through the fine-tune and the
device-side knapsack DP of the PyTorch port, against the JAX package on
the CPU:

* the vision and audio cases of ``tests/test_models.py`` (2 layers, d 32,
  4 patches + 8 text tokens of vocab 53; 10 audio frames, bidirectional,
  vocab 19): logits and loss within 1e-5 of jitted JAX's, each gradient
  leaf within 1e-5 x max(1, its largest |value|) (the token table's
  reaches ~9), with the JAX params carried over (``frontend_proj`` too)
  and the features crossed as numpy;
* ``feature_spec``, ``text_len`` and ``synth_features``' shapes equal to
  JAX's;
* 3 D2FT ``finetune`` steps on feature batches (B 8 in 4 micro-batches,
  2 p_f + 1 p_o, G 4, AdamW) at phi-3-vision-4.2b's and hubert-xlarge's
  smoke configs, on the kernel route (plain versions on the CPU): losses,
  metrics and parameters within 1e-4 of JAX's masked ``finetune``;
* ``dp_knapsack_value`` equal to JAX's ``dp_knapsack_value_jax`` on 20
  seeded instances, and to the value of ``dp_knapsack``'s selection;
* what stays refused: serving a non-causal or a frontend model, the
  launcher on a frontend arch, the sharding policy in ``forward``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.configs import base as jax_base
from repro.configs.base import D2FTConfig as JaxD2FTConfig
from repro.core import knapsack as jax_knapsack
from repro.models import frontends as jax_frontends
from repro.models import transformer as jax_tf
from repro.optim.optimizers import adamw as jax_adamw
from repro.train.loop import finetune as jax_finetune
from repro_torch import configs
from repro_torch.configs import base
from repro_torch.configs.base import D2FTConfig
from repro_torch.core import knapsack
from repro_torch.interop import params_from_jax
from repro_torch.launch import train as launcher
from repro_torch.models import frontends
from repro_torch.models import transformer as tf
from repro_torch.optim.optimizers import adamw
from repro_torch.serving.engine import PagedServingEngine
from repro_torch.train.loop import finetune

OP_TOL = 1e-5
TRAJ_TOL = 1e-4


def model_config(kind, b):
    """``tests/test_models.py::test_vlm_and_audio_frontends``'s configs in
    the config module ``b`` of either package."""
    if kind == "vision":
        return b.ModelConfig(name="v", arch_type="vlm", n_layers=2,
                             d_model=32, n_heads=4, n_kv_heads=4, d_ff=64,
                             vocab_size=53, frontend="vision_stub",
                             frontend_tokens=4, frontend_dim=16)
    return b.ModelConfig(name="a", arch_type="audio", n_layers=2, d_model=32,
                         n_heads=4, n_kv_heads=4, d_ff=64, vocab_size=19,
                         causal=False, rope=False, frontend="audio_stub",
                         frontend_dim=16, norm="layer", mlp_gated=False,
                         mlp_act="gelu")


@functools.lru_cache(maxsize=None)
def carried(kind):
    """(JAX config, JAX params, port config, port model) from seed 0."""
    jcfg = model_config(kind, jax_base)
    params = jax.jit(jax_tf.init_model, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg)
    cfg = model_config(kind, base)
    model = tf.init_model(torch.Generator().manual_seed(0), cfg)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return jcfg, params, cfg, model


def _inputs(kind):
    """numpy (tokens or None, features, labels): the JAX test's shapes."""
    rng = np.random.default_rng(1)
    if kind == "vision":
        feats = rng.standard_normal((2, 4, 16)).astype(np.float32)
        toks = rng.integers(0, 53, (2, 8)).astype(np.int32)
        return toks, feats, toks
    feats = rng.standard_normal((2, 10, 16)).astype(np.float32)
    return None, feats, rng.integers(0, 19, (2, 10)).astype(np.int32)


def _opt(a):
    return None if a is None else torch.from_numpy(a)


@pytest.mark.parametrize("kind", ["vision", "audio"])
def test_frontend_loss_and_grads_match_jax(kind):
    jcfg, params, cfg, model = carried(kind)
    toks, feats, labels = _inputs(kind)
    jt = None if toks is None else jnp.asarray(toks)

    def jloss(p):
        return jax_tf.lm_loss(p, jcfg, jt, jnp.asarray(labels),
                              features=jnp.asarray(feats))[0]
    jlogits, _ = jax.jit(lambda p: jax_tf.forward(
        p, jcfg, tokens=jt, features=jnp.asarray(feats)))(params)
    jl, jgrads = jax.jit(jax.value_and_grad(jloss))(params)

    model.zero_grad(set_to_none=True)
    with torch.no_grad():
        logits, _ = tf.forward(model, cfg, _opt(toks),
                               features=torch.from_numpy(feats))
    # 4 patch + 8 text positions; 10 frames
    assert logits.shape == ((2, 12, 53) if kind == "vision" else (2, 10, 19))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=OP_TOL, rtol=0)
    loss, metrics = tf.lm_loss(model, cfg, _opt(toks),
                               torch.from_numpy(labels),
                               features=torch.from_numpy(feats))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), atol=OP_TOL,
                               rtol=0)
    theirs = {k: v.numpy() for k, v in params_from_jax(
        jax.tree.map(np.asarray, jgrads)).items()}
    for name, p in model.named_parameters():
        mine = np.zeros_like(theirs[name]) if p.grad is None else \
            p.grad.numpy()
        # the token table's gradient reaches ~9 (rows of 0.02 through the
        # RMS norm): 1e-5 of the leaf's largest value, at least 1e-5
        tol = OP_TOL * max(1.0, float(np.abs(theirs[name]).max()))
        np.testing.assert_allclose(mine, theirs[name], atol=tol, rtol=0,
                                   err_msg=name)
    # the projector learns: its gradient is not zero
    assert float(model.frontend_proj.grad.abs().max()) > 0


@pytest.mark.parametrize("kind", ["vision", "audio"])
def test_frontend_proj_round_trips(kind):
    _, params, cfg, model = carried(kind)
    state = params_from_jax(jax.tree.map(np.asarray, params))
    assert set(state) == set(model.state_dict())
    np.testing.assert_array_equal(state["frontend_proj"].numpy(),
                                  np.asarray(params["frontend_proj"]))
    np.testing.assert_array_equal(model.frontend_proj.detach().numpy(),
                                  np.asarray(params["frontend_proj"]))
    fresh = tf.init_model(torch.Generator().manual_seed(1), cfg)
    assert fresh.frontend_proj.shape == (cfg.frontend_dim, cfg.d_model)
    fresh.load_state_dict(state)


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_feature_spec_and_text_len_equal_jax(arch):
    cfg = configs.get_config(arch)
    jcfg = jax_configs.get_config(arch)
    for seq in (16, 1024):
        assert frontends.text_len(cfg, seq) == \
            jax_frontends.text_len(jcfg, seq)
        spec = frontends.feature_spec(cfg, 3, seq)
        jspec = jax_frontends.feature_spec(jcfg, 3, seq)
        if jspec is None:
            assert spec is None
            continue
        shape, dtype = spec
        assert shape == tuple(jspec.shape)
        assert str(dtype).removeprefix("torch.") == str(jspec.dtype)
        small = configs.get_smoke_config(arch)
        feats = frontends.synth_features(torch.Generator().manual_seed(0),
                                         small, 2, seq)
        assert feats.shape == frontends.feature_spec(small, 2, seq)[0]
        assert bool(torch.isfinite(feats).all())


def feature_batches(cfg, batch, seq, steps, seed=0):
    """numpy feature batches: the stub frontend's unit-normal embeddings,
    with text tokens and text labels (vision) or frame labels (audio)."""
    rng = np.random.default_rng(seed)
    n_text = frontends.text_len(cfg, seq)
    for _ in range(steps):
        shape = frontends.feature_spec(cfg, batch, seq)[0]
        out = {"features": rng.standard_normal(shape).astype(np.float32)}
        if n_text:
            out["tokens"] = rng.integers(0, cfg.vocab_size,
                                         (batch, n_text)).astype(np.int32)
        out["labels"] = rng.integers(0, cfg.vocab_size,
                                     (batch, n_text or seq)).astype(np.int32)
        yield out


@pytest.mark.parametrize("arch", ["phi-3-vision-4.2b", "hubert-xlarge"])
def test_finetune_on_feature_batches_matches_jax(arch):
    """Scores and knapsack on the first batch's micro-batches (features
    included), then 3 gated steps: the port on the kernel route, JAX on
    its masked path."""
    jcfg = jax_configs.get_smoke_config(arch)
    cfg = configs.get_smoke_config(arch)
    params = jax.jit(jax_tf.init_model, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg)
    d2 = dict(n_microbatches=4, n_pf=2, n_po=1, head_groups=4)
    jp, _, jlog = jax_finetune(params, jcfg, JaxD2FTConfig(**d2),
                               jax_adamw(1e-3),
                               feature_batches(cfg, 8, 16, 3), steps=3)
    model = tf.init_model(torch.Generator().manual_seed(0), cfg)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    model, state, log = finetune(model, cfg, D2FTConfig(**d2), adamw(1e-3),
                                 feature_batches(cfg, 8, 16, 3), steps=3,
                                 use_kernel=True)
    assert state["step"] == 3
    np.testing.assert_allclose(log.losses, jlog.losses, atol=TRAJ_TOL,
                               rtol=0)
    for k in ("ce", "grad_norm"):
        np.testing.assert_allclose([m[k] for m in log.metrics],
                                   [m[k] for m in jlog.metrics],
                                   atol=TRAJ_TOL, rtol=0, err_msg=k)
    theirs = {k: v.numpy() for k, v in params_from_jax(
        jax.tree.map(np.asarray, jp)).items()}
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), theirs[name],
                                   atol=TRAJ_TOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("seed", range(20))
def test_dp_knapsack_value_equals_jax(seed):
    """Values in eighths, so that every float32 sum is exact: the torch DP
    equals JAX's bit for bit, and both equal the value of the numpy DP's
    selection."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 13))
    values = rng.integers(0, 80, n) / 8.0
    weights = rng.choice([0.4, 0.6, 1.0, 1.4], n)
    cap = float(rng.choice([0.0, 1.2, 2.0, 3.4, 5.0]))
    w_int = np.round(weights * 100).astype(np.int32)
    c_int = int(round(cap * 100))
    mine = knapsack.dp_knapsack_value(torch.from_numpy(values), w_int, c_int)
    theirs = jax_knapsack.dp_knapsack_value_jax(values, w_int, c_int)
    assert mine.dtype == torch.float32 and mine.shape == ()
    assert float(mine) == float(theirs)
    sel = knapsack.dp_knapsack(values, weights, cap)
    assert float(mine) == values[sel].sum()


@pytest.mark.parametrize("arch,make,match", [
    ("hubert-xlarge", "engine", "serving needs a causal decoder"),
    ("phi-3-vision-4.2b", "engine", "feature-frontend serving unsupported"),
    ("phi-3-vision-4.2b", "launcher", "text-training launcher"),
    ("hubert-xlarge", "launcher", "text-training launcher"),
    ("stablelm-3b", "policy", "comes with the distributed slice")])
def test_what_stays_refused(arch, make, match):
    cfg = configs.get_smoke_config(arch)
    if make == "launcher":
        with pytest.raises(SystemExit, match=match):
            launcher.main(["--arch", arch, "--steps", "1", "--device",
                           "cpu"])
        return
    model = tf.init_model(torch.Generator().manual_seed(0), cfg)
    if make == "engine":
        with pytest.raises(ValueError, match=match):
            PagedServingEngine(model, cfg)
        return
    with pytest.raises(NotImplementedError, match=match):
        tf.forward(model, cfg, torch.zeros((1, 4), dtype=torch.long),
                   policy=object())
