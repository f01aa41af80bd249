"""PyTorch port vs jitted JAX on the contiguous-cache serving path, on the
CPU, with the JAX params carried over by ``params_from_jax``:

* the SSD chunked scan's final state (S 1, 2, odd, a chunk multiple, and a
  chunk whose decays sum past 88) and both recurrent ``return_state``
  dumps; ``head_scale`` on SSD and RG-LRU;
* ``decode_ssd``, ``decode_rglru`` and ``decode_attention`` teacher-forced
  for 6 steps from a 7-token prefill (window 4: the ring wraps);
* ``prefill_forward(raw_kv=False)`` caches and ``decode_step`` logits for
  the four cases of ``tests/test_serving.py`` and olmoe-1b-7b's smoke
  config; the batched ``prefill`` against ``prefill_sequential``;
  ``generate`` tokens equal to JAX's; the serve example on the CPU.

Tolerances: 1e-5 for one op or block, 1e-4 over a model's layers or a
trajectory of decode steps (f32 matmuls summed in another order)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jax_base
from repro.configs.olmoe_1b_7b import smoke_config as jax_olmoe
from repro.models import attention as jax_attn
from repro.models import rglru as jax_rglru
from repro.models import ssm as jax_ssm
from repro.models import transformer as jax_tf
from repro.serving import decode as jax_decode
from repro.serving import paged_decode as jax_pd
from repro_torch.configs import base
from repro_torch.configs.olmoe_1b_7b import smoke_config as olmoe
from repro_torch.examples import serve as serve_example
from repro_torch.interop import params_from_jax
from repro_torch.models import attention, rglru, ssm
from repro_torch.models import transformer as tf
from repro_torch.serving import decode

OP_TOL = 1e-5
TRAJ_TOL = 1e-4


def case_config(name, b):
    """The serving test cases of ``tests/test_serving.py`` (plus
    olmoe-1b-7b's smoke config) in the config module ``b`` of either
    package."""
    common = dict(n_layers=3, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
                  vocab_size=53)
    if name == "dense_gqa":
        return b.ModelConfig(name="d", arch_type="dense", **common)
    if name == "swa":
        return b.ModelConfig(name="l", arch_type="dense", **common,
                             block_pattern=(b.ATTN_LOCAL,), window=4)
    if name == "ssm":
        return b.ModelConfig(name="s", arch_type="ssm", n_layers=2,
                             d_model=32, n_heads=0, n_kv_heads=0, d_ff=0,
                             vocab_size=53, rope=False,
                             block_pattern=(b.SSD,),
                             ssm=b.SSMConfig(state_dim=8, head_dim=8,
                                             chunk=4))
    if name == "hybrid":
        return b.ModelConfig(name="h", arch_type="hybrid", n_layers=3,
                             d_model=32, n_heads=4, n_kv_heads=1, d_ff=64,
                             vocab_size=53,
                             block_pattern=(b.RGLRU, b.RGLRU, b.ATTN_LOCAL),
                             window=4, rglru=b.RGLRUConfig())
    return (jax_olmoe if b is jax_base else olmoe)()


CASES = ["dense_gqa", "swa", "ssm", "hybrid", "olmoe"]


@functools.lru_cache(maxsize=None)
def models(name):
    """(JAX config, JAX params, port config, port model) from seed 0."""
    jcfg = case_config(name, jax_base)
    params = jax.jit(jax_tf.init_model, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg)
    tcfg = case_config(name, base)
    model = tf.init_model(torch.Generator().manual_seed(0), tcfg)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return jcfg, params, tcfg, model


def _tokens(cfg, shape, seed):
    return np.random.RandomState(seed).randint(
        0, cfg.vocab_size, shape).astype(np.int32)


def _close(mine, theirs, tol, what=""):
    np.testing.assert_allclose(np.asarray(mine), np.asarray(theirs),
                               atol=tol, rtol=0, err_msg=what)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ============================================================ the SSD scan
@pytest.mark.parametrize("S,chunk,dt_scale", [
    (1, 4, 1.0), (2, 4, 1.0), (7, 4, 1.0), (8, 4, 1.0),
    (256, 256, 1.0)])
def test_ssd_chunked_final_state_matches_jax(S, chunk, dt_scale):
    """y and the state after the last token from the padded plain scan. The
    last case's decays sum to ~-140 within its one chunk of 256, past
    exp's float32 range (88): the state stays finite and equal."""
    rng = np.random.default_rng(S)
    B, H, P, N = 2, 3, 4, 5
    xh = rng.normal(size=(B, S, H, P)).astype(np.float32)
    dt = (dt_scale * rng.uniform(0.5, 1.0, (B, S, H))).astype(np.float32)
    A = -rng.uniform(0.5, 1.0, (H,)).astype(np.float32)
    Bm = rng.normal(size=(B, S, N)).astype(np.float32)
    Cm = rng.normal(size=(B, S, N)).astype(np.float32)
    fn = jax.jit(functools.partial(jax_ssm.ssd_chunked, chunk=chunk,
                                   return_final_state=True))
    jy, jst = fn(*map(jnp.asarray, (xh, dt, A, Bm, Cm)))
    y, st = ssm.ssd_chunked(*map(_t, (xh, dt, A, Bm, Cm)), chunk,
                            return_final_state=True)
    assert st.dtype == torch.float32 and torch.isfinite(st).all()
    # at chunk 256 the decays' cumulative sums reach ~-140, where float32's
    # own spacing (~1e-5) moves exp(cum_q - cum_k) by that much relative:
    # held to the tolerance scaled by the values' size, as the on-card SSD
    # checks are
    _close(y, jy, OP_TOL * max(1.0, float(np.abs(jy).max())), "y")
    _close(st, jst, OP_TOL * max(1.0, float(np.abs(jst).max())), "state")


def _layer(name, i):
    """Layer i's params in both packages."""
    jcfg, params, tcfg, model = models(name)
    return jcfg, jax_pd.layer_params(params, jcfg, i), tcfg, model.layers[i]


@pytest.mark.parametrize("S", [1, 2, 5, 8])
def test_apply_ssd_return_state_matches_jax(S):
    """The block's output and its decode cache dump: the conv tail (raw
    xBC, zero-padded on the left when S < conv_width - 1) and the state."""
    jcfg, jp, tcfg, blk = _layer("ssm", 0)
    x = np.random.default_rng(S).normal(size=(2, S, 32)).astype(np.float32)
    jy, jc = jax.jit(lambda p, x: jax_ssm.apply_ssd(
        p, x, 32, jcfg.ssm, return_state=True))(jp["ssd"], jnp.asarray(x))
    with torch.no_grad():
        y, c = ssm.apply_ssd(blk.ssd, _t(x), 32, tcfg.ssm, return_state=True)
    _close(y, jy, OP_TOL, "y")
    for k in ("conv", "state"):
        _close(c[k], jc[k], OP_TOL, k)


@pytest.mark.parametrize("S", [1, 2, 5, 8])
def test_apply_rglru_return_state_matches_jax(S):
    """The block's output and its dump: the conv tail of raw pre-conv
    inputs and h at the last token."""
    jcfg, jp, tcfg, blk = _layer("hybrid", 0)
    x = np.random.default_rng(S).normal(size=(2, S, 32)).astype(np.float32)
    jy, jc = jax.jit(lambda p, x: jax_rglru.apply_rglru(
        p, x, jcfg.rglru, return_state=True))(jp["rglru"], jnp.asarray(x))
    with torch.no_grad():
        y, c = rglru.apply_rglru(blk.rglru, _t(x), tcfg.rglru,
                                 return_state=True)
    _close(y, jy, OP_TOL, "y")
    for k in ("conv", "h"):
        _close(c[k], jc[k], OP_TOL, k)


@pytest.mark.parametrize("kind", ["ssd", "rglru"])
def test_head_scale_matches_jax(kind):
    """A [B, H] head multiplier: per SSD head before the output norm, per
    block-diagonal channel group of the RG-LRU width (4 groups of 8)."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 6, 32)).astype(np.float32)
    if kind == "ssd":
        jcfg, jp, tcfg, blk = _layer("ssm", 1)
        hs = rng.uniform(size=(2, 8)).astype(np.float32)
        jy = jax.jit(lambda p, x, s: jax_ssm.apply_ssd(
            p, x, 32, jcfg.ssm, head_scale=s))(jp["ssd"], jnp.asarray(x),
                                               jnp.asarray(hs))
        with torch.no_grad():
            y = ssm.apply_ssd(blk.ssd, _t(x), 32, tcfg.ssm,
                              head_scale=_t(hs))
    else:
        jcfg, jp, tcfg, blk = _layer("hybrid", 1)
        hs = rng.uniform(size=(2, 4)).astype(np.float32)
        jy = jax.jit(lambda p, x, s: jax_rglru.apply_rglru(
            p, x, jcfg.rglru, head_scale=s))(jp["rglru"], jnp.asarray(x),
                                             jnp.asarray(hs))
        with torch.no_grad():
            y = rglru.apply_rglru(blk.rglru, _t(x), tcfg.rglru,
                                  head_scale=_t(hs))
    _close(y, jy, OP_TOL)


# ================================================ single-block decode steps
@pytest.mark.parametrize("kind", ["ssd", "rglru", "global", "local"])
def test_block_decode_teacher_forced_matches_jax(kind):
    """A 7-token prefill dump, then 6 decode steps on given inputs: each
    step's output and the whole cache after it. The local ring has window
    4, so the prefill already wraps it and every step overwrites a slot."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 13, 32)).astype(np.float32)
    max_len = 16
    if kind == "ssd":
        jcfg, jp, tcfg, blk = _layer("ssm", 0)
        jc = jax_ssm.apply_ssd(jp["ssd"], jnp.asarray(x[:, :7]), 32, jcfg.ssm,
                               return_state=True)[1]
        jstep = jax.jit(lambda c, h: jax_ssm.decode_ssd(jp["ssd"], c, h, 32,
                                                        jcfg.ssm))
        c = ssm.apply_ssd(blk.ssd, _t(x[:, :7]), 32, tcfg.ssm,
                          return_state=True)[1]

        def step(c, h, t):
            return ssm.decode_ssd(blk.ssd, c, h, 32, tcfg.ssm)
    elif kind == "rglru":
        jcfg, jp, tcfg, blk = _layer("hybrid", 0)
        jc = jax_rglru.apply_rglru(jp["rglru"], jnp.asarray(x[:, :7]),
                                   jcfg.rglru, return_state=True)[1]
        jstep = jax.jit(lambda c, h: jax_rglru.decode_rglru(
            jp["rglru"], c, h, jcfg.rglru))
        c = rglru.apply_rglru(blk.rglru, _t(x[:, :7]), tcfg.rglru,
                              return_state=True)[1]

        def step(c, h, t):
            return rglru.decode_rglru(blk.rglru, c, h, tcfg.rglru)
    else:
        name, window = ("dense_gqa", 0) if kind == "global" else ("swa", 4)
        jcfg, jp, tcfg, blk = _layer(name, 0)
        kw = dict(n_heads=4, n_kv_heads=2, head_dim=8, window=window)
        _, jk, jv = jax_attn.apply_attention(
            jp["attn"], jnp.asarray(x[:, :7]), causal=True, return_kv=True,
            **kw)
        jc = jax_attn.kv_prefill_cache(jk, jv, window, max_len)
        jdec = jax.jit(lambda c, h, t: jax_attn.decode_attention(
            jp["attn"], c, h, t=t, **kw))
        _, k, v = attention.apply_attention(blk.attn, _t(x[:, :7]),
                                            causal=True, return_kv=True,
                                            **kw)
        c = attention.kv_prefill_cache(k, v, window, max_len)
        assert c["k"].shape[1] == (4 if window else max_len)

        def jstep(c, h, t=None):
            return jdec(c, h, jnp.int32(t))

        def step(c, h, t):
            return attention.decode_attention(blk.attn, c, h, t=t, **kw)
    with torch.no_grad():
        for k in jc:
            _close(c[k], jc[k], OP_TOL, f"prefill {k}")
        for t in range(7, 13):
            h = x[:, t:t + 1]
            jy, jc = (jstep(jc, jnp.asarray(h), t) if kind in ("global",
                                                              "local")
                      else jstep(jc, jnp.asarray(h)))
            y, c = step(c, _t(h), t)
            _close(y, jy, OP_TOL, f"step {t}")
            for k in jc:
                _close(c[k], jc[k], OP_TOL, f"step {t} cache {k}")


# =============================================== the model's decode caches
@pytest.mark.parametrize("name", CASES)
def test_prefill_caches_and_decode_steps_match_jax(name):
    """``prefill_forward(raw_kv=False)``: logits and every layer's cache
    entry; then 4 teacher-forced ``decode_step``s: logits and caches."""
    jcfg, params, tcfg, model = models(name)
    toks = _tokens(tcfg, (2, 13), 5)
    max_len = 16
    jl, jc = jax.jit(jax_tf.prefill_forward, static_argnums=(1, 3))(
        params, jcfg, jnp.asarray(toks[:, :9]), max_len)
    jstep = jax.jit(lambda c, tok, t: jax_tf.decode_step(params, c, jcfg,
                                                         tok, t))
    with torch.inference_mode():
        tl, tc = tf.prefill_forward(model, tcfg, _t(toks[:, :9]).long(),
                                    max_len)
        _close(tl, jl, TRAJ_TOL, "prefill logits")

        def caches():
            for i in range(tcfg.n_layers):
                entry = jax_pd.layer_cache_entry(jc, jcfg, i)
                assert set(entry) == set(tc[i])
                for k in entry:
                    _close(tc[i][k], entry[k], TRAJ_TOL, f"layer {i} {k}")
        caches()
        for t in range(9, 13):
            jl, jc = jstep(jc, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
            tl, tc = tf.decode_step(model, tc, tcfg,
                                    _t(toks[:, t:t + 1]).long(), t)
            _close(tl, jl, TRAJ_TOL, f"decode logits at {t}")
            caches()


@pytest.mark.parametrize("name", CASES[:4])
def test_prefill_matches_sequential_oracle(name):
    """The batched prefill dump equals the port's own S-step decode-path
    prefill: last-position logits and the caches, leaf for leaf. Not on
    the MoE config: an expert's capacity follows the tokens of the call
    (10 slots for a 16-token prefill, 1 for a 2-token decode step), so the
    two drop different assignments, in the JAX package as here."""
    _, _, tcfg, model = models(name)
    toks = _t(_tokens(tcfg, (2, 8), 1)).long()
    lg_new, cache_new = decode.prefill(model, tcfg, toks, max_len=16)
    lg_old, cache_old = decode.prefill_sequential(model, tcfg, toks,
                                                  max_len=16)
    _close(lg_new, lg_old, OP_TOL, "logits")
    for i, (a, b) in enumerate(zip(cache_new, cache_old)):
        for k in a:
            _close(a[k], b[k], OP_TOL, f"layer {i} {k}")


@pytest.mark.parametrize("name", CASES)
def test_generate_matches_jax(name):
    """Greedy tokens of ``generate`` (batched prefill, 6 new tokens) equal
    JAX's."""
    jcfg, params, tcfg, model = models(name)
    toks = _tokens(tcfg, (2, 8), 2)
    theirs = jax_decode.generate(params, jcfg, jnp.asarray(toks), 6,
                                 max_len=16)
    mine = decode.generate(model, tcfg, _t(toks).long(), 6, max_len=16)
    np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))


def test_decode_refuses_a_sharding_policy():
    _, _, tcfg, model = models("dense_gqa")
    cache = tf.init_cache(tcfg, 1, 4, device="cpu")
    with pytest.raises(NotImplementedError, match="distributed slice"):
        tf.decode_step(model, cache, tcfg, torch.zeros((1, 1),
                                                       dtype=torch.long), 0,
                       policy=object())


def test_serve_example_runs_on_the_cpu():
    """The serve example's three smoke configs: prompt kept, 16 tokens in
    the vocabulary after it, and the tokens of ``generate`` itself."""
    outs = serve_example.run(torch.device("cpu"))
    assert sorted(outs) == sorted(serve_example.ARCHS)
    for arch, out in outs.items():
        assert tuple(out.shape) == (serve_example.BATCH,
                                    serve_example.PROMPT + serve_example.NEW)
        assert int(out.min()) >= 0
