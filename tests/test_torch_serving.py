"""PyTorch port vs the JAX package on the serving path, at gemma3-1b's smoke
size (7 layers: 6 in a 5-local:1-global cycle plus 1 local remainder,
d 128, window 8), on the CPU, with the JAX params carried over by
``params_from_jax``:

* ``prefill_forward`` logits and per-layer K/V at a length that takes the
  block-local path (24 = 3 windows) and one that does not (13), <= 1e-4;
* teacher-forced ``paged_decode_step`` logits, gather and kernel paths,
  against JAX's gather step, <= 1e-4;
* the engine: token equality with JAX's ``PagedServingEngine``
  (``use_kernel=False``) on a trace with mid-flight admission and one
  eviction, and the page pool draining clean.

1e-4 rather than 1e-5: seven layers of f32 matmuls summed in another order
by another BLAS, read at logits of magnitude ~1."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.gemma3_1b import smoke_config as jax_smoke
from repro.models.transformer import init_model as jax_init_model
from repro.serving import engine as jax_engine
from repro.serving import paged_decode as jax_pd
from repro_torch.configs.gemma3_1b import smoke_config
from repro_torch.interop import params_from_jax
from repro_torch.models.transformer import init_model, prefill_forward
from repro_torch.serving import engine as torch_engine
from repro_torch.serving import paged_decode as torch_pd
from repro_torch.serving.pages import PageManager

TOL = 1e-4
PS = 4


@functools.lru_cache(maxsize=None)
def _models():
    cfg = jax_smoke()
    params = jax.jit(jax_init_model, static_argnums=1)(
        jax.random.PRNGKey(0), cfg)
    model = init_model(torch.Generator().manual_seed(0), smoke_config())
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return cfg, params, model


def _tokens(seed, shape):
    return np.random.RandomState(seed).randint(
        0, jax_smoke().vocab_size, shape).astype(np.int32)


@pytest.mark.parametrize("S", [13, 24])
def test_prefill_matches_jax(S):
    cfg, params, model = _models()
    toks = _tokens(S, (2, S))
    lj, cj = jax_engine._jit_prefill(params, jnp.asarray(toks), cfg=cfg)
    with torch.inference_mode():
        lt, ct = prefill_forward(model, smoke_config(),
                                 torch.from_numpy(toks).long(), raw_kv=True)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=TOL, rtol=0)
    for i in range(cfg.n_layers):
        entry = jax_pd.layer_cache_entry(cj, cfg, i)
        for name in ("k", "v"):
            np.testing.assert_allclose(ct[i][name].numpy(),
                                       np.asarray(entry[name]), atol=TOL,
                                       rtol=0)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_paged_decode_step_teacher_forced(use_kernel):
    """Two slots (prompts 10 and 13 — the second crosses the window) and
    one idle slot, three forced tokens, logits compared at every step."""
    cfg, params, model = _models()
    tcfg = smoke_config()
    n_pages, n_pmax, B = 24, 6, 3
    lens = [10, 13]
    jpools = jax_pd.init_paged_pools(cfg, n_pages, PS, B)
    tpools = torch_pd.init_paged_pools(tcfg, n_pages, PS, B, device="cpu")
    pm = PageManager(n_pages=n_pages, page_size=PS)
    table = np.zeros((B, n_pmax), np.int32)
    for slot, S in enumerate(lens):
        toks = _tokens(100 + slot, (1, S))
        pages = pm.admit(slot, S, S + 3)
        _, cj = jax_engine._jit_prefill(params, jnp.asarray(toks), cfg=cfg)
        jpools = jax_pd.dump_prefill_to_pools(jpools, cj, cfg, slot, pages,
                                              PS, S)
        with torch.inference_mode():
            _, ct = prefill_forward(model, tcfg, torch.from_numpy(toks).long())
        torch_pd.dump_prefill_to_pools(tpools, ct, tcfg, slot, pages, PS, S)
        table[slot] = pm.table_array(slot, n_pmax)
    lengths = np.array(lens + [0], np.int32)
    forced = _tokens(7, (3, B, 1))
    for step in range(3):
        for slot in range(len(lens)):
            newp = pm.append_token(slot)
            if newp is not None:
                table[slot, lengths[slot] // PS] = newp
        lj, jpools = jax_engine._jit_decode_step(
            params, jpools, jnp.asarray(forced[step]), jnp.asarray(table),
            jnp.asarray(lengths), cfg=cfg, page_size=PS, use_kernel=False)
        with torch.inference_mode():
            lt, _ = torch_pd.paged_decode_step(
                model, tpools, tcfg, torch.from_numpy(forced[step]).long(),
                torch.from_numpy(table), torch.from_numpy(lengths),
                page_size=PS, use_kernel=use_kernel)
        live = slice(0, len(lens))
        np.testing.assert_allclose(lt.numpy()[live], np.asarray(lj)[live],
                                   atol=TOL, rtol=0)
        lengths[:len(lens)] += 1


def _requests(lens, max_new=6, seed=1):
    rng = np.random.RandomState(seed)
    return [(i, rng.randint(0, jax_smoke().vocab_size, size=s)
             .astype(np.int32), max_new) for i, s in enumerate(lens)]


def _drive(mod, eng, reqs, evict_uid, evict_after):
    for uid, prompt, m in reqs:
        eng.submit(mod.Request(uid=uid, prompt=prompt, max_new_tokens=m))
    for _ in range(evict_after):
        eng.step()
    freed = eng.evict(evict_uid)
    out = eng.run([])
    return out, freed


def test_engine_tokens_match_jax_with_midflight_admission_and_eviction():
    """Six requests through three slots: later requests are admitted while
    earlier ones decode; request 1 is evicted mid-flight. Every output
    (the evicted one's partial output included) is token-identical, the
    freed pages are the same, and the pool drains clean."""
    cfg, params, model = _models()
    reqs = _requests([5, 9, 13, 7, 11, 4])
    kw = dict(page_size=PS, n_pages=32, max_slots=3, max_seq_len=32)
    jeng = jax_engine.PagedServingEngine(params, cfg, **kw)
    teng = torch_engine.PagedServingEngine(model, smoke_config(), **kw)
    jout, jfreed = _drive(jax_engine, jeng, reqs, evict_uid=1, evict_after=3)
    tout, tfreed = _drive(torch_engine, teng, reqs, evict_uid=1,
                          evict_after=3)
    assert tfreed == jfreed and len(tfreed) > 0
    assert sorted(tout) == sorted(jout) == list(range(len(reqs)))
    for uid in jout:
        np.testing.assert_array_equal(tout[uid], jout[uid])
    assert len(tout[1]) < 9 + 6, "request 1 was evicted before finishing"
    teng.pm.check()
    assert teng.pm.n_free == teng.pm.capacity, "pages leaked after drain"
    assert teng.stats()["n_steps"] == jeng.stats()["n_steps"]
