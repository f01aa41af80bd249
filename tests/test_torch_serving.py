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
  eviction, and the page pool draining clean; the page ids checked once a
  decode step, not once a layer.

Then the recurrent and MoE families, on ``tests/test_serving.py``'s
``ssm`` and ``hybrid`` cases and olmoe-1b-7b's smoke config
(the configs of ``test_torch_decode.case_config``, repeated here): the paged
step teacher-forced against ``forward`` (<= 1e-5, as the JAX package's
own test), engine tokens equal to JAX's engine under mid-flight
admission and eviction, and a slot reused after an eviction.

1e-4 rather than 1e-5 against JAX: seven layers of f32 matmuls summed in
another order by another BLAS, read at logits of magnitude ~1."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jax_base
from repro.configs.gemma3_1b import smoke_config as jax_smoke
from repro.configs.olmoe_1b_7b import smoke_config as jax_olmoe
from repro.models.transformer import init_model as jax_init_model
from repro.serving import engine as jax_engine
from repro.serving import paged_decode as jax_pd
from repro_torch.configs import base
from repro_torch.configs.gemma3_1b import smoke_config
from repro_torch.configs.olmoe_1b_7b import smoke_config as olmoe
from repro_torch.interop import params_from_jax
from repro_torch.kernels import ops
from repro_torch.models.transformer import (forward, init_model,
                                            prefill_forward)
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
            _, ct = prefill_forward(model, tcfg, torch.from_numpy(toks).long(),
                                    raw_kv=True)
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


def test_engine_checks_page_ids_once_a_step():
    """The kernel path's page-id range check runs once per engine step, on
    the host copy of the table, and never per layer (7 attention layers);
    a direct ``paged_decode_step`` call checks its table once."""
    cfg, params, model = _models()
    tcfg = smoke_config()
    eng = torch_engine.PagedServingEngine(model, tcfg, page_size=PS,
                                          n_pages=32, max_slots=3,
                                          max_seq_len=32, use_kernel=True)
    for uid, prompt, m in _requests([5, 9, 13, 7], max_new=4):
        eng.submit(torch_engine.Request(uid=uid, prompt=prompt,
                                        max_new_tokens=m))
    ops.check_page_ids.calls = 0
    n = 0
    while eng.live or eng.waiting:
        eng.step()
        n += 1
        assert ops.check_page_ids.calls == n
    assert eng.n_steps == n
    pools = torch_pd.init_paged_pools(tcfg, 8, PS, 2, device="cpu")
    args = (torch.zeros((2, 1), dtype=torch.long),
            torch.zeros((2, 2), dtype=torch.int32),
            torch.zeros((2,), dtype=torch.int32))
    with torch.inference_mode():
        for checked, want in ((False, 1), (True, 0)):
            ops.check_page_ids.calls = 0
            torch_pd.paged_decode_step(model, pools, tcfg, *args,
                                       page_size=PS, use_kernel=True,
                                       tables_checked=checked)
            assert ops.check_page_ids.calls == want
        bad = torch.full((2, 2), 8, dtype=torch.int32)
        with pytest.raises(ValueError, match="valid page ids"):
            torch_pd.paged_decode_step(model, pools, tcfg, args[0], bad,
                                       args[2], page_size=PS,
                                       use_kernel=True)


# ============================================= recurrent and MoE families
def _family_config(name, b):
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


@functools.lru_cache(maxsize=None)
def _family(name):
    """(JAX config, JAX params, port config, port model) from seed 0."""
    jcfg = _family_config(name, jax_base)
    params = jax.jit(jax_init_model, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg)
    tcfg = _family_config(name, base)
    model = init_model(torch.Generator().manual_seed(0), tcfg)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return jcfg, params, tcfg, model


@pytest.mark.parametrize("name,use_kernel", [
    ("ssm", False), ("hybrid", False), ("hybrid", True)])
def test_recurrent_paged_decode_matches_forward(name, use_kernel):
    """Two sequences prefilled into slots 0 and 2 (prompts 8 and 12; the
    second admitted mid-flight), the rest teacher-forced through
    ``paged_decode_step``: logits within 1e-5 of the port's ``forward`` at
    every decoded position, recurrent state carried in place."""
    _, _, cfg, model = _family(name)
    max_slots, n_pmax, S_total = 3, 8, 16
    pm = PageManager(n_pages=64, page_size=PS)
    pools = torch_pd.init_paged_pools(cfg, 64, PS, max_slots, device="cpu")
    table = np.zeros((max_slots, n_pmax), np.int32)
    toks = torch.from_numpy(np.random.RandomState(1).randint(
        0, cfg.vocab_size, (2, S_total)))
    prompt_lens, slots = [8, 12], [0, 2]
    admitted = set()
    errs = []
    with torch.inference_mode():
        ref, _ = forward(model, cfg, toks)
        for t in range(min(prompt_lens), S_total):
            tok = np.zeros((max_slots, 1), np.int64)
            lens = np.zeros((max_slots,), np.int32)
            table_step = np.zeros_like(table)
            active = []
            for b, (slot, S) in enumerate(zip(slots, prompt_lens)):
                if S > t:
                    continue
                if b not in admitted:
                    pages = pm.admit(b, S, S_total)
                    _, cache = prefill_forward(model, cfg, toks[b:b + 1, :S],
                                               raw_kv=True)
                    torch_pd.dump_prefill_to_pools(pools, cache, cfg, slot,
                                                   pages, PS, S)
                    table[slot, :len(pages)] = pages
                    admitted.add(b)
                newp = pm.append_token(b)
                if newp is not None:
                    table[slot, t // PS] = newp
                tok[slot, 0] = int(toks[b, t])
                lens[slot] = t
                table_step[slot] = table[slot]
                active.append((b, slot))
            logits, _ = torch_pd.paged_decode_step(
                model, pools, cfg, torch.from_numpy(tok),
                torch.from_numpy(table_step), torch.from_numpy(lens),
                page_size=PS, use_kernel=use_kernel)
            errs += [float((logits[slot, 0] - ref[b, t]).abs().max())
                     for b, slot in active]
    pm.check()
    assert max(errs) <= 1e-5, max(errs)


def _family_requests(cfg, lens, max_new=5):
    rng = np.random.RandomState(3)
    return [(i, rng.randint(0, cfg.vocab_size, size=s).astype(np.int32),
             max_new) for i, s in enumerate(lens)]


# three prompt lengths (each JAX prefill compiles per length), more
# requests than slots, so admissions land while others decode
FAMILY_LENS = [5, 9, 7, 9, 5, 7]


@pytest.mark.parametrize("name", ["ssm", "hybrid", "olmoe"])
def test_family_engine_tokens_match_jax(name):
    """Six requests through three slots, request 1 evicted after 3 steps:
    every output token-identical to JAX's engine, the same freed pages,
    the pool drained. Under MoE the slots couple through the experts'
    capacity, inactive slots included, in both packages alike."""
    jcfg, params, tcfg, model = _family(name)
    reqs = _family_requests(tcfg, FAMILY_LENS)
    kw = dict(page_size=PS, n_pages=32, max_slots=3, max_seq_len=32)
    jeng = jax_engine.PagedServingEngine(params, jcfg, **kw)
    teng = torch_engine.PagedServingEngine(model, tcfg, **kw)
    jout, jfreed = _drive(jax_engine, jeng, reqs, evict_uid=1, evict_after=3)
    tout, tfreed = _drive(torch_engine, teng, reqs, evict_uid=1,
                          evict_after=3)
    assert tfreed == jfreed
    assert sorted(tout) == sorted(jout) == list(range(len(reqs)))
    for uid in jout:
        np.testing.assert_array_equal(tout[uid], jout[uid])
    teng.pm.check()
    assert teng.pm.n_free == teng.pm.capacity, "pages leaked after drain"


@pytest.mark.parametrize("name", ["ssm", "hybrid"])
def test_slot_reused_after_eviction_matches_a_fresh_engine(name):
    """Request 0 decodes 3 steps in slot 0 and is evicted; request 2 is
    admitted into that slot while request 1 keeps decoding. Request 2's
    tokens equal those of a fresh engine serving it alone: admission
    overwrites the slot's recurrent state."""
    _, _, cfg, model = _family(name)
    reqs = [torch_engine.Request(uid=uid, prompt=p, max_new_tokens=m)
            for uid, p, m in _family_requests(cfg, [7, 5, 9], max_new=6)]
    kw = dict(page_size=PS, n_pages=32, max_slots=2, max_seq_len=32)
    eng = torch_engine.PagedServingEngine(model, cfg, **kw)
    eng.submit(reqs[0])
    eng.submit(reqs[1])
    for _ in range(3):
        eng.step()
    slot = next(s for s, q in eng.live.items() if q.req.uid == 0)
    eng.evict(0)
    eng.submit(reqs[2])
    eng.step()                                     # admits request 2
    assert [q.req.uid for s, q in eng.live.items() if s == slot] == [2]
    out = eng.run([])
    alone = torch_engine.PagedServingEngine(model, cfg, **kw).run(
        [reqs[2]])
    np.testing.assert_array_equal(out[2], alone[2])
    assert eng.pm.n_free == eng.pm.capacity
