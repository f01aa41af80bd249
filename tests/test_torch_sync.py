"""The schedule-masked gradient sync of the PyTorch port
(``repro_torch/sharding/sync.py``) against the JAX package's on the CPU.

Plans leaf for leaf against ``repro.sharding.sync.grad_sync_plan`` at four
smoke configs: gemma3 (7 attention layers, 4 query heads on 1 KV head, G
4: shared KV, coarse), a GQA variant of it (8 query heads on 2 KV heads,
at G 2, where the KV columns split by group, and G 4, where they do not),
olmoe (2 MoE layers: the protected ``moe`` subtree and ``norm2``) and
mamba2 (2 SSD layers: coarse leaves), under the paper's concentrated mix,
a uniformly spread half, all-p_f and all-p_s schedules. The JAX plan's
stacked cycle leaves are unstacked by the interop rule (cycle c, position
j -> layer c*P + j). ``sync_byte_report``'s byte fields equal JAX's
exactly (they are counts); ``lofi_merge`` / ``stack_replicas`` equal
JAX's; and two gloo ranks (``tests/_torch_dist_ranks.py``, which imports
no jax) run ``apply_grad_sync`` and the cross-rank ``lofi_merge_`` on their
own gradients.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gemma3_1b as jax_gemma
from repro.configs import mamba2_130m as jax_mamba
from repro.configs import olmoe_1b_7b as jax_olmoe
from repro.core.schedule import P_F, P_O, P_S
from repro.core.schedule import Schedule as JaxSchedule
from repro.launch.diststep import paper_mix_schedule, uniform_half_schedule
from repro.models.transformer import init_model as jax_init_model
from repro.models.transformer import lm_loss as jax_lm_loss
from repro.sharding import sync as jax_sync
from repro_torch.configs import gemma3_1b, mamba2_130m, olmoe_1b_7b
from repro_torch.core.assignment import plan_device_assignment
from repro_torch.core.schedule import Schedule
from repro_torch.interop import params_from_jax
from repro_torch.models.transformer import init_model
from repro_torch.sharding import sync

from _torch_dist_ranks import run_ranks


def _gqa(cfg):
    return dataclasses.replace(cfg, n_heads=8, n_kv_heads=2, head_dim=16)


# name -> (JAX config, port config, G)
CONFIGS = {
    "gemma3": (jax_gemma.smoke_config(), gemma3_1b.smoke_config(), 4),
    "gqa_g2": (_gqa(jax_gemma.smoke_config()),
               _gqa(gemma3_1b.smoke_config()), 2),
    "gqa_g4": (_gqa(jax_gemma.smoke_config()),
               _gqa(gemma3_1b.smoke_config()), 4),
    "olmoe": (jax_olmoe.smoke_config(), olmoe_1b_7b.smoke_config(), 4),
    "mamba2": (jax_mamba.smoke_config(), mamba2_130m.smoke_config(), 4),
}
N_MB = 4


@functools.lru_cache(maxsize=None)
def _tree(jcfg):
    """The JAX param tree's shapes and dtypes (``jax.eval_shape``: the
    plans depend on them alone), filled with seeded normals."""
    shapes = jax.eval_shape(lambda k: jax_init_model(k, jcfg),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    return jax.tree.map(
        lambda s: rng.standard_normal(s.shape).astype(s.dtype), shapes)


def _schedules(L, G):
    """The tables the plans are compared on: the paper's concentrated mix
    at two seeds, the uniformly spread half, all-p_f, all-p_s, and one
    with layer 0 backward-dead and layer 1 half live."""
    half = np.full((L * G, N_MB), P_O, np.int8)
    half[:G] = P_S
    half[G:G + G // 2] = P_F
    return {"paper_mix_0": paper_mix_schedule(L, G, N_MB, seed=0).table,
            "paper_mix_3": paper_mix_schedule(L, G, N_MB, seed=3).table,
            "uniform_half": uniform_half_schedule(L, G, N_MB).table,
            "all_pf": np.full((L * G, N_MB), P_F, np.int8),
            "all_ps": np.full((L * G, N_MB), P_S, np.int8),
            "dead_layer": half}


def _leaves(prefix, tree):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(f"{prefix}.{k}" if prefix else k, v)
    else:
        yield prefix, tree


def _jax_plan_by_name(plan, cfg):
    """The JAX plan keyed by the port's names, as (mode, axis, live): a
    stacked leaf's per-cycle spec goes to its cycle's layer, and a sliced
    spec shared by every cycle loses the stack axis it was shifted by."""
    out = {}
    for key, sub in plan.items():
        if key not in ("cycles", "rest"):
            for name, s in _leaves(key, sub):
                out[name] = (s.mode, s.axis, s.live)
    P = len(plan.get("cycles", []))
    n_cycles = cfg.n_layers // P if P else 0
    for j, block in enumerate(plan.get("cycles", [])):
        for name, s in _leaves("", block):
            for c in range(n_cycles):
                if s.mode == "stacked":
                    one = s.per_cycle[c]
                    spec = (one.mode, one.axis, one.live)
                elif s.mode == "sliced":
                    spec = (s.mode, s.axis - 1, s.live)
                else:
                    spec = (s.mode, s.axis, s.live)
                out[f"layers.{c * P + j}.{name}"] = spec
    for i, block in enumerate(plan.get("rest", [])):
        for name, s in _leaves("", block):
            out[f"layers.{n_cycles * P + i}.{name}"] = (s.mode, s.axis,
                                                        s.live)
    return out


def _moe_norm2(name, named):
    parts = name.split(".")
    return parts[0] == "layers" and parts[2] == "norm2" and \
        f"layers.{parts[1]}.moe.router" in named


@pytest.mark.parametrize("arch", list(CONFIGS))
def test_plan_and_byte_report_match_jax(arch):
    """Every leaf's spec equals JAX's but one deliberate difference: an
    MoE block's ``norm2`` is protected (always ``all``), as the JAX
    module's docstring says it must be, where the JAX plan reaches it by
    the leaf name ``scale`` and elides it in a backward-dead layer (see
    ``test_jax_moe_norm2_gradient_is_live_in_a_dead_layer``). The byte
    report's totals, all-reduce bytes, fraction and wire bytes equal
    JAX's exactly; ``n_leaves`` counts the port's unstacked parameters, so
    JAX's counts each stacked cycle leaf once."""
    jcfg, cfg, G = CONFIGS[arch]
    tree = _tree(jcfg)
    named = params_from_jax(tree)
    n_stacked = sum(len(list(_leaves("", b))) for b in tree.get("cycles",
                                                                  []))
    n_cycles = cfg.n_layers // len(cfg.block_pattern)
    for what, table in _schedules(cfg.n_layers, G).items():
        jplan = jax_sync.grad_sync_plan(tree, jcfg,
                                        JaxSchedule(table, cfg.n_layers, G))
        plan = sync.grad_sync_plan(named, cfg,
                                   Schedule(table, cfg.n_layers, G))
        want = _jax_plan_by_name(jplan, cfg)
        assert set(plan) == set(want) == set(named), what
        live = sync.backward_live_groups(Schedule(table, cfg.n_layers, G))
        for name, spec in plan.items():
            theirs = want[name]
            if _moe_norm2(name, named):
                assert spec == sync.SyncSpec("all"), (what, name)
                layer = int(name.split(".")[1])
                assert theirs[0] == ("all" if live[layer].any() else
                                     "none"), (what, name, theirs)
                continue
            assert (spec.mode, spec.axis, spec.live) == theirs, \
                (what, name)
        # the protected norm2 of a backward-dead MoE layer adds its bytes
        extra = sum(4 * named[n].numel() for n in named
                    if _moe_norm2(n, named)
                    and not live[int(n.split(".")[1])].any())
        for k in (None, 2, 8):
            rep = sync.sync_byte_report(plan, named, n_shards=k)
            jrep = jax_sync.sync_byte_report(jplan, tree, n_shards=k)
            for key in ("total_bytes", "rs_bytes", "ag_bytes", "n_zero"):
                assert rep[key] == jrep[key], (what, k, key)
            for key in ("ar_bytes", "synced_bytes"):
                assert rep[key] == jrep[key] + extra, (what, k, key)
            if not extra:
                assert rep["fraction"] == jrep["fraction"], (what, k)
                assert rep.get("wire") == jrep.get("wire"), (what, k)
            assert rep["n_leaves"] == len(named)
            assert jrep["n_leaves"] == \
                len(named) - (n_cycles - 1) * n_stacked
    # the cases the comparison has to cover
    modes = {s.mode for t in _schedules(cfg.n_layers, G).values()
             for s in sync.grad_sync_plan(
                 named, cfg, Schedule(t, cfg.n_layers, G)).values()}
    assert modes == ({"all", "none"} if arch == "mamba2" else
                     {"all", "none", "sliced"}), modes


def test_gqa_kv_columns_slice_only_where_groups_own_kv_heads():
    """n_kv % G == 0 (G 2 on 2 KV heads): wk / wv split by group; G 4 on 2
    KV heads shares each KV head between groups: coarse."""
    for arch, want in (("gqa_g2", "sliced"), ("gqa_g4", "all")):
        jcfg, cfg, G = CONFIGS[arch]
        named = params_from_jax(_tree(jcfg))
        table = _schedules(cfg.n_layers, G)["dead_layer"]
        plan = sync.grad_sync_plan(named, cfg,
                                   Schedule(table, cfg.n_layers, G))
        assert plan["layers.1.attn.wk"].mode == want
        assert plan["layers.1.attn.wq"].mode == "sliced"
        assert plan["layers.0.attn.wk"].mode == "none"


def test_jax_moe_norm2_gradient_is_live_in_a_dead_layer():
    """Why the port protects an MoE block's norm2: with every group of a
    layer backward-dead, its router's aux losses still give norm2.scale a
    non-zero gradient (JAX's own), which the JAX plan would not sync."""
    jcfg, cfg, G = CONFIGS["olmoe"]
    params = jax_init_model(jax.random.PRNGKey(0), jcfg)
    B, S = 4, 8
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S))
    g_f = jnp.ones((cfg.n_layers, B, G))
    g_b = g_f.at[0].set(0.0)
    grads = jax.jit(jax.grad(lambda p: jax_lm_loss(
        p, jcfg, jnp.asarray(tokens), jnp.asarray(tokens),
        gates=(g_f, g_b))[0]))(params)
    norm2 = np.asarray(grads["cycles"][0]["norm2"]["scale"])[0]
    wq = np.asarray(grads["cycles"][0]["attn"]["wq"])[0]
    assert np.abs(wq).max() == 0.0
    assert np.abs(norm2).max() > 0.0
    table = np.full((cfg.n_layers * G, N_MB), P_F, np.int8)
    table[:G] = P_O
    sched = JaxSchedule(table, cfg.n_layers, G)
    jplan = jax_sync.grad_sync_plan(params, jcfg, sched)
    assert jplan["cycles"][0]["norm2"]["scale"].per_cycle[0].mode == "none"
    plan = sync.grad_sync_plan(params_from_jax(jax.tree.map(np.asarray,
                                                            params)),
                               cfg, Schedule(table, cfg.n_layers, G))
    assert plan["layers.0.norm2.scale"].mode == "all"


def test_plan_takes_the_zero_modes():
    """The zero modes plan (``tests/test_torch_zero.py`` holds them to
    JAX's): at k = 2 every leaf of the gemma3 smoke config splits evenly,
    so every spec is a zero spec, and a mode the JAX package lacks is
    refused."""
    jcfg, cfg, G = CONFIGS["gemma3"]
    named = params_from_jax(_tree(jcfg))
    sched = Schedule(_schedules(cfg.n_layers, G)["all_pf"], cfg.n_layers, G)
    for mode in ("zero", "zero3"):
        plan = sync.grad_sync_plan(named, cfg, sched, mode, n_shards=2)
        assert {s.mode for s in plan.values()} == {"zero"}
        assert all(s.shards == 2 and all(s.live) and all(s.gather)
                   for s in plan.values())
    with pytest.raises(ValueError, match="needs n_shards"):
        sync.grad_sync_plan(named, cfg, sched, "zero")
    with pytest.raises(ValueError, match="unknown sync plan mode"):
        sync.grad_sync_plan(named, cfg, sched, "zero2", n_shards=2)


@pytest.mark.parametrize("arch", ["gemma3", "gqa_g2", "olmoe", "mamba2"])
def test_lofi_merge_matches_jax(arch):
    """Two replicas that diverged: live slices averaged (<= 1e-6), dead
    slices replica 0's, bit for bit."""
    jcfg, cfg, G = CONFIGS[arch]
    tree = _tree(jcfg)
    named = params_from_jax(tree)
    table = _schedules(cfg.n_layers, G)["paper_mix_0"]
    jplan = jax_sync.grad_sync_plan(tree, jcfg,
                                    JaxSchedule(table, cfg.n_layers, G))
    plan = sync.grad_sync_plan(named, cfg, Schedule(table, cfg.n_layers, G))
    rng = np.random.default_rng(1)
    jstack = jax.jit(lambda t: jax_sync.stack_replicas(t, 2))(tree)
    stacked = sync.stack_replicas(named, 2)
    for r in range(2):
        theirs = params_from_jax(jax.tree.map(lambda x: np.asarray(x[r]),
                                              jstack))
        for name, x in stacked.items():
            assert torch.equal(x[r], theirs[name]), name
    # replica 1 moves everywhere, dead slices included, so the test sees
    # which replica a merged dead slice comes from
    jstack = jax.tree.map(lambda x: np.stack([
        x[0], x[1] + rng.standard_normal(x.shape[1:]).astype(np.float32)]),
        jax.tree.map(np.asarray, jstack))
    moved = params_from_jax(jax.tree.map(lambda x: x[1], jstack))
    stacked = {k: torch.stack([named[k], moved[k]]) for k in named}
    merged = sync.lofi_merge(stacked, plan)
    jmerged = params_from_jax(jax.tree.map(np.asarray, jax.jit(
        lambda st: jax_sync.lofi_merge(st, jplan))(jstack)))
    for name, spec in plan.items():
        np.testing.assert_allclose(merged[name].numpy(),
                                   jmerged[name].numpy(), atol=1e-6, rtol=0,
                                   err_msg=name)
        dead = _dead_mask(spec, tuple(named[name].shape))
        np.testing.assert_array_equal(merged[name].numpy()[dead],
                                      named[name].numpy()[dead])
        np.testing.assert_array_equal(jmerged[name].numpy()[dead],
                                      named[name].numpy()[dead])


def _dead_mask(spec, shape):
    """Bool mask of the elements the plan does not sync."""
    mask = np.zeros(shape, bool)
    if spec.mode == "none":
        mask[...] = True
    elif spec.mode == "sliced":
        size = shape[spec.axis] // len(spec.live)
        for g, is_live in enumerate(spec.live):
            if not is_live:
                idx = [slice(None)] * len(shape)
                idx[spec.axis] = slice(g * size, (g + 1) * size)
                mask[tuple(idx)] = True
    return mask


def test_two_gloo_ranks_sync_live_slices_only(tmp_path):
    """Each rank's own gradients under the paper's mix (gemma3 smoke, G 4,
    batch 8 x 16): after ``apply_grad_sync`` the plan's live views hold the
    ranks' mean, and every rank holds the same values there; dead views
    were exact zeros on both ranks and are untouched bit for bit; the
    counter saw ``ar_bytes`` in one all-reduce. Then each rank takes an
    SGD step of its own, and the cross-rank ``lofi_merge_`` equals JAX's
    ``lofi_merge`` of the two replicas."""
    _, cfg, G = CONFIGS["gemma3"]
    named = {n: p.detach() for n, p in init_model(
        torch.Generator().manual_seed(0), cfg).named_parameters()}
    table = _schedules(cfg.n_layers, G)["paper_mix_0"]
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (8, 16)))
    res = run_ranks("sync", tmp_path, {
        "cfg": cfg, "state": named, "table": torch.as_tensor(table),
        "G": G, "tokens": tokens, "labels": tokens.roll(-1, 1)})
    sched = Schedule(table, cfg.n_layers, G)
    plan = sync.grad_sync_plan(named, cfg, sched)
    rep = sync.sync_byte_report(plan, named)
    assert 0 < rep["fraction"] < 1
    assert {s.mode for s in plan.values()} == {"all", "none", "sliced"}
    for r in res:
        assert r["sent"] == rep["ar_bytes"] and r["calls"] == 1
    for name, spec in plan.items():
        shape = tuple(named[name].shape)
        dead = _dead_mask(spec, shape)
        mean = (res[0]["before"][name] + res[1]["before"][name]) / 2
        for r in res:
            b, a = r["before"][name].numpy(), r["after"][name].numpy()
            assert not b[dead].any(), name
            np.testing.assert_array_equal(a[dead], b[dead])
            np.testing.assert_allclose(a[~dead], mean.numpy()[~dead],
                                       atol=1e-7, rtol=0, err_msg=name)
        np.testing.assert_array_equal(res[0]["after"][name].numpy(),
                                      res[1]["after"][name].numpy())
    # the lo-fi merge across ranks against the in-process merge of the
    # two replicas (held to JAX's by test_lofi_merge_matches_jax)
    merged = sync.lofi_merge({n: torch.stack([r["replica"][n] for r in res])
                              for n in named}, plan)
    for name, spec in plan.items():
        dead = _dead_mask(spec, tuple(named[name].shape))
        for r in res:
            np.testing.assert_allclose(r["merged"][name].numpy(),
                                       merged[name].numpy(), atol=1e-7,
                                       rtol=0, err_msg=name)
            np.testing.assert_array_equal(r["merged"][name].numpy()[dead],
                                          r["replica"][name].numpy()[dead])
        np.testing.assert_array_equal(res[0]["merged"][name].numpy(),
                                      res[1]["merged"][name].numpy())


def test_sync_byte_report_counts_the_bucket_on_one_rank():
    """World of one (an in-memory store): the bucket holds exactly the
    plan's live bytes, the values come back unchanged, and dead slices
    are never touched."""
    from repro_torch.launch.mesh import make_data_mesh
    jcfg, cfg, G = CONFIGS["olmoe"]
    named = params_from_jax(_tree(jcfg))
    table = _schedules(cfg.n_layers, G)["dead_layer"]
    plan = sync.grad_sync_plan(named, cfg, Schedule(table, cfg.n_layers, G))
    grads = {k: torch.randn(v.shape) for k, v in named.items()}
    want = {k: v.clone() for k, v in grads.items()}
    mesh = make_data_mesh(1, "cpu")
    try:
        sync.apply_grad_sync(grads, plan, mesh)
    finally:
        mesh.close()
    assert mesh.counter.total() == sync.sync_byte_report(plan,
                                                         named)["ar_bytes"]
    for k in grads:
        assert torch.equal(grads[k], want[k]), k
    asg, _ = plan_device_assignment(Schedule(table, cfg.n_layers, G), 1)
    assert list(asg.device_of) == [0] * N_MB
