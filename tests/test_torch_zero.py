"""The ZeRO-1 / ZeRO-3 half of the port's data-parallel D2FT
(``repro_torch/sharding/sync.py``, ``train/loop.py``'s ZeRO bodies,
``launch/mesh.py``'s reduce-scatter and all-gather) against the JAX
package on the CPU:

* plans leaf for leaf against ``repro.sharding.sync.grad_sync_plan(mode=
  "zero" | "zero3")`` at four smoke configs (gemma3, the GQA variant at G
  2, olmoe, mamba2; ``tests/test_torch_sync.py``'s), k in {1, 2, 4}, with
  and without ``ever_live``, ``elide_gather`` both ways, under five
  schedules; ``sync_byte_report``, ``zero_state_byte_report``,
  ``zero3_param_byte_report`` and ``zero3_unit_schedule`` (JAX's unit
  names mapped to ``layers.<l>``) equal JAX's bytes exactly, but for the
  protected MoE ``norm2`` (``test_torch_sync.py``'s deliberate
  difference, carried over: its runs are always scattered and gathered);
* ``_zero_layout_perm`` and ``zero_reshard`` against JAX's on numpy
  arrays; a hypothesis property: k in {1, 2, 4, 8} ranks emulated in one
  process through the port's own bucket functions, gather and scatter
  against the canonical arrays, bit for bit;
* a world of one: ``finetune_distributed(refresh_every=1)`` under zero,
  zero3, zero3 streamed and zero3 with ``opt_chunk`` against JAX's on
  ``make_data_mesh(1)``, 3 AdamW steps on ``test_torch_distributed.py``'s
  dense config: losses, parameters and canonical moments within 1e-4,
  the refresh records' reports equal;
* two gloo ranks (``tests/_torch_dist_ranks.py``, which imports no jax),
  3 AdamW steps a leg (ZeRO-1 with weight decay 0 and 0.01, ZeRO-3,
  streamed ZeRO-3) under the paper's concentrated mix against JAX's
  single-device full-batch step: parameters and losses within 1e-4, the
  ranks bitwise equal, the counter equal to the plan's bytes every step,
  the moments' bytes equal to ``zero_state_byte_report``, streamed equal
  to unstreamed bit for bit, and its residency check passing.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from conftest import optional_hypothesis

from repro.configs import gemma3_1b as jax_gemma
from repro.configs import mamba2_130m as jax_mamba
from repro.configs import olmoe_1b_7b as jax_olmoe
from repro.configs.base import D2FTConfig as JaxD2FTConfig
from repro.configs.base import ModelConfig as JaxModelConfig
from repro.core.assignment import device_sample_order as jax_sample_order
from repro.core.assignment import plan_device_assignment as jax_assign
from repro.core.schedule import P_F, P_O, P_S
from repro.core.schedule import Schedule as JaxSchedule
from repro.core.schedule import gates_from_schedule as jax_gates
from repro.data.synthetic import microbatch_assignment
from repro.launch.diststep import paper_mix_schedule, uniform_half_schedule
from repro.launch.mesh import make_data_mesh as jax_data_mesh
from repro.launch.parallel import MeshSpec as JaxMeshSpec
from repro.launch.parallel import ParallelConfig as JaxParallelConfig
from repro.models.transformer import init_model as jax_init_model
from repro.optim.optimizers import adamw as jax_adamw
from repro.sharding import sync as jax_sync
from repro.train.loop import finetune_distributed as jax_finetune_dist
from repro.train.loop import make_train_step as jax_train_step
from repro_torch.configs import gemma3_1b, mamba2_130m, olmoe_1b_7b
from repro_torch.configs.base import D2FTConfig, ModelConfig
from repro_torch.core.schedule import Schedule
from repro_torch.data.synthetic import lm_batches
from repro_torch.interop import params_from_jax
from repro_torch.launch.mesh import make_data_mesh
from repro_torch.launch.parallel import MeshSpec, ParallelConfig
from repro_torch.models.transformer import init_model
from repro_torch.optim.optimizers import adamw
from repro_torch.sharding import sync
from repro_torch.train.loop import finetune_distributed

from _torch_dist_ranks import run_ranks

given, settings, st = optional_hypothesis()

TRAJ_TOL = 1e-4
N_MB = 4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """torch's intra-op threads at 1 for this file's tests, the old count
    restored after: its small CPU ops run faster on one thread than across
    threads beside the other test processes."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _gqa(cfg):
    return dataclasses.replace(cfg, n_heads=8, n_kv_heads=2, head_dim=16)


# name -> (JAX config, port config, G)
CONFIGS = {
    "gemma3": (jax_gemma.smoke_config(), gemma3_1b.smoke_config(), 4),
    "gqa_g2": (_gqa(jax_gemma.smoke_config()),
               _gqa(gemma3_1b.smoke_config()), 2),
    "olmoe": (jax_olmoe.smoke_config(), olmoe_1b_7b.smoke_config(), 4),
    "mamba2": (jax_mamba.smoke_config(), mamba2_130m.smoke_config(), 4),
}


@functools.lru_cache(maxsize=None)
def _tree(jcfg):
    """The JAX param tree's shapes and dtypes, filled with seeded
    normals (the plans depend on the shapes alone)."""
    shapes = jax.eval_shape(lambda k: jax_init_model(k, jcfg),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    return jax.tree.map(
        lambda s: rng.standard_normal(s.shape).astype(s.dtype), shapes)


def _schedules(L, G):
    """The paper's concentrated mix at two seeds, the uniformly spread
    half, all-p_s, and layer 0 backward-dead (p_o) with layer 1 half
    live."""
    half = np.full((L * G, N_MB), P_O, np.int8)
    half[G:G + G // 2] = P_F
    return {"paper_mix_0": paper_mix_schedule(L, G, N_MB, seed=0).table,
            "paper_mix_3": paper_mix_schedule(L, G, N_MB, seed=3).table,
            "uniform_half": uniform_half_schedule(L, G, N_MB).table,
            "all_ps": np.full((L * G, N_MB), P_S, np.int8),
            "dead_layer": half}


def _leaves(prefix, tree):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(f"{prefix}.{k}" if prefix else k, v)
    else:
        yield prefix, tree


def _fields(s):
    return (s.mode, s.axis, tuple(s.live), tuple(s.gather), s.shards)


def _unstacked(s, c):
    """Cycle c's spec of a JAX stacked leaf's spec."""
    if s.mode in ("stacked", "zero_stacked"):
        return s.per_cycle[c]
    if s.mode in ("sliced", "zero"):
        return dataclasses.replace(s, axis=s.axis - 1)
    return s


def _jax_plan_by_name(plan, cfg):
    """The JAX plan keyed by the port's names (cycle c, position j ->
    layer c*P + j), each spec as its fields."""
    out = {}
    for key, sub in plan.items():
        if key not in ("cycles", "rest"):
            for name, s in _leaves(key, sub):
                out[name] = _fields(s)
    P = len(plan.get("cycles", []))
    n_cycles = cfg.n_layers // P if P else 0
    for j, block in enumerate(plan.get("cycles", [])):
        for name, s in _leaves("", block):
            for c in range(n_cycles):
                out[f"layers.{c * P + j}.{name}"] = _fields(_unstacked(s, c))
    for i, block in enumerate(plan.get("rest", [])):
        for name, s in _leaves("", block):
            out[f"layers.{n_cycles * P + i}.{name}"] = _fields(s)
    return out


def _jax_unit(name, cfg, P):
    """JAX's residency-unit name -> the port's."""
    n_cycles = cfg.n_layers // P if P else 0
    if name.startswith("cycles["):
        i, c = (int(x) for x in name[7:-1].split("]["))
        return f"layers.{c * P + i}"
    if name.startswith("rest["):
        return f"layers.{n_cycles * P + int(name[5:-1])}"
    return name


def _moe_norm2(name, named):
    parts = name.split(".")
    return parts[0] == "layers" and parts[2] == "norm2" and \
        f"layers.{parts[1]}.moe.router" in named


def _plans(arch, mode, k, ever, elide, table):
    jcfg, cfg, G = CONFIGS[arch]
    tree = _tree(jcfg)
    named = params_from_jax(tree)
    L = cfg.n_layers
    jplan = jax_sync.grad_sync_plan(
        tree, jcfg, JaxSchedule(table, L, G), mode=mode, n_shards=k,
        ever_live=ever, elide_gather=elide)
    plan = sync.grad_sync_plan(named, cfg, Schedule(table, L, G), mode,
                               n_shards=k, ever_live=ever,
                               elide_gather=elide)
    return tree, named, jplan, plan


@pytest.mark.parametrize("mode", ["zero", "zero3"])
@pytest.mark.parametrize("arch", list(CONFIGS))
def test_zero_plans_and_reports_match_jax(arch, mode):
    """Every leaf's spec equals JAX's, but an MoE block's protected
    ``norm2`` (always scattered and gathered; JAX's has its layer's
    liveness); every byte of every report equals JAX's plus those
    leaves' extra bytes; the unit schedule is JAX's, unit for unit."""
    jcfg, cfg, G = CONFIGS[arch]
    L = cfg.n_layers
    P = len(cfg.block_pattern)
    rng = np.random.default_rng(0)
    seen = set()
    for what, table in _schedules(L, G).items():
        live = sync.backward_live_groups(Schedule(table, L, G))
        for k in (1, 2, 4):
            for ever in (None, rng.random((L, G)) < 0.3):
                for elide in (True, False):
                    tree, named, jplan, plan = _plans(arch, mode, k, ever,
                                                      elide, table)
                    want = _jax_plan_by_name(jplan, cfg)
                    assert set(plan) == set(want) == set(named)
                    extra_rs = extra_ag = 0.0
                    extra_unit = {}
                    for name, spec in plan.items():
                        mine, theirs = _fields(spec), want[name]
                        seen.add(spec.mode)
                        if _moe_norm2(name, named) and theirs[0] == "zero":
                            layer = int(name.split(".")[1])
                            assert mine == theirs[:2] + ((True,), (True,),
                                                         k), (what, name)
                            assert theirs[2] == (bool(live[layer].any()),)
                            nb = 4.0 * named[name].numel()
                            extra_rs += nb * (1 - theirs[2][0])
                            extra_ag += nb * (1 - theirs[3][0])
                            extra_unit[f"layers.{layer}"] = \
                                extra_unit.get(f"layers.{layer}", 0.0) + \
                                nb * (1 - theirs[3][0])
                            continue
                        assert mine == theirs, (what, k, name)
                    _check_reports(plan, named, jplan, tree, k, cfg, P,
                                   extra_rs, extra_ag, extra_unit)
    assert "zero" in seen


def _check_reports(plan, named, jplan, tree, k, cfg, P, extra_rs, extra_ag,
                   extra_unit):
    rep = sync.sync_byte_report(plan, named, n_shards=k)
    jrep = jax_sync.sync_byte_report(jplan, tree, n_shards=k)
    assert rep["total_bytes"] == jrep["total_bytes"]
    assert rep["ar_bytes"] == jrep["ar_bytes"]
    assert rep["rs_bytes"] == jrep["rs_bytes"] + extra_rs
    assert rep["ag_bytes"] == jrep["ag_bytes"] + extra_ag
    assert rep["synced_bytes"] == jrep["synced_bytes"] + \
        (extra_rs + extra_ag) / 2
    if not (extra_rs or extra_ag):
        assert rep["fraction"] == jrep["fraction"]
        assert rep.get("wire") == jrep.get("wire")
    assert rep["n_zero"] == sum(s.mode == "zero" for s in plan.values())
    for n_mom in (1, 2):
        st_ = sync.zero_state_byte_report(plan, named, k, n_mom)
        jst = jax_sync.zero_state_byte_report(jplan, tree, k, n_mom)
        for key in ("replicated_bytes", "per_device_bytes", "fraction",
                    "n_shards"):
            assert st_[key] == jst[key], key
    z3 = sync.zero3_param_byte_report(plan, named, k)
    jz3 = jax_sync.zero3_param_byte_report(jplan, tree, k)
    for key in ("replicated_bytes", "shard_bytes", "fallback_bytes",
                "n_shards"):
        assert z3[key] == jz3[key], key
    assert z3["gathered_bytes"] == jz3["gathered_bytes"] + extra_ag
    assert z3["elided_bytes"] == jz3["elided_bytes"] - extra_ag
    zero_specs = [s for s in plan.values() if s.mode == "zero"]
    assert z3["n_runs"] == sum(len(sync._zero_runs(s)) for s in zero_specs)
    assert z3["n_gather_elided"] == sum(
        not g for s in zero_specs for _, g, _, _ in sync._zero_runs(s))
    units = sync.zero3_unit_schedule(plan, named)
    junits = [(_jax_unit(u, cfg, P), b + extra_unit.get(
        _jax_unit(u, cfg, P), 0.0))
        for u, b in jax_sync.zero3_unit_schedule(jplan, tree)]
    assert units == junits
    peak = max(b for _, b in junits)
    assert z3["peak_unit_bytes"] == peak
    assert z3["per_device_peak_bytes"] == \
        jz3["shard_bytes"] + jz3["fallback_bytes"] + peak
    if not extra_ag:
        assert z3["peak_unit"] == _jax_unit(jz3["peak_unit"], cfg, P)
        assert z3["fraction"] == jz3["fraction"]


@pytest.mark.parametrize("arch", ["gemma3", "olmoe"])
def test_layout_perm_and_reshard_match_jax(arch):
    """``_zero_layout_perm`` equals JAX's for every zero leaf; the port's
    ``zero_reshard`` between two plans' layouts (and canonical) equals
    JAX's on the same arrays, bit for bit, and round-trips."""
    jcfg, cfg, G = CONFIGS[arch]
    tables = _schedules(cfg.n_layers, G)
    rng = np.random.default_rng(1)
    for k in (2, 4):
        tree, named, jold, old = _plans(arch, "zero3", k, None, True,
                                        tables["paper_mix_0"])
        _, _, jnew, new = _plans(arch, "zero3", k, None, True,
                                 tables["uniform_half"])
        values = jax.tree.map(
            lambda x: rng.standard_normal(x.shape).astype(np.float32), tree)
        canon = params_from_jax(values)
        for name, spec in old.items():
            if spec.mode == "zero":
                ax = named[name].shape[spec.axis]
                jspec = jax_sync.SyncSpec("zero", axis=spec.axis,
                                          live=spec.live, gather=spec.gather,
                                          shards=k)
                np.testing.assert_array_equal(
                    sync._zero_layout_perm(spec, ax),
                    jax_sync._zero_layout_perm(jspec, ax))
        laid = sync.zero_reshard(canon, None, old)
        jlaid = params_from_jax(jax.tree.map(
            np.asarray, jax_sync.zero_reshard(values, None, jold)))
        moved = sync.zero_reshard(laid, old, new)
        jmoved = params_from_jax(jax.tree.map(
            np.asarray, jax_sync.zero_reshard(
                jax_sync.zero_reshard(values, None, jold), jold, jnew)))
        back = sync.zero_reshard(moved, new, None)
        for name in canon:
            assert torch.equal(laid[name], jlaid[name]), name
            assert torch.equal(moved[name], jmoved[name]), name
            assert torch.equal(back[name], canon[name]), name
        # a rank's shard is its contiguous 1/k of the global layout
        for name, spec in old.items():
            if spec.mode == "zero":
                for d in range(k):
                    n = laid[name].shape[spec.axis] // k
                    assert torch.equal(
                        sync.zero_shard_leaf(canon[name], spec, d),
                        laid[name].narrow(spec.axis, d * n, n)), name


# ------------------------------------------------------------ the property
PROP = ModelConfig(name="prop", arch_type="dense", n_layers=2, d_model=32,
                   n_heads=4, n_kv_heads=4, d_ff=64, vocab_size=128)
PROP_SHAPES = {n: tuple(p.shape) for n, p in init_model(
    torch.Generator().manual_seed(0), PROP).named_parameters()}


@st.composite
def schedule_tables(draw):
    L, G = PROP.n_layers, 4
    n_mb = draw(st.integers(1, 6))
    cells = draw(st.lists(st.sampled_from([P_F, P_O, P_S]),
                          min_size=L * G * n_mb, max_size=L * G * n_mb))
    return Schedule(np.asarray(cells, np.int8).reshape(L * G, n_mb), L, G)


@settings(max_examples=40, deadline=None)
@given(schedule_tables(), st.sampled_from([1, 2, 4, 8]),
       st.sampled_from(["zero", "zero3"]), st.integers(0, 2 ** 16))
def test_emulated_ranks_gather_and_scatter_bit_exact(sched, k, mode, seed):
    """k ranks emulated in one process through the port's own bucket
    functions. Gather: each rank's shard (``zero_shard_leaf``) goes into
    its ``_gather_inputs`` bucket, the buckets are concatenated in rank
    order (what ``all_gather_`` returns) and ``_gather_outputs`` writes
    them into zeros: the canonical arrays with exactly the elided runs
    zero, and the concatenated shards are the global layout
    ``zero_reshard`` lays out (``_zero_layout_perm``). Scatter: each
    rank's local gradients (exact zeros on dead runs, as the schedule
    guarantees) into its ``_scatter_inputs`` bucket, the buckets summed
    (``reduce_scatter_``), rank d's segment divided by k into
    ``_scatter_outputs``: rank d's shard of the ranks' mean, bit for bit
    against the mean taken in the same order."""
    plan = sync.grad_sync_plan(
        {n: torch.empty(s, device="meta") for n, s in PROP_SHAPES.items()},
        PROP, sched, mode, n_shards=k)
    gen = torch.Generator().manual_seed(seed)
    canon = {n: torch.randn(s, generator=gen) for n, s in PROP_SHAPES.items()}
    zero = {n: s for n, s in plan.items() if s.mode == "zero"}
    shards = [{n: sync.zero_shard_leaf(canon[n], s, d)
               for n, s in zero.items()} for d in range(k)]
    outs = {}
    for d in range(k):
        for dtype, b in sync._gather_inputs(shards[d], zero,
                                            PROP_SHAPES).items():
            outs.setdefault(dtype, []).append(b)
    fulls = {n: torch.zeros(PROP_SHAPES[n]) for n in zero}
    sync._gather_outputs({dt: torch.cat(bs) for dt, bs in outs.items()},
                         fulls, zero, k)
    glob = sync.zero_reshard(canon, None, plan)
    for n, s in zero.items():
        want = canon[n].clone()
        for r in sync._run_layout(s, PROP_SHAPES[n][s.axis]):
            if not r.gather:
                want.narrow(s.axis, r.start, r.length).zero_()
        assert torch.equal(fulls[n], want), n
        assert torch.equal(torch.cat([sh[n] for sh in shards], s.axis),
                           glob[n]), n
        assert all(g or not lv for lv, g in zip(s.live, s.gather))
    grads = []
    for d in range(k):
        g = {n: torch.randn(PROP_SHAPES[n], generator=gen) for n in zero}
        for n, s in zero.items():
            for r in sync._run_layout(s, PROP_SHAPES[n][s.axis]):
                if not r.live:
                    g[n].narrow(s.axis, r.start, r.length).zero_()
        grads.append(g)
    buckets = [sync._scatter_inputs(g, zero, k) for g in grads]
    total = {dt: functools.reduce(torch.add, [b[dt] for b in buckets])
             for dt in buckets[0]}
    mean = {n: functools.reduce(torch.add, [g[n] for g in grads]) / k
            for n in zero}
    for d in range(k):
        seg = {dt: t.view(k, -1)[d] / k for dt, t in total.items()}
        got = sync._scatter_outputs(seg, grads[d], zero, d)
        for n, s in zero.items():
            assert torch.equal(got[n], sync.zero_shard_leaf(mean[n], s, d)), n


# ------------------------------------------------------- the loop, k = 1
B, S, G = 8, 8, 4
DENSE = dict(name="refresh", arch_type="dense", n_layers=2, d_model=64,
             n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=128)
JCFG, CFG = JaxModelConfig(**DENSE), ModelConfig(**DENSE)
D2 = dict(n_microbatches=N_MB, n_pf=2, n_po=1, head_groups=G)
SYNC_KEYS = ("total_bytes", "ar_bytes", "rs_bytes", "ag_bytes",
             "synced_bytes", "fraction", "wire")
Z3_KEYS = ("replicated_bytes", "shard_bytes", "fallback_bytes",
           "gathered_bytes", "elided_bytes", "peak_unit_bytes",
           "per_device_peak_bytes", "fraction")


@pytest.fixture(scope="module")
def dense_tree():
    params = jax.jit(jax_init_model, static_argnums=1)(
        jax.random.PRNGKey(0), JCFG)
    return jax.tree.map(np.asarray, params)


def _port(tree):
    model = init_model(torch.Generator().manual_seed(0), CFG)
    model.load_state_dict(params_from_jax(tree))
    return model


def _assert_close(mine, theirs, tol=TRAJ_TOL):
    for name, t in mine.items():
        np.testing.assert_allclose(t.detach().numpy(),
                                   theirs[name].numpy(), atol=tol, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("kw", [
    dict(sync_mode="zero"), dict(sync_mode="zero3"),
    dict(sync_mode="zero3", streamed=True),
    dict(sync_mode="zero3", opt_chunk=100)],
    ids=["zero", "zero3", "zero3_streamed", "zero3_opt_chunk"])
def test_world_of_one_matches_jax_finetune_distributed(dense_tree, kw):
    """Rank 0 scores and plans at every step (refresh_every=1); the
    moments are re-laid out at each refresh and handed back canonical, as
    the parameters are."""
    steps = 3
    jp, jstate, jlog = jax_finetune_dist(
        dense_tree, JCFG, JaxD2FTConfig(**D2), jax_adamw(1e-3),
        lm_batches(0, CFG.vocab_size, B, S, steps), steps=steps,
        mesh=jax_data_mesh(1),
        parallel=JaxParallelConfig(mesh=JaxMeshSpec(data=1), **kw),
        refresh_every=1)
    model = _port(dense_tree)
    mesh = make_data_mesh(1, "cpu")
    try:
        model, state, log = finetune_distributed(
            model, CFG, D2FTConfig(**D2), adamw(1e-3),
            lm_batches(0, CFG.vocab_size, B, S, steps), steps=steps,
            mesh=mesh,
            parallel=ParallelConfig(mesh=MeshSpec(data=1), **kw),
            refresh_every=1)
    finally:
        mesh.close()
    assert state["step"] == steps
    np.testing.assert_allclose(log.losses, jlog.losses, atol=TRAJ_TOL,
                               rtol=0)
    _assert_close(dict(model.named_parameters()),
                  params_from_jax(jax.tree.map(np.asarray, jp)))
    for key in ("m", "v"):
        _assert_close(state[key], params_from_jax(
            jax.tree.map(np.asarray, jstate[key])))
    mine, theirs = log.extras["refreshes"], jlog.extras["refreshes"]
    assert [r["step"] for r in mine] == [r["step"] for r in theirs] == \
        list(range(steps))
    for a, b in zip(mine, theirs):
        assert a["device_of"] == b["device_of"]
        assert a["op_counts"] == b["op_counts"]
        for key in SYNC_KEYS:
            assert a["sync"].get(key) == b["sync"].get(key), key
        if kw["sync_mode"] == "zero3":
            for key in Z3_KEYS:
                assert a["zero3_params"][key] == b["zero3_params"][key], key
            assert a["zero3_params"]["peak_unit"] == _jax_unit(
                b["zero3_params"]["peak_unit"], CFG, len(CFG.block_pattern))
        if kw.get("streamed"):
            assert a["residency"]["peak_agreement"] == 1.0
    plans = [r["sync"] for r in mine]
    assert log.extras["sync_bytes"] == [
        r["ar_bytes"] + r["rs_bytes"] + r["ag_bytes"] for r in plans]
    assert log.extras["sync_bytes_by_kind"] == [
        {k: v for k, v in (("reduce_scatter", r["rs_bytes"]),
                           ("all_gather", r["ag_bytes"]),
                           ("all_reduce", r["ar_bytes"])) if v}
        for r in plans]


def test_world_of_one_zero_modes_equal_masked_bitwise(dense_tree):
    """At k = 1 every shard is its whole leaf in canonical order and every
    collective an identity, so ZeRO-1, ZeRO-3 and streamed ZeRO-3 give the
    masked loop's losses and parameters bit for bit."""
    runs = {}
    for mode, streamed in (("masked", False), ("zero", False),
                           ("zero3", False), ("zero3", True)):
        model = _port(dense_tree)
        mesh = make_data_mesh(1, "cpu")
        try:
            _, _, log = finetune_distributed(
                model, CFG, D2FTConfig(**D2), adamw(1e-3),
                lm_batches(0, CFG.vocab_size, B, S, 3), steps=3, mesh=mesh,
                parallel=ParallelConfig(mesh=MeshSpec(data=1),
                                        sync_mode=mode, streamed=streamed),
                refresh_every=2)
        finally:
            mesh.close()
        runs[(mode, streamed)] = (log.losses, {
            n: p.detach().clone() for n, p in model.named_parameters()})
    base_losses, base = runs[("masked", False)]
    for key, (losses, params) in runs.items():
        assert losses == base_losses, key
        for n, p in params.items():
            assert torch.equal(p, base[n]), (key, n)


# ------------------------------------------------------------- two ranks
LEGS = [("zero_wd0", "zero", False, 0.0), ("zero", "zero", False, 0.01),
        ("zero3", "zero3", False, 0.01),
        ("zero3_streamed", "zero3", True, 0.01)]
LR = 1e-3


def test_two_gloo_ranks_match_jax_single_device_step(dense_tree, tmp_path):
    """Each rank runs its shard of JAX's 2-device permutation under the
    paper's concentrated mix; every leg's mean equals JAX's full-batch
    AdamW step; every leg's ranks end bit-identical; each step sent
    exactly the plan's bytes by collective; the moments on each rank are
    ``zero_state_byte_report``'s ``per_device_bytes``."""
    L = CFG.n_layers
    table = paper_mix_schedule(L, G, N_MB, seed=0).table
    jsched, sched = JaxSchedule(table, L, G), Schedule(table, L, G)
    mb_of = microbatch_assignment(B, N_MB)
    jasg, _ = jax_assign(jsched, 2)
    perm = jax_sample_order(jasg, mb_of)
    batch = next(lm_batches(0, CFG.vocab_size, B, S, 1))
    res = run_ranks("zero", tmp_path, {
        "cfg": CFG, "state": params_from_jax(dense_tree),
        "table": torch.as_tensor(table), "G": G, "legs": LEGS, "lr": LR,
        "tokens": torch.as_tensor(batch["tokens"]),
        "labels": torch.as_tensor(batch["labels"])})
    gates = jax_gates(jsched, mb_of[perm])
    jbatch = {k: v[perm] for k, v in batch.items()}
    shapes = {n: torch.empty(p.shape, device="meta")
              for n, p in _port(dense_tree).named_parameters()}
    for name, mode, streamed, wd in LEGS:
        opt = jax_adamw(LR, weight_decay=wd)
        step = jax.jit(jax_train_step(JCFG, opt, use_gates=True))
        params, state, losses = dense_tree, opt.init(dense_tree), []
        for _ in range(3):
            params, state, metrics = step(params, state, jbatch, gates)
            losses.append(float(metrics["loss"]))
        plan = sync.grad_sync_plan(shapes, CFG, sched, mode, n_shards=2,
                                   elide_gather=wd == 0.0)
        rep = sync.sync_byte_report(plan, shapes, n_shards=2)
        want = {k: v for k, v in (("reduce_scatter", rep["rs_bytes"]),
                                  ("all_gather", rep["ag_bytes"]),
                                  ("all_reduce", rep["ar_bytes"])) if v}
        moments = sync.zero_state_byte_report(plan, shapes, 2, 2)
        theirs = params_from_jax(jax.tree.map(np.asarray, params))
        for r in res:
            leg = r[name]
            np.testing.assert_allclose(leg["losses"], losses, atol=TRAJ_TOL,
                                       rtol=0, err_msg=name)
            _assert_close(leg["params"], theirs)
            assert leg["sent"] == [want] * 3, name
            assert leg["moment_bytes"] == moments["per_device_bytes"], name
            if streamed:
                assert leg["residency"]["peak_agreement"] == 1.0
        assert res[0][name]["losses"] == res[1][name]["losses"], name
        for n, p in res[0][name]["params"].items():
            assert torch.equal(p, res[1][name]["params"][n]), (name, n)
        if name == "zero_wd0":
            assert rep["ag_bytes"] < rep["total_bytes"]
        if mode == "zero3":
            z3 = sync.zero3_param_byte_report(plan, shapes, 2)
            assert z3["n_gather_elided"] > 0
    for r in res:
        assert r["zero3"]["losses"] == r["zero3_streamed"]["losses"]
        for n, p in r["zero3"]["params"].items():
            assert torch.equal(p, r["zero3_streamed"]["params"][n]), n
