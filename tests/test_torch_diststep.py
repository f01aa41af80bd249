"""The port's distributed-step measurement (``launch/diststep.py``) against
the JAX package on the CPU.

* The three schedule builders give JAX's tables for the same (layers,
  groups, micro-batches, mix, seed); ``zero3_overlap_report`` equals JAX's
  on the small config's plans (params through ``params_from_jax``).
* ``measure_distributed_step(2, time_steps=0)`` runs once, on two gloo
  ranks (``tests/_torch_dist_ranks.py``, which imports no jax), in a
  module fixture; its records are held to JAX's functions on the same
  schedules and JAX-initialised params (each variant's byte reports,
  op counts, cost model and rebalance; the pipeline's stage plan and
  bubbles) and to the port's own plans: the recorder's bytes under the
  plan's kinds equal the plan's ``ar_bytes`` / ``rs_bytes`` /
  ``ag_bytes`` and, priced as JAX prices HLO, its ``wire``; the other
  kinds are a few bytes of metrics; no ``torch.distributed`` call of a
  measured step bypassed the mesh's records.

Byte counts are exact; the reports' fractions are ratios of the same
integers. ``n_leaves``-type counts are not compared: the port's layers
are unstacked (``tests/test_torch_sync.py``).
"""
import jax
import numpy as np
import pytest
import torch

from repro.core.assignment import layer_live_costs as jax_live_costs
from repro.core.assignment import plan_device_assignment as jax_assign
from repro.core.assignment import plan_stage_assignment as jax_stages
from repro.core.cost_model import comm_cost as jax_comm_cost
from repro.core.cost_model import compute_cost as jax_compute_cost
from repro.core.schedule import op_counts as jax_op_counts
from repro.launch import diststep as jax_ds
from repro.models.transformer import init_model as jax_init_model
from repro.sharding import sync as jax_sync
from repro.train.pipeline import analytic_bubble_fraction as jax_bubble
from repro_torch.core.schedule import Schedule
from repro_torch.interop import params_from_jax
from repro_torch.launch import diststep
from repro_torch.sharding import sync

from _torch_dist_ranks import run_ranks

N = 2                                   # the ranks of the spawned world
K_OF = {"all_reduce": "ar_bytes", "reduce_scatter": "rs_bytes",
        "all_gather": "ag_bytes"}
OP_OF = {"all_reduce": "all-reduce", "reduce_scatter": "reduce-scatter",
         "all_gather": "all-gather"}

SCHEDULE_CASES = [
    (4, 4, 8, (0.4, 0.3, 0.3), 0),      # the small config's
    (6, 4, 8, (0.4, 0.3, 0.3), 0),      # gemma3-1b on 6 layers, G 4
    (6, 4, 8, (0.4, 0.3, 0.3), 3),
    (3, 8, 5, (0.5, 0.2, 0.3), 2),
    (2, 2, 3, (0.25, 0.5, 0.25), 1),
    (5, 3, 4, (0.2, 0.8, 0.0), 7),
]


@pytest.mark.parametrize("case", range(len(SCHEDULE_CASES)))
@pytest.mark.parametrize("builder", ["paper_mix", "all_pf", "uniform_half"])
def test_schedule_builders_match_jax(builder, case):
    L, G, n_mb, mix, seed = SCHEDULE_CASES[case]
    if builder == "paper_mix":
        args, kw = (L, G, n_mb, mix, seed), {}
    elif builder == "all_pf":
        args, kw = (L, G, n_mb), {}
    else:
        args, kw = (L, G, n_mb), dict(live_frac=mix[0], seed=seed)
    mine = getattr(diststep, f"{builder}_schedule")(*args, **kw)
    theirs = getattr(jax_ds, f"{builder}_schedule")(*args, **kw)
    assert mine.table.dtype == theirs.table.dtype
    np.testing.assert_array_equal(mine.table, theirs.table)
    assert (mine.n_layers, mine.n_groups) == (theirs.n_layers,
                                              theirs.n_groups)


@pytest.fixture(scope="module")
def small():
    """(JAX's config, JAX's params, the port's config, the port's params
    from JAX's)."""
    jcfg = jax_ds.small_config()
    jparams = jax.jit(jax_init_model, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg)
    return jcfg, jparams, diststep.small_config(), params_from_jax(jparams)


def test_small_config_is_jaxs(small):
    jcfg, _, cfg, _ = small
    for f in ("name", "arch_type", "n_layers", "d_model", "n_heads",
              "n_kv_heads", "d_ff", "vocab_size"):
        assert getattr(cfg, f) == getattr(jcfg, f), f


def _schedules(cfg, n_mb=8, mix=(0.4, 0.3, 0.3), seed=0):
    G = cfg.n_heads
    return {
        "all_pf_baseline": jax_ds.all_pf_schedule(cfg.n_layers, G, n_mb),
        "paper_mix": jax_ds.paper_mix_schedule(cfg.n_layers, G, n_mb, mix,
                                               seed),
        "uniform_half": jax_ds.uniform_half_schedule(cfg.n_layers, G, n_mb,
                                                     seed=seed)}


@pytest.mark.parametrize("k", [2, 4, 8])
@pytest.mark.parametrize("which", ["paper_mix", "uniform_half"])
def test_zero3_overlap_report_matches_jax(small, which, k):
    jcfg, jparams, cfg, named = small
    jsched = _schedules(jcfg)[which]
    table = jsched.table
    jplan = jax_sync.grad_sync_plan(jparams, jcfg, jsched, mode="zero3",
                                    n_shards=k, elide_gather=True)
    plan = sync.grad_sync_plan(named, cfg, Schedule(
        table, cfg.n_layers, cfg.n_heads), "zero3", n_shards=k,
        elide_gather=True)
    mine = diststep.zero3_overlap_report(plan, named, k)
    theirs = jax_ds.zero3_overlap_report(jplan, jparams, k)
    assert set(mine) == set(theirs)
    for key, want in theirs.items():
        assert mine[key] == pytest.approx(want, rel=1e-12, abs=0), key
    # the embedding, the layers, the final norm, the unembedding
    assert mine["n_units"] == cfg.n_layers + 3


# ------------------------------------------------ the two-rank measurement
@pytest.fixture(scope="module")
def measured(tmp_path_factory):
    """Both ranks' (record, torch.distributed call counts)."""
    outs = run_ranks("diststep", tmp_path_factory.mktemp("diststep"), {},
                     world=N)
    return [(o["record"], o["counts"]) for o in outs]


@pytest.fixture(scope="module")
def jax_side(small):
    """JAX's plans of every variant and the pipeline's on the same
    schedules, on JAX-initialised params."""
    jcfg, jparams, _, _ = small
    scheds = _schedules(jcfg)
    plans = {name: jax_sync.grad_sync_plan(
        jparams, jcfg, scheds[s], mode=mode, n_shards=N, elide_gather=True)
        for name, (s, mode, _) in diststep.VARIANTS.items()}
    return scheds, plans


def _variants():
    return list(diststep.VARIANTS)


@pytest.mark.parametrize("name", _variants())
def test_variant_reports_match_jax(measured, small, jax_side, name):
    jcfg, jparams, _, _ = small
    scheds, plans = jax_side
    v = measured[0][0]["variants"][name]
    jsched, jplan = scheds[v["schedule"]], plans[name]
    assert v["op_counts"] == jax_op_counts(jsched)
    assert v["cost_model"] == {
        "compute": round(jax_compute_cost(jsched.table), 4),
        "comm": round(jax_comm_cost(jsched.table), 4)}
    assert v["rebalance"] == jax_assign(jsched, N)[1]
    rep = jax_sync.sync_byte_report(jplan, jparams, n_shards=N)
    for key in ("total_bytes", "synced_bytes", "ar_bytes", "rs_bytes",
                "ag_bytes", "fraction", "wire"):
        assert v["sync_plan"][key] == rep[key], key
    if v["sync_mode"] in ("zero", "zero3"):
        jst = jax_sync.zero_state_byte_report(jplan, jparams, N,
                                              n_moments=2)
        for key in ("replicated_bytes", "per_device_bytes", "fraction",
                    "n_shards"):
            assert v["opt_memory"][key] == jst[key], key
    else:
        assert "opt_memory" not in v
    if v["sync_mode"] == "zero3":
        jz3 = jax_sync.zero3_param_byte_report(jplan, jparams, N)
        for key in ("replicated_bytes", "shard_bytes", "fallback_bytes",
                    "gathered_bytes", "elided_bytes", "peak_unit_bytes",
                    "per_device_peak_bytes", "fraction", "n_shards"):
            assert v["param_memory"][key] == jz3[key], key
        # JAX's unit cycles[i][c] is layer c * P + i (P = 1 here)
        assert v["param_memory"]["peak_unit"] == \
            jz3["peak_unit"].replace("cycles[0][", "layers.").rstrip("]")
    else:
        assert "param_memory" not in v


@pytest.mark.parametrize("name", _variants())
def test_recorded_sync_bytes_equal_the_plan(measured, name):
    """Under the plan's kinds the recorder holds exactly ar_bytes /
    rs_bytes / ag_bytes, one call a dtype (one here), and priced with
    JAX's formulas they are the plan's per-rank ``wire``; the other kinds
    are the metrics all-reduce, a few scalars."""
    for rec, _ in measured:
        v = rec["variants"][name]
        plan = v["sync_plan"]
        for kind, key in K_OF.items():
            got = v["recorded"].get(kind)
            if plan[key]:
                # one bucket a dtype; the streamed step one a residency unit
                calls = got.pop("calls")
                assert calls == 1 or (v["streamed"] and 1 < calls <= 7)
                assert got == {"op": OP_OF[kind], "bytes": int(plan[key]),
                               "k": N}, kind
            else:
                assert got is None, kind
        assert v["sync_collectives"] == {
            OP_OF[kind]: pytest.approx(plan["wire"][kind], rel=1e-12)
            for kind in K_OF if plan["wire"][kind]}
        assert v["wire_bytes"] == pytest.approx(plan["wire"]["total"],
                                                rel=1e-12)
        other = {k: e for k, e in v["recorded"].items() if k not in K_OF}
        assert set(other) == {"metrics"}
        assert other["metrics"]["op"] == "all-reduce"
        assert other["metrics"]["calls"] == 1
        assert other["metrics"]["bytes"] <= 64
        # every call of the step, priced as JAX prices a compiled step's
        assert sum(v["collectives"].values()) == pytest.approx(
            plan["wire"]["total"] + 2 * (N - 1) / N
            * other["metrics"]["bytes"], rel=1e-12)


def test_zero3_variants_all_gather_and_masked_ones_do_not(measured):
    for rec, _ in measured:
        for name, v in rec["variants"].items():
            n_ag = v["collectives_n"].get("all-gather", 0)
            if v["sync_mode"] == "zero3":
                assert n_ag >= 1, name
            elif v["sync_mode"] == "masked":
                assert n_ag == 0 and "reduce-scatter" not in \
                    v["collectives_n"], name
        assert rec["zero3"]["n_all_gather_ops"] >= 1


def test_all_reduce_fraction_is_the_plans_ratio(measured):
    rec = measured[0][0]
    v = rec["variants"]
    want = v["paper_mix"]["sync_plan"]["ar_bytes"] / \
        v["all_pf_baseline"]["sync_plan"]["ar_bytes"]
    assert rec["all_reduce_fraction"] == pytest.approx(want, rel=1e-12)
    assert rec["sync_model_fraction"] == \
        v["paper_mix"]["sync_plan"]["fraction"]
    assert 0 < rec["all_reduce_fraction"] < 1


def test_zero_summaries(measured):
    rec = measured[0][0]
    v, zs, z3 = rec["variants"], rec["zero_sync"], rec["zero3"]
    base = v["all_pf_baseline"]["sync_plan"]["wire"]["total"]
    for key, name in (("paper_mix_wire_fraction", "paper_mix_zero"),
                      ("paper_mix_masked_wire_fraction", "paper_mix"),
                      ("uniform_wire_fraction", "uniform_half_zero"),
                      ("uniform_masked_wire_fraction", "uniform_half")):
        assert zs[key] == pytest.approx(
            v[name]["sync_plan"]["wire"]["total"] / base, rel=1e-12), key
    # whole-subnet elision never fires on the spread schedule
    assert zs["uniform_masked_n_skipped"] == 0
    assert zs["opt_memory_fraction"] == 0.5
    pm = v["paper_mix_zero3"]["param_memory"]
    assert z3["residency_fraction"] == pm["fraction"]
    assert z3["n_gather_elided"] == pm["n_gather_elided"] > 0
    assert z3["paper_mix_wire_fraction"] == pytest.approx(
        v["paper_mix_zero3"]["sync_plan"]["wire"]["total"] / base,
        rel=1e-12)


def test_streamed_variant_residency_and_overlap(measured, small,
                                                jax_side):
    jcfg, jparams, _, _ = small
    _, plans = jax_side
    rec = measured[0][0]
    res = rec["variants"]["paper_mix_zero3_streamed"]["residency_check"]
    units = jax_sync.zero3_unit_schedule(plans["paper_mix_zero3_streamed"],
                                         jparams)
    # units whose every run the schedule elides gather nothing
    assert res["n_units_model"] == len(units)
    assert res["n_units_measured"] == sum(b > 0 for _, b in units)
    assert res["peak_agreement"] == pytest.approx(1.0, abs=0.05)
    ov = jax_ds.zero3_overlap_report(plans["paper_mix_zero3_streamed"],
                                     jparams, N)
    assert rec["overlap"]["exposed_collective_fraction"] == pytest.approx(
        ov["exposed_fraction"], rel=1e-12)
    assert rec["overlap"]["double_buffer_fraction"] == pytest.approx(
        ov["double_buffer_fraction"], rel=1e-12)
    # streaming re-schedules the collectives, not what they move
    assert rec["overlap"]["wire_ratio_vs_unstreamed"] == 1.0


def test_variants_on_one_schedule_take_the_same_loss(measured):
    """The masked, ZeRO-1, ZeRO-3 and streamed steps of one schedule
    compute one forward from the same parameters; both ranks report the
    mean over the ranks."""
    r0, r1 = measured[0][0], measured[1][0]
    for which in ("paper_mix", "uniform_half"):
        losses = [v["loss"] for v in r0["variants"].values()
                  if v["schedule"] == which]
        assert max(losses) - min(losses) <= 1e-6, (which, losses)
    for name in _variants():
        assert r0["variants"][name]["loss"] == r1["variants"][name]["loss"]
        assert r0["variants"][name]["recorded"] == \
            r1["variants"][name]["recorded"]


def test_pipeline_matches_jax_stage_plan(measured, jax_side):
    scheds, _ = jax_side
    p = measured[0][0]["pipeline"]
    jsched = scheds["paper_mix"]
    assign, rep = jax_stages(jsched, 2)
    assert p["mesh"] == {"data": N // 2, "stage": 2}
    for key in ("boundaries", "loads", "makespan", "layer_count_makespan",
                "makespan_ratio"):
        assert p[key] == rep[key], key
    assert p["layer_count_boundaries"] == list(rep["layer_count_boundaries"])
    assert p["bubble_fraction"] == jax_bubble(assign.loads, 4)
    costs = np.asarray(jax_live_costs(jsched))
    ub = rep["layer_count_boundaries"]
    assert p["layer_count_bubble_fraction"] == jax_bubble(
        [float(sum(costs[lo:hi])) for lo, hi in zip(ub, ub[1:])], 4)
    assert p["rebalance"] == jax_assign(jsched, N // 2)[1]
    assert p["trace"]["n_rounds"] == 4 + 2 - 1


def test_pipeline_collectives(measured):
    """The stage axis sums the loss terms and the gradient tree (one
    bucket) and sends M activations one way and M cotangents back; the
    data axis of one rank records its plan's bytes and sends nothing."""
    for rank, (rec, _) in enumerate(measured):
        p = rec["pipeline"]
        r = p["recorded"]
        assert r["p2p"]["calls"] == 4 and r["p2p"]["k"] == 2
        assert r["stage"]["calls"] == 2 and r["stage"]["k"] == 2
        assert r["all_reduce"]["k"] == 1 and r["metrics"]["k"] == 1
        assert r["all_reduce"]["bytes"] == \
            rec["variants"]["paper_mix"]["sync_plan"]["ar_bytes"]
        assert p["collectives"]["collective-permute"] == r["p2p"]["bytes"]
        assert p["collectives"]["all-reduce"] == r["stage"]["bytes"]
        assert p["n_sent"] == 6


def test_no_collective_bypassed_the_mesh(measured):
    """Every torch.distributed call the ranks made came from a recorded
    mesh call: the sends and collectives number the records whose axis
    has more than one rank; each receive pairs with a recorded send."""
    for rec, counts in measured:
        recv = counts.pop("recv", 0)
        sent = sum(v["n_sent"] for v in rec["variants"].values()) \
            + rec["pipeline"]["n_sent"]
        assert sum(counts.values()) == sent, counts
        assert recv == rec["pipeline"]["recorded"]["p2p"]["calls"]
        assert counts.get("all_reduce", 0) > 0


def test_record_layout(measured):
    rec = measured[0][0]
    assert rec["rank"] == 0 and measured[1][0]["rank"] == 1
    assert rec["backend"] == "cpu"
    assert rec["n_devices"] == N
    # JAX's matrix, in JAX's order
    assert list(rec["variants"]) == [
        "all_pf_baseline", "paper_mix", "paper_mix_zero", "paper_mix_zero3",
        "paper_mix_zero3_streamed", "uniform_half", "uniform_half_zero",
        "uniform_half_zero3"]
    for key in ("all_reduce_fraction", "sync_model_fraction", "zero_sync",
                "zero3", "overlap", "pipeline"):
        assert key in rec, key
    assert rec["variants"]["paper_mix_zero3_streamed"]["opt_chunk"] == 2048
    assert all("wall_us_per_step" not in v
               for v in rec["variants"].values())



def test_unit_schedule_takes_jaxs_order_from_the_models_parameters(
        small):
    """The residency units come in JAX's forward order (embedding, layers,
    final norm, unembedding) from the model's own parameter order, which
    lists ``unembed`` first: the overlap report depends on the order."""
    from repro_torch.models.transformer import init_model
    jcfg, jparams, cfg, _ = small
    model = init_model(torch.Generator().manual_seed(0), cfg)
    named = dict(model.named_parameters())
    assert next(iter(named)) == "unembed"
    jsched = _schedules(jcfg)["paper_mix"]
    jplan = jax_sync.grad_sync_plan(jparams, jcfg, jsched, mode="zero3",
                                    n_shards=N, elide_gather=True)
    plan = sync.grad_sync_plan(named, cfg, Schedule(
        jsched.table, cfg.n_layers, cfg.n_heads), "zero3", n_shards=N,
        elide_gather=True)
    units = [u for u, _ in sync.zero3_unit_schedule(plan, named)]
    assert units == [u.replace("cycles[0][", "layers.").rstrip("]")
                     for u, _ in jax_sync.zero3_unit_schedule(jplan,
                                                              jparams)]
    assert diststep.zero3_overlap_report(plan, named, N) == pytest.approx(
        jax_ds.zero3_overlap_report(jplan, jparams, N), rel=1e-12)
