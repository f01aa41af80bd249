"""Distributed-step measurement (port of ``repro/launch/diststep.py``): run
the distributed gated train step of a schedule x sync-mode matrix and
price its collectives against the all-p_f baseline and the sync plans.

The JAX package lowers and compiles the shard_map step of each variant
and parses the collectives out of the HLO (``repro/launch/hlo.py``). The
port runs one process per rank and one eager step of each variant, every
variant from the same parameters and fresh optimizer state, with the
mesh's call records cleared before it; ``launch.collectives`` prices the
records the step left (``launch.mesh.CollectiveRecord``: kind, class,
bytes, group size) with JAX's formulas. Every rank of a world of
``n_devices`` processes calls ``measure_distributed_step``; each returns
its own record, and rank 0's is the measurement.

The variants are JAX's: the all-p_f baseline, the paper's concentrated
mix (``paper_mix_schedule``) under the masked sync, ZeRO-1, ZeRO-3 and
streamed ZeRO-3, and the uniformly spread half-live schedule
(``uniform_half_schedule``, where whole-subnet elision never fires) under
the masked sync, ZeRO-1 and ZeRO-3; then the GPipe pipeline on a (data =
n/2, stage = 2) carve of the same world. A variant's sync kinds
(``all_reduce``, ``reduce_scatter``, ``all_gather``) carry exactly its
plan's ``ar_bytes``, ``rs_bytes`` and ``ag_bytes``; its other records
(``metrics``: the loss, metrics and ZeRO norm all-reduce) are priced
apart, in ``recorded``. ``all_reduce_bytes`` and ``wire_bytes`` are the
sync kinds' ring traffic, so ``all_reduce_fraction`` is the plans'
``ar_bytes`` ratio; ``collectives`` prices every call of the step, as
JAX's HLO does.

``measure_elastic`` runs the four elastic fault scenarios of JAX's
``measure_elastic`` (a straggler, a dropout, a NaN burst, dropped syncs)
on a world of four or more ranks and records their outcomes.
"""
from __future__ import annotations

import os
import time
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import D2FTConfig, ModelConfig
from repro_torch.core.assignment import (layer_live_costs,
                                         plan_device_assignment,
                                         plan_stage_assignment)
from repro_torch.core.cost_model import comm_cost, compute_cost
from repro_torch.core.schedule import P_F, P_O, P_S, Schedule, op_counts
from repro_torch.data.synthetic import lm_batches
from repro_torch.launch.collectives import (collective_bytes,
                                            collective_counts)
from repro_torch.launch.parallel import MeshSpec, ParallelConfig
from repro_torch.models.transformer import init_model
from repro_torch.optim.optimizers import adamw
from repro_torch.sharding.sync import (ResidencyRecorder,
                                       check_zero3_residency,
                                       grad_sync_plan, sync_byte_report,
                                       zero3_param_byte_report,
                                       zero3_unit_schedule,
                                       zero_state_byte_report)
from repro_torch.train.pipeline import (PipelineRecorder,
                                        analytic_bubble_fraction)

# the kinds a data-axis sync plan prices (its ar_bytes, rs_bytes, ag_bytes)
SYNC_KINDS = ("all_reduce", "reduce_scatter", "all_gather")

# name -> (schedule, sync mode, streamed): JAX's matrix
VARIANTS = {
    "all_pf_baseline": ("all_pf_baseline", "masked", False),
    "paper_mix": ("paper_mix", "masked", False),
    "paper_mix_zero": ("paper_mix", "zero", False),
    "paper_mix_zero3": ("paper_mix", "zero3", False),
    "paper_mix_zero3_streamed": ("paper_mix", "zero3", True),
    "uniform_half": ("uniform_half", "masked", False),
    "uniform_half_zero": ("uniform_half", "zero", False),
    "uniform_half_zero3": ("uniform_half", "zero3", False),
}


def small_config() -> ModelConfig:
    """Bench-scale dense config (block params dominate embed/unembed, so
    the subnet-granular sync skip is visible in the total bytes)."""
    return ModelConfig(name="diststep", arch_type="dense", n_layers=4,
                       d_model=128, n_heads=4, n_kv_heads=4, d_ff=256,
                       vocab_size=512)


def paper_mix_schedule(n_layers: int, n_groups: int, n_mb: int,
                       mix: Tuple[float, float, float] = (0.4, 0.3, 0.3),
                       seed: int = 0) -> Schedule:
    """Schedule with table-entry fractions ~= mix, all three ops
    *concentrated* by subnet: round(mix[0] * K) subnets run p_f on every
    micro-batch; the remaining subnets never run a backward, the p_o
    budget fills whole rows of them in order (a partial row spread over
    seeded columns) and the rest are p_s on every micro-batch. JAX's
    table for the same arguments."""
    K = n_layers * n_groups
    rng = np.random.default_rng(seed)
    n_pf_rows = int(round(mix[0] * K))
    pf_rows = np.sort(rng.permutation(K)[:n_pf_rows])
    table = np.full((K, n_mb), P_S, np.int8)
    table[pf_rows] = P_F
    rest = np.setdiff1d(np.arange(K), pf_rows)
    want_po = int(round(mix[1] * K * n_mb))
    filled = []
    for r in rest:
        take = min(n_mb, want_po)
        if take == 0:
            break
        table[r, rng.permutation(n_mb)[:take]] = P_O
        want_po -= take
        filled.append(r)
    if filled and len(filled) < len(rest) \
            and bool((table[filled[-1]] == P_O).all()):
        # no partial row: move one cell from the last full p_o row to the
        # next p_s row (counts unchanged), so the table stays seed-dependent
        table[filled[-1], rng.integers(n_mb)] = P_S
        table[rest[len(filled)], rng.integers(n_mb)] = P_O
    return Schedule(table, n_layers, n_groups)


def all_pf_schedule(n_layers: int, n_groups: int, n_mb: int) -> Schedule:
    """Standard full fine-tuning as a schedule (the comm baseline)."""
    return Schedule(np.full((n_layers * n_groups, n_mb), P_F, np.int8),
                    n_layers, n_groups)


def uniform_half_schedule(n_layers: int, n_groups: int, n_mb: int,
                          live_frac: float = 0.5, seed: int = 0) -> Schedule:
    """Uniformly spread live subnets: every layer has round(G * live_frac)
    backward-live groups at a rotating offset, so no layer is fully dead
    or fully live and whole-subnet elision never fires. Live rows run p_f
    on every micro-batch; dead rows split p_o / p_s at random."""
    n_live = max(1, min(n_groups - 1, int(round(live_frac * n_groups))))
    rng = np.random.default_rng(seed)
    table = np.full((n_layers * n_groups, n_mb), P_S, np.int8)
    for layer in range(n_layers):
        for j in range(n_live):
            g = (layer + j * max(n_groups // n_live, 1)) % n_groups
            table[layer * n_groups + g] = P_F
    dead = np.nonzero((table != P_F).all(axis=1))[0]
    for r in dead:
        po = rng.random(n_mb) < 0.5
        table[r, po] = P_O
    return Schedule(table, n_layers, n_groups)


def zero3_overlap_report(plan, named, n_shards: int, *,
                         compute_ratio: float = 2.0) -> dict:
    """Overlap-window model of the streamed ZeRO-3 schedule over the
    plan's units in forward order (``zero3_unit_schedule``; ``named``: the
    canonical parameters or their shapes). A unit's gather time is proxied
    by its gathered bytes and its compute by ``compute_ratio`` x the same
    bytes; under double buffering unit i+1's gather hides behind unit i's
    compute, so it exposes max(0, gather(i+1) - compute(i)), and the first
    unit's gather is always exposed. ``exposed_fraction`` = exposed /
    serialized gather bytes; ``double_buffer_peak_bytes`` prices shards +
    fallback + the largest adjacent pair of gathered units."""
    units = zero3_unit_schedule(plan, named)
    gathers = [b for _, b in units]
    exposed, prev_compute = 0.0, 0.0
    for g in gathers:
        exposed += max(0.0, g - prev_compute)
        prev_compute = g * compute_ratio
    total = sum(gathers)
    report = zero3_param_byte_report(plan, named, n_shards)
    pair = max((gathers[i] + gathers[i + 1]
                for i in range(len(gathers) - 1)),
               default=report["peak_unit_bytes"])
    peak2 = report["shard_bytes"] + report["fallback_bytes"] \
        + max(pair, report["peak_unit_bytes"])
    return {
        "n_units": len(units),
        "compute_ratio": compute_ratio,
        "serialized_gather_bytes": total,
        "exposed_gather_bytes": exposed,
        "exposed_fraction": exposed / total if total else 0.0,
        "double_buffer_peak_bytes": peak2,
        "double_buffer_fraction": (peak2 / report["replicated_bytes"]
                                   if report["replicated_bytes"] else 1.0),
    }


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@torch.no_grad()
def _restore(model, base):
    """The model's parameters set to copies of ``base`` (whole, whatever
    the last variant left: ZeRO-3 leaves shards)."""
    for n, p in model.named_parameters():
        p.data = base[n].clone()


def _backend(dev) -> str:
    if dev.type == "cuda":
        return f"cuda: {torch.cuda.get_device_name(dev)}"
    return dev.type


def _recorded(records) -> dict:
    """{kind: {op, calls, bytes, k}} of a step's records."""
    out = {}
    for r in records:
        e = out.setdefault(r.kind, {"op": r.op, "calls": 0, "bytes": 0,
                                    "k": r.k})
        e["calls"] += 1
        e["bytes"] += r.nbytes
    return out


def _step_record(records, n_devices):
    """The collectives of a step's ``records``: every call priced as JAX
    prices the compiled step's (``collectives``, ``collectives_n``), the
    sync kinds apart (``sync_collectives``), each kind's calls and bytes
    (``recorded``) and the calls that reached the backend (k > 1)."""
    sync = [r for r in records if r.kind in SYNC_KINDS]
    coll = collective_bytes(records, default_group_size=n_devices)
    return {
        "collectives": coll,
        "collectives_n": collective_counts(records),
        "sync_collectives": collective_bytes(sync,
                                             default_group_size=n_devices),
        "recorded": _recorded(records),
        "n_sent": sum(1 for r in records if r.k > 1),
    }


def _timed_steps(step, args, time_steps, dev) -> float:
    """One warm-up step, then ``time_steps`` timed ones from the state it
    leaves, the device synchronised at both ends: µs a step."""
    step(*args)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(time_steps):
        step(*args)
    _sync(dev)
    return (time.perf_counter() - t0) / time_steps * 1e6


def measure_distributed_step(n_devices: int = 8, *,
                             cfg: Optional[ModelConfig] = None,
                             batch: int = 32, seq: int = 32, n_mb: int = 8,
                             mix: Tuple[float, float, float] = (.4, .3, .3),
                             seed: int = 0, use_kernel: bool = False,
                             time_steps: int = 0, device=None) -> dict:
    """Run the distributed step on a data mesh of ``n_devices`` ranks (this
    process one of them: every rank calls it with the same arguments) for
    JAX's schedule x sync-mode matrix (``VARIANTS``), one step each from
    the same parameters (``init_model`` from ``seed``) and fresh
    decay-free AdamW state, on ``lm_batches``' first batch; then the
    pipeline variant. Each variant's record holds its collectives (module
    docstring), its sync plan's byte report, ZeRO's moment and ZeRO-3's
    residency reports, the streamed variant's residency check over the
    gathers its step ran (``check_zero3_residency``), and with
    ``time_steps`` > 0 the µs a step of ``time_steps`` steps after a
    warm-up one. The summaries (``all_reduce_fraction``, ``zero_sync``,
    ``zero3``, ``overlap``, ``pipeline``) are JAX's. ``use_kernel`` runs
    the kernel path with the per-rank live bounds. Runs on the card
    unless ``device`` names another; returns this rank's record.

    The optimizer is decay-free AdamW: zero weight decay keeps it elidable
    (``Optimizer.elidable``), so the ZeRO-1 gather mask can skip
    backward-dead runs."""
    from repro_torch.launch.mesh import make_data_mesh
    from repro_torch.train.loop import (data_step_inputs, lay_out_plan,
                                        make_distributed_train_step)

    cfg = cfg or small_config()
    G = cfg.n_heads
    mesh = make_data_mesh(n_devices, device)
    dev = mesh.device
    model = init_model(torch.Generator(device=dev).manual_seed(seed), cfg)
    base = {n: p.detach().clone() for n, p in model.named_parameters()}
    shapes = {n: torch.empty(p.shape, dtype=p.dtype, device="meta")
              for n, p in base.items()}
    opt = adamw(1e-3, weight_decay=0.0)
    data = next(lm_batches(seed, cfg.vocab_size, batch, seq, 1))
    schedules = {
        "all_pf_baseline": all_pf_schedule(cfg.n_layers, G, n_mb),
        "paper_mix": paper_mix_schedule(cfg.n_layers, G, n_mb, mix, seed),
        "uniform_half": uniform_half_schedule(cfg.n_layers, G, n_mb,
                                              seed=seed),
    }
    # chunk size of the streamed variant's shard-resident optimizer sweep
    opt_chunk = 2048
    record = {
        "n_devices": n_devices, "mix": list(mix), "seed": seed,
        "model": {"name": cfg.name, "n_layers": cfg.n_layers,
                  "d_model": cfg.d_model, "n_heads": cfg.n_heads,
                  "d_ff": cfg.d_ff, "vocab": cfg.vocab_size},
        "shape": {"batch": batch, "seq": seq, "n_microbatches": n_mb},
        "use_kernel": use_kernel,
        "backend": _backend(dev),
        "rank": mesh.rank,
        "variants": {},
    }
    plans = {}
    for name, (sched_name, sync_mode, streamed) in VARIANTS.items():
        sched = schedules[sched_name]
        assignment, rebalance = plan_device_assignment(sched, n_devices)
        plan = grad_sync_plan(shapes, cfg, sched, sync_mode,
                              n_shards=n_devices,
                              elide_gather=opt.elidable)
        plans[name] = plan
        shard, gates, bounds = data_step_inputs(
            data, sched, assignment, n_mb, n_devices, mesh.rank, dev,
            use_kernel)
        _restore(model, base)
        state = opt.init(dict(model.named_parameters())) \
            if sync_mode == "masked" else \
            lay_out_plan(model, opt, None, None, plan, sync_mode, mesh,
                         shapes)
        recorder = ResidencyRecorder() if streamed else None
        pconf = ParallelConfig(mesh=MeshSpec(data=n_devices),
                               sync_mode=sync_mode, streamed=streamed,
                               opt_chunk=opt_chunk if streamed else None,
                               use_kernel=use_kernel)
        step = make_distributed_train_step(cfg, opt, mesh, plan,
                                           parallel=pconf,
                                           live_bounds=bounds,
                                           residency_recorder=recorder)
        mesh.counter.records.clear()
        _, state, metrics = step(model, state, shard, gates)
        _sync(dev)
        var = {
            "schedule": sched_name,
            "sync_mode": sync_mode,
            "streamed": streamed,
            "op_counts": op_counts(sched),
            "cost_model": {"compute": round(compute_cost(sched.table), 4),
                           "comm": round(comm_cost(sched.table), 4)},
            **_step_record(list(mesh.counter.records), n_devices),
            "sync_plan": sync_byte_report(plan, shapes, n_shards=n_devices),
            "rebalance": rebalance,
            "loss": float(metrics["loss"]),
        }
        var["all_reduce_bytes"] = float(
            var["sync_collectives"].get("all-reduce", 0.0))
        var["wire_bytes"] = float(sum(var["sync_collectives"].values()))
        if sync_mode in ("zero", "zero3"):
            var["opt_memory"] = zero_state_byte_report(
                plan, shapes, n_devices, n_moments=opt.n_moments)
        if sync_mode == "zero3":
            var["param_memory"] = zero3_param_byte_report(plan, shapes,
                                                          n_devices)
        if streamed:
            # the recorder holds the gathers the step ran: fail here, at
            # the measurement, if they disagree with the model
            var["residency_check"] = check_zero3_residency(
                recorder, plan, shapes, n_devices)
            var["opt_chunk"] = opt_chunk
        if bounds is not None:
            var["live_bounds"] = [int(b) for b in bounds]
        if time_steps > 0:
            var["wall_us_per_step"] = _timed_steps(
                step, (model, state, shard, gates), time_steps, dev)
        record["variants"][name] = var
        del step, state, metrics

    v = record["variants"]
    base_ar = v["all_pf_baseline"]["all_reduce_bytes"]
    base_wire = v["all_pf_baseline"]["wire_bytes"]
    record["all_reduce_fraction"] = \
        v["paper_mix"]["all_reduce_bytes"] / base_ar if base_ar else 1.0
    record["sync_model_fraction"] = \
        v["paper_mix"]["sync_plan"]["fraction"]

    def wire_frac(name):
        return v[name]["wire_bytes"] / base_wire if base_wire else 1.0

    record["zero_sync"] = {
        "paper_mix_wire_fraction": wire_frac("paper_mix_zero"),
        "paper_mix_masked_wire_fraction": wire_frac("paper_mix"),
        "uniform_wire_fraction": wire_frac("uniform_half_zero"),
        "uniform_masked_wire_fraction": wire_frac("uniform_half"),
        "uniform_masked_n_skipped":
            v["uniform_half"]["sync_plan"]["n_skipped"],
        "opt_memory_fraction":
            v["paper_mix_zero"]["opt_memory"]["fraction"],
    }
    z3 = v["paper_mix_zero3"]
    record["zero3"] = {
        # the zero3 wire includes the forward param all-gather the
        # replicated modes never pay: it buys the sharded residency
        "paper_mix_wire_fraction": wire_frac("paper_mix_zero3"),
        "uniform_wire_fraction": wire_frac("uniform_half_zero3"),
        "residency_fraction": z3["param_memory"]["fraction"],
        "peak_unit": z3["param_memory"]["peak_unit"],
        "n_gather_elided": z3["param_memory"]["n_gather_elided"],
        "elided_bytes": z3["param_memory"]["elided_bytes"],
        # calls, not HLO instructions: one all-gather a dtype a step
        "n_all_gather_ops": z3["collectives_n"].get("all-gather", 0),
        "opt_memory_fraction": z3["opt_memory"]["fraction"],
    }
    z3s = v["paper_mix_zero3_streamed"]
    res = z3s["residency_check"]
    ov = zero3_overlap_report(plans["paper_mix_zero3_streamed"], shapes,
                              n_devices)
    replicated = z3s["param_memory"]["replicated_bytes"]
    record["overlap"] = {
        "exposed_collective_fraction": ov["exposed_fraction"],
        "n_units": ov["n_units"],
        "compute_ratio": ov["compute_ratio"],
        # measured streamed peak residency (the gathers the step ran)
        "streamed_residency_fraction":
            res["measured_per_device_peak_bytes"] / replicated
            if replicated else 1.0,
        "peak_agreement": res["peak_agreement"],
        "n_units_measured": res["n_units_measured"],
        "double_buffer_fraction": ov["double_buffer_fraction"],
        # re-scheduling collectives against compute must not change what
        # crosses the wire
        "wire_ratio_vs_unstreamed":
            z3s["wire_bytes"] / z3["wire_bytes"]
            if z3["wire_bytes"] else 1.0,
    }
    record["pipeline"] = _measure_pipeline_variant(
        cfg, opt, model, base, shapes, data, schedules["paper_mix"],
        n_devices, time_steps=time_steps, device=device)
    del model, base
    mesh.close()
    return record


def _measure_pipeline_variant(cfg, opt, model, base, shapes, data, sched,
                              n_devices: int, *, n_stages: int = 2,
                              n_microbatches: int = 4, time_steps: int = 0,
                              device=None) -> dict:
    """The GPipe pipeline step on a (data = n / n_stages, stage =
    n_stages) carve of the same world (``make_mesh``: every rank calls
    it), one step from ``base``: the live-cost stage packing's makespan
    against layer-count packing (``makespan_ratio``), the analytic bubbles
    and the recorder's round report, and the step's collectives."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.loop import (data_step_inputs,
                                        make_distributed_train_step)

    pipe_data = n_devices // n_stages
    spec = MeshSpec(data=pipe_data, stage=n_stages)
    mesh = make_mesh(spec, device)
    dev = mesh.device
    stage_assign, stage_rep = plan_stage_assignment(sched, n_stages)
    pconf = ParallelConfig(mesh=spec, microbatches=n_microbatches)
    recorder = PipelineRecorder()
    plan = grad_sync_plan(shapes, cfg, sched)
    assignment, rebalance = plan_device_assignment(sched, pipe_data)
    shard, gates, _ = data_step_inputs(
        data, sched, assignment, sched.n_microbatches, pipe_data,
        mesh.data.rank, dev, False)
    _restore(model, base)
    state = opt.init(dict(model.named_parameters()))
    step = make_distributed_train_step(cfg, opt, mesh, plan,
                                       parallel=pconf,
                                       stage_assignment=stage_assign,
                                       pipeline_recorder=recorder)
    mesh.counter.records.clear()
    step(model, state, shard, gates)
    _sync(dev)
    records = list(mesh.counter.records)
    # layer-count packing's loads (what naive uniform splitting would run)
    costs = layer_live_costs(sched)
    ub = stage_rep["layer_count_boundaries"]
    uniform_loads = [float(sum(costs[lo:hi]))
                     for lo, hi in zip(ub, ub[1:])]
    var = {
        "mesh": {"data": pipe_data, "stage": n_stages},
        "n_microbatches": n_microbatches,
        "rebalance": rebalance,
        "boundaries": stage_rep["boundaries"],
        "loads": stage_rep["loads"],
        "makespan": stage_rep["makespan"],
        "layer_count_boundaries": list(ub),
        "layer_count_makespan": stage_rep["layer_count_makespan"],
        "makespan_ratio": stage_rep["makespan_ratio"],
        "bubble_fraction": analytic_bubble_fraction(
            stage_assign.loads, n_microbatches),
        "layer_count_bubble_fraction": analytic_bubble_fraction(
            uniform_loads, n_microbatches),
        "trace": recorder.report(),
        **_step_record(records, n_devices),
    }
    if time_steps > 0:
        var["wall_us_per_step"] = _timed_steps(
            step, (model, state, shard, gates), time_steps, dev)
    return var


def _maxdiff(a, b) -> float:
    """Largest |a - b| over the tensors of two like-structured trees (the
    optimizer state's ``step`` counts compared as numbers)."""
    if isinstance(a, dict):
        return max((_maxdiff(a[k], b[k]) for k in a), default=0.0)
    if torch.is_tensor(a):
        return float((a.detach().double() - b.detach().double()).abs()
                     .max()) if a.numel() else 0.0
    return float(abs(a - b))


def measure_elastic(n_devices: int = 8, *, seed: int = 0,
                    device=None) -> dict:
    """The four elastic fault scenarios of JAX's ``measure_elastic`` on a
    data mesh of ``n_devices`` ranks (this process one of them; four or
    more, as JAX needs four devices: rank 3 is the straggler), at JAX's
    config and with JAX's fault plans as written. ``FaultPlan`` reads
    ``dropout`` as (step, device) and a grad fault as (step, device,
    scale) (JAX's comments read them the other way round; its
    ``BENCH_elastic.json`` shows the plans' own reading):

    * ``straggler`` — rank 3 runs 2x slow, re-planned every 2 steps: the
      last capacity-mitigated refresh's mitigation ratio;
    * ``dropout`` — device 5 lost at step 3, checkpoints every 2 (the
      world shrinks to ``feasible_survivor_count`` ranks, the first ones
      but device 5, whether or not the world has a rank 5): the steps the
      survivors replay from the last checkpoint, and the largest
      parameter and optimizer-state difference from a fresh resume of
      that checkpoint on the survivors' own group (``sub_mesh``, made by
      every rank);
    * ``nan_guard`` — a NaN burst on rank 1 at step 2 and an inf one on
      rank 6 at step 3 (none in a world of fewer than seven): the guard's
      skips and the final-loss gap from the fault-free run over the clean
      run's loss drop;
    * ``lofi`` — the syncs of steps 1 and 2 dropped: the lo-fi fallback's
      step, the merges, the final mode and the loss drop.

    Checkpoints go to a temporary directory rank 0 makes and broadcasts,
    one subdirectory a run, removed at the end. Returns this rank's record
    (a rank the dropout takes out of the survivors records no
    differences); rank 0's is the measurement."""
    import shutil
    import tempfile

    from repro_torch.launch.faults import FaultPlan
    from repro_torch.launch.mesh import make_data_mesh, sub_mesh
    from repro_torch.optim.optimizers import sgd
    from repro_torch.train.elastic import (ElasticConfig, _broadcast_text,
                                           feasible_survivor_count,
                                           finetune_elastic)

    if n_devices < 4:
        raise ValueError(f"measure_elastic needs 4 or more ranks (rank 3 "
                         f"is the straggler and the dropout): {n_devices}")
    cfg = ModelConfig(name="elastic", arch_type="dense", n_layers=4,
                      d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
                      vocab_size=256)
    d2 = D2FTConfig(n_microbatches=16, n_pf=6, n_po=4, head_groups=4)
    B, S = 32, 16
    mesh = make_data_mesh(n_devices, device)
    dev = mesh.device
    root = _broadcast_text(mesh, tempfile.mkdtemp(prefix="measure_elastic_")
                           if mesh.rank == 0 else "")

    def batches(n):
        return list(lm_batches(seed, cfg.vocab_size, batch=B, seq=S,
                               steps=n))

    def run(name, opt, n, run_mesh=mesh, faults=None, resume_from=None,
            **el):
        # the same parameters every run: one seeded init on one device
        model = init_model(torch.Generator(device=dev).manual_seed(seed),
                           cfg)
        _, state, log = finetune_elastic(
            model, cfg, d2, opt, batches(n), steps=n, mesh=run_mesh,
            faults=faults, resume_from=resume_from,
            elastic=ElasticConfig(ckpt_dir=os.path.join(root, name), **el))
        return model, state, log

    record = {
        "n_devices": n_devices, "seed": seed,
        "model": {"name": cfg.name, "n_layers": cfg.n_layers,
                  "d_model": cfg.d_model, "n_heads": cfg.n_heads,
                  "d_ff": cfg.d_ff, "vocab": cfg.vocab_size},
        "shape": {"batch": B, "seq": S,
                  "n_microbatches": d2.n_microbatches},
        "backend": _backend(dev),
        "rank": mesh.rank,
    }
    ok = False
    try:
        # -- straggler: rank 3 runs 2x slow, refresh every 2 steps -------
        t0 = time.perf_counter()
        _, _, log_s = run("straggler", sgd(0.1), 5,
                          faults=FaultPlan(slowdowns=((3, 2.0),)),
                          refresh_every=2, ckpt_every=0)
        refreshes = log_s.extras["refreshes"]
        mitigated = [r for r in refreshes
                     if r["elastic"].get("capacities") is not None]
        m = mitigated[-1]["elastic"]
        record["straggler"] = {
            "n_refreshes": len(refreshes),
            "n_capacity_refreshes": len(mitigated),
            "straggler_unit_time": m["unit_times"][3],
            "unit_times": m["unit_times"],
            "makespan": m["makespan"],
            "unmitigated_makespan": m["unmitigated_makespan"],
            "mitigation_ratio": m["mitigation_ratio"],
            "load_spread": mitigated[-1]["rebalance"]["spread"],
            "wall_s": round(time.perf_counter() - t0, 2),
        }

        # -- dropout: lose device 5 at step 3, recover onto the survivors -
        t0 = time.perf_counter()
        opt = adamw(1e-3)
        plan = FaultPlan(dropout=(3, 5))
        model_a, s_a, log_a = run("dropout", opt, 6, faults=plan,
                                  refresh_every=4, ckpt_every=2)
        gone = plan.dropout[1]
        n_after = feasible_survivor_count(n_devices, d2.n_microbatches)
        survivors = sub_mesh(mesh, [r for r in range(n_devices)
                                    if r != gone][:n_after])
        rec = [e for e in log_a.extras["elastic"]["events"]
               if e["type"] in ("dropout_recovery", "dropped")][0]
        out = {"recovery_steps": rec.get("recovery_steps"),
               "ckpt_step": rec.get("ckpt_step"),
               "n_devices_after": rec["n_devices"]}
        if survivors is not None:
            model_b, s_b, _ = run("resume", opt, 6, run_mesh=survivors,
                                  resume_from=rec["ckpt"], refresh_every=4,
                                  ckpt_every=2)
            out["resume_parity_diff"] = _maxdiff(
                dict(model_a.named_parameters()),
                dict(model_b.named_parameters()))
            out["resume_opt_diff"] = _maxdiff(s_a, s_b)
            del model_b, s_b
        out["wall_s"] = round(time.perf_counter() - t0, 2)
        record["dropout"] = out
        del model_a, s_a

        # -- NaN burst: device 1 at step 2, inf on device 6 at step 3 ----
        t0 = time.perf_counter()
        fp = FaultPlan(grad_faults=((2, 1, float("nan")),
                                    (3, 6, float("inf"))))
        _, _, log_f = run("nan", sgd(0.1), 8, faults=fp, refresh_every=0,
                          ckpt_every=0)
        _, _, log_c = run("clean", sgd(0.1), 8, refresh_every=0,
                          ckpt_every=0)
        gap = abs(log_f.losses[-1] - log_c.losses[-1])
        drop = log_c.losses[0] - log_c.losses[-1]
        record["nan_guard"] = {
            "steps_skipped": log_f.extras["elastic"]["guard_skips"],
            "skip_steps": [e["step"]
                           for e in log_f.extras["elastic"]["events"]
                           if e["type"] == "guard_skip"],
            "final_loss_faulted": round(log_f.losses[-1], 6),
            "final_loss_clean": round(log_c.losses[-1], 6),
            "loss_gap": round(gap, 6),
            "clean_loss_drop": round(drop, 6),
            "gap_fraction": round(gap / drop, 6) if drop > 0 else 0.0,
            "wall_s": round(time.perf_counter() - t0, 2),
        }

        # -- dropped syncs: 2 lost rounds engage the lo-fi fallback ------
        t0 = time.perf_counter()
        _, _, log_l = run("lofi", sgd(0.1), 8,
                          faults=FaultPlan(dropped_syncs=(1, 2)),
                          refresh_every=0, ckpt_every=0, merge_every=2,
                          sync_fault_threshold=2)
        ev = log_l.extras["elastic"]
        fb = [e for e in ev["events"] if e["type"] == "lofi_fallback"]
        # in the local mode a rank logs its own replica's loss: the mean
        # over the replicas is the loss JAX's vmapped step reports
        last = mesh.all_reduce_(torch.tensor(
            [log_l.losses[-1]], dtype=torch.float64, device=dev))
        last = float(last[0]) / n_devices
        record["lofi"] = {
            "fallback_step": fb[0]["step"],
            "n_fallbacks": len(fb),
            "sync_drops": ev["sync_faults"],
            "n_merges": ev["merges"],
            "final_mode_local": 1 if ev["final_mode"] == "local" else 0,
            "loss_drop": round(log_l.losses[0] - last, 6),
            "wall_s": round(time.perf_counter() - t0, 2),
        }
        ok = True
    finally:
        if ok:
            # no rank still reads a checkpoint when rank 0 removes them
            mesh.all_reduce_(torch.zeros(1, device=dev), kind="barrier")
        if mesh.rank == 0:
            shutil.rmtree(root, ignore_errors=True)
        mesh.close()
    return record
