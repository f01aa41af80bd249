"""Elastic fault-tolerant D2FT fine-tuning (port of
``repro/train/elastic.py``).

``finetune_elastic`` wraps the distributed D2FT step of ``train/loop.py``
with the four responses a commodity fleet needs, driven by a
deterministic ``launch.faults.FaultPlan``. One process per rank, as
``finetune_distributed``: every rank calls it with the same arguments and
the same batches, and every rank keeps the same records.

* **straggler-aware replanning** — an EMA of each rank's step time per
  unit of assigned schedule cost. Its input is the plan's
  ``unit_times``, as in the JAX loop (a rank's own clock is not fed in);
  when the spread exceeds ``straggler_tol`` the refresh's device
  assignment runs with ``core.assignment.speed_capacities`` budgets.
  Every refresh logs its rebalance report with the predicted makespan
  with and without mitigation.
* **device-dropout recovery** — at the plan's dropout every rank computes
  ``feasible_survivor_count``; the survivors are the first that many
  ranks other than the dropped one. Every rank of the world creates the
  survivors' group (``launch.mesh.sub_mesh``: ``dist.new_group`` is
  collective over the world). The survivors restore the last step-level
  checkpoint (always saved in canonical element order, in the JAX
  package's file layout), re-plan, and run their collectives in the new
  group only. The dropped rank does no further step, collective or kernel
  launch: it leaves the loop and returns its model as it stood, with no
  optimizer state. (The JAX loop's simulated mesh keeps the first n
  devices, which may include the one that "died"; the shards depend only
  on the survivor count, so the values are the same.)
* **non-finite-grad guard** — every step runs with the pre-sync guard
  armed (``ParallelConfig(guard=True)``): a NaN / inf burst (or a
  grad-norm spike past ``guard_factor`` x the norm EMA) on one rank zeroes
  that rank's grads before any collective and skips the update on every
  rank.
* **degraded-sync fallback** — each dropped sync round discards that
  step's update; once ``sync_fault_threshold`` rounds have been lost the
  loop switches to ``sync_mode="local"`` (each rank one replica, no
  gradient sync) and merges the replicas every ``merge_every`` steps under
  the union of the backward-live masks since they were last in sync
  (``sharding.sync.lofi_merge_``, counted under ``merge``).

Checkpoints: one file a save, written by rank 0 of the current mesh to a
directory every rank sees (``ElasticConfig.ckpt_dir``; by default a fresh
temporary directory rank 0 makes and broadcasts). ZeRO-1 moments and
ZeRO-3 parameters are gathered to canonical order first (counted under
``reshard``), local-mode replicas stacked ([ranks, ...], as the JAX
loop's state is; counted under ``ckpt``). Everything the loop decides is
recorded in ``log.extras["elastic"]`` (events, checkpoints, final mode)
and per refresh in ``log.extras["refreshes"]``; each checkpoint record
also holds the save's host-clock seconds (the gather, the copies to the
host, the write) and the file's bytes, and ``restores`` each load's
seconds (the read and the copies to the device).
"""
from __future__ import annotations

import os
import tempfile
import time
from dataclasses import dataclass
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from repro_torch import interop
from repro_torch.configs.base import D2FTConfig, ModelConfig
from repro_torch.core.assignment import (microbatch_costs,
                                         plan_device_assignment,
                                         speed_capacities, weighted_makespan)
from repro_torch.core.schedule import P_F, P_S, Schedule
from repro_torch.launch.faults import NO_FAULTS, FaultPlan
from repro_torch.launch.mesh import DataMesh, axes, sub_mesh
from repro_torch.launch.parallel import MeshSpec, ParallelConfig
from repro_torch.models.transformer import Transformer
from repro_torch.optim.optimizers import Optimizer
from repro_torch.sharding import sync
from repro_torch.train.checkpoints import load_train_state, save_train_state
from repro_torch.train.loop import (TrainLog, data_plan_record,
                                    data_step_inputs, data_sync_plan,
                                    lay_out_plan, logged_step,
                                    make_distributed_train_step,
                                    planned_schedule, relayout_moments)


@dataclass
class ElasticConfig:
    """Policy knobs of the elastic loop (see module docstring)."""
    refresh_every: Optional[int] = None   # re-score the schedule every k
    ckpt_every: int = 1                   # step-level checkpoint cadence
    ckpt_dir: Optional[str] = None        # default: a fresh temp dir
    ema_alpha: float = 0.5                # step-time / grad-norm EMA weight
    capacity_slack: float = 1.1           # speed_capacities feasibility slack
    straggler_tol: float = 0.15           # engage capacities past this spread
    guard_factor: Optional[float] = 10.0  # norm-anomaly thresh = f * EMA
    sync_fault_threshold: int = 2         # dropped syncs before lo-fi
    merge_every: int = 4                  # lo-fi merge cadence (steps)


def feasible_survivor_count(n_devices: int, n_microbatches: int) -> int:
    """Largest fleet size < n_devices that still divides the micro-batch
    count (equal shards: 8 -> 4 for 8 micro-batches, not 7)."""
    for n in range(n_devices - 1, 0, -1):
        if n_microbatches % n == 0:
            return n
    return 1


def _mask_schedule(mask: np.ndarray) -> Schedule:
    """[L, G] bool liveness -> a one-micro-batch Schedule whose
    backward-live set is exactly the mask (feeds ``grad_sync_plan`` to
    build the lo-fi merge plan)."""
    table = np.where(np.asarray(mask, bool).reshape(-1, 1), P_F,
                     P_S).astype(np.int8)
    return Schedule(table, mask.shape[0], mask.shape[1])


def _broadcast_text(mesh: DataMesh, text: str, size: int = 4096) -> str:
    """Rank 0's ``text`` on every rank of ``mesh``."""
    buf = torch.zeros(size, dtype=torch.uint8, device=mesh.device)
    raw = text.encode()
    if len(raw) >= size:
        raise ValueError(f"path of {len(raw)} bytes: at most {size - 1}")
    if mesh.rank == 0:
        buf[:len(raw)] = torch.tensor(list(raw), dtype=torch.uint8)
    mesh.broadcast_(buf)
    return bytes(buf.cpu().numpy().tobytes()).rstrip(b"\0").decode()


@torch.no_grad()
def _gather_replicas(tensors: Dict[str, torch.Tensor], mesh: DataMesh
                     ) -> Dict[str, torch.Tensor]:
    """Every rank's copy of ``tensors`` stacked in rank order ([ranks,
    ...]), on every rank: one ``all_gather_`` a dtype, counted under
    ``ckpt``."""
    by_dtype: Dict[torch.dtype, list] = {}
    for n, t in tensors.items():
        by_dtype.setdefault(t.dtype, []).append(n)
    out = {}
    for dtype, names in by_dtype.items():
        flat = torch.cat([tensors[n].reshape(-1) for n in names])
        full = torch.empty(mesh.size * flat.numel(), dtype=dtype,
                           device=flat.device)
        mesh.counted("ckpt", full.numel() * full.element_size(),
                     lambda: mesh.all_gather_(full, flat))
        full = full.view(mesh.size, -1)
        off = 0
        for n in names:
            k = tensors[n].numel()
            out[n] = full[:, off:off + k].reshape(
                (mesh.size,) + tuple(tensors[n].shape))
            off += k
    return out


def _stack_trees(trees):
    """Leafwise ``np.stack`` of same-structured trees (the replica
    stack)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return [_stack_trees([t[i] for t in trees])
                for i in range(len(first))]
    return np.stack([np.asarray(t) for t in trees])


def _replica(tree, r: int):
    """Replica ``r`` of a stacked tree."""
    if isinstance(tree, dict):
        return {k: _replica(v, r) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_replica(v, r) for v in tree]
    return np.asarray(tree)[r]


def finetune_elastic(model: Transformer, cfg: ModelConfig, d2: D2FTConfig,
                     opt: Optimizer, batches: Iterable, *, steps: int,
                     mesh, sync_mode: str = "masked",
                     faults: Optional[FaultPlan] = None,
                     elastic: Optional[ElasticConfig] = None,
                     use_kernel: bool = False, clip: float = 1.0,
                     rng=None, resume_from: Optional[str] = None,
                     log: Optional[TrainLog] = None) -> tuple:
    """Elastic distributed D2FT fine-tuning on one rank of ``mesh`` (a data
    mesh: ``launch.mesh.DataMesh``, or a ``launch.mesh.Mesh`` whose stage
    and tensor axes are 1); see the module docstring.

    ``batches`` must be a deterministic stream of numpy {"tokens",
    "labels"} batches (buffered, so a recovery replays from the checkpoint
    step). ``resume_from`` restores a ``save_train_state`` checkpoint (this
    port's or the JAX package's) on the original mesh size or a shrunk one.
    Runs on ``mesh.device``, where the model must be. Returns (model,
    opt_state, log), the model updated in place, its parameters and the
    moments in canonical order whatever the mode; in the local mode the
    replicas are merged one last time and the moments are this rank's
    (the JAX loop returns replica 0's). A rank the plan drops returns
    (model, None, log) with ``log.extras["elastic"]["dropped"]`` True."""
    fp = faults or NO_FAULTS
    el = elastic or ElasticConfig()
    log = log or TrainLog()
    if sync_mode not in ("masked", "zero", "zero3", "local"):
        raise ValueError(f"unknown sync_mode {sync_mode!r}")
    shape = dict(mesh.shape)
    if shape.get("stage", 1) > 1 or shape.get("tensor", 1) > 1:
        raise ValueError("the elastic loop runs on a pure data mesh "
                         f"(mesh {shape})")
    run_mesh = axes(mesh)[1]
    dev = run_mesh.device
    ndev = run_mesh.size
    named = dict(model.named_parameters())
    # the canonical shapes the plans and reports are made from (a ZeRO-3
    # model's parameters hold shards between steps)
    shapes = {n: torch.empty(p.shape, dtype=p.dtype, device="meta")
              for n, p in named.items()}
    mode = sync_mode
    if resume_from is None:
        for p in named.values():
            run_mesh.broadcast_(p.detach())
    opt_state = opt.init(named)
    ckpt_dir = el.ckpt_dir
    if ckpt_dir is None:
        made = tempfile.mkdtemp(prefix="elastic_ckpt_") \
            if run_mesh.rank == 0 else ""
        ckpt_dir = _broadcast_text(run_mesh, made) if ndev > 1 else made
    speeds = np.ones(ndev)                # EMA of per-unit step time
    ema_gnorm: Optional[float] = None
    sync_faults = 0
    guard_skips = 0
    merges = 0
    next_refresh = el.refresh_every or 0
    sched = assignment = sync_plan = step_fn = None
    zero3_plan = None                     # the plan the model is sharded by
    ever_live = None                      # zero-mode gather staleness mask
    live_since_merge = None               # local-mode divergence mask
    steps_since_merge = 0
    dropped = False
    events: list = []
    elastic_log = {"events": events, "ckpts": [], "restores": []}
    log.extras["elastic"] = elastic_log

    batch_buf: list = []
    batch_iter = iter(batches)

    def get_batch(idx: int):
        while len(batch_buf) <= idx:
            batch_buf.append(next(batch_iter))
        return batch_buf[idx]

    def to_canonical():
        """The model's parameters and the moments to canonical order in
        place, whatever the mode (collectives in the ZeRO modes)."""
        nonlocal zero3_plan, sync_plan, opt_state
        if zero3_plan is not None:
            sync.zero3_unshard_model_(model, zero3_plan, run_mesh)
            zero3_plan = None
        if mode in ("zero", "zero3") and sync_plan is not None:
            opt_state = relayout_moments(opt_state, sync_plan, None,
                                         run_mesh, shapes)
            sync_plan = None

    def canonical_state():
        """(params, opt_state) as the JAX package's trees in canonical
        order, on rank 0 of the mesh (None elsewhere): the ZeRO layouts
        gathered, the local replicas stacked (collectives on every
        rank)."""
        params = {n: p.detach() for n, p in named.items()}
        state = opt_state
        if zero3_plan is not None:
            params = sync._zero_unshard(params, zero3_plan, run_mesh)
        if mode in ("zero", "zero3") and sync_plan is not None:
            state = relayout_moments(state, sync_plan, None, run_mesh,
                                     shapes)
        if mode == "local":
            moments = {k: v for k, v in state.items() if k != "step"}
            params = _gather_replicas(params, run_mesh)
            moments = {k: _gather_replicas(v, run_mesh)
                       for k, v in moments.items()}
            steps_of = torch.tensor([float(state["step"])], device=dev)
            steps_of = _gather_replicas({"s": steps_of}, run_mesh)["s"]
            if run_mesh.rank != 0:
                return None, None
            R = run_mesh.size
            p_tree = _stack_trees([interop.params_to_jax(
                {n: t[r] for n, t in params.items()}, cfg) for r in range(R)])
            s_tree = {k: _stack_trees([interop.params_to_jax(
                {n: t[r] for n, t in v.items()}, cfg) for r in range(R)])
                for k, v in moments.items()}
            s_tree["step"] = steps_of.reshape(-1).cpu().numpy().astype(
                np.int32)
            return p_tree, s_tree
        if run_mesh.rank != 0:
            return None, None
        return (interop.params_to_jax(params, cfg),
                interop.opt_state_to_jax(state, cfg))

    def save_ckpt(step: int) -> str:
        t0 = time.perf_counter()
        p, s = canonical_state()
        path = os.path.join(ckpt_dir, f"ckpt_{step}.npz")
        if run_mesh.rank == 0:
            extra = {
                "speeds": speeds,
                "ema_gnorm": np.nan if ema_gnorm is None else ema_gnorm,
                "sync_faults": sync_faults, "guard_skips": guard_skips,
                "merges": merges, "next_refresh": next_refresh,
                "local": 1 if mode == "local" else 0, "n_devices": ndev,
            }
            if ever_live is not None:
                extra["ever_live"] = ever_live
            if mode == "local" and live_since_merge is not None:
                extra["live_since_merge"] = live_since_merge
            tmp = os.path.join(ckpt_dir, f".ckpt_{step}.tmp.npz")
            save_train_state(tmp, step=step, params=p, opt_state=s,
                             sched=sched, assignment=assignment, rng=rng,
                             extra=extra)
            os.replace(tmp, path)
        del p, s
        # no rank reads the file before its writer is done
        run_mesh.all_reduce_(torch.zeros(1, device=dev), kind="barrier")
        elastic_log["ckpts"].append({
            "step": step, "path": path,
            "seconds": time.perf_counter() - t0,
            "bytes": os.path.getsize(path) if run_mesh.rank == 0 else None})
        return path

    def install(p_tree, s_tree):
        """Host trees in the JAX layout -> the model's parameters and the
        optimizer state on this rank's device."""
        nonlocal opt_state

        def on_device(tree):           # each leaf straight to the device
            return {n: torch.as_tensor(a, device=dev) for n, a in
                    interop._arrays_from_jax(tree).items()}

        with torch.no_grad():
            for n, t in on_device(p_tree).items():
                named[n].data = t
        opt_state = {k: int(np.asarray(v)) if k == "step" else on_device(v)
                     for k, v in s_tree.items()}

    def restore(path: str) -> int:
        """Load a checkpoint into the loop state for the CURRENT mesh (the
        assignment, plan and layouts are rebuilt; the schedule is
        kept)."""
        nonlocal sched, sync_plan, step_fn, speeds, ema_gnorm, sync_faults, \
            guard_skips, merges, next_refresh, mode, ever_live, \
            live_since_merge, steps_since_merge, assignment, zero3_plan
        t0 = time.perf_counter()
        ck = load_train_state(path)
        p_tree, s_tree = ck["params"], ck["opt_state"]
        sched = ck.get("schedule")
        extra = ck.get("extra", {})
        was_local = bool(int(extra.get("local", 0)))
        ck_ndev = int(extra.get("n_devices", ndev))
        spd = np.asarray(extra.get("speeds", np.ones(ndev)), np.float64)
        speeds = spd if len(spd) == ndev else np.ones(ndev)
        eg = float(extra.get("ema_gnorm", np.nan))
        ema_gnorm = None if np.isnan(eg) else eg
        sync_faults = int(extra.get("sync_faults", 0))
        guard_skips = int(extra.get("guard_skips", 0))
        merges = int(extra.get("merges", 0))
        next_refresh = int(extra.get("next_refresh", next_refresh))
        ev = extra.get("ever_live")
        ever_live = np.asarray(ev, bool) if ev is not None else None
        mode = sync_mode if sync_mode != "local" else "masked"
        if was_local and ck_ndev == ndev:
            mode = "local"
            lsm = extra.get("live_since_merge")
            live_since_merge = np.asarray(lsm, bool) if lsm is not None \
                else None
            p_tree = _replica(p_tree, run_mesh.rank)
            s_tree = _replica(s_tree, run_mesh.rank)
        elif was_local:
            # stacked state cannot survive a fleet resize: merge the
            # replica stack and fall back to the pre-degradation mode
            lsm = extra.get("live_since_merge")
            mask = np.asarray(lsm, bool) if lsm is not None else \
                np.ones((cfg.n_layers, sched.n_groups), bool)
            reps = [interop.params_from_jax(_replica(p_tree, r))
                    for r in range(ck_ndev)]
            stacked = {n: torch.stack([rep[n] for rep in reps])
                       for n in reps[0]}
            plan = sync.grad_sync_plan(shapes, cfg, _mask_schedule(mask))
            merged = sync.lofi_merge(stacked, plan)
            p_tree = interop.params_to_jax(merged, cfg)
            s_tree = _replica(s_tree, 0)
        install(p_tree, s_tree)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        elastic_log["restores"].append({
            "step": int(ck["step"]), "path": path,
            "seconds": time.perf_counter() - t0})
        zero3_plan = None
        steps_since_merge = 0
        sync_plan = None
        assignment = None
        step_fn = None
        return int(ck["step"])

    def rescore(batch) -> Schedule:
        """Fresh scoring pass on rank 0's canonical (ZeRO-3: gathered)
        parameters -> the new schedule on every rank."""
        nonlocal zero3_plan
        if zero3_plan is not None:
            sync.zero3_unshard_model_(model, zero3_plan, run_mesh)
            zero3_plan = None
        return planned_schedule(model, cfg, d2, batch, run_mesh)

    def rebuild(step: int):
        """Schedule + current speeds -> assignment (capacity-mitigated
        when a straggler shows), sync plan, refresh record; re-lays the
        ZeRO state out for the new plan (the model is whole here)."""
        nonlocal assignment, sync_plan, ever_live, live_since_merge, \
            zero3_plan, opt_state
        costs = microbatch_costs(sched)
        caps = None
        if speeds.max() / speeds.min() > 1.0 + el.straggler_tol:
            caps = speed_capacities(costs, speeds, el.capacity_slack)
        old_plan = sync_plan
        assignment, report = plan_device_assignment(sched, ndev, caps)
        mitigation = {
            "unit_times": [round(float(u), 4) for u in speeds],
            "capacities": [round(float(c), 4) for c in caps]
            if caps is not None else None,
            "makespan": round(weighted_makespan(assignment, speeds), 6),
        }
        if caps is not None:
            base, _ = plan_device_assignment(sched, ndev, None)
            unmit = weighted_makespan(base, speeds)
            mitigation["unmitigated_makespan"] = round(unmit, 6)
            mitigation["mitigation_ratio"] = round(
                mitigation["makespan"] / unmit, 6) if unmit > 0 else 1.0
        record = {"step": step, "rebalance": report, "elastic": mitigation,
                  "n_devices": ndev, "sync_mode": mode}
        if mode == "local":                         # the merge mask only
            sync_plan = None
            live = sync.backward_live_groups(sched)
            live_since_merge = live if live_since_merge is None \
                else live_since_merge | live
        else:
            sync_plan, ever_live = data_sync_plan(shapes, cfg, sched, mode,
                                                  ndev, opt, ever_live)
            opt_state = lay_out_plan(model, opt, opt_state, old_plan,
                                     sync_plan, mode, run_mesh, shapes)
            zero3_plan = sync_plan if mode == "zero3" else None
            record.update(data_plan_record(sync_plan, shapes, mode, ndev,
                                           opt))
            log.extras["sync"] = record["sync"]
        log.extras["rebalance"] = report
        log.extras.setdefault("refreshes", []).append(record)
        return record

    def switch_to_local(step: int):
        nonlocal mode, step_fn, live_since_merge, steps_since_merge
        to_canonical()
        mode = "local"
        live_since_merge = sync.backward_live_groups(sched) \
            if sched is not None else None
        steps_since_merge = 0
        step_fn = None
        events.append({"type": "lofi_fallback", "step": step,
                       "sync_faults": sync_faults,
                       "merge_every": el.merge_every})

    def do_merge(step: int):
        nonlocal live_since_merge, steps_since_merge, merges
        mask = live_since_merge if live_since_merge is not None \
            else np.ones((cfg.n_layers, sched.n_groups), bool)
        plan = sync.grad_sync_plan(shapes, cfg, _mask_schedule(mask))
        rep = sync.sync_byte_report(plan, shapes)
        sync.lofi_merge_({n: p.detach() for n, p in named.items()}, plan,
                         run_mesh, kind="merge")
        merges += 1
        steps_since_merge = 0
        live_since_merge = sync.backward_live_groups(sched)
        events.append({"type": "merge", "step": step,
                       "live_fraction": round(rep["fraction"], 6),
                       "merged_bytes": rep["synced_bytes"]})

    i = 0
    if resume_from is not None:
        i = restore(resume_from)
        events.append({"type": "resume", "step": i, "path": resume_from})
    last_ckpt = save_ckpt(i)

    while i < steps:
        # -- 1. device dropout: shrink to the survivors, restore, replay --
        gone = fp.dropout_at(i) if not dropped else None
        if gone is not None:
            dropped = True
            new_ndev = feasible_survivor_count(ndev, d2.n_microbatches)
            members = [r for r in range(ndev) if r != gone][:new_ndev] \
                if ndev > 1 else [0]
            old_i, ndev = i, new_ndev
            run_mesh = sub_mesh(run_mesh, members)
            if run_mesh is None:
                # this rank is the one the plan drops: no further step,
                # collective or kernel launch
                events.append({"type": "dropped", "step": old_i,
                               "device": gone, "n_devices": ndev})
                break
            i = restore(last_ckpt)
            events.append({
                "type": "dropout_recovery", "step": old_i, "device": gone,
                "ckpt_step": i, "recovery_steps": old_i - i,
                "n_devices": ndev, "ckpt": last_ckpt})
            continue

        # -- 2. plan: fresh scores on refresh, rebuild after recovery --
        if sched is None or (el.refresh_every and i >= next_refresh
                             and i > 0):
            sched = rescore(get_batch(i))
            if el.refresh_every:
                next_refresh = (i // el.refresh_every + 1) * el.refresh_every
            rebuild(i)
            step_fn = None
        elif step_fn is None and (assignment is None or sync_plan is None
                                  or mode == "local"):
            rebuild(i)

        # -- 3. dropped gradient-sync round: lose the step, count it ---
        if mode != "local" and fp.sync_dropped(i):
            sync_faults += 1
            events.append({"type": "sync_drop", "step": i,
                           "count": sync_faults})
            if el.sync_fault_threshold and \
                    sync_faults >= el.sync_fault_threshold:
                switch_to_local(i)
            if el.ckpt_every and (i + 1) % el.ckpt_every == 0:
                last_ckpt = save_ckpt(i + 1)
            i += 1
            continue

        # -- 4. run the guarded step --------------------------------
        shard, gates, bounds = data_step_inputs(
            get_batch(i), sched, assignment, d2.n_microbatches, ndev,
            run_mesh.rank, dev, use_kernel)
        if step_fn is None:
            step_fn = make_distributed_train_step(
                cfg, opt, run_mesh, sync_plan, clip=clip,
                live_bounds=bounds,
                parallel=ParallelConfig(mesh=MeshSpec(data=ndev),
                                        sync_mode=mode, guard=True,
                                        use_kernel=use_kernel))
        fault_vec = fp.grad_fault_vector(i, ndev)
        thresh = np.float32(np.inf)
        if el.guard_factor is not None and ema_gnorm is not None:
            thresh = np.float32(el.guard_factor * ema_gnorm)
        opt_state, metrics = logged_step(
            log, run_mesh.counter, dev,
            lambda: step_fn(model, opt_state, shard, gates, fault_vec,
                            thresh))

        if metrics.get("skipped", 0.0) > 0:
            guard_skips += 1
            events.append({
                "type": "guard_skip", "step": i,
                "bad_devices": metrics.get("bad_devices", 0.0),
                "bad_blocks": metrics.get("bad_blocks", 0.0)})
        elif np.isfinite(metrics["grad_norm"]):
            g = metrics["grad_norm"]
            ema_gnorm = g if ema_gnorm is None else \
                (1 - el.ema_alpha) * ema_gnorm + el.ema_alpha * g

        # -- 5. per-device timing -> speed EMA (the plan's unit times
        # are the measurement, as in the JAX loop) -------------------
        u_obs = fp.unit_times(i, ndev)
        speeds = (1 - el.ema_alpha) * speeds + el.ema_alpha * u_obs

        # -- 6. lo-fi merge cadence ----------------------------------
        if mode == "local":
            steps_since_merge += 1
            if steps_since_merge >= el.merge_every \
                    and not fp.sync_dropped(i):
                do_merge(i)

        if el.ckpt_every and (i + 1) % el.ckpt_every == 0:
            last_ckpt = save_ckpt(i + 1)
        i += 1

    # ---- hand back canonical state (not on a dropped rank) ---------
    if run_mesh is not None:
        if mode != "local":
            to_canonical()
        elif steps_since_merge > 0:
            do_merge(steps - 1)
    elastic_log.update({
        "final_mode": mode, "n_devices": ndev, "guard_skips": guard_skips,
        "sync_faults": sync_faults, "merges": merges,
        "last_ckpt": last_ckpt,
        "unit_times": [round(float(u), 4) for u in speeds],
        "dropped": run_mesh is None,
        "rank": None if run_mesh is None else run_mesh.rank})
    return model, opt_state if run_mesh is not None else None, log
