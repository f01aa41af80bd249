"""Training loops (port of ``repro/train/loop.py``).

``finetune`` drives the D2FT fine-tune of LLM backbones (what
``launch/train.py`` runs); ``finetune_vit`` is the paper's ViT experiment.
Both: optional D2FT schedule (scores -> knapsack -> gates), the masked or
the kernel path, a global-norm clip and the optimizer update, one step per
batch; ``finetune`` also runs the packed path (``core.d2ft.
packed_forward``). ``finetune_distributed`` is the paper's data-parallel
D2FT over a ``launch.mesh.DataMesh`` (one process per rank), with the
schedule-masked gradient sync; ``make_distributed_train_step`` also has
the lo-fi local mode. The sharding policy, the ZeRO modes, the stage and
tensor axes and the guard come with later slices.
"""
from __future__ import annotations

import time
import warnings
from dataclasses import dataclass, field
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from repro_torch.configs.base import D2FTConfig, ModelConfig
from repro_torch.core import d2ft as d2ft_mod
from repro_torch.core.schedule import (Schedule, gates_from_schedule,
                                       live_slice_bounds, packed_indices)
from repro_torch.core.scores import compute_scores, transformer_blocks
from repro_torch.data.synthetic import (microbatch_assignment,
                                        split_microbatches)
from repro_torch.kernels.ops import _validate_gates
from repro_torch.models.transformer import Transformer, fused_xent, lm_loss
from repro_torch.models.vit import ViT, ViTConfig, vit_forward, vit_loss
from repro_torch.optim.optimizers import Optimizer, clip_by_global_norm_


@dataclass
class TrainLog:
    losses: list = field(default_factory=list)
    metrics: list = field(default_factory=list)
    step_times: list = field(default_factory=list)
    # distributed path: rebalance report, sync-plan byte report, refreshes,
    # and the bytes and host-clock ms of each step's gradient sync
    extras: dict = field(default_factory=dict)

    def last(self, k: str):
        return self.metrics[-1][k] if self.metrics else None


def _grads(loss, params):
    """d loss / d params as a name -> tensor dict; zeros where unused."""
    leaves = list(params.values())
    gs = torch.autograd.grad(loss, leaves, allow_unused=True)
    return {n: torch.zeros_like(p) if g is None else g
            for (n, p), g in zip(params.items(), gs)}


# ------------------------------------------------------------------ LLM path
def make_train_step(cfg: ModelConfig, opt: Optimizer, *, use_gates: bool,
                    packed: bool = False, policy=None, remat: bool = False,
                    clip: float = 1.0, use_kernel: bool = False,
                    live_bounds=None):
    """Returns step(model, opt_state, batch, sched_args=None) -> (model,
    opt_state, metrics), updating the model's parameters in place.

    batch: {"tokens", "labels"} tensors on the model's device, with
    "features" for a frontend arch (an audio encoder's batch has no
    "tokens"); sched_args:
    the (g_f, g_b) gates [n_layers, B, G] when ``use_gates``, or with
    ``packed`` the plan (idx, bwd, val) [n_layers, G, C]
    (``core.schedule.packed_indices``) that ``core.d2ft.packed_forward``
    runs, whose loss is the mean token cross-entropy (no aux term, as the
    reference's). use_kernel routes the attention, SSD, RG-LRU and MoE
    blocks through the gated kernels, whose backward skips the p_o / p_s
    slices; the packed path runs no kernel and ignores it. live_bounds:
    the (live_fwd, live_bwd) (sample, group) compaction bounds
    (``core.schedule.live_slice_bounds``) of the gates this step gets.
    remat checkpoints each layer. The sharding policy is not ported
    yet."""
    if policy is not None:
        raise NotImplementedError(
            "the sharding policy is not ported yet: it comes with the "
            "distributed slice")

    def loss_of(model, batch, sched_args):
        if packed:
            logits, _ = d2ft_mod.packed_forward(model, cfg, batch["tokens"],
                                                sched_args, remat=remat)
            ce = fused_xent(logits, batch["labels"])
            return ce, {"ce": ce}
        gates = sched_args if use_gates else None
        return lm_loss(model, cfg, batch.get("tokens"), batch["labels"],
                       features=batch.get("features"), gates=gates,
                       remat=remat, use_kernel=use_kernel,
                       live_bounds=live_bounds if use_gates else None)

    def step(model: Transformer, opt_state, batch, sched_args=None):
        params = dict(model.named_parameters())
        loss, metrics = loss_of(model, batch, sched_args)
        grads, gnorm = clip_by_global_norm_(_grads(loss, params), clip)
        opt.update(grads, opt_state, params)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return model, opt_state, dict(metrics, loss=loss.detach(),
                                      grad_norm=gnorm)

    return step


def plan_from_scores(cfg: ModelConfig, d2: D2FTConfig, params,
                     score_batches, loss_fn) -> Schedule:
    """Scoring pass (paper: before fine-tuning) + bi-level knapsack.
    params: name -> tensor (``dict(model.named_parameters())``);
    loss_fn(params, microbatch) -> scalar tensor."""
    G = d2.head_groups or max(cfg.n_heads, 1)
    bw, fw = compute_scores(loss_fn, params,
                            lambda t: transformer_blocks(t, cfg),
                            score_batches, G,
                            backward_metric=d2.backward_score,
                            forward_metric=d2.forward_score)
    return d2ft_mod.plan_schedule(d2, bw, fw, cfg.n_layers, G)


def finetune(model: Transformer, cfg: ModelConfig, d2: Optional[D2FTConfig],
             opt: Optimizer, batches: Iterable, *, steps: int,
             packed: bool = False, use_kernel: bool = False,
             log: Optional[TrainLog] = None) -> tuple:
    """Fine-tune; if d2 is given, schedule ops per batch via D2FT: scores
    and the knapsack on the first batch's micro-batches, then per batch the
    gates and the live-slice bounds of that batch's micro-batch split. The
    gates are checked once per step on the host. Runs on the model's
    device; ``batches`` yields numpy {"tokens", "labels"} (and "features"
    for a frontend arch: an audio batch has no "tokens"). With
    ``packed`` each batch's gather plan (``packed_indices``) replaces the
    gates, and crosses to the device before the step, as the gates do.
    Returns (model, opt_state, log); the model is updated in place."""
    if packed and d2 is None:
        raise ValueError("the packed path runs a D2FT schedule: pass d2")
    log = log or TrainLog()
    dev = next(model.parameters()).device
    opt_state = opt.init(dict(model.named_parameters()))

    def on_device(batch):
        return {k: torch.as_tensor(np.asarray(v), device=dev)
                for k, v in batch.items()}

    sched = None
    for i, batch in enumerate(batches):
        if i >= steps:
            break
        if d2 is not None and sched is None:
            mbs = split_microbatches(on_device(batch), d2.n_microbatches)
            sched = plan_from_scores(
                cfg, d2, dict(model.named_parameters()), mbs,
                lambda p, mb: lm_loss(model, cfg, mb.get("tokens"),
                                      mb["labels"],
                                      features=mb.get("features"))[0])
        sched_args = bounds = None
        if d2 is not None:
            B = batch["labels"].shape[0]
            mb_of = microbatch_assignment(B, d2.n_microbatches)
            if packed:
                plan = packed_indices(sched, mb_of)[:3]
                sched_args = tuple(torch.as_tensor(a, device=dev)
                                   for a in plan)
            else:
                g_f, g_b = gates_from_schedule(sched, mb_of, "cpu")
                if use_kernel:
                    bounds = live_slice_bounds(sched, mb_of)
                _check_schedule_gates(g_f, g_b, bounds)
                sched_args = (g_f.to(dev), g_b.to(dev))
        # the JAX package caches a jitted step per bounds pair; an eager
        # step costs nothing to make
        step_fn = make_train_step(cfg, opt, use_gates=d2 is not None,
                                  packed=packed, use_kernel=use_kernel,
                                  live_bounds=bounds)
        t0 = time.perf_counter()
        _, opt_state, metrics = step_fn(model, opt_state, on_device(batch),
                                        sched_args)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        log.step_times.append(time.perf_counter() - t0)
        log.metrics.append({k: float(v) for k, v in metrics.items()})
        log.losses.append(log.metrics[-1]["loss"])
    return model, opt_state, log


# ---------------------------------------------------------- distributed path
_UNSET = object()     # sentinel: a deprecated loose kwarg was not passed


def _resolve_parallel(parallel, mesh, given: dict, *, where: str):
    """Deprecation shim: fold the loose kwargs (``sync_mode=``,
    ``use_kernel=``, ...) into a ``launch.parallel.ParallelConfig``.

    ``given`` holds only the deprecated kwargs the caller passed. Exactly
    one of ``parallel`` / loose kwargs may be used; ``axis_name`` names the
    mesh axis whose size is the data axis."""
    from repro_torch.launch.parallel import MeshSpec, ParallelConfig

    if parallel is not None:
        if given:
            raise TypeError(
                f"{where}: pass either parallel=ParallelConfig(...) or the "
                f"deprecated kwargs {sorted(given)}, not both")
        return parallel
    if given:
        warnings.warn(
            f"{where}({', '.join(sorted(given))}=...) is deprecated; pass "
            "parallel=repro_torch.launch.parallel.ParallelConfig(...) "
            "instead", DeprecationWarning, stacklevel=3)
    axis = given.pop("axis_name", "data")
    shape = dict(mesh.shape) if mesh is not None else {}
    spec = MeshSpec(data=int(shape.get(axis, 1)),
                    stage=int(shape.get("stage", 1)),
                    tensor=int(shape.get("tensor", 1)))
    return ParallelConfig(mesh=spec, **given)


def make_distributed_train_step(cfg: ModelConfig, opt: Optimizer, mesh,
                                sync_plan, *, parallel=None,
                                clip: float = 1.0, live_bounds=None,
                                use_kernel=_UNSET, axis_name=_UNSET,
                                sync_mode=_UNSET, guard=_UNSET,
                                streamed=_UNSET, opt_chunk=_UNSET):
    """The paper's *distributed* D2FT step on one rank of a data mesh
    (``launch.mesh.DataMesh``).

    Returns step(model, opt_state, batch, gates) -> (model, opt_state,
    metrics), updating the model in place: ``batch`` is this rank's shard
    (its knapsack-assigned micro-batches after ``core.assignment.
    device_sample_order``), ``gates`` its (g_f, g_b) [L, B / world, G].
    Each rank runs the masked or kernel gated path on its shard; then, by
    ``parallel.sync_mode``:

    * ``"masked"`` — ``sharding.sync.apply_grad_sync``: only the leaves and
      group slices with a live backward somewhere in the schedule are
      averaged over the ranks; the loss and metrics are averaged too. The
      post-sync grads are the global mean on every rank, so the clip and
      the update stay replicated with no more collectives.
    * ``"local"`` — the lo-fi communication-free mode: every rank is one
      replica and updates its own copy from its own shard with no
      collective in the step; the metrics are the rank's own. The caller
      merges the replicas with ``sharding.sync.lofi_merge_``.

    ``sync_plan``: {name: SyncSpec} from ``sharding.sync.grad_sync_plan``
    (ignored in local mode). ``live_bounds``: the per-rank (live_fwd,
    live_bwd) compaction bounds (``core.assignment.
    distributed_live_bounds``). The loose kwargs below ``live_bounds`` are
    the deprecated spelling of ``parallel``. The ZeRO modes raise until the
    ZeRO slice; stage / tensor axes and the guard are refused by
    ``ParallelConfig``."""
    from repro_torch.sharding.sync import apply_grad_sync

    given = {k: v for k, v in dict(
        use_kernel=use_kernel, axis_name=axis_name, sync_mode=sync_mode,
        guard=guard, streamed=streamed, opt_chunk=opt_chunk).items()
        if v is not _UNSET}
    parallel = _resolve_parallel(parallel, mesh, given,
                                 where="make_distributed_train_step")
    parallel.require_ported()
    parallel.validate_model(cfg)
    local = parallel.sync_mode == "local"

    def step(model: Transformer, opt_state, batch, gates):
        params = dict(model.named_parameters())
        loss, metrics = lm_loss(model, cfg, batch.get("tokens"),
                                batch["labels"],
                                features=batch.get("features"), gates=gates,
                                use_kernel=parallel.use_kernel,
                                live_bounds=live_bounds)
        grads = _grads(loss, params)
        names = sorted(metrics)
        vals = torch.stack([loss.detach().float()] +
                           [metrics[k].detach().float() for k in names])
        if not local:
            apply_grad_sync(grads, sync_plan, mesh)
            vals = mesh.all_reduce_(vals) / mesh.size
        grads, gnorm = clip_by_global_norm_(grads, clip)
        opt.update(grads, opt_state, params)
        return model, opt_state, dict(zip(names, vals[1:]), loss=vals[0],
                                      grad_norm=gnorm)

    return step


def finetune_distributed(model: Transformer, cfg: ModelConfig,
                         d2: D2FTConfig, opt: Optimizer, batches: Iterable,
                         *, steps: int, mesh, parallel=None,
                         clip: float = 1.0,
                         refresh_every: Optional[int] = None,
                         log: Optional[TrainLog] = None,
                         use_kernel=_UNSET, sync_mode=_UNSET,
                         streamed=_UNSET, opt_chunk=_UNSET) -> tuple:
    """Distributed D2FT fine-tuning on one rank of ``mesh`` (every rank
    calls it with the same arguments and the same batches).

    Rank 0 broadcasts its parameters at the start. At the first batch, and
    every ``refresh_every`` steps, rank 0 scores the batch's micro-batches
    and plans the schedule, and broadcasts the table, so every rank runs
    one schedule; every rank then runs the multiple-knapsack device
    assignment (``core.assignment.plan_device_assignment``), the sample
    order and the per-rank live bounds, and rebuilds the sync plan. Rank r
    takes the r-th contiguous block of the permuted batch and its gates
    [L, B / world, G]. The latest rebalance and sync reports land in
    ``log.extras`` and every refresh is appended to
    ``log.extras["refreshes"]``; ``log.extras["sync_bytes"]`` and
    ``["sync_ms"]`` hold each step's bytes handed to the sync's
    collective (``mesh.counter``) and its host-clock ms. Runs on
    ``mesh.device``, where the model must be; ``batches`` yields numpy
    {"tokens", "labels"}. The loose kwargs are the deprecated spelling of
    ``parallel``. Returns (model, opt_state, log); the model is updated in
    place."""
    from repro_torch.core.assignment import (device_sample_order,
                                             distributed_live_bounds,
                                             plan_device_assignment)
    from repro_torch.core.schedule import op_counts
    from repro_torch.sharding.sync import grad_sync_plan, sync_byte_report

    given = {k: v for k, v in dict(
        use_kernel=use_kernel, sync_mode=sync_mode, streamed=streamed,
        opt_chunk=opt_chunk).items() if v is not _UNSET}
    parallel = _resolve_parallel(parallel, mesh, given,
                                 where="finetune_distributed")
    parallel.require_ported()
    if parallel.sync_mode != "masked":
        raise ValueError(
            f"finetune_distributed runs sync_mode 'masked', not "
            f"{parallel.sync_mode!r} (local replicas merge in the elastic "
            "loop)")
    parallel.validate_model(cfg)
    parallel.validate_mesh(mesh)
    log = log or TrainLog()
    dev, world, rank = mesh.device, mesh.size, mesh.rank
    params = dict(model.named_parameters())
    for p in params.values():
        mesh.broadcast_(p.detach())
    opt_state = opt.init(params)
    G = d2.head_groups or max(cfg.n_heads, 1)

    def on_device(batch):
        return {k: torch.as_tensor(np.asarray(v), device=dev)
                for k, v in batch.items()}

    def replan(batch):
        table = torch.zeros((cfg.n_layers * G, d2.n_microbatches),
                            dtype=torch.int32, device=dev)
        if rank == 0:
            mbs = split_microbatches(on_device(batch), d2.n_microbatches)
            planned = plan_from_scores(
                cfg, d2, params, mbs,
                lambda p, mb: lm_loss(model, cfg, mb.get("tokens"),
                                      mb["labels"],
                                      features=mb.get("features"))[0])
            table.copy_(torch.from_numpy(planned.table.astype(np.int32)))
        mesh.broadcast_(table)
        sched = Schedule(table.cpu().numpy().astype(np.int8), cfg.n_layers,
                         G)
        assignment, report = plan_device_assignment(sched, world)
        sync_plan = grad_sync_plan(params, cfg, sched)
        record = {
            "rebalance": report,
            "sync": sync_byte_report(sync_plan, params, n_shards=world),
            "op_counts": op_counts(sched),
            "device_of": [int(x) for x in assignment.device_of],
        }
        return sched, assignment, sync_plan, record

    sched = assignment = sync_plan = step_fn = bounds = None
    for i, batch in enumerate(batches):
        if i >= steps:
            break
        if sched is None or (refresh_every and i % refresh_every == 0
                             and i > 0):
            sched, assignment, sync_plan, record = replan(batch)
            record["step"] = i
            log.extras["rebalance"] = record["rebalance"]
            log.extras["sync"] = record["sync"]
            log.extras.setdefault("refreshes", []).append(record)
            step_fn = None
        B = batch["labels"].shape[0]
        mb_of = microbatch_assignment(B, d2.n_microbatches)
        perm = device_sample_order(assignment, mb_of)
        n = B // world
        local = perm[rank * n:(rank + 1) * n]
        if step_fn is None:
            bounds = distributed_live_bounds(sched, mb_of, assignment) \
                if parallel.use_kernel else None
            step_fn = make_distributed_train_step(
                cfg, opt, mesh, sync_plan, parallel=parallel, clip=clip,
                live_bounds=bounds)
        g_f, g_b = gates_from_schedule(sched, mb_of[local], "cpu")
        _check_schedule_gates(g_f, g_b, bounds)
        shard = on_device({k: np.asarray(v)[local] for k, v in batch.items()})
        sent, secs = mesh.counter.total(), mesh.counter.seconds
        t0 = time.perf_counter()
        _, opt_state, metrics = step_fn(model, opt_state, shard,
                                        (g_f.to(dev), g_b.to(dev)))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        log.step_times.append(time.perf_counter() - t0)
        log.metrics.append({k: float(v) for k, v in metrics.items()})
        log.losses.append(log.metrics[-1]["loss"])
        log.extras.setdefault("sync_bytes", []).append(
            mesh.counter.total() - sent)
        log.extras.setdefault("sync_ms", []).append(
            1e3 * (mesh.counter.seconds - secs))
    return model, opt_state, log


def make_vit_step(cfg: ViTConfig, opt: Optimizer, use_gates: bool,
                  clip: float = 1.0, use_kernel: bool = False):
    """Returns step(model, opt_state, images, labels, gates=None,
    live_bounds=None) -> (model, opt_state, metrics), updating the model's
    parameters in place. live_bounds: the (live_fwd, live_bwd) compaction
    bounds of this step's gates. The JAX package bakes them into a jitted
    step per bounds pair; PyTorch runs eagerly, so they are passed each
    step."""
    def step(model: ViT, opt_state, images, labels, gates=None,
             live_bounds=None):
        params = dict(model.named_parameters())
        loss, metrics = vit_loss(model, images, labels, cfg,
                                 gates=gates if use_gates else None,
                                 use_kernel=use_kernel,
                                 live_bounds=live_bounds if use_gates
                                 else None)
        grads, gnorm = clip_by_global_norm_(_grads(loss, params), clip)
        opt.update(grads, opt_state, params)
        return model, opt_state, dict(metrics, loss=loss.detach(),
                                      grad_norm=gnorm)
    return step


def _check_schedule_gates(g_f, g_b, bounds):
    """The kernels' gate contracts, checked once per step on the host's
    [L, B, G] gates before they go to the device (the model path checks
    shapes only, so it pays no synchronisation per layer)."""
    L, B, G = g_f.shape
    live_f, live_b = bounds if bounds is not None else (None, None)
    for layer in range(L):
        _validate_gates(g_f[layer], g_b[layer], B, G, live_f, live_b)


def finetune_vit(model: ViT, cfg: ViTConfig, opt: Optimizer, batches,
                 steps: int, schedule_fn: Optional[Callable] = None,
                 n_microbatches: int = 5, use_kernel: bool = False,
                 log: Optional[TrainLog] = None):
    """schedule_fn(step_idx, model, images, labels) -> Schedule or None.

    The schedule is rematerialized whenever schedule_fn returns a new one
    (supports dynamic-pruning baselines that refresh every k iterations).
    use_kernel routes attention through the gated flash kernels so the
    Schedule's (g_f, g_b) gates drive the gate-aware backward kernel. Runs
    on the model's device; ``batches`` yields numpy (images, labels).
    Returns (model, opt_state, log); the model is updated in place.
    """
    log = log or TrainLog()
    dev = next(model.parameters()).device
    opt_state = opt.init(dict(model.named_parameters()))
    use_gates = schedule_fn is not None
    step_fn = make_vit_step(cfg, opt, use_gates, use_kernel=use_kernel)
    sched = None
    for i, (images, labels) in enumerate(batches):
        if i >= steps:
            break
        gates = bounds = None
        if schedule_fn is not None:
            new = schedule_fn(i, model, images, labels)
            sched = new if new is not None else sched
            mb_of = microbatch_assignment(images.shape[0], n_microbatches)
            g_f, g_b = gates_from_schedule(sched, mb_of, "cpu")
            if use_kernel:
                bounds = live_slice_bounds(sched, mb_of)
            _check_schedule_gates(g_f, g_b, bounds)
            gates = (g_f.to(dev), g_b.to(dev))
        t0 = time.perf_counter()
        _, opt_state, metrics = step_fn(
            model, opt_state, torch.as_tensor(images, device=dev),
            torch.as_tensor(labels, device=dev), gates, bounds)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        log.step_times.append(time.perf_counter() - t0)
        log.metrics.append({k: float(v) for k, v in metrics.items()})
        log.losses.append(log.metrics[-1]["loss"])
    return model, opt_state, log


@torch.no_grad()
def eval_vit(model: ViT, cfg: ViTConfig, batches,
             max_batches: int = 10) -> float:
    dev = next(model.parameters()).device
    correct = total = 0
    for i, (images, labels) in enumerate(batches):
        if i >= max_batches:
            break
        logits = vit_forward(model, torch.as_tensor(images, device=dev), cfg)
        pred = logits.argmax(-1).cpu().numpy()
        correct += int((pred == labels).sum())
        total += len(labels)
    return correct / max(total, 1)
