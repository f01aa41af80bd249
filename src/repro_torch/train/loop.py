"""Training loops (port of ``repro/train/loop.py``).

``finetune`` drives the D2FT fine-tune of LLM backbones (what
``launch/train.py`` runs); ``finetune_vit`` is the paper's ViT experiment.
Both: optional D2FT schedule (scores -> knapsack -> gates), the masked or
the kernel path, a global-norm clip and the optimizer update, one step per
batch; ``finetune`` also runs the packed path (``core.d2ft.
packed_forward``). ``finetune_distributed`` is the paper's distributed
D2FT over a ``launch.mesh.DataMesh`` or a (data, stage, tensor)
``launch.mesh.Mesh`` (one process per rank), with the schedule-masked
gradient sync or ZeRO-1 / ZeRO-3 (streamed too, on a data mesh) over the
data axis, the GPipe pipeline over the stage axis and Megatron tensor
parallelism over the tensor axis; ``make_distributed_train_step`` also has
the lo-fi local mode and the pre-sync guard (``_grad_anomaly``), which
``train/elastic.py::finetune_elastic`` arms. The sharding policy comes
with a later slice.
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
from repro_torch.optim.optimizers import (Optimizer, chunked,
                                          clip_by_global_norm_, clip_scale)


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
def _block_of(name: str) -> str:
    """The guard's block of a flat parameter name: its layer
    (``layers.<l>``), else its loss-path subtree (``embed``,
    ``final_norm``, ``unembed``, ``frontend_proj``)."""
    parts = name.split(".")
    return ".".join(parts[:2]) if parts[0] == "layers" else parts[0]


def _grad_anomaly(grads, thresh):
    """Per-subnet-block gradient anomaly detection (the pre-sync guard).

    One squared grad norm per parameter block: each layer (the JAX
    package's per-cycle entry of a ``cycles`` leaf, or a ``rest`` block)
    and each loss-path subtree; a block is bad when its norm is non-finite
    or exceeds ``thresh`` (+inf disables the norm test). Returns
    (bad_any, n_bad_blocks): a 0-d bool and a 0-d float32 tensor, left on
    the device."""
    blocks: dict = {}
    for n, g in grads.items():
        sq = torch.sum(g.float() ** 2)
        b = _block_of(n)
        blocks[b] = blocks[b] + sq if b in blocks else sq
    sq = torch.stack(list(blocks.values()))
    bad = ~torch.isfinite(sq) | (torch.sqrt(sq) > float(thresh))
    return bad.any(), bad.sum().float()


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
                                residency_recorder=None,
                                stage_assignment=None,
                                pipeline_recorder=None,
                                use_kernel=_UNSET, axis_name=_UNSET,
                                sync_mode=_UNSET, guard=_UNSET,
                                streamed=_UNSET, opt_chunk=_UNSET):
    """The paper's *distributed* D2FT step on one rank of a data mesh
    (``launch.mesh.DataMesh``) or of a (data, stage, tensor) mesh
    (``launch.mesh.Mesh``).

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
    * ``"zero"`` — ZeRO-1: live runs are reduce-scattered onto their
      owners (``apply_zero_scatter``), the global norm is sqrt(all-reduced
      shard_sq + full_sq), each rank updates its owned shard copy with its
      shard of the moments (``opt_state`` in the plan's shard layout), and
      the schedule-masked all-gather (``apply_zero_gather``) writes the
      updated runs back into the model's replicated parameters.
    * ``"zero3"`` — ZeRO-3: the model's zero leaves hold this rank's
      shards (``sharding.sync.zero3_shard_model_``) between steps. The
      step materializes full views under the forward mask
      (``zero3_materialize``), runs the loss with the views in place of
      the parameters (``sharding.sync.installed``), takes the gradients
      against the views, reduce-scatters them onto the shards, frees the
      views and updates shard-resident: no gather after the update.
      ``parallel.streamed`` swaps in the streamed schedule
      (``zero3_stream_materialize``: one autograd Function a residency
      unit, gathered when the forward reaches it, scattered when its
      backward runs; the gradients autograd returns are the shards'),
      bit-identical; ``residency_recorder`` counts its per-unit gather
      bytes. ``parallel.opt_chunk`` streams the shard update that many
      elements at a time (``optim.optimizers.chunked``, bit-identical).
    * ``"local"`` — the lo-fi communication-free mode: every rank is one
      replica and updates its own copy from its own shard with no
      collective in the step; the metrics are the rank's own. The caller
      merges the replicas with ``sharding.sync.lofi_merge_``.

    Axes beyond data compose around the same bodies, as in the JAX step:

    * ``stage > 1`` — the GPipe pipeline (``train.pipeline.
      pipeline_loss``): this rank runs its ``stage_assignment`` layer range
      (a ``core.assignment.StageAssignment``, required) on
      ``parallel.microbatches`` micro-batches; the loss, the metrics and
      the whole grad tree are summed over the stage axis (counted under
      ``stage``) before any data-axis sync, so the sync modes see the
      full-batch grads they always did. ``pipeline_recorder`` (a
      ``train.pipeline.PipelineRecorder``) counts rounds and sends.
    * ``tensor > 1`` — Megatron sharding of attention heads / FFN columns
      inside each block (``models.transformer``'s ``tp``); the sharded
      leaves' grads are disjoint slices, summed over the tensor axis
      (``sharding.sync.apply_tensor_grad_sync``) before the data-axis
      sync.

    Ranks that share a data index take the same batch shard; the data-axis
    sync, the metrics' mean and the ZeRO shards run over the data axis.

    ``parallel.guard`` arms the pre-sync guard (not with ``streamed``, nor
    with a stage or tensor axis: ``ParallelConfig`` refuses them, as JAX
    does): the step takes ``(fault, thresh)`` after the gates, ``fault`` a
    [data ranks] multiplier (numpy) of which this rank applies entry
    ``rank`` to its local grads (the fault-injection seam; all ones when
    healthy) and ``thresh`` the per-block grad-norm threshold (+inf
    disables it). After the backward each rank checks its local grads
    block by block (``_grad_anomaly``) and zeroes them all where one is
    bad, before any collective; one ``all_reduce`` of [bad, n_bad_blocks]
    (counted under ``guard``) tells every rank whether any rank flagged.
    If one did, the sync still runs (on the zeroed grads; its norm is the
    step's ``grad_norm``) but no rank updates: parameters and optimizer
    state stay bit for bit. The metrics gain ``skipped`` (0 / 1),
    ``bad_devices`` and ``bad_blocks``. In the local mode the guard is
    the rank's own: no collective, and only the flagged replica holds
    back.

    ``sync_plan``: {name: SyncSpec} from ``sharding.sync.grad_sync_plan``
    of the step's mode (ignored in local mode). ``live_bounds``: the
    per-rank (live_fwd, live_bwd) compaction bounds (``core.assignment.
    distributed_live_bounds``). The loose kwargs below ``live_bounds`` are
    the deprecated spelling of ``parallel``. The JAX step takes a
    ``params`` template for the moments' sharding; here the shapes come
    from the model."""
    from repro_torch.launch.mesh import axes
    from repro_torch.sharding import sync
    from repro_torch.train.pipeline import pipeline_loss

    given = {k: v for k, v in dict(
        use_kernel=use_kernel, axis_name=axis_name, sync_mode=sync_mode,
        guard=guard, streamed=streamed, opt_chunk=opt_chunk).items()
        if v is not _UNSET}
    parallel = _resolve_parallel(parallel, mesh, given,
                                 where="make_distributed_train_step")
    parallel.validate_model(cfg)
    mode = parallel.sync_mode
    S, T = parallel.mesh.stage, parallel.mesh.tensor
    if (S > 1 or T > 1) and mesh is not None:
        parallel.validate_mesh(mesh)
    if S > 1:
        if stage_assignment is None:
            raise ValueError(
                "stage > 1 needs a core.assignment.StageAssignment "
                "(plan_stage_assignment on the current schedule)")
        if stage_assignment.n_stages != S:
            raise ValueError(f"a stage assignment of "
                             f"{stage_assignment.n_stages} stages on a "
                             f"stage axis of {S}")
    _, dmesh, smesh, tmesh = axes(mesh) if mesh is not None else \
        (None, None, None, None)
    guard = parallel.guard
    tp = tmesh if T > 1 else None
    upd_opt = chunked(opt, parallel.opt_chunk) if parallel.opt_chunk \
        else opt

    def local_loss(model, batch, gates):
        return lm_loss(model, cfg, batch.get("tokens"), batch["labels"],
                       features=batch.get("features"), gates=gates,
                       use_kernel=parallel.use_kernel,
                       live_bounds=live_bounds, tp=tp)

    def loss_and_grads(model, params, batch, gates):
        """(loss, metrics, grads) against ``params``, completed over the
        stage and tensor axes: every body below sees the full grads of
        this data shard, as on a pure data mesh."""
        if S <= 1:
            loss, metrics = local_loss(model, batch, gates)
            grads = _grads(loss, params)
        else:
            if batch.get("features") is not None:
                raise ValueError("the pipeline path is tokens-only")
            loss, metrics, grads = pipeline_loss(
                model, cfg, params, batch["tokens"], batch["labels"], gates,
                boundaries=stage_assignment.boundaries,
                n_microbatches=parallel.microbatches, stage=smesh, tp=tp,
                recorder=pipeline_recorder)
            # stage partials (each stage's own layers, the last stage's
            # head) sum to the full-batch values; the grads' supports are
            # disjoint by layer, so the sum is a reassembly
            names = sorted(metrics)
            vals = smesh.sum_(torch.stack(
                [loss] + [metrics[k] for k in names]), "stage")
            loss, metrics = vals[0], dict(zip(names, vals[1:]))
            sync.sum_over_axis_(grads.values(), smesh, "stage")
        if tp is not None:
            sync.apply_tensor_grad_sync(grads, tmesh)
        return loss, metrics, grads

    def mean_over_ranks(loss, metrics, *extra):
        """The loss and metrics, averaged over the ranks unless the mode
        is local, in one scalar all-reduce that also sums ``extra`` (the
        shards' squared norm)."""
        names = sorted(metrics)
        vals = torch.stack([loss.detach().float()] +
                           [metrics[k].detach().float() for k in names] +
                           list(extra))
        n = len(names) + 1
        if mode == "local":
            return dict(zip(names, vals[1:n]), loss=vals[0]), vals[n:]
        vals = dmesh.all_reduce_(vals, kind="metrics")
        return dict(zip(names, vals[1:n] / dmesh.size),
                    loss=vals[0] / dmesh.size), vals[n:]

    def guard_local(grads, fault, thresh):
        """Fault-inject, then zero this rank's grads where a block is
        anomalous, before any collective. Returns [bad ranks, bad blocks]
        over the ranks (this rank's own in the local mode)."""
        uniq = list({id(g): g for g in grads.values()}.values())
        f = float(np.asarray(fault)[dmesh.rank if dmesh is not None else 0])
        if f != 1.0:
            for g in uniq:
                g.mul_(f)
        bad, n_bad = _grad_anomaly(grads, np.inf if thresh is None
                                   else thresh)
        for g in uniq:
            g.masked_fill_(bad, 0.0)
        flags = torch.stack([bad.float(), n_bad])
        if mode != "local":
            dmesh.sum_(flags, "guard")
        return flags

    def guarded(metrics, flags):
        """(skip the update?, the metrics with the guard's three)."""
        if flags is None:
            return False, metrics
        return bool(flags[0] > 0), dict(
            metrics, skipped=(flags[0] > 0).float(), bad_devices=flags[0],
            bad_blocks=flags[1])

    def finish_zero(gsync, loss, metrics):
        """The ZeRO bodies' metrics and clip: the global norm is
        sqrt(all-reduced shard_sq + full_sq), and the grads are scaled in
        place."""
        shard_sq, full_sq = sync.zero_norm_sq(gsync, sync_plan)
        out, (shard_sum,) = mean_over_ranks(loss, metrics, shard_sq)
        gnorm = torch.sqrt(shard_sum + full_sq)
        scale = clip_scale(gnorm, clip)
        for g in {id(g): g for g in gsync.values()}.values():
            g.mul_(scale)
        return dict(out, grad_norm=gnorm)

    def step_masked(model, opt_state, batch, gates, fault=None,
                    thresh=None):
        params = dict(model.named_parameters())
        loss, metrics, grads = loss_and_grads(model, params, batch, gates)
        flags = guard_local(grads, fault, thresh) if guard else None
        if mode != "local":
            sync.apply_grad_sync(grads, sync_plan, dmesh)
        out, _ = mean_over_ranks(loss, metrics)
        grads, gnorm = clip_by_global_norm_(grads, clip)
        skip, out = guarded(dict(out, grad_norm=gnorm), flags)
        if not skip:
            opt.update(grads, opt_state, params)
        return model, opt_state, out

    def step_zero(model, opt_state, batch, gates, fault=None, thresh=None):
        params = dict(model.named_parameters())
        loss, metrics, grads = loss_and_grads(model, params, batch, gates)
        flags = guard_local(grads, fault, thresh) if guard else None
        gsync = sync.apply_zero_scatter(grads, sync_plan, dmesh)
        del grads
        skip, out = guarded(finish_zero(gsync, loss, metrics), flags)
        if not skip:
            # each rank updates its owned shard copy; the masked all-gather
            # re-replicates exactly the runs whose parameters can have
            # changed
            pshard = sync.zero_shard_params(params, sync_plan, dmesh.rank)
            opt.update(gsync, opt_state, pshard)
            sync.apply_zero_gather(pshard, params, sync_plan, dmesh)
        return model, opt_state, out

    def step_zero3(model, opt_state, batch, gates, fault=None, thresh=None):
        params = dict(model.named_parameters())
        full = sync.zero3_materialize(
            {n: p.detach() for n, p in params.items()}, sync_plan, dmesh)
        views = {n: full[n].requires_grad_() for n in params
                 if sync._is_zero(sync_plan[n])}
        with sync.installed(model, views):
            loss, metrics, grads = loss_and_grads(
                model, {n: views.get(n, p) for n, p in params.items()},
                batch, gates)
        del full, views
        flags = guard_local(grads, fault, thresh) if guard else None
        gsync = sync.apply_zero_scatter(grads, sync_plan, dmesh)
        del grads
        skip, out = guarded(finish_zero(gsync, loss, metrics), flags)
        del loss, metrics
        # shards and their grads are both shard-resident: the update never
        # touches a full tensor and no gather follows it
        if not skip:
            upd_opt.update(gsync, opt_state, params)
        return model, opt_state, out

    def step_zero3_streamed(model, opt_state, batch, gates):
        params = dict(model.named_parameters())
        with sync.zero3_stream_materialize(model, sync_plan, dmesh,
                                           recorder=residency_recorder):
            loss, metrics = local_loss(model, batch, gates)
        gsync = _grads(loss, params)
        out = finish_zero(gsync, loss, metrics)
        del loss, metrics
        upd_opt.update(gsync, opt_state, params)
        return model, opt_state, out

    if mode in ("masked", "local"):
        return step_masked
    if mode == "zero":
        return step_zero
    return step_zero3_streamed if parallel.streamed else step_zero3


def planned_schedule(model: Transformer, cfg: ModelConfig, d2: D2FTConfig,
                     batch, mesh) -> Schedule:
    """Rank 0 of ``mesh`` scores ``batch``'s micro-batches on the model and
    plans the schedule; the table is broadcast over ``mesh``, so every rank
    runs one schedule. ``batch``: numpy {"tokens", "labels"}."""
    G = d2.head_groups or max(cfg.n_heads, 1)
    dev = mesh.device
    table = torch.zeros((cfg.n_layers * G, d2.n_microbatches),
                        dtype=torch.int32, device=dev)
    if mesh.rank == 0:
        mbs = split_microbatches(
            {k: torch.as_tensor(np.asarray(v), device=dev)
             for k, v in batch.items()}, d2.n_microbatches)
        planned = plan_from_scores(
            cfg, d2, dict(model.named_parameters()), mbs,
            lambda p, mb: lm_loss(model, cfg, mb.get("tokens"),
                                  mb["labels"],
                                  features=mb.get("features"))[0])
        table.copy_(torch.from_numpy(planned.table.astype(np.int32)))
    mesh.broadcast_(table)
    return Schedule(table.cpu().numpy().astype(np.int8), cfg.n_layers, G)


def logged_step(log: TrainLog, counter, dev, call):
    """Run one distributed step (``call()`` -> (model, opt_state,
    metrics)) and log it: its host-clock seconds to a device sync, its
    metrics and loss, and the bytes and ms it handed to each collective
    (``counter``: the mesh's ``CollectiveCounter``) in ``log.extras``'s
    ``sync_bytes``, ``sync_bytes_by_kind``, ``sync_ms_by_kind`` and
    ``sync_ms``. Returns (opt_state, metrics as floats)."""
    sent = dict(counter.bytes)
    secs = dict(counter.kind_seconds)
    total_s = counter.seconds
    t0 = time.perf_counter()
    _, opt_state, metrics = call()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    log.step_times.append(time.perf_counter() - t0)
    log.metrics.append({k: float(v) for k, v in metrics.items()})
    log.losses.append(log.metrics[-1]["loss"])
    by_kind = {k: v - sent.get(k, 0) for k, v in counter.bytes.items()
               if v != sent.get(k, 0)}
    log.extras.setdefault("sync_bytes", []).append(sum(by_kind.values()))
    log.extras.setdefault("sync_bytes_by_kind", []).append(by_kind)
    log.extras.setdefault("sync_ms_by_kind", []).append(
        {k: 1e3 * (counter.kind_seconds[k] - secs.get(k, 0.0))
         for k in by_kind})
    log.extras.setdefault("sync_ms", []).append(
        1e3 * (counter.seconds - total_s))
    return opt_state, log.metrics[-1]


# the data axis's plan and step inputs, shared by ``finetune_distributed``
# and ``train/elastic.py::finetune_elastic``
def data_sync_plan(shapes, cfg: ModelConfig, sched: Schedule, mode: str,
                   n_data: int, opt: Optimizer, ever_live):
    """(the data axis's sync plan for ``sched`` under ``mode``, the new
    ``ever_live``). ``ever_live`` is ZeRO-1's [L, G] groups backward-live
    under any plan since the moments were zero (None: none yet): its
    gather elision, for an ``opt.elidable`` optimizer only, must still
    gather them. ``shapes``: the canonical parameter shapes."""
    from repro_torch.sharding import sync
    if mode != "zero":
        return sync.grad_sync_plan(shapes, cfg, sched, mode,
                                   n_shards=n_data), ever_live
    plan = sync.grad_sync_plan(shapes, cfg, sched, "zero", n_shards=n_data,
                               ever_live=ever_live,
                               elide_gather=opt.elidable)
    live = sync.backward_live_groups(sched)
    return plan, live if ever_live is None else ever_live | live


def data_plan_record(sync_plan, shapes, mode: str, n_data: int,
                     opt: Optimizer) -> dict:
    """A refresh record's byte reports of ``sync_plan``: ``sync``, and
    under ZeRO ``zero_state``, under ZeRO-3 ``zero3_params``."""
    from repro_torch.sharding import sync
    record = {"sync": sync.sync_byte_report(sync_plan, shapes,
                                            n_shards=n_data)}
    if mode in ("zero", "zero3"):
        record["zero_state"] = sync.zero_state_byte_report(
            sync_plan, shapes, n_data, opt.n_moments)
    if mode == "zero3":
        record["zero3_params"] = sync.zero3_param_byte_report(
            sync_plan, shapes, n_data)
    return record


def relayout_moments(state, old_plan, new_plan, mesh, shapes):
    """The optimizer state's moments from ``old_plan``'s shard layout to
    ``new_plan``'s over ``mesh`` (None: canonical whole); a new dict, the
    step counter kept."""
    from repro_torch.sharding import sync
    return {k: sync.zero_relayout(v, old_plan, new_plan, mesh)
            if isinstance(v, dict) and v.keys() == shapes.keys() else v
            for k, v in state.items()}


def lay_out_plan(model: Transformer, opt: Optimizer, opt_state, old_plan,
                 new_plan, mode: str, mesh, shapes):
    """The ZeRO state moved to ``new_plan``'s layout on this rank of the
    data axis ``mesh``: the moments re-laid out from ``old_plan``'s (a
    None state starts fresh in the new layout) and, under ZeRO-3, the
    model's parameters, whole on entry, cut to this rank's shards. Returns
    the optimizer state; the masked mode's is returned as it is."""
    from repro_torch.sharding import sync
    if mode not in ("zero", "zero3"):
        return opt_state
    if opt_state is None:
        opt_state = opt.init({n: torch.empty(
            sync.zero_shard_shape(s.shape, new_plan[n]), dtype=s.dtype,
            device=mesh.device) for n, s in shapes.items()})
    else:
        opt_state = relayout_moments(opt_state, old_plan, new_plan, mesh,
                                     shapes)
    if mode == "zero3":
        sync.zero3_shard_model_(model, new_plan, mesh.rank)
    return opt_state


def data_step_inputs(batch, sched: Schedule, assignment, n_microbatches: int,
                     n_data: int, rank: int, dev, use_kernel: bool):
    """(shard, gates, bounds) of data rank ``rank``: its contiguous block
    of the numpy ``batch`` permuted by the device assignment, as tensors on
    ``dev``; its gates [L, B / n_data, G] on ``dev``; the kernel's live
    bounds over every rank (None without the kernel), which the gates are
    checked against."""
    from repro_torch.core.assignment import (device_sample_order,
                                             distributed_live_bounds)
    B = batch["labels"].shape[0]
    mb_of = microbatch_assignment(B, n_microbatches)
    n = B // n_data
    local = device_sample_order(assignment, mb_of)[rank * n:(rank + 1) * n]
    bounds = distributed_live_bounds(sched, mb_of, assignment) \
        if use_kernel else None
    g_f, g_b = gates_from_schedule(sched, mb_of[local], "cpu")
    _check_schedule_gates(g_f, g_b, bounds)
    shard = {k: torch.as_tensor(np.asarray(v)[local], device=dev)
             for k, v in batch.items()}
    return shard, (g_f.to(dev), g_b.to(dev)), bounds


def finetune_distributed(model: Transformer, cfg: ModelConfig,
                         d2: D2FTConfig, opt: Optimizer, batches: Iterable,
                         *, steps: int, mesh, parallel=None,
                         clip: float = 1.0,
                         refresh_every: Optional[int] = None,
                         log: Optional[TrainLog] = None,
                         use_kernel=_UNSET, sync_mode=_UNSET,
                         streamed=_UNSET, opt_chunk=_UNSET) -> tuple:
    """Distributed D2FT fine-tuning on one rank of ``mesh`` (a data mesh,
    ``launch.mesh.DataMesh``, or a (data, stage, tensor)
    ``launch.mesh.Mesh``; every rank calls it with the same arguments and
    the same batches).

    Rank 0 broadcasts its parameters at the start. At the first batch, and
    every ``refresh_every`` steps, rank 0 scores the batch's micro-batches
    and plans the schedule, and broadcasts the table, so every rank runs
    one schedule; every rank then runs the multiple-knapsack device
    assignment over the data axis (``core.assignment.
    plan_device_assignment``), the sample order and the per-rank live
    bounds, and rebuilds the sync plan; with a stage axis it also re-runs
    the live-cost stage assigner (``core.assignment.plan_stage_assignment``
    on the new schedule, with its ``bubble_fraction``: the refresh record's
    and ``log.extras["stages"]``) and the step is rebuilt around the new
    boundaries. The rank at data index d takes the d-th contiguous block of
    the permuted batch and its gates [L, B / data, G]; ranks that share a
    data index take the same block. The latest rebalance and sync reports
    land in ``log.extras`` and every refresh is appended to
    ``log.extras["refreshes"]``; ``log.extras["sync_bytes"]`` and
    ``["sync_ms"]`` hold each step's bytes handed to the sync's
    collectives (``mesh.counter``) and its host-clock ms,
    ``["sync_bytes_by_kind"]`` and ``["sync_ms_by_kind"]`` the same by
    collective (the ms of the calls alone). Runs on ``mesh.device``, where
    the model must be; ``batches`` yields numpy {"tokens", "labels"}. The
    loose kwargs are the deprecated spelling of ``parallel``.

    ``parallel.sync_mode``: "masked", or the ZeRO modes. "zero" runs the
    ZeRO-1 step with the moments in each plan's shard layout, re-laid out
    at every refresh (``sharding.sync.zero_relayout``); its gather elision
    engages only for an ``opt.elidable`` optimizer and for groups never
    backward-live since the moments were zero (``ever_live``). "zero3"
    keeps each zero leaf's parameter as this rank's shard between steps;
    at a refresh every rank first gathers every run back into canonical
    parameters (counted under the kind "reshard", not a step's sync), rank
    0 scores on them, and every rank then keeps its shard of the new
    plan's layout; each refresh record gains the ``zero3_params``
    residency report, and under ``streamed`` the ``residency`` check of
    the first step of its plan (``check_zero3_residency``). Each ZeRO
    refresh record gains ``zero_state`` (``zero_state_byte_report``). The
    model's parameters and the returned moments are in canonical order,
    whole, whatever the mode. Returns (model, opt_state, log); the model
    is updated in place."""
    from repro_torch.core.assignment import (plan_device_assignment,
                                             plan_stage_assignment)
    from repro_torch.core.schedule import op_counts
    from repro_torch.launch.mesh import axes
    from repro_torch.models.transformer import check_tp_tiling
    from repro_torch.sharding import sync
    from repro_torch.train.pipeline import analytic_bubble_fraction

    given = {k: v for k, v in dict(
        use_kernel=use_kernel, sync_mode=sync_mode, streamed=streamed,
        opt_chunk=opt_chunk).items() if v is not _UNSET}
    parallel = _resolve_parallel(parallel, mesh, given,
                                 where="finetune_distributed")
    mode = parallel.sync_mode
    if mode == "local":
        raise ValueError(
            "finetune_distributed runs the masked and ZeRO sync modes, not "
            "'local' (local replicas merge in the elastic loop)")
    parallel.validate_model(cfg)
    parallel.validate_mesh(mesh)
    S, T = parallel.mesh.stage, parallel.mesh.tensor
    G = d2.head_groups or max(cfg.n_heads, 1)
    if T > 1:
        check_tp_tiling(cfg, G, T)
    log = log or TrainLog()
    wmesh, dmesh, _, _ = axes(mesh)
    dev, n_data = mesh.device, dmesh.size
    params = dict(model.named_parameters())
    for p in params.values():
        wmesh.broadcast_(p.detach())
    # the canonical shapes the plans and reports are made from (the
    # parameters of a ZeRO-3 model hold shards between steps)
    shapes = {n: torch.empty(p.shape, dtype=p.dtype, device="meta")
              for n, p in params.items()}
    zero = mode in ("zero", "zero3")
    opt_state = None if zero else opt.init(params)

    ever_live = None

    def replan(batch):
        nonlocal ever_live
        sched = planned_schedule(model, cfg, d2, batch, wmesh)
        assignment, report = plan_device_assignment(sched, n_data)
        sync_plan, ever_live = data_sync_plan(shapes, cfg, sched, mode,
                                              n_data, opt, ever_live)
        record = {
            "rebalance": report,
            **data_plan_record(sync_plan, shapes, mode, n_data, opt),
            "op_counts": op_counts(sched),
            "device_of": [int(x) for x in assignment.device_of],
        }
        stage_assign = None
        if S > 1:
            # re-pack the stages for the NEW schedule's live costs: a
            # packing balanced for a stale schedule un-balances this one
            stage_assign, stage_rep = plan_stage_assignment(sched, S)
            stage_rep["bubble_fraction"] = analytic_bubble_fraction(
                stage_assign.loads, parallel.microbatches)
            record["stages"] = stage_rep
        return sched, assignment, stage_assign, sync_plan, record

    sched = assignment = stage_assign = sync_plan = step_fn = None
    recorder = record = None
    for i, batch in enumerate(batches):
        if i >= steps:
            break
        if sched is None or (refresh_every and i % refresh_every == 0
                             and i > 0):
            old_plan = sync_plan
            if mode == "zero3" and old_plan is not None:
                # back to canonical parameters before scoring
                sync.zero3_unshard_model_(model, old_plan, dmesh)
            sched, assignment, stage_assign, sync_plan, record = \
                replan(batch)
            opt_state = lay_out_plan(model, opt, opt_state, old_plan,
                                     sync_plan, mode, dmesh, shapes)
            if mode == "zero3":
                log.extras["zero3_params"] = record["zero3_params"]
            record["step"] = i
            log.extras["rebalance"] = record["rebalance"]
            log.extras["sync"] = record["sync"]
            if "stages" in record:
                log.extras["stages"] = record["stages"]
            log.extras.setdefault("refreshes", []).append(record)
            step_fn = None
        shard, gates, bounds = data_step_inputs(
            batch, sched, assignment, d2.n_microbatches, n_data, dmesh.rank,
            dev, parallel.use_kernel)
        if step_fn is None:
            recorder = sync.ResidencyRecorder() if parallel.streamed \
                else None
            step_fn = make_distributed_train_step(
                cfg, opt, mesh, sync_plan, parallel=parallel, clip=clip,
                live_bounds=bounds, residency_recorder=recorder,
                stage_assignment=stage_assign)
        opt_state, _ = logged_step(
            log, mesh.counter, dev,
            lambda: step_fn(model, opt_state, shard, gates))
        if recorder is not None and "residency" not in record:
            record["residency"] = sync.check_zero3_residency(
                recorder, sync_plan, shapes, n_data)
    if zero and sync_plan is not None:
        # hand back canonical whole state: the shard layout is internal
        opt_state = relayout_moments(opt_state, sync_plan, None, dmesh,
                                     shapes)
        if mode == "zero3":
            sync.zero3_unshard_model_(model, sync_plan, dmesh)
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
