"""Schedule-masked gradient synchronization for the distributed D2FT step
(port of the masked half of ``repro/sharding/sync.py``).

In data-parallel D2FT every rank computes gradients only for its own
micro-batches, but the masked and kernel gated paths guarantee something
stronger: a (layer, head-group) subnet with **no p_f micro-batch anywhere
in the schedule** has *identically zero* gradient on every rank (p_o
contributions are detached and p_s contributions are zeroed before they
enter the residual stream). All-reducing those zeros is waste, so the
host-side schedule table becomes a per-parameter *sync plan*:

* ``all``    — live backward somewhere in the leaf: full mean over ranks.
* ``none``   — no live backward in any covered subnet: nothing is sent
               (every rank already holds the exact, zero, global grad).
* ``sliced`` — the leaf has head-group structure along one axis (wq / wo
               columns / rows, gated-FFN up / down blocks): only the live
               groups' contiguous runs are averaged; dead runs stay.

Safety rails (always ``all``): embeddings, unembed, final norm and
``frontend_proj`` (gradients flow through every sample), every ``moe``
subtree and an MoE block's ``norm2`` (the router's aux losses are not
gated), and any leaf whose group axis does not split into G blocks.

The plan is keyed by the port's flat parameter names (``layers.<l>.attn.
wq`` ...). The port's layers are unstacked, so there is no ``stacked``
spec: layer ``c*P + j`` takes the spec of cycle ``c`` of the JAX package's
stacked leaf. Leaf layouts are the JAX ones (``[in, out]``), so the group
axes carry over unchanged.

``apply_grad_sync`` runs the plan as one ``all_reduce`` over a flat bucket
(one per dtype): every ``all`` leaf and every live run of every ``sliced``
leaf is packed into it, summed over the ranks, divided by the world size
and copied back. Dead runs and ``none`` leaves are never copied or sent.
The mesh's ``CollectiveCounter`` counts the bytes handed to the
collective, so ``sync_byte_report``'s ``ar_bytes`` is checked against what
was sent.

ZeRO-1 (``mode="zero"``) and ZeRO-3 (``mode="zero3"``)
----------------------------------------------------
``grad_sync_plan(..., mode="zero", n_shards=k)`` gives every leaf that
splits evenly over the k ranks a ``zero`` spec: a partition axis, its
group blocks merged into runs of equal (backward-live, gather) flags
(``_zero_runs``), and for each run rank d owns the d-th sub-chunk *along
the partition axis*. A rank's shard of a leaf is the concatenation of its
sub-chunks in run order: the optimizer moments live there (about 1/k of
them a rank) and the update runs there. The live runs are
reduce-scattered (dead runs are exact zeros on every rank and are sliced
locally); the updated shards are all-gathered under the gather mask: the
live runs, the runs live under any earlier plan (``ever_live``), or every
run for an optimizer whose update of a zero gradient with zero moments is
not the identity (weight decay: ``Optimizer.elidable``). Leaves with no
evenly divisible axis keep their masked spec and their replicated
moments. ZeRO-3 keeps the same partition, but the shards are the
parameters between steps; the step gathers full views under the
*forward* mask (a run p_s on every micro-batch is a zeros view, exact:
``gate_mix`` multiplies its every consumer by g_f = 0) and there is no
gather after the update.

Collectives are bucketed as the masked sync's are: one ``reduce_scatter_``
a dtype carries every live run of every zero leaf, one ``all_gather_`` a
dtype every gathered run, and the fallback leaves keep their one
``all_reduce``. The reduce-scatter's bucket is rank-major: rank d's
segment is its sub-chunks of every live run, leaf by leaf in plan order
(the order ``_zero_layout_perm`` lays a global array out in), so a flat
reduce-scatter lands each rank's owned sub-chunks on it; the all-gather's
output has the same layout. The layout arithmetic is kept in functions of
(tensors, plan, rank, k) apart from the collectives (``_scatter_inputs``,
``_scatter_outputs``, ``_gather_inputs``, ``_gather_outputs``), so one
process can emulate k ranks. The counter counts each collective's
full-size side (the reduce-scatter's input, the all-gather's output), so a
step's bytes equal ``sync_byte_report``'s ``ar_bytes``, ``rs_bytes`` and
``ag_bytes`` exactly.

``zero3_stream_materialize`` is the streamed ZeRO-3 step: each residency
unit (the loss-path subtrees, then one layer at a time, in
``zero3_unit_schedule``'s order) is materialized by an autograd Function
(``_StreamUnit``) whose forward is the unit's all-gather and whose
backward is its reduce-scatter (and the masked mean of its fallback
leaves), installed where the layer reads its weights by a forward
pre-hook on the block, so a unit's full gradient lives only until its
backward. ``ResidencyRecorder`` counts each unit's gathered bytes as it
runs; ``check_zero3_residency`` holds them to ``zero3_param_byte_report``.

The stage and tensor axes (``launch.mesh.Mesh``) add two sums: the
pipeline's whole gradient tree over the stage axis (``sum_over_axis_``,
kind ``stage``), then ``apply_tensor_grad_sync`` over the tensor axis
(``tp_grad``: exactly the leaves JAX's ``_TP_SHARDED`` selects), both
before the data-axis sync, which runs over the data axis alone.

The JAX package's ``zero_param_specs`` and ``_zero_state_specs`` are
``PartitionSpec`` plumbing for ``shard_map``; each rank here holds its
shard as an ordinary tensor, so they have no counterpart.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import Dict, Iterator, List, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.schedule import P_F, P_S, Schedule


def backward_live_groups(sched: Schedule) -> np.ndarray:
    """[L, G] bool — subnet (l, g) has a live backward (any p_f micro-batch).

    Schedule-global, not per-rank: a subnet live on any rank needs the
    all-reduce on every rank."""
    return (sched.layer_group_view() == P_F).any(axis=-1)


def forward_live_groups(sched: Schedule) -> np.ndarray:
    """[L, G] bool — subnet (l, g) has a live forward (any non-p_s cell);
    the complement is the ZeRO-3 gather-elision set. Superset of
    ``backward_live_groups``."""
    return (sched.layer_group_view() != P_S).any(axis=-1)


@dataclass(frozen=True)
class SyncSpec:
    """Per-leaf gradient synchronization recipe (see module docstring)."""
    mode: str                                  # all | none | sliced | zero
    axis: int = 0                              # sliced/zero: partition axis
    live: Tuple[bool, ...] = ()                # per-group backward liveness
    gather: Tuple[bool, ...] = ()              # zero: param all-gather mask
    shards: int = 0                            # zero: data-mesh size k


_ALL = SyncSpec("all")
_NONE = SyncSpec("none")

# Leaf name -> axis holding the G contiguous head-group blocks. Matches the
# group decomposition of the masked path (models/transformer.py
# _group_project / _apply_ffn) and the packed path's column / row slices.
_Q_AXIS = {"wq": 1, "bq": 0, "wo": 0}
_KV_AXIS = {"wk": 1, "bk": 0, "wv": 1, "bv": 0}
_FFN_AXIS = {"w_up": 1, "w_gate": 1, "w_down": 0}


def _sliceable_axis(name: str, shape: Tuple[int, ...], cfg: ModelConfig,
                    G: int):
    """Axis of the G group blocks in this leaf, or None (coarse leaf)."""
    axis = None
    if name in _Q_AXIS:
        axis = _Q_AXIS[name]
    elif name in _KV_AXIS:
        # KV columns align with query groups only when every group owns a
        # whole number of kv heads; shared kv heads receive gradients from
        # several groups -> coarse.
        if cfg.n_kv_heads % G == 0:
            axis = _KV_AXIS[name]
    elif name in _FFN_AXIS and len(shape) == 2:
        axis = _FFN_AXIS[name]
    if axis is None or shape[axis] % G != 0:
        return None
    return axis


def _leaf_spec(name: str, shape: Tuple[int, ...], live_g: np.ndarray,
               cfg: ModelConfig, protected: bool) -> SyncSpec:
    """Spec for one block leaf given its layer's [G] liveness."""
    if protected or live_g.all():
        return _ALL
    if not live_g.any():
        return _NONE
    axis = _sliceable_axis(name, shape, cfg, len(live_g))
    if axis is None:
        return _ALL          # partially live, not group-sliceable
    return SyncSpec("sliced", axis=axis, live=tuple(bool(x) for x in live_g))


def _zero_axis(name: str, shape: Tuple[int, ...], cfg: ModelConfig, G: int,
               k: int):
    """(partition axis, groups along it) for a zero leaf, or None.

    Group-sliceable leaves keep mask granularity G when every group block
    splits evenly over the k shards; otherwise the leaf is partitioned
    coarse (one run spanning the largest evenly divisible axis)."""
    axis = _sliceable_axis(name, shape, cfg, G)
    if axis is not None and (shape[axis] // G) % k == 0:
        return axis, G
    divisible = [a for a in range(len(shape)) if shape[a] % k == 0]
    if not divisible:
        return None
    return max(divisible, key=lambda a: shape[a]), 1


def _zero_leaf_spec(name: str, shape: Tuple[int, ...], live_g: np.ndarray,
                    ever_g: np.ndarray, fwd_g: np.ndarray, cfg: ModelConfig,
                    protected: bool, k: int, elide_gather: bool,
                    zero3: bool) -> SyncSpec:
    """Zero-mode spec for one leaf: partition + (live, gather) masks; the
    masked spec when no axis splits evenly. zero3 takes forward liveness
    as the gather mask (the full view is rebuilt from the shards every
    step, so staleness and elidability cannot arise)."""
    part = _zero_axis(name, shape, cfg, len(live_g), k)
    if part is None:
        return _leaf_spec(name, shape, live_g, cfg, protected)
    axis, groups = part
    if protected:
        live_g = np.ones_like(live_g)
    if zero3:
        gather_g = fwd_g | live_g
    else:
        gather_g = live_g | ever_g if elide_gather \
            else np.ones_like(live_g, bool)
    if groups == 1:
        # coarse partition: the mask collapses to the whole block, which
        # is elidable under zero3 only when every group is forward-dead
        live_g = np.atleast_1d(live_g.any())
        gather_g = np.atleast_1d(gather_g.any())
    return SyncSpec("zero", axis=axis, shards=k,
                    live=tuple(bool(x) for x in live_g),
                    gather=tuple(bool(x) for x in gather_g))


def _named(model_or_named_params) -> Mapping[str, torch.Tensor]:
    if isinstance(model_or_named_params, torch.nn.Module):
        return dict(model_or_named_params.named_parameters())
    return model_or_named_params


def grad_sync_plan(model_or_named_params, cfg: ModelConfig, sched: Schedule,
                   mode: str = "masked", *, n_shards: int = 0,
                   ever_live: Optional[np.ndarray] = None,
                   elide_gather: bool = True) -> Dict[str, SyncSpec]:
    """{parameter name: SyncSpec} for a model or a name -> tensor mapping
    (anything with ``.shape``: the full, canonical shapes), under
    ``sched``. Host-side numpy over the schedule table: a new schedule
    means a new plan.

    mode="masked": the masked plan. mode="zero": the ZeRO-1 plan over
    ``n_shards`` ranks; ``ever_live`` is an optional [L, G] bool of groups
    backward-live under any earlier plan since the moments were last zero
    (their parameters must still be gathered); ``elide_gather=False``
    (an optimizer that is not ``elidable``) forces a full gather mask.
    mode="zero3": the same partition with the forward mask as the gather
    mask; ``ever_live`` and ``elide_gather`` are ignored."""
    if mode not in ("masked", "zero", "zero3"):
        raise ValueError(f"unknown sync plan mode {mode!r}")
    if mode != "masked" and n_shards < 1:
        raise ValueError(f"{mode} mode needs n_shards")
    named = _named(model_or_named_params)
    live = backward_live_groups(sched)                       # [L, G]
    if live.shape[0] != cfg.n_layers:
        raise ValueError(f"schedule has {live.shape[0]} layers, the config "
                         f"{cfg.n_layers}")
    ever = np.zeros_like(live) if ever_live is None \
        else np.asarray(ever_live, bool)
    if ever.shape != live.shape:
        raise ValueError(f"ever_live {ever.shape} != {live.shape}")
    fwd = forward_live_groups(sched) if mode == "zero3" \
        else np.zeros_like(live)
    zero = mode != "masked"
    one = np.ones(1, bool)
    moe_layers = {n.split(".")[1] for n in named
                  if n.startswith("layers.") and n.split(".")[2] == "moe"}
    plan = {}
    for name, p in named.items():
        parts = name.split(".")
        shape = tuple(p.shape)
        if parts[0] != "layers":
            # embed / unembed / final_norm / frontend_proj: gradients flow
            # through every sample's loss path — never skipped (zero modes:
            # always scattered, always gathered)
            plan[name] = _zero_leaf_spec("", shape, one, one, one, cfg, True,
                                         n_shards, True, False) \
                if zero else _ALL
            continue
        path, layer = parts[2:], int(parts[1])
        # the MoE router's aux losses are computed from norm2(x) whatever
        # the gates, so an MoE block's FFN side keeps the full sync
        protected = "moe" in path or (parts[1] in moe_layers
                                      and path[0] == "norm2")
        if zero:
            plan[name] = _zero_leaf_spec(
                path[-1], shape, live[layer], ever[layer], fwd[layer], cfg,
                protected, n_shards, elide_gather, mode == "zero3")
        else:
            plan[name] = _leaf_spec(path[-1], shape, live[layer], cfg,
                                    protected)
    return plan


# ------------------------------------------------------------- application
def _runs(live: Tuple[bool, ...]):
    """Merge consecutive equal-liveness groups into (live, start, stop)."""
    out = []
    start = 0
    for g in range(1, len(live) + 1):
        if g == len(live) or live[g] != live[start]:
            out.append((live[start], start, g))
            start = g
    return out


def _live_views(t: torch.Tensor, spec: SyncSpec) -> Iterator[torch.Tensor]:
    """The views of ``t`` that the plan averages: the whole leaf, nothing,
    or each live run of group blocks along the spec's axis (nothing for a
    zero leaf, which the reduce-scatter carries)."""
    if spec.mode == "all":
        yield t
    elif spec.mode == "sliced":
        size = t.shape[spec.axis] // len(spec.live)
        for is_live, start, stop in _runs(spec.live):
            if is_live:
                yield t.narrow(spec.axis, start * size, (stop - start) * size)
    elif spec.mode not in ("none", "zero"):
        raise ValueError(f"unknown sync spec mode {spec.mode!r}")


def _sync_device(mesh):
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)


@contextlib.contextmanager
def _clock(mesh):
    """Adds the host-clock seconds of the block to ``mesh.counter``, from
    the end of the work queued before it (the device is synchronised at
    both ends)."""
    _sync_device(mesh)
    t0 = time.perf_counter()
    yield
    _sync_device(mesh)
    mesh.counter.seconds += time.perf_counter() - t0


def _bucketed_sum_(views: List[torch.Tensor], mesh, kind: str,
                   mean: bool = False):
    """Sum ``views`` over the mesh's ranks in place (divided by their
    number where ``mean``), through one flat bucket per dtype and one
    ``all_reduce`` each, counted under ``kind``."""
    by_dtype: Dict[torch.dtype, list] = {}
    for v in views:
        by_dtype.setdefault(v.dtype, []).append(v)
    for dtype, vs in by_dtype.items():
        n = sum(v.numel() for v in vs)
        bucket = torch.empty(n, dtype=dtype, device=mesh.device)
        off = 0
        for v in vs:
            bucket[off:off + v.numel()].view(v.shape).copy_(v)
            off += v.numel()
        mesh.counted(kind, bucket.numel() * bucket.element_size(),
                     lambda: mesh.all_reduce_(bucket))
        if mean:
            bucket.div_(mesh.size)
        off = 0
        for v in vs:
            v.copy_(bucket[off:off + v.numel()].view(v.shape))
            off += v.numel()
        del bucket


def _all_reduce_live_(tensors: Mapping[str, torch.Tensor], plan, mesh,
                      kind: str = "all_reduce"):
    """Average the plan's live views of ``tensors`` over the mesh's ranks,
    in place, through one flat bucket per dtype and one ``all_reduce``
    each, counted under ``kind``."""
    _bucketed_sum_([v for name, spec in plan.items()
                    for v in _live_views(tensors[name], spec)], mesh,
                   kind, mean=True)


@torch.no_grad()
def sum_over_axis_(tensors, mesh, kind: str):
    """Sum ``tensors`` (a list) over the ranks of ``mesh`` (one axis) in
    place, one flat bucket per dtype, counted under ``kind``: the stage
    axis's gradient reassembly and the tensor axis's gradient sync."""
    _bucketed_sum_(list(tensors), mesh, kind)
    return tensors


# ------------------------------------------------ tensor-axis grad combine
# Leaves whose COMPUTE shards over the tensor axis (attention head blocks,
# FFN column blocks: the ``tp`` branches of models.transformer). Their local
# grads are disjoint slices of the true grad (zero outside this rank's
# block), so a sum over the tensor axis reassembles the full tensor. Every
# other leaf's compute is replicated across the axis (identical grads after
# the f operator's backward all-reduces the activation cotangent), so it
# must NOT be summed. MoE reuses the w_up / w_gate / w_down names but runs
# replicated, hence the parent-key rule.
_TP_SHARDED = {
    "attn": {"wq", "wk", "wv", "wo", "bq", "bk", "bv"},
    "mlp": {"w_up", "w_gate", "w_down"},
}


def tensor_sharded(name: str) -> bool:
    """Whether the flat parameter ``name`` (``layers.<l>.attn.wq`` ...) is
    one the tensor axis shards: its parent key decides."""
    parts = name.split(".")
    return len(parts) >= 2 and parts[-1] in _TP_SHARDED.get(parts[-2], ())


def apply_tensor_grad_sync(grads: Mapping[str, torch.Tensor], mesh):
    """Sum the tensor-sharded grad leaves over ``mesh`` (the tensor axis)
    in place, one bucket per dtype, counted under ``tp_grad``; replicated
    leaves pass through. Runs before the data-axis sync, which then sees
    full grads. Returns the grads."""
    sum_over_axis_([g for n, g in grads.items() if tensor_sharded(n)], mesh,
                   "tp_grad")
    return grads


@torch.no_grad()
def _mean_live_(tensors: Mapping[str, torch.Tensor], plan, mesh,
                kind: str = "all_reduce"):
    """``_all_reduce_live_`` adding the bytes sent to ``mesh.counter``,
    and the host-clock seconds of the whole sync, bucket copies
    included."""
    with _clock(mesh):
        _all_reduce_live_(tensors, plan, mesh, kind)


def apply_grad_sync(grads: Mapping[str, torch.Tensor], plan, mesh):
    """Masked mean: all-reduce exactly the live slices of the grads, in
    place. Skipped leaves and slices are identically zero on every rank,
    so leaving them alone leaves them, correctly, at the global value.
    Returns the grads."""
    _mean_live_(grads, plan, mesh)
    return grads


# ------------------------------------------------------ lo-fi local sync
def stack_replicas(named: Mapping[str, torch.Tensor], n: int
                   ) -> Dict[str, torch.Tensor]:
    """Replicated tensors -> per-replica stacked copies ([n, ...]): the
    state layout of ``sync_mode="local"`` in one process."""
    return {k: v.detach().unsqueeze(0).expand((n,) + tuple(v.shape)).clone()
            for k, v in named.items()}


def _merge_leaf(x: torch.Tensor, spec: SyncSpec) -> torch.Tensor:
    """[R, ...] stacked replica leaf -> merged leaf: live slices averaged,
    dead slices taken from replica 0 (they are bit-identical on every
    replica, and never need to move)."""
    if spec.mode == "none":
        return x[0].clone()
    if spec.mode == "all":
        return x.mean(dim=0)
    axis = spec.axis + 1                       # leaf axes shift past [R]
    size = x.shape[axis] // len(spec.live)
    parts = []
    for is_live, start, stop in _runs(spec.live):
        seg = x.narrow(axis, start * size, (stop - start) * size)
        parts.append(seg.mean(dim=0) if is_live else seg[0])
    return torch.cat(parts, dim=spec.axis)


@torch.no_grad()
def lofi_merge(stacked: Mapping[str, torch.Tensor], plan
               ) -> Dict[str, torch.Tensor]:
    """Merge per-replica stacked tensors under a masked plan, built from
    the union of every schedule active since the replicas were last in
    sync (a subnet live under any of them may have diverged)."""
    return {k: _merge_leaf(stacked[k], plan[k]) for k in stacked}


def lofi_merge_(named: Mapping[str, torch.Tensor], plan, mesh,
                kind: str = "all_reduce"):
    """The cross-rank merge: each rank holds one replica; the plan's live
    slices are averaged over the ranks through the gradient sync's bucket
    (counted under ``kind``), in place, and every other slice is left as
    it is. Returns ``named``."""
    _mean_live_(named, plan, mesh, kind)
    return named


# -------------------------------------------------------- zero application
def _is_zero(spec) -> bool:
    return spec.mode == "zero"


def _zero_runs(spec: SyncSpec):
    """Merge consecutive groups with equal (live, gather) into (live,
    gather, start_group, stop_group) runs. Run boundaries define the shard
    layout: for each run, rank d owns its d-th sub-chunk, and the rank's
    shard is the concatenation of those sub-chunks in run order."""
    out = []
    start = 0
    n = len(spec.live)
    for g in range(1, n + 1):
        if g == n or (spec.live[g], spec.gather[g]) != \
                (spec.live[start], spec.gather[start]):
            out.append((spec.live[start], spec.gather[start], start, g))
            start = g
    return out


class _Run(NamedTuple):
    """One run of a zero leaf along its partition axis: its flags, its
    canonical start and length, each rank's sub-chunk length, and the
    sub-chunk's offset in a rank's shard."""
    live: bool
    gather: bool
    start: int
    length: int
    plen: int
    off: int


def _run_layout(spec: SyncSpec, axis_len: int) -> List[_Run]:
    gs = axis_len // len(spec.live)
    out, off = [], 0
    for live, gather, s, e in _zero_runs(spec):
        plen = (e - s) * gs // spec.shards
        out.append(_Run(live, gather, s * gs, (e - s) * gs, plen, off))
        off += plen
    return out


def _resized(shape, axis: int, n: int) -> Tuple[int, ...]:
    out = list(shape)
    out[axis] = n
    return tuple(out)


def _full_shape(shard_shape, spec: SyncSpec) -> Tuple[int, ...]:
    """A zero leaf's canonical shape from a rank's shard shape."""
    if not _is_zero(spec):
        return tuple(shard_shape)
    return _resized(shard_shape, spec.axis, shard_shape[spec.axis]
                    * spec.shards)


def zero_shard_shape(shape, spec: SyncSpec) -> Tuple[int, ...]:
    """A rank's shard shape of a leaf of canonical ``shape``."""
    if not _is_zero(spec):
        return tuple(shape)
    return _resized(shape, spec.axis, shape[spec.axis] // spec.shards)


def _zero_items(plan, shapes, which: Optional[str] = None):
    """(name, spec, run) of every zero leaf's runs in plan order, the
    leaves' canonical shapes from ``shapes``; ``which`` ("live" or
    "gather") keeps the runs whose flag is set."""
    for name, spec in plan.items():
        if not _is_zero(spec):
            continue
        for run in _run_layout(spec, shapes[name][spec.axis]):
            if which is None or getattr(run, which):
                yield name, spec, run


def _by_dtype(items, tensors) -> Dict[torch.dtype, list]:
    groups: Dict[torch.dtype, list] = {}
    for item in items:
        groups.setdefault(tensors[item[0]].dtype, []).append(item)
    return groups


def zero_shard_leaf(x: torch.Tensor, spec: SyncSpec,
                    rank: int) -> torch.Tensor:
    """Canonical leaf -> rank ``rank``'s owned shard: its sub-chunk of
    every run along the partition axis, in run order, as a new contiguous
    tensor (no communication). Other specs: ``x`` itself."""
    if not _is_zero(spec):
        return x
    return torch.cat([x.narrow(spec.axis, r.start + rank * r.plen, r.plen)
                      for r in _run_layout(spec, x.shape[spec.axis])],
                     dim=spec.axis)


def _scatter_inputs(grads: Mapping[str, torch.Tensor], plan,
                    k: int) -> Dict[torch.dtype, torch.Tensor]:
    """The rank-major reduce-scatter buckets of full local ``grads``, one
    per dtype: rank d's segment is its sub-chunk of every live run, leaf
    by leaf in plan order."""
    shapes = {n: tuple(g.shape) for n, g in grads.items()}
    out = {}
    for dtype, items in _by_dtype(_zero_items(plan, shapes, "live"),
                                  grads).items():
        subs = [[grads[n].narrow(sp.axis, r.start + d * r.plen, r.plen)
                 for n, sp, r in items] for d in range(k)]
        bucket = torch.empty(sum(v.numel() for v in subs[0]) * k,
                             dtype=dtype, device=subs[0][0].device)
        off = 0
        for views in subs:
            for v in views:
                bucket[off:off + v.numel()].view(v.shape).copy_(v)
                off += v.numel()
        out[dtype] = bucket
    return out


def _scatter_outputs(outs: Mapping[torch.dtype, torch.Tensor],
                     grads: Mapping[str, torch.Tensor], plan,
                     rank: int) -> Dict[str, torch.Tensor]:
    """Rank ``rank``'s shards of every zero leaf's gradient: its reduced
    segment ``outs[dtype]`` (already the mean) at live runs, its own
    sub-chunk of the local gradient at dead runs (exact zeros on every
    rank, so already the global value)."""
    shapes = {n: tuple(g.shape) for n, g in grads.items()}
    shards = {n: torch.empty(zero_shard_shape(shapes[n], sp),
                             dtype=grads[n].dtype, device=grads[n].device)
              for n, sp in plan.items() if _is_zero(sp)}
    for n, sp, r in _zero_items(plan, shapes):
        if not r.live:
            shards[n].narrow(sp.axis, r.off, r.plen).copy_(
                grads[n].narrow(sp.axis, r.start + rank * r.plen, r.plen))
    for dtype, items in _by_dtype(_zero_items(plan, shapes, "live"),
                                  grads).items():
        seg, off = outs[dtype], 0
        for n, sp, r in items:
            dst = shards[n].narrow(sp.axis, r.off, r.plen)
            dst.copy_(seg[off:off + dst.numel()].view(dst.shape))
            off += dst.numel()
    return shards


def _gather_inputs(shards: Mapping[str, torch.Tensor], plan, shapes,
                   which: Optional[str] = "gather"
                   ) -> Dict[torch.dtype, torch.Tensor]:
    """This rank's all-gather buckets, one per dtype: its sub-chunk of
    every run in ``which``'s mask (every run for None), leaf by leaf in
    plan order. ``shapes``: the leaves' canonical shapes."""
    out = {}
    for dtype, items in _by_dtype(_zero_items(plan, shapes, which),
                                  shards).items():
        views = [shards[n].narrow(sp.axis, r.off, r.plen)
                 for n, sp, r in items]
        bucket = torch.empty(sum(v.numel() for v in views), dtype=dtype,
                             device=views[0].device)
        off = 0
        for v in views:
            bucket[off:off + v.numel()].view(v.shape).copy_(v)
            off += v.numel()
        out[dtype] = bucket
    return out


def _gather_outputs(outs: Mapping[torch.dtype, torch.Tensor],
                    fulls: Mapping[str, torch.Tensor], plan, k: int,
                    which: Optional[str] = "gather"):
    """Write the gathered buckets (the k ranks' segments in rank order)
    into the canonical ``fulls``, in place: rank d's sub-chunk of each run
    goes to the run's d-th place along the partition axis."""
    shapes = {n: tuple(f.shape) for n, f in fulls.items()}
    for dtype, items in _by_dtype(_zero_items(plan, shapes, which),
                                  fulls).items():
        out, off = outs[dtype], 0
        for d in range(k):
            for n, sp, r in items:
                dst = fulls[n].narrow(sp.axis, r.start + d * r.plen, r.plen)
                dst.copy_(out[off:off + dst.numel()].view(dst.shape))
                off += dst.numel()


def _reduce_scatter(grads, plan, mesh) -> Dict[str, torch.Tensor]:
    k = mesh.size
    outs = {}
    for dtype, inp in _scatter_inputs(grads, plan, k).items():
        out = torch.empty(inp.numel() // k, dtype=dtype, device=inp.device)
        mesh.counted("reduce_scatter", inp.numel() * inp.element_size(),
                     lambda: mesh.reduce_scatter_(out, inp))
        outs[dtype] = out.div_(k)
    return _scatter_outputs(outs, grads, plan, mesh.rank)


def _all_gather(shards, fulls, plan, mesh, which: Optional[str] = "gather",
                kind: str = "all_gather"):
    k = mesh.size
    shapes = {n: tuple(f.shape) for n, f in fulls.items()}
    for dtype, inp in _gather_inputs(shards, plan, shapes, which).items():
        out = torch.empty(inp.numel() * k, dtype=dtype, device=inp.device)
        mesh.counted(kind, out.numel() * out.element_size(),
                     lambda: mesh.all_gather_(out, inp))
        _gather_outputs({dtype: out}, fulls, plan, k, which)


@torch.no_grad()
def apply_zero_scatter(grads: Mapping[str, torch.Tensor], plan, mesh
                       ) -> Dict[str, torch.Tensor]:
    """Local full grads -> mixed dict: this rank's reduced shard (the mean
    over the ranks) at zero leaves, through one ``reduce_scatter_`` a
    dtype; the masked mean, in place, at fallback leaves, through one
    ``all_reduce`` a dtype."""
    with _clock(mesh):
        _all_reduce_live_(grads, plan, mesh)
        shards = _reduce_scatter(grads, plan, mesh)
    return {n: shards.get(n, g) for n, g in grads.items()}


def zero_shard_params(params: Mapping[str, torch.Tensor], plan,
                      rank: int) -> Dict[str, torch.Tensor]:
    """Replicated params -> this rank's owned shards (copies) at zero
    leaves, the parameters themselves elsewhere (no communication)."""
    with torch.no_grad():
        return {n: zero_shard_leaf(p, plan[n], rank)
                for n, p in params.items()}


@torch.no_grad()
def apply_zero_gather(updated: Mapping[str, torch.Tensor],
                      params: Mapping[str, torch.Tensor], plan, mesh):
    """ZeRO-1's schedule-masked all-gather: the gathered runs of the
    updated shards are written into the replicated ``params``, in place;
    runs outside the mask keep their values on every rank (zero grad,
    zero moments, an elidable update). Returns ``params``."""
    with _clock(mesh):
        _all_gather(updated, params, plan, mesh)
    return params


def _empty_fulls(shards, plan) -> Dict[str, torch.Tensor]:
    return {n: torch.empty(_full_shape(t.shape, plan[n]), dtype=t.dtype,
                           device=t.device)
            for n, t in shards.items() if _is_zero(plan[n])}


@torch.no_grad()
def zero3_materialize(shards: Mapping[str, torch.Tensor], plan, mesh
                      ) -> Dict[str, torch.Tensor]:
    """Sharded params -> full views for the step: the runs in the gather
    mask all-gathered (one ``all_gather_`` a dtype), the elided runs
    zeros; fallback leaves passed through."""
    fulls = _empty_fulls(shards, plan)
    shapes = {n: tuple(f.shape) for n, f in fulls.items()}
    for n, sp, r in _zero_items(plan, shapes):
        if not r.gather:
            fulls[n].narrow(sp.axis, r.start, r.length).zero_()
    with _clock(mesh):
        _all_gather(shards, fulls, plan, mesh)
    return {n: fulls.get(n, t) for n, t in shards.items()}


@torch.no_grad()
def _zero_unshard(shards: Mapping[str, torch.Tensor], plan, mesh,
                 kind: str = "reshard") -> Dict[str, torch.Tensor]:
    """This rank's shards (parameters or moments) -> canonical full
    tensors on every rank: every run all-gathered, counted under
    ``kind`` (not a step's sync); other leaves passed through."""
    fulls = _empty_fulls(shards, plan)
    with _clock(mesh):
        _all_gather(shards, fulls, plan, mesh, which=None, kind=kind)
    return {n: fulls.get(n, t) for n, t in shards.items()}


def zero_norm_sq(grads: Mapping[str, torch.Tensor], plan):
    """(shard_sq, full_sq): squared-norm contributions of a mixed grads
    dict, in plan order. ``shard_sq`` sums zero-leaf shards (disjoint
    across ranks: a scalar all-reduce completes them); ``full_sq`` sums
    the fallback leaves, identical on every rank."""
    dev = next(iter(grads.values())).device
    shard_sq = torch.zeros((), dtype=torch.float32, device=dev)
    full_sq = torch.zeros((), dtype=torch.float32, device=dev)
    for n, spec in plan.items():
        sq = torch.sum(grads[n].float() ** 2)
        if _is_zero(spec):
            shard_sq = shard_sq + sq
        else:
            full_sq = full_sq + sq
    return shard_sq, full_sq


# ------------------------------------------------- ZeRO-3 model state
def _owner(model: torch.nn.Module, name: str):
    """(module, attribute) holding parameter ``name``."""
    path, _, attr = name.rpartition(".")
    return (model.get_submodule(path) if path else model), attr


@contextlib.contextmanager
def installed(model: torch.nn.Module, tensors: Mapping[str, torch.Tensor]):
    """Inside the block the model's layers read ``tensors`` (name ->
    tensor) where they read those parameters; the parameters are put
    back on exit."""
    saved = []
    try:
        for n, t in tensors.items():
            mod, attr = _owner(model, n)
            saved.append((mod, attr, mod._parameters[attr]))
            mod._parameters[attr] = t
        yield
    finally:
        for mod, attr, p in reversed(saved):
            mod._parameters[attr] = p


@torch.no_grad()
def zero3_shard_model_(model: torch.nn.Module, plan, rank: int):
    """Canonical full parameters -> this rank's shards, in place: each
    zero leaf's ``Parameter`` then holds its shard (a new tensor; the full
    storage is freed), fallback leaves stay whole. No communication."""
    for n, p in model.named_parameters():
        if _is_zero(plan[n]):
            p.data = zero_shard_leaf(p.data, plan[n], rank)


@torch.no_grad()
def zero3_unshard_model_(model: torch.nn.Module, plan, mesh,
                         kind: str = "reshard"):
    """The inverse of ``zero3_shard_model_`` on every rank: every run of
    every zero leaf all-gathered into canonical full parameters."""
    params = dict(model.named_parameters())
    fulls = _zero_unshard({n: p.data for n, p in params.items()}, plan, mesh,
                         kind)
    for n, p in params.items():
        if _is_zero(plan[n]):
            p.data = fulls[n]


# ------------------------------------------------ streamed materialization
class ResidencyRecorder:
    """Run-time counter of the bytes each residency unit all-gathers.

    The streamed materializer reports every gathered run as ``record(unit,
    site, nbytes)``; sites are keyed (not summed), so a second step under
    the same plan changes nothing. ``unit_bytes()`` is the *measured* side
    of the residency model, which ``check_zero3_residency`` holds to
    ``zero3_param_byte_report``."""

    def __init__(self):
        self.sites: dict = {}            # unit -> {site_key: bytes}

    def record(self, unit: str, site: str, nbytes: float):
        self.sites.setdefault(unit, {})[site] = float(nbytes)

    def unit_bytes(self) -> dict:
        return {u: float(sum(s.values())) for u, s in self.sites.items()}


# Loss-path subtrees consumed before the layers in the forward; everything
# else outside the layers runs after them, the final norm before the
# unembedding (JAX's parameter order, whatever order the caller's names
# come in)
_HEAD_KEYS = ("embed", "frontend_proj")
_TAIL_KEYS = ("final_norm", "unembed")


def _unit_of(name: str) -> str:
    """The residency unit of a parameter: ``layers.<l>`` for a layer's,
    else its top-level key (``embed``, ``final_norm``, ``unembed``,
    ``frontend_proj``)."""
    parts = name.split(".")
    return f"layers.{parts[1]}" if parts[0] == "layers" else parts[0]


def _units(names) -> Dict[str, List[str]]:
    """{unit: its parameter names}, ordered as the forward runs them: the
    head loss-path units, the layers in layer order, then the rest (the
    final norm, then the unembedding)."""
    units: Dict[str, List[str]] = {}
    for n in names:
        units.setdefault(_unit_of(n), []).append(n)
    head = [u for u in units if u in _HEAD_KEYS]
    layers = sorted((u for u in units if u.startswith("layers.")),
                    key=lambda u: int(u.split(".")[1]))
    tail = sorted((u for u in units if u not in head and u not in layers),
                  key=lambda u: _TAIL_KEYS.index(u) if u in _TAIL_KEYS
                  else len(_TAIL_KEYS))
    return {u: units[u] for u in head + layers + tail}


class _Unit:
    """One residency unit of the streamed ZeRO-3 step."""

    def __init__(self, name, names, plan, mesh, recorder):
        self.name, self.names, self.mesh = name, names, mesh
        self.plan = {n: plan[n] for n in names}
        self.recorder = recorder

    def gather(self, tensors):
        shards = dict(zip(self.names, tensors))
        fulls = zero3_materialize(shards, self.plan, self.mesh)
        if self.recorder is not None:
            shapes = {n: tuple(fulls[n].shape) for n in self.names}
            for n, sp, r in _zero_items(self.plan, shapes, "gather"):
                row = fulls[n].numel() // shapes[n][sp.axis] * \
                    fulls[n].element_size()
                self.recorder.record(self.name,
                                     f"{n}[{r.start}:{r.start + r.length}]",
                                     r.length * row)
        return [fulls[n] if _is_zero(self.plan[n]) else t.view_as(t)
                for n, t in shards.items()]

    def scatter(self, cts):
        grads = {n: g if _is_zero(self.plan[n]) else g.clone()
                 for n, g in zip(self.names, cts)}
        mixed = apply_zero_scatter(grads, self.plan, self.mesh)
        return [mixed[n] for n in self.names]


class _StreamUnit(torch.autograd.Function):
    """Forward: the unit's schedule-masked all-gather (fallback leaves
    pass through). Backward: its reduce-scatter onto the owning shards
    (the masked mean for fallback leaves), where the backward releases
    the unit's gradient."""

    @staticmethod
    def forward(ctx, unit: _Unit, *tensors):
        ctx.unit = unit
        return tuple(unit.gather(tensors))

    @staticmethod
    def backward(ctx, *cts):
        return (None,) + tuple(ctx.unit.scatter(cts))


@contextlib.contextmanager
def zero3_stream_materialize(model: torch.nn.Module, plan, mesh, *,
                             recorder: Optional[ResidencyRecorder] = None):
    """The streamed ZeRO-3 schedule over a model whose zero leaves hold
    this rank's shards (``zero3_shard_model_``). Inside the block, each
    residency unit is materialized when the forward reaches it: the head
    loss-path units on entry, each layer by a forward pre-hook on its
    block, the other loss-path units by a forward hook on the last block;
    every unit goes through one ``_StreamUnit``, so the gradient of a
    shard (or fallback leaf) that autograd returns is already the
    scattered (or masked-mean) one, sent as that unit's backward runs.
    Values equal ``zero3_materialize`` + ``apply_zero_scatter`` bit for
    bit. ``recorder`` counts each unit's gathered bytes."""
    params = dict(model.named_parameters())
    units = _units(params)
    done, handles = set(), []

    def materialize(unit):
        if unit in done or unit not in units:
            return
        done.add(unit)
        names = units[unit]
        views = _StreamUnit.apply(_Unit(unit, names, plan, mesh, recorder),
                                  *[params[n] for n in names])
        for n, v in zip(names, views):
            mod, attr = _owner(model, n)
            mod._parameters[attr] = v

    def pre_hook(unit):
        def hook(module, args):
            materialize(unit)
        return hook

    def tail_hook(module, args, output):
        for u in units:
            if not u.startswith("layers."):
                materialize(u)

    try:
        for u in units:
            if u in _HEAD_KEYS:
                materialize(u)
        for i, block in enumerate(model.layers):
            handles.append(block.register_forward_pre_hook(
                pre_hook(f"layers.{i}")))
        handles.append(model.layers[-1].register_forward_hook(tail_hook))
        yield
        if set(units) - done:
            raise RuntimeError(f"the forward did not reach the units "
                               f"{sorted(set(units) - done)}")
    finally:
        for h in handles:
            h.remove()
        for n, p in params.items():
            mod, attr = _owner(model, n)
            mod._parameters[attr] = p


# ------------------------------------------------------------- accounting
def _nbytes(p) -> int:
    return int(np.prod(tuple(p.shape))) * \
        torch.empty((), dtype=p.dtype).element_size()


def _mask_bytes(nbytes: int, mask: Tuple[bool, ...]) -> int:
    return nbytes // len(mask) * sum(mask)


def _live_bytes(nbytes: int, spec: SyncSpec) -> int:
    if spec.mode == "all":
        return nbytes
    if spec.mode == "none":
        return 0
    return _mask_bytes(nbytes, spec.live)


def _gather_fraction(spec: SyncSpec) -> float:
    if _is_zero(spec):
        return float(sum(spec.gather)) / len(spec.gather)
    return 0.0


def sync_byte_report(plan, named, n_shards: Optional[int] = None) -> dict:
    """Price the plan over ``named`` (name -> tensor, or anything with
    ``shape`` and ``dtype``: the canonical shapes). Masked leaves add
    their live bytes to ``ar_bytes`` (what ``apply_grad_sync`` hands to
    its all-reduce); zero leaves add their live runs' bytes to
    ``rs_bytes`` (the reduce-scatter's input) and their gathered runs'
    to ``ag_bytes`` (the all-gather's output). ``synced_bytes`` counts a
    zero leaf's pair as the mean of the two, so ``fraction`` stays
    comparable across modes. With ``n_shards`` > 1, ``wire`` is the
    per-rank ring traffic (2·(k-1)/k per all-reduce byte, (k-1)/k per
    reduce-scatter or all-gather byte). ``n_leaves`` counts the port's
    unstacked parameters."""
    totals = {"total_bytes": 0.0, "synced_bytes": 0.0, "ar_bytes": 0.0,
              "rs_bytes": 0.0, "ag_bytes": 0.0, "n_leaves": 0,
              "n_skipped": 0, "n_sliced": 0, "n_zero": 0}
    for name, spec in plan.items():
        nbytes = _nbytes(named[name])
        totals["total_bytes"] += float(nbytes)
        totals["n_leaves"] += 1
        if _is_zero(spec):
            rs = float(_mask_bytes(nbytes, spec.live))
            ag = float(_mask_bytes(nbytes, spec.gather))
            totals["rs_bytes"] += rs
            totals["ag_bytes"] += ag
            totals["synced_bytes"] += (rs + ag) / 2.0
            totals["n_zero"] += 1
            continue
        live = float(_live_bytes(nbytes, spec))
        totals["ar_bytes"] += live
        totals["synced_bytes"] += live
        if spec.mode == "none":
            totals["n_skipped"] += 1
        elif spec.mode == "sliced":
            totals["n_sliced"] += 1
    totals["fraction"] = (totals["synced_bytes"] / totals["total_bytes"]
                          if totals["total_bytes"] else 1.0)
    if n_shards is not None and n_shards > 1:
        k = n_shards
        wire = {"all_reduce": 2.0 * (k - 1) / k * totals["ar_bytes"],
                "reduce_scatter": (k - 1) / k * totals["rs_bytes"],
                "all_gather": (k - 1) / k * totals["ag_bytes"]}
        wire["total"] = sum(wire.values())
        totals["wire"] = wire
    return totals


def zero_state_byte_report(plan, named, n_shards: int,
                           n_moments: int = 1) -> dict:
    """Per-rank optimizer-moment memory under the plan's partition: zero
    leaves keep 1/k of each moment copy a rank, fallback leaves stay
    replicated. ``fraction`` is per-rank bytes over the replicated
    baseline, the ZeRO-1 memory claim."""
    totals = {"replicated_bytes": 0.0, "per_device_bytes": 0.0,
              "n_partitioned": 0, "n_replicated": 0}
    for name, spec in plan.items():
        size = float(_nbytes(named[name]))
        totals["replicated_bytes"] += size
        if _is_zero(spec):
            totals["per_device_bytes"] += size / n_shards
            totals["n_partitioned"] += 1
        else:
            totals["per_device_bytes"] += size
            totals["n_replicated"] += 1
    for key in ("replicated_bytes", "per_device_bytes"):
        totals[key] *= n_moments
    totals["n_shards"] = n_shards
    totals["fraction"] = (totals["per_device_bytes"]
                          / totals["replicated_bytes"]
                          if totals["replicated_bytes"] else 1.0)
    return totals


def zero3_unit_schedule(plan, named) -> List[Tuple[str, float]]:
    """Ordered [(unit, gathered bytes)] in forward order: the head
    loss-path units (embeddings), the layers in layer order
    (``layers.<l>``: JAX's ``cycles[i][c]`` for l = c*P + i and
    ``rest[i]`` for l = n_cycles*P + i), then the other loss-path units.
    The units the streamed materializer gathers; the names the
    ``ResidencyRecorder`` measures."""
    return [(u, sum(float(_nbytes(named[n])) * _gather_fraction(plan[n])
                    for n in names if _is_zero(plan[n])))
            for u, names in _units(plan).items()]


def zero3_param_byte_report(plan, named, n_shards: int) -> dict:
    """Residency-window memory model of the ZeRO-3 partition.

    Persistent per-rank bytes: the owned shards (1/k of every zero leaf)
    and the replicated fallback leaves. Transient: the full views the step
    materializes, priced per residency unit (a layer, or a loss-path
    subtree) under the gather mask, elided runs costing nothing.
    ``per_device_peak_bytes`` prices the streamed schedule (one unit at a
    time); ``fraction`` = peak / replicated is the ZeRO-3 memory claim;
    ``n_gather_elided`` counts the runs whose all-gather the schedule
    killed."""
    totals = {"replicated_bytes": 0.0, "shard_bytes": 0.0,
              "fallback_bytes": 0.0, "gathered_bytes": 0.0,
              "elided_bytes": 0.0, "n_runs": 0, "n_gather_elided": 0,
              "n_partitioned": 0, "n_fallback": 0}
    for name, spec in plan.items():
        size = float(_nbytes(named[name]))
        totals["replicated_bytes"] += size
        if not _is_zero(spec):
            totals["fallback_bytes"] += size
            totals["n_fallback"] += 1
            continue
        totals["shard_bytes"] += size / n_shards
        totals["n_partitioned"] += 1
        for _, gather, s, e in _zero_runs(spec):
            frac = (e - s) / len(spec.live)
            totals["n_runs"] += 1
            if gather:
                totals["gathered_bytes"] += size * frac
            else:
                totals["n_gather_elided"] += 1
                totals["elided_bytes"] += size * frac
    units = dict(zero3_unit_schedule(plan, named))
    totals["peak_unit_bytes"] = max(units.values()) if units else 0.0
    totals["peak_unit"] = max(units, key=units.get) if units else ""
    totals["per_device_peak_bytes"] = (totals["shard_bytes"]
                                       + totals["fallback_bytes"]
                                       + totals["peak_unit_bytes"])
    totals["fraction"] = (totals["per_device_peak_bytes"]
                          / totals["replicated_bytes"]
                          if totals["replicated_bytes"] else 1.0)
    totals["n_shards"] = n_shards
    return totals


def check_zero3_residency(recorder: ResidencyRecorder, plan, named,
                          n_shards: int, *, tol: float = 0.05) -> dict:
    """Fail if the streamed schedule's measured gathers and the residency
    model disagree beyond ``tol`` (relative): every unit is compared,
    units the model does not know are an error, and the derived
    ``per_device_peak_bytes`` must agree. Returns the measured side."""
    report = zero3_param_byte_report(plan, named, n_shards)
    measured = recorder.unit_bytes()
    model = dict(zero3_unit_schedule(plan, named))

    def close(a, b):
        return abs(a - b) <= tol * max(abs(a), abs(b), 1.0)

    unknown = set(measured) - set(model)
    assert not unknown, f"streamed schedule gathered unknown units {unknown}"
    for name, want in model.items():
        got = measured.get(name, 0.0)
        assert close(got, want), \
            f"unit {name}: measured {got:.0f}B vs model {want:.0f}B"
    peak_meas = max(measured.values()) if measured else 0.0
    assert close(peak_meas, report["peak_unit_bytes"]), \
        (peak_meas, report["peak_unit_bytes"])
    device_peak = (report["shard_bytes"] + report["fallback_bytes"]
                   + peak_meas)
    assert close(device_peak, report["per_device_peak_bytes"]), \
        (device_peak, report["per_device_peak_bytes"])
    return {
        "measured_peak_unit_bytes": peak_meas,
        "measured_peak_unit": (max(measured, key=measured.get)
                               if measured else ""),
        "measured_per_device_peak_bytes": device_peak,
        "model_per_device_peak_bytes": report["per_device_peak_bytes"],
        "peak_agreement": (device_peak / report["per_device_peak_bytes"]
                           if report["per_device_peak_bytes"] else 1.0),
        "n_units_measured": len(measured),
        "n_units_model": len(model),
    }


# ----------------------------------------------- layout / state resharding
def _zero_layout_perm(spec: SyncSpec, axis_len: int) -> np.ndarray:
    """perm[i] = canonical axis index held at position i of the global
    shard-concatenated layout (rank-major, runs in order, the d-th
    sub-chunk of each run for rank d). A bijection over range(axis_len)."""
    perm = np.empty(axis_len, np.int64)
    pos = 0
    for d in range(spec.shards):
        for r in _run_layout(spec, axis_len):
            start = r.start + d * r.plen
            perm[pos:pos + r.plen] = np.arange(start, start + r.plen)
            pos += r.plen
    assert pos == axis_len
    return perm


def _leaf_to_canonical(x: torch.Tensor, spec: SyncSpec) -> torch.Tensor:
    """Global shard-layout tensor -> canonical element order."""
    if not _is_zero(spec):
        return x
    perm = torch.from_numpy(_zero_layout_perm(spec, x.shape[spec.axis]))
    return torch.empty_like(x).index_copy_(spec.axis, perm.to(x.device), x)


def _leaf_from_canonical(x: torch.Tensor, spec: SyncSpec) -> torch.Tensor:
    """Canonical tensor -> the global shard-concatenated layout."""
    if not _is_zero(spec):
        return x
    perm = torch.from_numpy(_zero_layout_perm(spec, x.shape[spec.axis]))
    return x.index_select(spec.axis, perm.to(x.device))


def zero_reshard(tree: Mapping[str, torch.Tensor], old_plan, new_plan
                 ) -> Dict[str, torch.Tensor]:
    """Re-lay out a dict of global (full-size) tensors from one plan's
    shard layout to another's; either plan may be None, meaning the
    canonical layout, so this also converts masked <-> zero state."""
    out = {}
    for n, x in tree.items():
        if old_plan is not None:
            x = _leaf_to_canonical(x, old_plan[n])
        if new_plan is not None:
            x = _leaf_from_canonical(x, new_plan[n])
        out[n] = x
    return out


def _layout_key(spec: Optional[SyncSpec], shape) -> tuple:
    """Two layouts of a rank's tensor are the same iff their keys are:
    canonical whole (no plan, a fallback leaf, or one shard), or the
    runs' boundaries along one axis over k ranks."""
    if spec is None or not _is_zero(spec) or spec.shards == 1:
        return ("canonical",)
    return ("zero", spec.axis, spec.shards,
            tuple((r.start, r.length)
                  for r in _run_layout(spec, shape[spec.axis])))


def zero_relayout(tensors: Mapping[str, torch.Tensor], old_plan, new_plan,
                  mesh, kind: str = "reshard") -> Dict[str, torch.Tensor]:
    """This rank's tensors (moments) from ``old_plan``'s shard layout to
    ``new_plan``'s; either plan None means canonical whole tensors.
    Leaves whose layout does not change are kept; the others are
    all-gathered whole (every run, one ``all_gather_`` a dtype, counted
    under ``kind``) where they were sharded, then cut to the new shard."""
    def spec(plan, n):
        return None if plan is None else plan[n]

    def canonical_shape(n, t):
        s = spec(old_plan, n)
        return _full_shape(t.shape, s) if s is not None else tuple(t.shape)

    moving = [n for n, t in tensors.items()
              if _layout_key(spec(old_plan, n), canonical_shape(n, t))
              != _layout_key(spec(new_plan, n), canonical_shape(n, t))]
    sharded = {n: tensors[n] for n in moving
               if _layout_key(spec(old_plan, n), canonical_shape(
                   n, tensors[n])) != ("canonical",)}
    fulls = _zero_unshard(sharded, {n: old_plan[n] for n in sharded}, mesh,
                         kind) if sharded else {}
    out = dict(tensors)
    for n in moving:
        full = fulls.get(n, tensors[n])
        new = spec(new_plan, n)
        out[n] = full if new is None else zero_shard_leaf(full, new,
                                                          mesh.rank)
    return out
