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

The ZeRO-1 / ZeRO-3 half of the JAX module comes with the ZeRO slice.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.schedule import P_F, P_S, Schedule
from repro_torch.launch.parallel import not_ported


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
    mode: str                                  # all | none | sliced
    axis: int = 0                              # sliced: partition axis
    live: Tuple[bool, ...] = ()                # per-group backward liveness


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


def _named(model_or_named_params) -> Mapping[str, torch.Tensor]:
    if isinstance(model_or_named_params, torch.nn.Module):
        return dict(model_or_named_params.named_parameters())
    return model_or_named_params


def grad_sync_plan(model_or_named_params, cfg: ModelConfig, sched: Schedule,
                   mode: str = "masked") -> Dict[str, SyncSpec]:
    """{parameter name: SyncSpec} for a model or a name -> tensor mapping
    (anything with ``.shape``), under ``sched``. Host-side numpy over the
    schedule table: a new schedule means a new plan."""
    if mode in ("zero", "zero3"):
        raise not_ported(f"grad_sync_plan(mode={mode!r})", "ZeRO")
    if mode != "masked":
        raise ValueError(f"unknown sync plan mode {mode!r}")
    named = _named(model_or_named_params)
    live = backward_live_groups(sched)                       # [L, G]
    if live.shape[0] != cfg.n_layers:
        raise ValueError(f"schedule has {live.shape[0]} layers, the config "
                         f"{cfg.n_layers}")
    moe_layers = {n.split(".")[1] for n in named
                  if n.startswith("layers.") and n.split(".")[2] == "moe"}
    plan = {}
    for name, p in named.items():
        parts = name.split(".")
        if parts[0] != "layers":
            # embed / unembed / final_norm / frontend_proj: gradients flow
            # through every sample's loss path — never skipped
            plan[name] = _ALL
            continue
        path = parts[2:]
        # the MoE router's aux losses are computed from norm2(x) whatever
        # the gates, so an MoE block's FFN side keeps the full sync
        protected = "moe" in path or (parts[1] in moe_layers
                                      and path[0] == "norm2")
        plan[name] = _leaf_spec(path[-1], tuple(p.shape),
                                live[int(parts[1])], cfg, protected)
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
    or each live run of group blocks along the spec's axis."""
    if spec.mode == "all":
        yield t
    elif spec.mode == "sliced":
        size = t.shape[spec.axis] // len(spec.live)
        for is_live, start, stop in _runs(spec.live):
            if is_live:
                yield t.narrow(spec.axis, start * size, (stop - start) * size)
    elif spec.mode != "none":
        raise ValueError(f"unknown sync spec mode {spec.mode!r}")


@torch.no_grad()
def _mean_live_(tensors: Mapping[str, torch.Tensor], plan, mesh):
    """Average the plan's live views of ``tensors`` over the mesh's ranks,
    in place, through one flat bucket per dtype and one ``all_reduce``
    each. Adds the bytes sent to ``mesh.counter``, and the host-clock
    seconds of the call, from the end of the work queued before it (the
    device is synchronised at both ends)."""
    by_dtype: Dict[torch.dtype, list] = {}
    for name, spec in plan.items():
        for v in _live_views(tensors[name], spec):
            by_dtype.setdefault(v.dtype, []).append(v)
    dev = mesh.device
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for dtype, views in by_dtype.items():
        n = sum(v.numel() for v in views)
        bucket = torch.empty(n, dtype=dtype, device=dev)
        off = 0
        for v in views:
            bucket[off:off + v.numel()].view(v.shape).copy_(v)
            off += v.numel()
        mesh.all_reduce_(bucket)
        mesh.counter.add("all_reduce", bucket.numel() * bucket.element_size())
        bucket.div_(mesh.size)
        off = 0
        for v in views:
            v.copy_(bucket[off:off + v.numel()].view(v.shape))
            off += v.numel()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    mesh.counter.seconds += time.perf_counter() - t0


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


def lofi_merge_(named: Mapping[str, torch.Tensor], plan, mesh):
    """The cross-rank merge: each rank holds one replica; the plan's live
    slices are averaged over the ranks through the gradient sync's bucket,
    in place, and every other slice is left as it is. Returns ``named``."""
    _mean_live_(named, plan, mesh)
    return named


# ------------------------------------------------------------- accounting
def _live_bytes(nbytes: int, spec: SyncSpec) -> int:
    if spec.mode == "all":
        return nbytes
    if spec.mode == "none":
        return 0
    return nbytes // len(spec.live) * sum(spec.live)


def sync_byte_report(plan, named, n_shards: Optional[int] = None) -> dict:
    """Price the plan over ``named`` (name -> tensor, or anything with
    ``shape`` and ``dtype``). ``ar_bytes`` is what ``apply_grad_sync``
    hands to its all-reduce; with ``n_shards`` > 1, ``wire`` is the
    per-rank ring traffic (2·(k-1)/k per all-reduce byte). The ZeRO fields
    (``rs_bytes``, ``ag_bytes``, ``n_zero``) stay 0 until the ZeRO slice.
    ``n_leaves`` counts the port's unstacked parameters."""
    totals = {"total_bytes": 0.0, "synced_bytes": 0.0, "ar_bytes": 0.0,
              "rs_bytes": 0.0, "ag_bytes": 0.0, "n_leaves": 0,
              "n_skipped": 0, "n_sliced": 0, "n_zero": 0}
    for name, spec in plan.items():
        p = named[name]
        nbytes = int(np.prod(tuple(p.shape))) * \
            torch.empty((), dtype=p.dtype).element_size()
        live = float(_live_bytes(nbytes, spec))
        totals["total_bytes"] += float(nbytes)
        totals["n_leaves"] += 1
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
                "reduce_scatter": 0.0, "all_gather": 0.0}
        wire["total"] = sum(wire.values())
        totals["wire"] = wire
    return totals
