"""Contribution scores for D2FT subnets (port of ``repro/core/scores.py``).

Metrics: Fisher Information Σ‖∇w‖² (per micro-batch), Weight Magnitude
Σ‖w‖ (sample-independent), Gradient Magnitude Σ‖∇w‖, Taylor importance
Σ‖w ⊙ ∇w‖. The paper's final choice: backward = Weight Magnitude,
forward = Fisher Information.

A *subnet* is (layer l, head-group g): the g-th slice of every width-
partitionable weight in block l. Slicing rules are name-based; weights with
no natural width partition (norms and the like) count fully in every group.

Parameters and gradients are flat dicts of dotted name -> tensor, as
``dict(model.named_parameters())`` gives them; a block is the dict of one
layer's entries, walked in sorted name order (the JAX package's pytree
order), each leaf known by its last name component.
"""
from __future__ import annotations

import re
from typing import Callable, Dict, List, Mapping, Sequence

import numpy as np
import torch

# name -> ("col" slice last dim | "row" slice first dim | "rep" replicate)
_SLICE_RULES: Dict[str, str] = {
    "wq": "col", "wk": "col", "wv": "col", "wo": "row",
    "bq": "col", "bk": "col", "bv": "col",
    "w_up": "col", "w_gate": "col", "w_down": "row",
    # SSD
    "w_in": "col", "w_out": "row", "A_log": "col", "dt_bias": "col",
    "D": "col", "norm_scale": "col", "conv_w": "col", "conv_b": "col",
    # RG-LRU
    "w_gate_branch": "col", "w_rec_branch": "col", "w_a": "col",
    "w_x": "col", "b_a": "col", "b_x": "col", "Lambda": "col",
}


def _slice_reduce(name: str, a: torch.Tensor, G: int, leaf_fn):
    """Reduce one weight into per-group scalars [G]."""
    rule = _SLICE_RULES.get(name, "rep")
    if rule == "col" and a.shape[-1] % G == 0:
        parts = a.reshape(*a.shape[:-1], G, a.shape[-1] // G)
        axes = tuple(i for i in range(parts.ndim) if i != parts.ndim - 2)
        return leaf_fn(parts, axes)
    if rule == "row" and a.shape[0] % G == 0:
        parts = a.reshape(G, a.shape[0] // G, *a.shape[1:])
        return leaf_fn(parts, tuple(range(1, parts.ndim)))
    full = leaf_fn(a[None], tuple(range(1, a.ndim + 1)))
    return full.expand(G)


def _walk(block: Mapping[str, torch.Tensor]):
    for key in sorted(block):
        yield key.rsplit(".", 1)[-1], block[key]


def subnet_reduce(block: Mapping[str, torch.Tensor], G: int, leaf_fn):
    """Reduce a block's params (or grads) into per-group scores [G]."""
    total = None
    for name, arr in _walk(block):
        part = _slice_reduce(name, arr.detach().float(), G, leaf_fn)
        total = part if total is None else total + part
    return total


def _sum_abs(parts, axes):
    return torch.sum(torch.abs(parts), dim=axes)


def _sum_sq(parts, axes):
    return torch.sum(parts * parts, dim=axes)


def _host(rows: List[torch.Tensor]) -> np.ndarray:
    return torch.stack(rows).cpu().numpy()


# ------------------------------------------------------------------ metrics
def weight_magnitude(blocks: Sequence[Mapping], G: int) -> np.ndarray:
    """[L, G] — Σ‖w‖ per subnet."""
    return _host([subnet_reduce(b, G, _sum_abs) for b in blocks])


def grad_metric(grad_blocks: Sequence[Mapping], blocks: Sequence[Mapping],
                G: int, metric: str) -> np.ndarray:
    """[L, G] for one micro-batch's gradients."""
    out = []
    for gb, wb in zip(grad_blocks, blocks):
        if metric == "fisher":
            out.append(subnet_reduce(gb, G, _sum_sq))
        elif metric == "gradient_magnitude":
            out.append(subnet_reduce(gb, G, _sum_abs))
        elif metric == "taylor":
            prod = {k: gb[k] * wb[k].detach() for k in gb}
            out.append(subnet_reduce(prod, G, _sum_abs))
        else:
            raise ValueError(metric)
    return _host(out)


def compute_scores(loss_fn: Callable, params: Mapping[str, torch.Tensor],
                   blocks_getter: Callable, microbatches: Sequence, G: int,
                   backward_metric: str = "weight_magnitude",
                   forward_metric: str = "fisher"):
    """Score every (subnet, micro-batch) pair before fine-tuning.

    loss_fn(params, microbatch) -> scalar tensor, differentiable in the
    tensors of ``params`` (name -> tensor); blocks_getter(dict) -> list of
    per-layer block dicts (works on params and on grads, which share
    names). Returns (backward [K, N], forward [K, N]) with K = L*G.

    Per the paper: all samples are fed forward+backward once *without
    updating weights* to collect gradient statistics.
    """
    blocks = blocks_getter(params)
    L = len(blocks)
    N = len(microbatches)
    names = list(params)
    leaves = [params[n] for n in names]

    def grads_of(mb) -> Dict[str, torch.Tensor]:
        gs = torch.autograd.grad(loss_fn(params, mb), leaves,
                                 allow_unused=True)
        return {n: torch.zeros_like(t) if g is None else g
                for n, t, g in zip(names, leaves, gs)}

    def metric_per_mb(metric):
        if metric == "weight_magnitude":
            wm = weight_magnitude(blocks, G)                    # [L, G]
            return np.repeat(wm.reshape(L * G, 1), N, axis=1)
        vals = np.zeros((L * G, N))
        for i, mb in enumerate(microbatches):
            gm = grad_metric(blocks_getter(grads_of(mb)), blocks, G, metric)
            vals[:, i] = gm.reshape(L * G)
        return vals

    return metric_per_mb(backward_metric), metric_per_mb(forward_metric)


# ------------------------------------------------------- block extractors
def _indexed_blocks(params: Mapping[str, torch.Tensor], prefix: str
                    ) -> List[dict]:
    """Per-layer block dicts of the ``<prefix>.<i>.<name>`` entries."""
    pattern = re.compile(re.escape(prefix) + r"\.(\d+)\.(.+)")
    blocks: Dict[int, dict] = {}
    for key, t in params.items():
        m = pattern.fullmatch(key)
        if m:
            blocks.setdefault(int(m.group(1)), {})[m.group(2)] = t
    return [blocks[i] for i in sorted(blocks)]


def transformer_blocks(params: Mapping[str, torch.Tensor], cfg=None
                       ) -> List[dict]:
    """Per-layer block dicts of a Transformer's flat ``layers.<i>.<name>``
    entries: the JAX package's unstacked scan cycles, in layer order."""
    return _indexed_blocks(params, "layers")


def vit_blocks(params: Mapping[str, torch.Tensor], cfg=None) -> List[dict]:
    """Per-layer block dicts of a ViT's ``blocks.<i>.<name>`` entries."""
    return _indexed_blocks(params, "blocks")
