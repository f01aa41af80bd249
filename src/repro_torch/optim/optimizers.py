"""Minimal optimizer library (port of ``repro/optim/optimizers.py``).

The paper fine-tunes with SGD + momentum (§IV-A); AdamW is provided for the
LLM fine-tuning paths. Parameters, gradients and moments are dicts of
tensors keyed by parameter name (``dict(model.named_parameters())``), and
``update`` is leaf-wise, as in the JAX package.

Unlike the JAX package's pure updates, ``update`` works in place under
``torch.no_grad()``: it overwrites the parameter tensors (so the model that
owns them is updated) and the moment tensors, and returns the same dicts.
That keeps one copy of each instead of two. The step counter is a Python
int in the state, so the update needs no device synchronisation.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Tuple

import numpy as np
import torch

Params = Dict[str, torch.Tensor]


class Optimizer(NamedTuple):
    init: Callable[[Params], Any]
    update: Callable[[Params, Any, Params], Tuple[Params, Any]]
    # True when a parameter with zero gradient AND zero moments gets an
    # exactly-identity update (no weight decay): the ZeRO-1 sync of the
    # distributed slice may then skip its all-gather.
    elidable: bool = True
    # params-shaped moment copies in the state (sgd: mu; adamw: m and v)
    n_moments: int = 1


def sgd(lr: float, momentum: float = 0.9, weight_decay: float = 0.0,
        nesterov: bool = False) -> Optimizer:
    def init(params: Params):
        return {"mu": {n: torch.zeros_like(p) for n, p in params.items()},
                "step": 0}

    @torch.no_grad()
    def update(grads: Params, state, params: Params):
        for n, p in params.items():
            g = grads[n]
            if weight_decay:
                g = g + weight_decay * p
            mu = state["mu"][n].mul_(momentum).add_(g)
            upd = momentum * mu + g if nesterov else mu
            p.sub_(lr * upd)
        state["step"] += 1
        return params, state

    return Optimizer(init, update, elidable=weight_decay == 0.0,
                     n_moments=1)


def adamw(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.01) -> Optimizer:
    def init(params: Params):
        return {"m": {n: torch.zeros_like(p) for n, p in params.items()},
                "v": {n: torch.zeros_like(p) for n, p in params.items()},
                "step": 0}

    @torch.no_grad()
    def update(grads: Params, state, params: Params):
        step = state["step"] + 1
        # bias corrections in float32, as the JAX package computes them
        bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(step))
        bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(step))
        for n, p in params.items():
            g = grads[n]
            m = state["m"][n].mul_(b1).add_((1 - b1) * g)
            v = state["v"][n].mul_(b2).add_((1 - b2) * g * g)
            mh = m / bc1
            vh = v / bc2
            p.sub_(lr * (mh / (torch.sqrt(vh) + eps) + weight_decay * p))
        state["step"] = step
        return params, state

    return Optimizer(init, update, elidable=weight_decay == 0.0,
                     n_moments=2)


def chunked(opt: Optimizer, chunk: int) -> Optimizer:
    """Stream ``opt``'s update ``chunk`` elements at a time.

    The update of every optimizer here is leafwise and elementwise, so
    each leaf and its params-shaped moments can be flattened and updated
    one ``chunk``-sized slice at a time: the update then touches O(chunk)
    elements at once instead of O(leaf). The slices are views, so the
    in-place update writes through to the parameters and moments. Every
    slice sees the same input ``step`` (the bias correction of the whole
    update) and the counter advances once per call, so the results are
    bit-identical to ``opt.update``."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")

    def update(grads: Params, state, params: Params):
        moment_keys = [k for k in state if k != "step"]
        step = state["step"]
        for n, p in params.items():
            flat = {"g": grads[n].reshape(-1), "p": p.view(-1)}
            flat.update({k: state[k][n].view(-1) for k in moment_keys})
            for a in range(0, flat["p"].numel(), chunk):
                sl = {k: v[a:a + chunk] for k, v in flat.items()}
                opt.update({n: sl["g"]},
                           {"step": step,
                            **{k: {n: sl[k]} for k in moment_keys}},
                           {n: sl["p"]})
        state["step"] = step + 1
        return params, state

    return Optimizer(opt.init, update, elidable=opt.elidable,
                     n_moments=opt.n_moments)


def clip_scale(norm, max_norm: float):
    """Global-norm clip factor."""
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def _global_norm(grads: Params):
    return torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads.values()))


def clip_by_global_norm(grads: Params, max_norm: float):
    """Returns (clipped grads, global norm); the norm stays a device
    tensor, so clipping needs no synchronisation."""
    norm = _global_norm(grads)
    scale = clip_scale(norm, max_norm)
    return {n: g * scale for n, g in grads.items()}, norm


def clip_by_global_norm_(grads: Params, max_norm: float):
    """``clip_by_global_norm`` scaling gradients that nothing else holds in
    place: the same values, without a second parameter-sized copy (which
    would not fit beside mixtral-8x22b's two full-width layers and their
    gradients on one 80 GB card). Returns (grads, global norm)."""
    norm = _global_norm(grads)
    scale = clip_scale(norm, max_norm)
    # autograd may hand two leaves one tensor: scale each tensor once
    for g in {id(g): g for g in grads.values()}.values():
        g.mul_(scale)
    return grads, norm
