"""Training loops (port of the single-device half of
``repro/train/loop.py``).

``finetune`` drives the D2FT fine-tune of LLM backbones (what
``launch/train.py`` runs); ``finetune_vit`` is the paper's ViT experiment.
Both: optional D2FT schedule (scores -> knapsack -> gates), the masked or
the kernel path, a global-norm clip and the optimizer update, one step per
batch. The packed path, the sharding policy and the distributed loops come
with later slices.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from repro_torch.configs.base import D2FTConfig, ModelConfig
from repro_torch.core import d2ft as d2ft_mod
from repro_torch.core.schedule import (Schedule, gates_from_schedule,
                                       live_slice_bounds)
from repro_torch.core.scores import compute_scores, transformer_blocks
from repro_torch.data.synthetic import (microbatch_assignment,
                                        split_microbatches)
from repro_torch.kernels.ops import _validate_gates
from repro_torch.models.transformer import Transformer, lm_loss
from repro_torch.models.vit import ViT, ViTConfig, vit_forward, vit_loss
from repro_torch.optim.optimizers import Optimizer, clip_by_global_norm


@dataclass
class TrainLog:
    losses: list = field(default_factory=list)
    metrics: list = field(default_factory=list)
    step_times: list = field(default_factory=list)

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

    batch: {"tokens", "labels"} tensors on the model's device; sched_args:
    the (g_f, g_b) gates [n_layers, B, G] when ``use_gates``. use_kernel
    routes the attention and SSD blocks through the gated kernels, whose
    backward skips the p_o / p_s (sample, head) slices. live_bounds: the
    (live_fwd, live_bwd) (sample, group) compaction bounds
    (``core.schedule.live_slice_bounds``) of the gates this step gets. The
    packed path and the sharding policy are not ported yet."""
    if packed:
        raise NotImplementedError(
            "the packed D2FT path is not ported yet")
    if policy is not None:
        raise NotImplementedError(
            "the sharding policy is not ported yet: it comes with the "
            "distributed slice")

    def step(model: Transformer, opt_state, batch, sched_args=None):
        params = dict(model.named_parameters())
        gates = sched_args if use_gates else None
        loss, metrics = lm_loss(model, cfg, batch.get("tokens"),
                                batch["labels"], gates=gates, remat=remat,
                                use_kernel=use_kernel,
                                live_bounds=live_bounds if use_gates
                                else None)
        grads, gnorm = clip_by_global_norm(_grads(loss, params), clip)
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
    device; ``batches`` yields numpy {"tokens", "labels"}. Returns (model,
    opt_state, log); the model is updated in place."""
    if packed:
        raise NotImplementedError("the packed D2FT path is not ported yet")
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
                                      mb["labels"])[0])
        sched_args = bounds = None
        if d2 is not None:
            B = batch["labels"].shape[0]
            mb_of = microbatch_assignment(B, d2.n_microbatches)
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
        grads, gnorm = clip_by_global_norm(_grads(loss, params), clip)
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
