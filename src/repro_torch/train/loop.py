"""Training loops (port of the single-device ViT half of
``repro/train/loop.py``).

``finetune_vit`` is the paper's ViT experiment: optional D2FT schedule
(scores -> knapsack -> gates), the masked or the kernel attention path, a
global-norm clip and the optimizer update, one step per batch. The LLM
loop (``finetune``) and the distributed loops come with later slices.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch

from repro_torch.core.schedule import gates_from_schedule, live_slice_bounds
from repro_torch.data.synthetic import microbatch_assignment
from repro_torch.kernels.ops import _validate_gates
from repro_torch.models.vit import ViT, ViTConfig, vit_forward, vit_loss
from repro_torch.optim.optimizers import Optimizer, clip_by_global_norm


@dataclass
class TrainLog:
    losses: list = field(default_factory=list)
    metrics: list = field(default_factory=list)
    step_times: list = field(default_factory=list)

    def last(self, k: str):
        return self.metrics[-1][k] if self.metrics else None


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
        leaves = list(params.values())
        gs = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = {n: torch.zeros_like(p) if g is None else g
                 for (n, p), g in zip(params.items(), gs)}
        grads, gnorm = clip_by_global_norm(grads, clip)
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
