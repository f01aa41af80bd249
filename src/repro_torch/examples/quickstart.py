"""Quickstart: D2FT on a small ViT. Port of the JAX package's
``examples/quickstart.py``, with its config (2 layers, d 96, 6 heads,
patch 8, 32 x 32 images, 4 classes), SGD 0.05, batch 40, 40 steps and
D2FT budget (3 p_f + 1 p_o of 5 micro-batches, a new schedule every 16
steps).

The paper's full pipeline on a synthetic image task: scoring pass ->
bi-level knapsack schedule -> gated fine-tuning, against standard full
fine-tuning at the same step count, from the same weights.

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

It runs on the CUDA card unless ``--device cpu`` is given; ``run`` is the
example end to end and returns both top-1s.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import D2FTConfig
from repro_torch.core.cost_model import comm_cost, compute_cost, \
    workload_variance
from repro_torch.core.d2ft import plan_schedule
from repro_torch.core.scores import compute_scores, vit_blocks
from repro_torch.data.synthetic import image_batches, make_image_task
from repro_torch.models.vit import ViTConfig, init_vit, vit_loss
from repro_torch.optim.optimizers import sgd
from repro_torch.train.loop import eval_vit, finetune_vit

CFG = ViTConfig(n_layers=2, d_model=96, n_heads=6, d_ff=192, patch=8,
                image_size=32, n_classes=4)
# 3 full + 1 forward-only of 5 micro-batches => 68% compute
D2 = D2FTConfig(n_microbatches=5, n_pf=3, n_po=1)
BATCH, STEPS, LR, REFRESH = 40, 40, 0.05, 16


def schedule_fn(step, model, images, labels):
    """Scores and the knapsack on this batch's micro-batches every REFRESH
    steps; None (keep the last schedule) in between."""
    if step % REFRESH != 0:
        return None
    dev = next(model.parameters()).device
    n_mb = D2.n_microbatches
    mbs = list(zip(np.split(images, n_mb), np.split(labels, n_mb)))

    def loss_fn(p, mb):
        return vit_loss(model, torch.as_tensor(mb[0], device=dev),
                        torch.as_tensor(mb[1], device=dev), CFG)[0]

    bw, fw = compute_scores(loss_fn, dict(model.named_parameters()),
                            vit_blocks, mbs, CFG.n_heads)
    sched = plan_schedule(D2, bw, fw, CFG.n_layers, CFG.n_heads)
    print(f"  step {step}: schedule compute={compute_cost(sched.table):.0%} "
          f"comm={comm_cost(sched.table):.0%} "
          f"variance={workload_variance(sched.table):.2f}")
    return sched


def run(*, device, steps: int = STEPS, eval_batches: int = 5):
    """Fine-tunes the model from seed 0 with the D2FT schedule, then again
    from seed 0 without; returns (top-1 of D2FT, top-1 of standard
    fine-tuning) over ``eval_batches`` held-out batches."""
    dev = torch.device(device)
    task = make_image_task(3, n_classes=CFG.n_classes,
                           image_size=CFG.image_size)
    accs = []
    for fn in (schedule_fn, None):
        print("D2FT fine-tuning (68% compute budget):" if fn else
              "standard full fine-tuning (100% compute):")
        model = init_vit(CFG, seed=0, device=dev)
        finetune_vit(model, CFG, sgd(LR), image_batches(task, 5, BATCH,
                                                        steps),
                     steps=steps, schedule_fn=fn,
                     n_microbatches=D2.n_microbatches)
        accs.append(eval_vit(model, CFG, image_batches(task, 7, BATCH,
                                                       eval_batches)))
    return tuple(accs)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--steps", type=int, default=STEPS)
    args = ap.parse_args(argv)
    acc_d2ft, acc_std = run(device=resolve_device(args.device),
                            steps=args.steps)
    print(f"\ntop-1: D2FT@68% = {acc_d2ft:.3f}   standard@100% = "
          f"{acc_std:.3f}")
    return acc_d2ft, acc_std


if __name__ == "__main__":
    main()
