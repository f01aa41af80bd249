"""End-to-end example: fine-tune a ~100M-param LLM with D2FT on synthetic
Markov data, on the masked, kernel or packed execution path. Port of the
JAX package's ``examples/d2ft_llm_finetune.py``, with its config (12
layers, d 768, 12 heads, vocab 8192), batch 8 x 128, AdamW 3e-4 and D2FT
budget (2 p_f + 1 p_o of 4 micro-batches, 12 head groups).

  PYTHONPATH=src python -m repro_torch.examples.d2ft_llm_finetune \\
      [--device cpu] [--steps 200] [--packed | --kernel]

It runs on the CUDA card unless ``--device cpu`` is given. ``--kernel``
routes attention through the gated flash kernels (their plain versions on
the CPU); ``--packed`` runs the packed gather path, which bypasses them,
so the two are exclusive. ``run`` is the example end to end at any config.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import D2FTConfig, ModelConfig
from repro_torch.data.synthetic import lm_batches
from repro_torch.models.transformer import init_model
from repro_torch.optim.optimizers import adamw
from repro_torch.train.loop import TrainLog, finetune

# ~100M params: 12 layers, d_model 768 (GPT-2-small-ish)
CFG = ModelConfig(name="llm100m", arch_type="dense", n_layers=12,
                  d_model=768, n_heads=12, n_kv_heads=12, d_ff=3072,
                  vocab_size=8192)
D2 = D2FTConfig(n_microbatches=4, n_pf=2, n_po=1, head_groups=12)
BATCH, SEQ, STEPS, LR = 8, 128, 200, 3e-4


def run(cfg: ModelConfig = CFG, *, device, d2: Optional[D2FTConfig] = D2,
        batch: int = BATCH, seq: int = SEQ, steps: int = STEPS,
        packed: bool = False, use_kernel: bool = False) -> TrainLog:
    """The model from seed 0, ``steps`` batches of ``lm_batches(0, ...)``,
    scores and the knapsack on the first, then ``train.loop.finetune`` on
    the chosen path. Returns its log."""
    if packed and use_kernel:
        raise ValueError("packed and use_kernel are exclusive (the packed "
                         "gather path bypasses the gated attention kernel)")
    dev = torch.device(device)
    model = init_model(torch.Generator(device=dev).manual_seed(0), cfg)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model: {n_params / 1e6:.1f}M params")
    batches = lm_batches(0, cfg.vocab_size, batch=batch, seq=seq,
                         steps=steps)
    _, _, log = finetune(model, cfg, d2, adamw(LR), batches, steps=steps,
                         packed=packed, use_kernel=use_kernel)
    return log


def main(argv=None) -> TrainLog:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--packed", action="store_true")
    ap.add_argument("--kernel", action="store_true",
                    help="route attention through the gated flash kernels")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the kernels' plain versions)")
    args = ap.parse_args(argv)
    if args.packed and args.kernel:
        ap.error("--packed and --kernel are mutually exclusive (the packed "
                 "gather path bypasses the gated attention kernel)")
    dev = resolve_device(args.device)
    print(f"D2FT budget: compute {(2 + 0.4) / 4:.0%}, comm {(2 + 0.5) / 4:.0%}")
    t0 = time.time()
    log = run(CFG, device=dev, steps=args.steps, packed=args.packed,
              use_kernel=args.kernel)
    path = "packed" if args.packed else ("kernel" if args.kernel else
                                         "masked")
    print(f"{args.steps} steps ({path} path) in {time.time() - t0:.0f}s")
    print(f"loss: {np.mean(log.losses[:10]):.3f} -> "
          f"{np.mean(log.losses[-10:]):.3f}")
    return log


if __name__ == "__main__":
    main()
