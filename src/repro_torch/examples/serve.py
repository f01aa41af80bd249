"""Serving example: batched prefill + greedy decode with KV caches across
block families (dense KV, ring-buffer sliding window, SSM state, RG-LRU
state). Port of the JAX package's ``examples/serve.py``: the same three
smoke configs, batch 4, prompts of 8 tokens and 16 new tokens, through
``serving/decode.py::generate``. Weights are random from seed 0 and the
prompts come from numpy's seed 1.

  PYTHONPATH=src python -m repro_torch.examples.serve [--device cpu]

It runs on the CUDA card unless ``--device cpu`` is given; ``run`` is the
example end to end and returns each arch's output tokens.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_smoke_config
from repro_torch.models.transformer import init_model
from repro_torch.serving.decode import generate

ARCHS = ("gemma3-1b", "mamba2-130m", "recurrentgemma-2b")
BATCH, PROMPT, NEW = 4, 8, 16


def run(device, archs: Sequence[str] = ARCHS) -> Dict[str, torch.Tensor]:
    """Generate NEW tokens for a [BATCH, PROMPT] prompt on each arch's
    smoke config; prints one line per arch and returns the outputs."""
    outs = {}
    for arch in archs:
        cfg = get_smoke_config(arch)
        model = init_model(torch.Generator(device=device).manual_seed(0),
                           cfg)
        prompt = torch.as_tensor(np.random.RandomState(1).randint(
            0, cfg.vocab_size, (BATCH, PROMPT)), device=device)
        t0 = time.perf_counter()
        out = generate(model, cfg, prompt, n_tokens=NEW)
        if device.type == "cuda":
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        print(f"{arch:20s} generated {tuple(out.shape)} in {dt:.1f}s "
              f"(batch={BATCH}, {NEW} new tokens)")
        outs[arch] = out
    return outs


def main(argv=None) -> Dict[str, torch.Tensor]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    return run(resolve_device(args.device))


if __name__ == "__main__":
    main()
