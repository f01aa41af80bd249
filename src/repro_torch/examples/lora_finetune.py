"""D2FT-LoRA (paper §II-D): freeze the base model, fine-tune low-rank
adapters under a D2FT schedule; includes the fused LoRA matmul. Port of
the JAX package's ``examples/lora_finetune.py``, with its config, rank 8,
SGD 0.1 and D2FT budget (n_pf 3, n_po 0 of 4 micro-batches, 4 head groups).

  PYTHONPATH=src python -m repro_torch.examples.lora_finetune \\
      [--device cpu] [--steps 60] [--kernel]

It runs on the CUDA card unless ``--device cpu`` is given; ``--kernel``
routes attention through the gated flash kernels (their plain versions on
the CPU). ``run`` is the example end to end at any config, and
``plan_lora``, ``make_lora_step`` and ``finetune_lora`` its parts: the
scoring pass on the merged model, one step (``merge_lora`` -> ``lm_loss``
with the gates -> the optimizer on the adapters only) and the loop.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import D2FTConfig, ModelConfig
from repro_torch.core.d2ft import plan_schedule
from repro_torch.core.lora import (call_with_weights, init_lora,
                                   lora_param_count, lora_params, merge_lora)
from repro_torch.core.schedule import (Schedule, gates_from_schedule,
                                       live_slice_bounds)
from repro_torch.core.scores import compute_scores, transformer_blocks
from repro_torch.data.synthetic import (lm_batches, microbatch_assignment,
                                        split_microbatches)
from repro_torch.kernels.ops import lora_linear
from repro_torch.models.transformer import Transformer, init_model, lm_loss
from repro_torch.optim.optimizers import Optimizer, sgd
from repro_torch.train.loop import TrainLog, _check_schedule_gates, _grads

CFG = ModelConfig(name="base", arch_type="dense", n_layers=4, d_model=128,
                  n_heads=4, n_kv_heads=4, d_ff=256, vocab_size=1024)
RANK = 8
SCALE = 1.0              # merge scale of the fine-tune
FUSED_SCALE = 2.0        # scale of the one fused lora_linear call
LR = 0.1
D2 = D2FTConfig(n_microbatches=4, n_pf=3, n_po=0, head_groups=4)
BATCH, SEQ, STEPS = 8, 64, 60


def _on_device(batch, dev):
    return {k: torch.as_tensor(np.asarray(v), device=dev)
            for k, v in batch.items()}


def fused_wq(model: Transformer, lora, x):
    """The fused kernel: x·W + s·(x·A)·B on layer 0's wq and its adapter,
    without materializing x·A in device memory (``ops.lora_linear``,
    forward only: the weights go in detached)."""
    ab = lora["layers.0.attn.wq"]
    return lora_linear(x, model.layers[0].attn.wq.detach(),
                       ab["a"].detach(), ab["b"].detach(), scale=FUSED_SCALE)


def plan_lora(model: Transformer, cfg: ModelConfig, lora, d2: D2FTConfig,
              batch) -> Schedule:
    """Scoring pass on the merged model (weight magnitude of the frozen
    weights backward, Fisher information of the merged weights' gradients
    forward) over the batch's micro-batches, then the knapsack."""
    dev = next(model.parameters()).device
    merged = {n: t.detach().requires_grad_() for n, t in
              merge_lora(dict(model.named_parameters()), lora,
                         SCALE).items()}
    mbs = split_microbatches(_on_device(batch, dev), d2.n_microbatches)

    def loss_fn(p, mb):
        return call_with_weights(lm_loss, model, p, cfg, mb["tokens"],
                                 mb["labels"])[0]

    G = d2.head_groups
    bw, fw = compute_scores(loss_fn, merged,
                            lambda t: transformer_blocks(t, cfg), mbs, G)
    return plan_schedule(d2, bw, fw, cfg.n_layers, G)


def make_lora_step(model: Transformer, cfg: ModelConfig, opt: Optimizer, *,
                   use_kernel: bool = False):
    """Returns step(lora, opt_state, batch, gates=None, live_bounds=None)
    -> (lora, opt_state, loss): merge, the (gated) LM loss on the merged
    weights, gradients of the adapters only, the optimizer update in place.
    The base model's parameters are never written."""
    params = dict(model.named_parameters())

    def step(lora, opt_state, batch, gates=None, live_bounds=None):
        merged = merge_lora(params, lora, SCALE)
        loss, _ = call_with_weights(lm_loss, model, merged, cfg,
                                    batch["tokens"], batch["labels"],
                                    gates=gates, use_kernel=use_kernel,
                                    live_bounds=live_bounds)
        leaves = lora_params(lora)
        opt.update(_grads(loss, leaves), opt_state, leaves)
        return lora, opt_state, loss.detach()

    return step


def finetune_lora(model: Transformer, cfg: ModelConfig, lora,
                  opt: Optimizer, batches, *, steps: int,
                  sched: Optional[Schedule] = None,
                  use_kernel: bool = False):
    """One step per batch (numpy {"tokens", "labels"}): with ``sched``, the
    D2FT gates of each batch's micro-batch split (and, on the kernel path,
    its compaction bounds), checked once per step on the host; without,
    plain LoRA. Returns (lora, opt_state, log); the adapters are updated in
    place."""
    log = TrainLog()
    dev = next(model.parameters()).device
    opt_state = opt.init(lora_params(lora))
    step = make_lora_step(model, cfg, opt, use_kernel=use_kernel)
    for i, batch in enumerate(batches):
        if i >= steps:
            break
        gates = bounds = None
        if sched is not None:
            mb_of = microbatch_assignment(batch["labels"].shape[0],
                                          sched.n_microbatches)
            g_f, g_b = gates_from_schedule(sched, mb_of, "cpu")
            if use_kernel:
                bounds = live_slice_bounds(sched, mb_of)
            _check_schedule_gates(g_f, g_b, bounds)
            gates = (g_f.to(dev), g_b.to(dev))
        t0 = time.perf_counter()
        _, opt_state, loss = step(lora, opt_state, _on_device(batch, dev),
                                  gates, bounds)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        log.step_times.append(time.perf_counter() - t0)
        log.losses.append(float(loss))
    return lora, opt_state, log


def run(cfg: ModelConfig = CFG, *, device, batch: int = BATCH,
        seq: int = SEQ, steps: int = STEPS, use_kernel: bool = False,
        d2: Optional[D2FTConfig] = D2, sched: Optional[Schedule] = None):
    """The example end to end: the base model (seed 0), adapters (seed 1),
    the fused call on a [128, d_model] input (seed 2), then scoring and
    the knapsack on the first batch (unless ``sched`` is given; none when
    ``d2`` is None: plain LoRA) and the loop. Returns (model, lora, sched,
    fused output, log)."""
    dev = torch.device(device)
    model = init_model(torch.Generator(device=dev).manual_seed(0), cfg)
    lora = init_lora(torch.Generator(device=dev).manual_seed(1),
                     dict(model.named_parameters()), rank=RANK)
    x = torch.randn((128, cfg.d_model),
                    generator=torch.Generator(device=dev).manual_seed(2),
                    device=dev)
    y = fused_wq(model, lora, x)
    batches = list(lm_batches(0, cfg.vocab_size, batch, seq, steps))
    if d2 is None:
        sched = None
    elif sched is None:
        sched = plan_lora(model, cfg, lora, d2, batches[0])
    lora, _, log = finetune_lora(model, cfg, lora, sgd(LR), batches,
                                 steps=steps, sched=sched,
                                 use_kernel=use_kernel)
    return model, lora, sched, y, log


def main(argv=None) -> TrainLog:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the kernels' plain versions)")
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--kernel", action="store_true",
                    help="route attention through the gated flash kernels")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    _, lora, _, y, log = run(CFG, device=dev, steps=args.steps,
                             use_kernel=args.kernel)
    print(f"adapters: {lora_param_count(lora)} trainable params "
          f"({len(lora)} targets)")
    print(f"fused lora_linear output: {tuple(y.shape)}")
    print(f"D2FT-LoRA loss: {np.mean(log.losses[:5]):.3f} -> "
          f"{np.mean(log.losses[-5:]):.3f}")
    return log


if __name__ == "__main__":
    main()
