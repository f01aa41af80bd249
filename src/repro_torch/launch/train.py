"""Train launcher (port of the single-device half of
``repro/launch/train.py``).

On one CUDA card, the slice's main path:

  python -m repro_torch.launch.train --arch mamba2-130m --full --d2ft \
      --kernel --n-pf 2 --n-po 1 --batch 8 --seq 2048 --steps 8

It runs on the card unless ``--device cpu`` is given, with a reduced
(smoke) config unless ``--full`` is passed. The weights are random, from
seed 0. The distributed, elastic, packed, mesh, fault-injection, resume
and checkpoint options exit with "not ported yet".
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import D2FTConfig
from repro_torch.data.synthetic import lm_batches
from repro_torch.models.transformer import init_model
from repro_torch.optim.optimizers import adamw, sgd
from repro_torch.train.loop import TrainLog, finetune

# flags of the JAX launcher whose paths come with later slices
_NOT_PORTED = ("distributed", "elastic", "packed", "mesh", "faults",
               "resume_from", "ckpt")


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--optimizer", choices=("sgd", "adamw"), default="adamw")
    ap.add_argument("--d2ft", action="store_true")
    ap.add_argument("--packed", action="store_true",
                    help="use the packed D2FT execution path (not ported "
                         "yet)")
    ap.add_argument("--distributed", action="store_true",
                    help="data-parallel D2FT (not ported yet)")
    ap.add_argument("--kernel", action="store_true",
                    help="route attention and SSD blocks through the gated "
                         "CUDA kernels (their plain versions on the CPU)")
    ap.add_argument("--mesh", default=None, metavar="data=D,stage=S,tensor=T",
                    help="multi-axis device mesh (not ported yet)")
    ap.add_argument("--sync-mode",
                    choices=("masked", "zero", "zero3", "local"),
                    default="masked",
                    help="distributed gradient sync (only the --distributed "
                         "path, not ported yet)")
    ap.add_argument("--refresh-every", type=int, default=None,
                    help="re-plan the schedule every k steps (only the "
                         "--distributed path, not ported yet)")
    ap.add_argument("--n-pf", type=int, default=3)
    ap.add_argument("--n-po", type=int, default=1)
    ap.add_argument("--n-microbatches", type=int, default=4)
    ap.add_argument("--full", action="store_true",
                    help="full-size config (default: the smoke config)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the kernels' plain versions)")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--elastic", action="store_true",
                    help="the fault-tolerant elastic loop (not ported yet)")
    ap.add_argument("--faults", default=None, metavar="PATH.json",
                    help="inject a FaultPlan (not ported yet)")
    ap.add_argument("--ckpt-every", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--merge-every", type=int, default=4)
    ap.add_argument("--resume-from", default=None, metavar="CKPT.npz",
                    help="resume from a step-level checkpoint (not ported "
                         "yet)")
    return ap.parse_args(argv)


def main(argv=None) -> TrainLog:
    args = parse_args(argv)
    for flag in _NOT_PORTED:
        if getattr(args, flag):
            raise SystemExit(f"--{flag.replace('_', '-')} is not ported yet")
    if args.sync_mode != "masked" or args.refresh_every is not None:
        raise SystemExit("--sync-mode/--refresh-every only apply to the "
                         "--distributed path")
    dev = resolve_device(args.device)
    cfg = get_config(args.arch) if args.full else get_smoke_config(args.arch)
    print(f"arch={cfg.name} layers={cfg.n_layers} d_model={cfg.d_model} "
          f"device={dev}")
    if cfg.frontend != "none":
        raise SystemExit("text-training launcher; audio/vlm archs run "
                         "through the scripts in examples/")

    d2 = None
    if args.d2ft:
        d2 = D2FTConfig(n_microbatches=args.n_microbatches, n_pf=args.n_pf,
                        n_po=args.n_po,
                        head_groups=max(cfg.n_heads, 1))
        print(f"D2FT: {args.n_pf} p_f + {args.n_po} p_o of "
              f"{args.n_microbatches} micro-batches "
              f"(compute {100 * (args.n_pf + 0.4 * args.n_po) / args.n_microbatches:.0f}%)")

    model = init_model(torch.Generator(device=dev).manual_seed(0), cfg)
    opt = adamw(args.lr) if args.optimizer == "adamw" else sgd(args.lr)
    batches = lm_batches(0, cfg.vocab_size, args.batch, args.seq,
                         args.steps)
    t0 = time.time()
    _, _, log = finetune(model, cfg, d2, opt, batches, steps=args.steps,
                         use_kernel=args.kernel)
    dt = time.time() - t0
    print(f"{args.steps} steps in {dt:.1f}s — loss "
          f"{log.losses[0]:.3f} -> {log.losses[-1]:.3f}")
    return log


if __name__ == "__main__":
    main()
