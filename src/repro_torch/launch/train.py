"""Train launcher (port of the single-device half of
``repro/launch/train.py``).

On one CUDA card, the main paths of the LLM fine-tune:

  python -m repro_torch.launch.train --arch mamba2-130m --full --d2ft \
      --kernel --n-pf 2 --n-po 1 --batch 8 --seq 2048 --steps 8
  python -m repro_torch.launch.train --arch gemma3-1b --full --d2ft \
      --kernel --batch 4 --seq 1024 --steps 8
  python -m repro_torch.launch.train --arch recurrentgemma-2b --full \
      --d2ft --kernel --optimizer sgd --batch 4 --seq 512 --steps 8
  python -m repro_torch.launch.train --arch gemma3-1b --full --d2ft \
      --packed --batch 4 --seq 1024 --steps 8

``--packed`` runs the packed D2FT path (``core.d2ft.packed_forward``:
each head group gathers the samples its subnet runs), which takes
attention blocks with a dense FFN only, and no gated kernel: it is
exclusive with ``--kernel`` and refused on mamba2-130m, recurrentgemma-2b
and olmoe-1b-7b.

(olmoe-1b-7b's 27.7 GB of weights leave no room on one 80 GB card for
the full fine-tune's gradients and optimizer state: ``chip_smoke.py`` runs
this loop on 8 of its 16 layers, and the full depth as D2FT-LoRA.)

``--distributed`` runs the data-parallel D2FT loop
(``train.loop.finetune_distributed``, one process per rank) with the
schedule-masked gradient sync, or with ``--sync-mode zero`` (ZeRO-1: the
optimizer moments sharded over the ranks) or ``--sync-mode zero3`` (the
parameters sharded too). One rank needs no launcher:

  python -m repro_torch.launch.train --arch gemma3-1b --full --d2ft \
      --kernel --distributed --mesh data=1 --batch 4 --seq 1024 --steps 4

and N ranks run under ``torch.distributed.run`` (NCCL where every rank has
its own card, gloo where ranks share one, or on the CPU):

  python -m torch.distributed.run --standalone --nproc_per_node 2 \
      -m repro_torch.launch.train --arch gemma3-1b --d2ft --distributed \
      --mesh data=2 --steps 3 --device cpu

``--mesh data=D,stage=S,tensor=T`` adds the stage axis (a GPipe pipeline
over live-cost-balanced layer ranges, ``--n-microbatches`` micro-batches a
data shard) and the tensor axis (Megatron sharding of attention heads and
FFN columns); the world must equal D x S x T, one process a rank, and
neither axis has a ``--kernel`` route (the masked path runs):

  python -m torch.distributed.run --standalone --nproc_per_node 2 \
      -m repro_torch.launch.train --arch gemma3-1b --full --d2ft \
      --distributed --mesh stage=2 --batch 4 --seq 1024 --steps 4
  python -m torch.distributed.run --standalone --nproc_per_node 2 \
      -m repro_torch.launch.train --arch stablelm-3b --d2ft \
      --distributed --mesh tensor=2 --steps 3 --device cpu

``--elastic`` (with ``--distributed``, on a data mesh) runs the
fault-tolerant loop (``train.elastic.finetune_elastic``): step-level
checkpoints every ``--ckpt-every`` steps into ``--ckpt-dir``, the pre-sync
guard, straggler-aware re-planning, dropout recovery and the lo-fi
fallback; ``--faults plan.json`` injects a ``launch.faults.FaultPlan``
(its ``to_json`` text), ``--resume-from ckpt_N.npz`` resumes from a
checkpoint (this port's or the JAX package's), on the mesh it was saved
on or a smaller one, and ``--sync-mode local`` starts in the lo-fi mode
(merged every ``--merge-every`` steps):

  python -m repro_torch.launch.train --arch gemma3-1b --d2ft --kernel \
      --distributed --elastic --faults plan.json --ckpt out.npz --device cpu
  python -m torch.distributed.run --standalone --nproc_per_node 2 \
      -m repro_torch.launch.train --arch gemma3-1b --d2ft --kernel \
      --distributed --elastic --mesh data=2 --faults plan.json --device cpu

``--ckpt out.npz`` saves ``{"params": ...}`` in the JAX package's layout
(``interop.params_to_jax``) at the end of every path. Where the caller
made the process group itself, ``--mesh`` may be smaller than the world:
the ranks past it sit the run out (``main`` returns None there), as the
devices past a JAX mesh's size are left out of it.

It runs on the card unless ``--device cpu`` is given, with a reduced
(smoke) config unless ``--full`` is passed. The weights are random, from
seed 0.
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import ATTN_GLOBAL, ATTN_LOCAL, D2FTConfig
from repro_torch.data.synthetic import lm_batches
from repro_torch.launch.parallel import MeshSpec, ParallelConfig
from repro_torch.models.transformer import check_tp_tiling, init_model
from repro_torch.optim.optimizers import adamw, sgd
from repro_torch.train.loop import TrainLog, finetune, finetune_distributed


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
                    help="use the packed D2FT execution path (attention "
                         "blocks with a dense FFN only)")
    ap.add_argument("--distributed", action="store_true",
                    help="data-parallel D2FT with the schedule-masked "
                         "gradient sync (one process per rank)")
    ap.add_argument("--kernel", action="store_true",
                    help="route the attention (any head_dim the kernels "
                         "take, 256 included), SSD, RG-LRU and MoE blocks "
                         "through the gated CUDA kernels (their plain "
                         "versions on the CPU)")
    ap.add_argument("--mesh", default=None, metavar="data=D,stage=S,tensor=T",
                    help="device mesh of the --distributed path: D x S x T "
                         "ranks, one process a rank (stage: the pipeline "
                         "over --n-microbatches micro-batches; tensor: "
                         "attention heads and FFN columns sharded)")
    ap.add_argument("--sync-mode",
                    choices=("masked", "zero", "zero3", "local"),
                    default="masked",
                    help="distributed gradient sync (only the --distributed "
                         "path): 'masked' = schedule-masked all-reduce "
                         "(replicated optimizer state), 'zero' = ZeRO-1 "
                         "sliced reduce-scatter / all-gather with the "
                         "optimizer moments sharded ~1/n_ranks, 'zero3' = "
                         "the parameters sharded too, with the "
                         "schedule-masked (gate-elided) forward gather, "
                         "'local' = lo-fi zero-sync replicas merged every "
                         "--merge-every steps (requires --elastic)")
    ap.add_argument("--refresh-every", type=int, default=None,
                    help="re-plan the schedule every k steps (only the "
                         "--distributed path)")
    ap.add_argument("--n-pf", type=int, default=3)
    ap.add_argument("--n-po", type=int, default=1)
    ap.add_argument("--n-microbatches", type=int, default=4)
    ap.add_argument("--full", action="store_true",
                    help="full-size config (default: the smoke config)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the kernels' plain versions)")
    ap.add_argument("--ckpt", default=None,
                    help="save the final parameters here (npz, the JAX "
                         "package's layout)")
    ap.add_argument("--elastic", action="store_true",
                    help="run the fault-tolerant elastic loop "
                         "(train.elastic.finetune_elastic): straggler-"
                         "aware replanning, dropout recovery from step-"
                         "level checkpoints, NaN-burst gradient guard, "
                         "lo-fi sync fallback; requires --distributed")
    ap.add_argument("--faults", default=None, metavar="PATH.json",
                    help="inject a deterministic FaultPlan from a JSON "
                         "file (launch.faults.FaultPlan.to_json) into the "
                         "elastic loop: slowdowns, a rank dropout, "
                         "gradient bursts, dropped sync rounds")
    ap.add_argument("--ckpt-every", type=int, default=1,
                    help="elastic step-level checkpoint cadence (steps); "
                         "0 disables periodic checkpoints")
    ap.add_argument("--ckpt-dir", default=None,
                    help="directory for elastic step-level checkpoints "
                         "(default: a fresh temp dir)")
    ap.add_argument("--merge-every", type=int, default=4,
                    help="lo-fi local-mode weight-merge cadence (steps)")
    ap.add_argument("--resume-from", default=None, metavar="CKPT.npz",
                    help="resume the elastic loop from a step-level "
                         "checkpoint (save_train_state format), on the "
                         "original mesh size or a shrunk one")
    return ap.parse_args(argv)


def _distributed_spec(args, spec, argv) -> MeshSpec:
    """The --distributed path's refusals, as the JAX launcher makes them,
    and its mesh spec (``--mesh``, else the world), which must match this
    process's world."""
    if not args.d2ft:
        raise SystemExit("--distributed requires --d2ft")
    if args.packed:
        raise SystemExit("--distributed and --packed are exclusive "
                         "(the shard_map step drives the gated paths)")
    world = int(os.environ.get("WORLD_SIZE", 1))
    spec = spec or MeshSpec(data=world)
    _parallel(args, spec)
    ndev = spec.data
    if spec.stage > 1 and (args.batch // ndev) % args.n_microbatches:
        raise SystemExit(
            f"pipeline needs the per-data-shard batch divisible by the "
            f"microbatch count: ({args.batch} / {ndev}) % "
            f"{args.n_microbatches} != 0")
    if args.n_microbatches % ndev:
        raise SystemExit(
            f"--distributed needs --n-microbatches divisible by the "
            f"data-mesh size: {args.n_microbatches} % {ndev} != 0 "
            "(equal-sized shard_map shards)")
    if args.batch % args.n_microbatches:
        raise SystemExit(
            f"--batch must be divisible by --n-microbatches: "
            f"{args.batch} % {args.n_microbatches} != 0")
    text = args.mesh or f"data={ndev}"
    if spec.size > 1 and "WORLD_SIZE" not in os.environ:
        raise SystemExit(
            f"--mesh {text} runs one process per rank; launch it as "
            f"python -m torch.distributed.run --standalone --nproc_per_node "
            f"{spec.size} -m repro_torch.launch.train "
            + " ".join(sys.argv[1:] if argv is None else argv))
    if spec.size > world or (spec.size < world
                             and not dist.is_initialized()):
        raise SystemExit(f"--mesh {text} does not match the world of "
                         f"{world} processes")
    return spec


def _parallel(args, spec: MeshSpec) -> ParallelConfig:
    """The run's ``ParallelConfig``: ``--n-microbatches`` is the pipeline's
    micro-batch count where there is a stage axis, as in the JAX
    launcher."""
    return ParallelConfig(
        mesh=spec, sync_mode=args.sync_mode, use_kernel=args.kernel,
        microbatches=args.n_microbatches if spec.stage > 1 else 0)


def main(argv=None) -> Optional[TrainLog]:
    args = parse_args(argv)
    spec = MeshSpec.parse(args.mesh) if args.mesh else None
    if spec is not None and not args.distributed:
        raise SystemExit("--mesh only applies to the --distributed path")
    if spec is not None and args.elastic and \
            (spec.stage > 1 or spec.tensor > 1):
        raise SystemExit("--elastic runs on a pure data mesh; use "
                         "--mesh data=N (stage=tensor=1)")
    if args.packed and args.kernel:
        raise SystemExit("--packed and --kernel are exclusive (the packed "
                         "gather path bypasses the gated attention kernel)")
    if not args.distributed and (args.sync_mode != "masked"
                                 or args.refresh_every is not None):
        raise SystemExit("--sync-mode/--refresh-every only apply to the "
                         "--distributed path")
    if not args.elastic and (args.faults or args.resume_from
                             or args.sync_mode == "local"):
        raise SystemExit("--faults/--resume-from/--sync-mode local require "
                         "--elastic (the plain distributed loop has no "
                         "fault handling)")
    if args.elastic and not args.distributed:
        raise SystemExit("--elastic requires --distributed")
    if args.packed and not args.d2ft:
        raise SystemExit("--packed runs a D2FT schedule: add --d2ft")
    if args.distributed:
        spec = _distributed_spec(args, spec, argv)
    cfg = get_config(args.arch) if args.full else get_smoke_config(args.arch)
    if cfg.frontend != "none":
        raise SystemExit("text-training launcher; audio/vlm archs run "
                         "through the scripts in examples/")
    if args.packed:
        other = sorted(set(cfg.layer_kinds) - {ATTN_GLOBAL, ATTN_LOCAL})
        if other or cfg.moe is not None:
            raise SystemExit(
                f"--packed runs attention blocks with a dense FFN only; "
                f"{cfg.name} has " + (f"{other} blocks" if other else
                                      "an MoE FFN"))
    if not args.distributed:
        return _run(args, cfg, resolve_device(args.device), None, None)
    # the model-dependent refusals before any process group is made
    _parallel(args, spec).validate_model(cfg)
    if spec.tensor > 1:
        check_tp_tiling(cfg, max(cfg.n_heads, 1), spec.tensor)
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh(spec, args.device)
    if mesh is None:
        return None             # a rank past the mesh: it sits the run out
    try:
        return _run(args, cfg, mesh.device, mesh, spec)
    finally:
        mesh.close()


def _run(args, cfg, dev, mesh, spec) -> TrainLog:
    """The fine-tune on ``dev``: ``finetune``, or with a mesh, rank
    ``mesh.rank``'s part of ``finetune_distributed`` (rank 0 prints)."""
    lead = mesh is None or mesh.rank == 0
    if lead:
        print(f"arch={cfg.name} layers={cfg.n_layers} d_model={cfg.d_model} "
              f"device={dev}" + (f" mesh={spec.describe()}" if mesh else ""))
    d2 = None
    if args.d2ft:
        d2 = D2FTConfig(n_microbatches=args.n_microbatches, n_pf=args.n_pf,
                        n_po=args.n_po,
                        head_groups=max(cfg.n_heads, 1))
        if lead:
            print(f"D2FT: {args.n_pf} p_f + {args.n_po} p_o of "
                  f"{args.n_microbatches} micro-batches "
                  f"(compute {100 * (args.n_pf + 0.4 * args.n_po) / args.n_microbatches:.0f}%)")

    model = init_model(torch.Generator(device=dev).manual_seed(0), cfg)
    opt = adamw(args.lr) if args.optimizer == "adamw" else sgd(args.lr)
    batches = lm_batches(0, cfg.vocab_size, args.batch, args.seq,
                         args.steps)
    t0 = time.time()
    if mesh is None:
        _, _, log = finetune(model, cfg, d2, opt, batches, steps=args.steps,
                             packed=args.packed, use_kernel=args.kernel)
    elif args.elastic:
        log = _run_elastic(args, cfg, d2, model, opt, batches, mesh)
        # after a dropout the survivors' first rank reports; the dropped
        # rank is silent
        lead = log.extras["elastic"]["rank"] == 0
        if lead:
            _print_sync(args, log, spec)
    else:
        _, _, log = finetune_distributed(
            model, cfg, d2, opt, batches, steps=args.steps, mesh=mesh,
            parallel=_parallel(args, spec),
            refresh_every=args.refresh_every)
        if lead:
            _print_sync(args, log, spec)
    dt = time.time() - t0
    if lead:
        print(f"{args.steps} steps in {dt:.1f}s — loss "
              f"{log.losses[0]:.3f} -> {log.losses[-1]:.3f}")
        if args.ckpt:
            from repro_torch.interop import params_to_jax
            from repro_torch.train.checkpoints import save_checkpoint
            save_checkpoint(args.ckpt, {"params": params_to_jax(
                dict(model.named_parameters()), cfg)})
            print(f"saved {args.ckpt}")
    return log


def _run_elastic(args, cfg, d2, model, opt, batches, mesh) -> TrainLog:
    """``finetune_elastic`` with the launcher's flags; the first rank of
    the final mesh prints the JAX launcher's elastic lines."""
    from repro_torch.launch.faults import FaultPlan
    from repro_torch.train.elastic import ElasticConfig, finetune_elastic
    fp = None
    if args.faults:
        with open(args.faults) as f:
            fp = FaultPlan.from_json(f.read())
    el = ElasticConfig(refresh_every=args.refresh_every,
                       ckpt_every=args.ckpt_every, ckpt_dir=args.ckpt_dir,
                       merge_every=args.merge_every)
    _, _, log = finetune_elastic(
        model, cfg, d2, opt, batches, steps=args.steps, mesh=mesh,
        sync_mode=args.sync_mode, faults=fp, elastic=el,
        use_kernel=args.kernel, resume_from=args.resume_from)
    ev = log.extras["elastic"]
    if ev["rank"] == 0:
        print(f"elastic: final_mode={ev['final_mode']} "
              f"devices={ev['n_devices']} "
              f"guard_skips={ev['guard_skips']} "
              f"sync_faults={ev['sync_faults']} "
              f"merges={ev['merges']}")
        for e in ev["events"]:
            print(f"  event: {e}")
        print(f"last checkpoint: {ev['last_ckpt']}")
    return log


def _print_sync(args, log, spec):
    """Rank 0's report of the distributed run: the JAX launcher's lines,
    then the bytes and host-clock ms each step sent (by collective where
    there is a stage or tensor axis)."""
    ndev = log.extras["elastic"]["n_devices"] if args.elastic else spec.data
    rep, sync = log.extras["rebalance"], log.extras.get("sync")
    print(f"assignment: loads {rep['loads']} spread {rep['spread']} "
          f"imbalance {rep['imbalance']:.3f} "
          f"({len(log.extras['refreshes'])} replans)")
    stages = log.extras.get("stages")
    if stages is not None:
        print(f"pipeline: boundaries {stages['boundaries']} "
              f"loads {stages['loads']} "
              f"makespan_ratio {stages['makespan_ratio']:.3f} "
              f"(vs layer-count {stages['layer_count_boundaries']}) "
              f"bubble {stages['bubble_fraction']:.3f}")
    if sync is None:
        print("grad sync: none (lo-fi local replicas, merged "
              f"every {args.merge_every} steps)")
    elif args.sync_mode in ("zero", "zero3"):
        print(f"grad sync ({args.sync_mode}): {sync['fraction']:.0%} "
              f"all-reduce-equivalent bytes ({sync['n_zero']} leaves "
              f"partitioned over {ndev} shards, "
              f"rs {sync['rs_bytes']:.2e}B / "
              f"ag {sync['ag_bytes']:.2e}B)")
        z3 = log.extras.get("zero3_params")
        if args.sync_mode == "zero3" and z3 is not None:
            print(f"param residency (zero3): "
                  f"{z3['fraction']:.0%} of replicated peak "
                  f"({z3['n_gather_elided']} forward-dead gathers "
                  f"elided, peak unit {z3['peak_unit']})")
    else:
        print(f"grad sync: {sync['fraction']:.0%} of param bytes "
              f"all-reduced ({sync['n_skipped']} leaves skipped, "
              f"{sync['n_sliced']} group-sliced)")
    print(f"sent per step {log.extras['sync_bytes']} bytes in "
          f"{[round(ms, 3) for ms in log.extras['sync_ms']]} ms")
    if spec.size > ndev:
        print(f"sent per step by collective "
              f"{log.extras['sync_bytes_by_kind']}")


if __name__ == "__main__":
    main()
