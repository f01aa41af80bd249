"""The ranks of the port's 2-rank gloo tests (imports torch and the port,
never jax): ``python tests/_torch_dist_ranks.py CASE DIR RANK WORLD`` runs
one rank.

A test calls ``run_ranks``, which writes ``DIR/inputs.pt`` (a port config
and state dict, a schedule table, a batch, and the case's settings),
starts WORLD of these processes, which meet through ``file://DIR/store``, and reads back
each ``DIR/rank<r>.pt``.

Cases:

* ``sync`` — each rank takes its shard of the batch (the port's device
  assignment and sample order), computes its gradients under the gates,
  saves them, runs ``apply_grad_sync`` and saves them again with the
  counter's bytes; then it takes one local SGD step of its own and runs
  the cross-rank ``lofi_merge_``, saving its parameters before and after.
* ``train`` — 3 SGD steps of ``make_distributed_train_step`` (masked) on
  the masked path and on the kernel path (the kernels' plain versions on
  the CPU), each from the same weights, saving losses and parameters; then
  2 steps of ``finetune_distributed(refresh_every=1)``, saving its log and
  parameters.
* ``zero`` — for each leg of ``inp["legs"]`` (name, sync mode, streamed,
  AdamW weight decay), 3 AdamW steps of the ZeRO step from the same
  weights on the masked path, saving the losses, each step's bytes by
  collective, the moments' bytes, the residency check of the streamed
  step (``check_zero3_residency``) and the canonical parameters after the
  run.
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs.base import D2FTConfig  # noqa: E402
from repro_torch.core.assignment import (device_sample_order,  # noqa: E402
                                         distributed_live_bounds,
                                         plan_device_assignment)
from repro_torch.core.schedule import Schedule, gates_from_schedule  # noqa
from repro_torch.data.synthetic import microbatch_assignment  # noqa: E402
from repro_torch.launch.mesh import make_data_mesh  # noqa: E402
from repro_torch.launch.parallel import MeshSpec, ParallelConfig  # noqa
from repro_torch.models.transformer import init_model, lm_loss  # noqa
from repro_torch.optim.optimizers import adamw, sgd  # noqa: E402
from repro_torch.sharding import sync  # noqa: E402
from repro_torch.sharding.sync import (apply_grad_sync,  # noqa: E402
                                       grad_sync_plan, lofi_merge_)
from repro_torch.train import loop  # noqa: E402


def _model(inp):
    cfg = inp["cfg"]
    model = init_model(torch.Generator().manual_seed(0), cfg)
    model.load_state_dict(inp["state"])
    return cfg, model


def _shard(inp, sched, mesh):
    """(local sample indices, gates, live bounds) of this rank."""
    B = inp["tokens"].shape[0]
    mb_of = microbatch_assignment(B, sched.n_microbatches)
    assignment, _ = plan_device_assignment(sched, mesh.size)
    perm = device_sample_order(assignment, mb_of)
    n = B // mesh.size
    local = perm[mesh.rank * n:(mesh.rank + 1) * n]
    gates = gates_from_schedule(sched, mb_of[local], "cpu")
    bounds = distributed_live_bounds(sched, mb_of, assignment)
    return local, gates, bounds


def _params(model):
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def case_sync(inp, mesh, sched):
    cfg, model = _model(inp)
    local, gates, _ = _shard(inp, sched, mesh)
    params = dict(model.named_parameters())
    loss, _ = lm_loss(model, cfg, inp["tokens"][local], inp["labels"][local],
                      gates=gates)
    grads = loop._grads(loss, params)
    before = {n: g.clone() for n, g in grads.items()}
    plan = grad_sync_plan(model, cfg, sched)
    apply_grad_sync(grads, plan, mesh)
    sent, calls = mesh.counter.total(), mesh.counter.calls["all_reduce"]
    opt = sgd(0.1, momentum=0.0)
    opt.update(before, opt.init(params), params)
    replica = _params(model)
    lofi_merge_(params, plan, mesh)
    return {"before": before, "after": grads, "sent": sent, "calls": calls,
            "replica": replica, "merged": _params(model)}


def case_train(inp, mesh, sched):
    out = {}
    for use_kernel in (False, True):
        cfg, model = _model(inp)
        local, gates, bounds = _shard(inp, sched, mesh)
        opt = sgd(1e-2)
        state = opt.init(dict(model.named_parameters()))
        step = loop.make_distributed_train_step(
            cfg, opt, mesh, grad_sync_plan(model, cfg, sched),
            parallel=ParallelConfig(mesh=MeshSpec(data=mesh.size),
                                    use_kernel=use_kernel),
            live_bounds=bounds if use_kernel else None)
        losses = []
        for _ in range(3):
            _, state, metrics = step(model, state,
                                     {"tokens": inp["tokens"][local],
                                      "labels": inp["labels"][local]}, gates)
            losses.append(float(metrics["loss"]))
        out[f"losses_{use_kernel}"] = losses
        out[f"params_{use_kernel}"] = _params(model)
    cfg, model = _model(inp)
    d2 = D2FTConfig(**inp["d2"])
    batches = [{"tokens": inp["tokens"].numpy(),
                "labels": inp["labels"].numpy()}] * 2
    _, _, log = loop.finetune_distributed(
        model, cfg, d2, sgd(1e-2), batches, steps=2, mesh=mesh,
        parallel=ParallelConfig(mesh=MeshSpec(data=mesh.size),
                                use_kernel=True), refresh_every=1)
    out["loop_losses"] = log.losses
    out["loop_sync_bytes"] = log.extras["sync_bytes"]
    out["loop_ar_bytes"] = [r["sync"]["ar_bytes"]
                            for r in log.extras["refreshes"]]
    out["loop_params"] = _params(model)
    return out


def case_zero(inp, mesh, sched):
    out = {}
    for name, mode, streamed, wd in inp["legs"]:
        cfg, model = _model(inp)
        local, gates, _ = _shard(inp, sched, mesh)
        opt = adamw(inp["lr"], weight_decay=wd)
        shapes = {n: torch.empty(p.shape, device="meta")
                  for n, p in model.named_parameters()}
        plan = grad_sync_plan(shapes, cfg, sched, mode, n_shards=mesh.size,
                              elide_gather=opt.elidable)
        if mode == "zero3":
            sync.zero3_shard_model_(model, plan, mesh.rank)
        state = opt.init({n: torch.empty(sync.zero_shard_shape(s.shape,
                                                               plan[n]))
                          for n, s in shapes.items()})
        recorder = sync.ResidencyRecorder() if streamed else None
        step = loop.make_distributed_train_step(
            cfg, opt, mesh, plan, residency_recorder=recorder,
            parallel=ParallelConfig(mesh=MeshSpec(data=mesh.size),
                                    sync_mode=mode, streamed=streamed))
        losses, sent = [], []
        for _ in range(3):
            before = dict(mesh.counter.bytes)
            _, state, metrics = step(model, state,
                                     {"tokens": inp["tokens"][local],
                                      "labels": inp["labels"][local]}, gates)
            losses.append(float(metrics["loss"]))
            sent.append({k: v - before.get(k, 0)
                         for k, v in mesh.counter.bytes.items()
                         if v != before.get(k, 0)})
        out[name] = {
            "losses": losses, "sent": sent,
            "moment_bytes": sum(t.numel() * t.element_size()
                                for k in ("m", "v")
                                for t in state[k].values()),
            "residency": None if recorder is None else
            sync.check_zero3_residency(recorder, plan, shapes, mesh.size)}
        if mode == "zero3":
            sync.zero3_unshard_model_(model, plan, mesh)
        out[name]["params"] = _params(model)
    return out


def run_ranks(case, root, inputs, world=2, timeout=240):
    """Start ``world`` ranks of ``case`` on ``inputs`` (in ``root``, a
    fresh directory) and return each rank's saved results."""
    torch.save(inputs, root / "inputs.pt")
    procs = [subprocess.Popen([sys.executable, __file__, case, str(root),
                               str(r), str(world)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"rank exited with {p.returncode}:\n{out}")
    return [torch.load(root / f"rank{r}.pt") for r in range(world)]


def main():
    case, root, rank, world = sys.argv[1], Path(sys.argv[2]), \
        int(sys.argv[3]), int(sys.argv[4])
    torch.manual_seed(0)
    dist.init_process_group("gloo", init_method=f"file://{root / 'store'}",
                            rank=rank, world_size=world)
    try:
        mesh = make_data_mesh(world, "cpu")
        # the test process wrote these inputs (a ModelConfig among them)
        inp = torch.load(root / "inputs.pt", weights_only=False)
        sched = Schedule(inp["table"].numpy().astype(np.int8),
                         inp["cfg"].n_layers, inp["G"])
        out = {"sync": case_sync, "train": case_train,
               "zero": case_zero}[case](inp, mesh, sched)
        torch.save(out, root / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
