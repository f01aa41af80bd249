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
* ``elastic`` — ``train.elastic.finetune_elastic`` on the two ranks,
  two legs. (a) The plan drops rank 1 at step 3 (checkpoints every 2):
  each rank saves its events, losses, parameters and the steps it ran;
  then rank 0 alone resumes the step-2 checkpoint on a mesh of its own
  (``launch.mesh.sub_mesh``) and saves the same. (b) Dropped syncs at
  steps 1 and 2 into the lo-fi mode, merged every 2 steps, checkpoints in
  the default directory (rank 0's, broadcast): each rank saves its events
  and, after every merge, its parameters and the bytes the merge sent.
* ``multiaxis`` — a world of 8 (``launch.mesh.make_mesh``), one arm after
  another, each 3 SGD steps of the step from the same weights, saving its
  losses, each step's bytes by collective, the pipeline's round report and
  the parameters: (data=4, tensor=2), the same with ZeRO-3, (data=2,
  stage=2) on ranks 0-3 (M = 4, the live-cost stage assignment),
  (data=2, stage=2, tensor=2), and (data=4, tensor=2) with D2FT-LoRA
  (``merge_lora``, then the loss under ``tp``, the adapter grads summed
  over the tensor axis before the data axis's mean). Then the tensor
  axis's f and g operators on rank-dependent inputs, and the launcher's
  ``--mesh data=4,stage=2`` and ``data=4,tensor=2`` on stablelm-3b's
  smoke config, saving their logs and the schedules they planned.
* ``diststep`` — ``launch.diststep.measure_distributed_step`` at its
  small config on the ranks (``time_steps`` 0), every
  ``torch.distributed`` function that sends or receives wrapped to count
  its calls: saves the record and the counts.
* ``elastic_measure`` — ``launch.diststep.measure_elastic`` on the ranks
  (a world of 4), the elastic loop's capacity-mitigated device
  assignments captured (schedule table, ranks, capacities): saves the
  record and the captures.
"""
import os
import subprocess
import sys
import time
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
from repro_torch.launch.mesh import make_data_mesh, make_mesh  # noqa
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


MULTIAXIS_ARMS = (
    ("tp", dict(data=4, tensor=2), "masked"),
    ("tp_zero3", dict(data=4, tensor=2), "zero3"),
    ("pipe", dict(data=2, stage=2), "masked"),
    ("all3", dict(data=2, stage=2, tensor=2), "masked"),
    ("lora_tp", dict(data=4, tensor=2), "lora"))


def _arm_shard(inp, sched, mesh):
    """This rank's contiguous block of the batch by its data index (the
    JAX shard_map's batch sharding) and its gates."""
    B = inp["tokens"].shape[0]
    n = B // mesh.data.size
    rows = slice(mesh.data.rank * n, (mesh.data.rank + 1) * n)
    g_f, g_b = gates_from_schedule(
        sched, microbatch_assignment(B, sched.n_microbatches), "cpu")
    return ({"tokens": inp["tokens"][rows], "labels": inp["labels"][rows]},
            (g_f[:, rows], g_b[:, rows]))


def _lora_arm(inp, sched, mesh):
    from repro_torch.core.lora import call_with_weights, merge_lora
    cfg, model = _model(inp)
    batch, gates = _arm_shard(inp, sched, mesh)
    lora = {n: {k: t.clone().requires_grad_() for k, t in ab.items()}
            for n, ab in inp["lora"].items()}
    lp = {f"{n}.{k}": ab[k] for n, ab in lora.items() for k in ("a", "b")}
    params = dict(model.named_parameters())
    plan = {n: sync.SyncSpec("all") for n in lp}
    opt = sgd(1e-2)
    state = opt.init(lp)
    losses, sent = [], []
    for _ in range(3):
        before = dict(mesh.counter.bytes)
        loss, _ = call_with_weights(
            lm_loss, model, merge_lora(params, lora, 1.0), cfg,
            batch["tokens"], batch["labels"], gates=gates, tp=mesh.tensor)
        grads = dict(zip(lp, torch.autograd.grad(loss, list(lp.values()))))
        # the adapter grads come through this rank's slice of the merged
        # weights: the tensor axis sums them, then the data axis averages
        sync.sum_over_axis_(grads.values(), mesh.tensor, "tp_grad")
        sync.apply_grad_sync(grads, plan, mesh.data)
        opt.update(grads, state, lp)
        losses.append(float(mesh.data.all_reduce_(loss.detach().clone())
                            / mesh.data.size))
        sent.append({k: v - before.get(k, 0)
                     for k, v in mesh.counter.bytes.items()
                     if v != before.get(k, 0)})
    return {"losses": losses, "sent": sent,
            "params": {n: t.detach().clone() for n, t in lp.items()}}


def _step_arm(inp, sched, mesh, spec, mode):
    from repro_torch.core.assignment import plan_stage_assignment
    from repro_torch.train.pipeline import PipelineRecorder
    cfg, model = _model(inp)
    batch, gates = _arm_shard(inp, sched, mesh)
    opt = sgd(1e-2)
    shapes = {n: torch.empty(p.shape, device="meta")
              for n, p in model.named_parameters()}
    plan = grad_sync_plan(shapes, cfg, sched, mode,
                          n_shards=mesh.data.size)
    if mode == "zero3":
        sync.zero3_shard_model_(model, plan, mesh.data.rank)
    state = opt.init({n: torch.empty(sync.zero_shard_shape(s.shape,
                                                           plan[n]))
                      for n, s in shapes.items()})
    stages = recorder = None
    if spec.stage > 1:
        stages, _ = plan_stage_assignment(sched, spec.stage)
        recorder = PipelineRecorder()
    step = loop.make_distributed_train_step(
        cfg, opt, mesh, plan, stage_assignment=stages,
        pipeline_recorder=recorder,
        parallel=ParallelConfig(mesh=spec, sync_mode=mode,
                                microbatches=4 if spec.stage > 1 else 0))
    losses, sent = [], []
    for _ in range(3):
        before = dict(mesh.counter.bytes)
        _, state, metrics = step(model, state, batch, gates)
        losses.append(float(metrics["loss"]))
        sent.append({k: v - before.get(k, 0)
                     for k, v in mesh.counter.bytes.items()
                     if v != before.get(k, 0)})
    if mode == "zero3":
        sync.zero3_unshard_model_(model, plan, mesh.data)
    return {"losses": losses, "sent": sent, "params": _params(model),
            "report": None if recorder is None else recorder.report(),
            "boundaries": None if stages is None else stages.boundaries}


def _tp_operators(mesh):
    """f and g on the tensor axis: forward values and the gradients of
    rank-dependent cotangents."""
    from repro_torch.models.transformer import _tp_copy, _tp_sum
    tp, r = mesh.tensor, mesh.tensor.rank
    out = {}
    for name, op in (("copy", _tp_copy), ("sum", _tp_sum)):
        x = (torch.arange(6.0) * (1 + r)).requires_grad_()
        before = dict(mesh.counter.calls)
        y = op(x, tp)
        y.backward(torch.full((6,), float(r + 1)))
        out[name] = {"y": y.detach(), "grad": x.grad.clone(),
                     "calls": mesh.counter.calls.get("tp_act", 0)
                     - before.get("tp_act", 0)}
    return out


def _launcher_runs():
    """The launcher at --mesh data=4,stage=2 and data=4,tensor=2 (stablelm
    smoke), with the schedule tables it planned."""
    from repro_torch.core import assignment
    from repro_torch.launch import train as launcher
    os.environ["WORLD_SIZE"] = str(dist.get_world_size())
    out = {}
    for mesh_arg in ("data=4,stage=2", "data=4,tensor=2"):
        tables = []
        orig = assignment.plan_device_assignment

        def capture(sched, n, orig=orig, tables=tables):
            tables.append(torch.as_tensor(sched.table))
            return orig(sched, n)
        assignment.plan_device_assignment = capture
        try:
            log = launcher.main([
                "--arch", "stablelm-3b", "--d2ft", "--distributed",
                "--mesh", mesh_arg, "--batch", "16", "--seq", "16",
                "--steps", "2", "--refresh-every", "1", "--optimizer",
                "sgd", "--device", "cpu"])
        finally:
            assignment.plan_device_assignment = orig
        out[mesh_arg] = {"losses": log.losses, "tables": tables,
                         "stages": [r.get("stages")
                                    for r in log.extras["refreshes"]],
                         "by_kind": log.extras["sync_bytes_by_kind"]}
    return out


def case_multiaxis(inp, world_mesh, sched):
    out = {}
    for name, axes, mode in MULTIAXIS_ARMS:
        spec = MeshSpec(**axes)
        mesh = make_mesh(spec, "cpu")
        if mesh is None:
            continue
        out[name] = _lora_arm(inp, sched, mesh) if mode == "lora" else \
            _step_arm(inp, sched, mesh, spec, mode)
        out[name]["coords"] = mesh.coords
        out[name]["axes"] = {
            ax: (getattr(mesh, ax).size, getattr(mesh, ax).trivial)
            for ax in ("world", "data", "stage", "tensor")}
        if name == "tp":
            out["tp_operators"] = _tp_operators(mesh)
    out["launcher"] = _launcher_runs()
    return out


def run_ranks(case, root, inputs, world=2, timeout=240):
    """Start ``world`` ranks of ``case`` on ``inputs`` (in ``root``, a
    fresh directory) and return each rank's saved results."""
    return start_ranks(case, root, inputs, world, timeout)()


def start_ranks(case, root, inputs, world=2, timeout=240):
    """``run_ranks`` that returns as soon as the ranks have started: call
    what it returns for each rank's saved results (the caller works
    meanwhile)."""
    torch.save(inputs, root / "inputs.pt")
    # one thread a rank: the ranks share the CPU with each other and with
    # the test run's other workers
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, __file__, case, str(root),
                               str(r), str(world)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, env=env) for r in range(world)]
    t_end = time.monotonic() + timeout

    def results():
        outs = []
        try:
            for p in procs:
                left = max(t_end - time.monotonic(), 1.0)
                outs.append(p.communicate(timeout=left)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for p, out in zip(procs, outs):
            if p.returncode != 0:
                raise RuntimeError(f"rank exited with {p.returncode}:\n{out}")
        return [torch.load(root / f"rank{r}.pt") for r in range(world)]
    return results


def case_elastic(inp, mesh, sched):
    from repro_torch.launch.faults import FaultPlan
    from repro_torch.launch.mesh import sub_mesh
    from repro_torch.train import elastic

    d2 = D2FTConfig(**inp["d2"])
    root = Path(inp["root"])
    out = {}

    def run(faults, steps, run_mesh, **kw):
        cfg, model = _model(inp)
        el = elastic.ElasticConfig(**kw.pop("el"))
        _, _, log = elastic.finetune_elastic(
            model, cfg, d2, sgd(0.1), inp["batches"], steps=steps,
            mesh=run_mesh, faults=faults, elastic=el, use_kernel=True, **kw)
        ev = log.extras["elastic"]
        return {"events": ev["events"], "losses": log.losses,
                "params": _params(model), "steps_run": len(log.losses),
                "dropped": ev["dropped"], "final_mode": ev["final_mode"]}

    out["dropout"] = run(FaultPlan(dropout=(3, 1)), 5, mesh,
                         el=dict(ckpt_every=2, ckpt_dir=str(root / "a")))
    alone = sub_mesh(mesh, [0])
    if alone is not None:
        out["resumed"] = run(None, 5, alone,
                             el=dict(ckpt_every=0, ckpt_dir=str(root / "r")),
                             resume_from=str(root / "a" / "ckpt_2.npz"))
    merged, merge_bytes = [], []
    merge = sync.lofi_merge_

    def recorded(named, plan, m, kind="all_reduce"):
        sent = m.counter.bytes.get(kind, 0)
        merge(named, plan, m, kind)
        merged.append({n: t.clone() for n, t in named.items()})
        merge_bytes.append(m.counter.bytes[kind] - sent)
        return named

    # the default checkpoint directory: rank 0's fresh temporary directory,
    # broadcast (made under the test's own directory)
    import tempfile
    sync.lofi_merge_, tempfile.tempdir = recorded, str(root)
    try:
        out["lofi"] = run(FaultPlan(dropped_syncs=(1, 2)), 6, mesh,
                          el=dict(ckpt_every=0, merge_every=2))
    finally:
        sync.lofi_merge_, tempfile.tempdir = merge, None
    out["lofi"].update(merged=merged, merge_bytes=merge_bytes)
    return out


# the torch.distributed functions that move data between ranks
DIST_CALLS = ("all_reduce", "broadcast", "reduce_scatter_tensor",
              "all_gather_into_tensor", "send", "recv", "isend", "irecv",
              "all_gather", "reduce_scatter", "all_to_all",
              "all_to_all_single", "gather", "scatter", "reduce", "barrier",
              "all_gather_object", "broadcast_object_list",
              "batch_isend_irecv")


def case_diststep(inp, mesh, sched):
    from repro_torch.launch import diststep
    counts = {}
    real = {n: getattr(dist, n) for n in DIST_CALLS if hasattr(dist, n)}

    def counting(name, fn):
        def call(*a, **k):
            counts[name] = counts.get(name, 0) + 1
            return fn(*a, **k)
        return call
    for name, fn in real.items():
        setattr(dist, name, counting(name, fn))
    try:
        rec = diststep.measure_distributed_step(mesh.size, device="cpu")
    finally:
        for name, fn in real.items():
            setattr(dist, name, fn)
    return {"record": rec, "counts": counts}


def case_elastic_measure(inp, mesh, sched):
    from repro_torch.launch import diststep
    from repro_torch.train import elastic
    mitigated = []
    orig = elastic.plan_device_assignment

    def capture(sched, n, caps=None):
        if caps is not None:
            mitigated.append({"table": torch.from_numpy(sched.table.copy()),
                              "n": n, "caps": torch.from_numpy(
                                  np.array(caps, np.float64))})
        return orig(sched, n, caps)
    elastic.plan_device_assignment = capture
    try:
        rec = diststep.measure_elastic(mesh.size, device="cpu")
    finally:
        elastic.plan_device_assignment = orig
    return {"record": rec, "mitigated": mitigated}


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
                         inp["cfg"].n_layers, inp["G"]) \
            if "table" in inp else None
        inp["root"] = str(root)
        out = {"sync": case_sync, "train": case_train, "zero": case_zero,
               "multiaxis": case_multiaxis, "elastic": case_elastic,
               "diststep": case_diststep,
               "elastic_measure": case_elastic_measure}[case](inp, mesh,
                                                              sched)
        torch.save(out, root / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
