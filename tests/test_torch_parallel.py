"""The port's parallelism config, its refusals and the chunked optimizer
(``repro_torch/launch/parallel.py``, ``launch/train.py``'s distributed
flags, ``optim/optimizers.py::chunked``) against the JAX package on the
CPU: ``MeshSpec.parse`` and ``ParallelConfig`` give JAX's results, error
types and messages, case for case; the launcher refuses the distributed
flags' misuses, ``--mesh`` among them, with JAX's messages; what the port
ran "not ported yet" before runs now (the guard builds with JAX's
refusals only, the launcher's elastic flags take JAX's refusals), and so
do the ZeRO, stage and tensor calls;
``chunked`` is bit-identical to the unchunked SGD and AdamW updates.
"""
import sys
import warnings

import numpy as np
import pytest
import torch

from repro.launch import train as jax_launcher
from repro.launch.parallel import MeshSpec as JaxMeshSpec
from repro.launch.parallel import ParallelConfig as JaxParallelConfig
from repro_torch.configs import gemma3_1b
from repro_torch.configs.base import D2FTConfig
from repro_torch.core.assignment import plan_stage_assignment
from repro_torch.core.schedule import Schedule
from repro_torch.launch import train as launcher
from repro_torch.launch.parallel import MeshSpec, ParallelConfig
from repro_torch.optim.optimizers import adamw, chunked, sgd
from repro_torch.train import loop


def _outcome(fn):
    """(exception type name, message) or ("ok", repr of the result)."""
    try:
        return "ok", fn()
    except (AssertionError, ValueError, TypeError,
            NotImplementedError) as e:
        return type(e).__name__, str(e)


@pytest.mark.parametrize("text", [
    "data=4,stage=2,tensor=1", "data=8", "", " data = 2 , tensor=2 ",
    "data", "pod=2", "data=2,data=4", "data=0", "stage=-1", "data=x"])
def test_mesh_spec_parse_matches_jax(text):
    def shape(cls):
        return lambda: (cls.parse(text).shape, cls.parse(text).size,
                        cls.parse(text).describe())
    assert _outcome(shape(MeshSpec)) == _outcome(shape(JaxMeshSpec))


@pytest.mark.parametrize("kw", [
    dict(), dict(sync_mode="zero"), dict(sync_mode="zero3"),
    dict(sync_mode="local"), dict(sync_mode="bogus"),
    dict(sync_mode="zero3", streamed=True),
    dict(sync_mode="zero3", opt_chunk=64),
    dict(streamed=True), dict(opt_chunk=64),
    dict(sync_mode="zero3", streamed=True, guard=True),
    dict(sync_mode="local", mesh=dict(stage=2), microbatches=2),
    dict(sync_mode="zero3", streamed=True, mesh=dict(tensor=2)),
    dict(guard=True, mesh=dict(tensor=2)),
    dict(use_kernel=True, mesh=dict(stage=2), microbatches=2),
    dict(mesh=dict(stage=2)), dict(microbatches=2),
    dict(mesh=dict(data=0)), dict(use_kernel=True, mesh=dict(data=4)),
    dict(mesh=dict(stage=2), microbatches=4), dict(mesh=dict(tensor=2)),
    dict(mesh=dict(data=2, stage=2, tensor=2), microbatches=4,
         sync_mode="zero3"),
    dict(use_kernel=True, mesh=dict(tensor=2)),
    dict(sync_mode="zero", mesh=dict(tensor=2), microbatches=1)],
    ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()) or "default")
def test_parallel_config_matches_jax(kw):
    """Every config the JAX package refuses is refused with its error; the
    ones it accepts are accepted."""
    def make(config, spec):
        def build():
            args = dict(kw)
            args["mesh"] = spec(**args.get("mesh", {}))
            c = config(**args)
            return (c.mesh.shape, c.sync_mode, c.data_axis, c.stage_axis,
                    c.tensor_axis)
        return build
    assert _outcome(make(ParallelConfig, MeshSpec)) == \
        _outcome(make(JaxParallelConfig, JaxMeshSpec))


@pytest.mark.parametrize("what", ["guard", "launcher_elastic"])
def test_what_is_not_ported_says_so(what, monkeypatch):
    """What said "not ported yet" before the elastic slice: the guard
    builds as JAX's does (on a data mesh, masked or ZeRO), and the
    launcher's ``--elastic`` reaches JAX's refusal of a stage axis, with
    its message."""
    if what == "guard":
        for kw in (dict(), dict(sync_mode="zero3"),
                   dict(sync_mode="local", mesh=dict(data=2))):
            def build(config, spec):
                c = config(guard=True, **dict(kw, mesh=spec(
                    **kw.get("mesh", {}))))
                return c.guard, c.sync_mode, c.mesh.shape
            assert _outcome(lambda: build(ParallelConfig, MeshSpec)) == \
                _outcome(lambda: build(JaxParallelConfig, JaxMeshSpec)) == \
                ("ok", (True, kw.get("sync_mode", "masked"),
                        (kw.get("mesh", {}).get("data", 1), 1, 1)))
        return
    argv = ["--arch", "gemma3-1b", "--d2ft", "--distributed", "--elastic",
            "--mesh", "data=1,stage=2"]
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    with pytest.raises(SystemExit) as theirs:
        jax_launcher.main()
    with pytest.raises(SystemExit) as mine:
        launcher.main(argv + ["--device", "cpu"])
    assert str(mine.value) == str(theirs.value) == (
        "--elastic runs on a pure data mesh; use --mesh data=N "
        "(stage=tensor=1)")


@pytest.mark.parametrize("what", [
    "step_zero", "step_zero3", "loop_zero3", "plan_zero", "launcher_zero",
    "launcher_zero3", "require_zero3_streamed", "stage", "tensor",
    "step_stage", "launcher_stage"])
def test_what_was_refused_now_runs(what, capsys):
    """The ZeRO calls that raised "not ported yet" before the ZeRO slice
    run: the steps and the plan are made, the loop and the launcher run
    one step on the CPU (a world of one), and the launcher prints the JAX
    launcher's two lines (``grad sync (zero...)``, and ``param residency
    (zero3)`` under zero3) from the run's own reports. So do the stage and
    tensor configs and the pipeline step, and the launcher's ``--mesh
    data=1,stage=2`` asks for its two processes (its runs are in
    tests/test_torch_multiaxis.py)."""
    from repro_torch.launch.mesh import make_data_mesh
    from repro_torch.sharding import sync
    cfg = gemma3_1b.smoke_config()
    d2 = D2FTConfig(n_microbatches=4, n_pf=3, n_po=1, head_groups=4)
    argv = ["--arch", "gemma3-1b", "--d2ft", "--distributed", "--device",
            "cpu", "--steps", "1", "--batch", "4", "--seq", "16"]
    table = np.full((cfg.n_layers * 4, 4), 1, np.int8)
    sched = Schedule(table, cfg.n_layers, 4)

    def loop_zero3():
        from repro_torch.data.synthetic import lm_batches
        from repro_torch.models.transformer import init_model
        mesh = make_data_mesh(1, "cpu")
        try:
            _, state, log = loop.finetune_distributed(
                init_model(torch.Generator().manual_seed(0), cfg), cfg, d2,
                sgd(0.1), lm_batches(0, cfg.vocab_size, 4, 16, 1), steps=1,
                mesh=mesh, parallel=ParallelConfig(sync_mode="zero3"))
        finally:
            mesh.close()
        return log

    calls = {
        "step_zero": lambda: loop.make_distributed_train_step(
            cfg, sgd(0.1), None, None,
            parallel=ParallelConfig(sync_mode="zero")),
        "step_zero3": lambda: loop.make_distributed_train_step(
            cfg, sgd(0.1), None, None,
            parallel=ParallelConfig(sync_mode="zero3")),
        "loop_zero3": loop_zero3,
        "plan_zero": lambda: sync.grad_sync_plan(
            {"embed.table": torch.empty(8, 4)}, cfg, sched, "zero",
            n_shards=2),
        "launcher_zero": lambda: launcher.main(argv + ["--sync-mode",
                                                       "zero"]),
        "launcher_zero3": lambda: launcher.main(argv + ["--sync-mode",
                                                        "zero3"]),
        "require_zero3_streamed": lambda: ParallelConfig(
            sync_mode="zero3", streamed=True).validate(),
        "stage": lambda: ParallelConfig(mesh=MeshSpec(stage=2),
                                        microbatches=2).validate(),
        "tensor": lambda: ParallelConfig(
            mesh=MeshSpec(tensor=2)).validate(),
        "step_stage": lambda: loop.make_distributed_train_step(
            cfg, sgd(0.1), None, None,
            parallel=ParallelConfig(mesh=MeshSpec(stage=2), microbatches=2),
            stage_assignment=plan_stage_assignment(sched, 2)[0]),
    }
    if what == "launcher_stage":
        with pytest.raises(SystemExit) as e:
            launcher.main(argv + ["--mesh", "data=1,stage=2"])
        assert str(e.value).startswith(
            "--mesh data=1,stage=2 runs one process per rank; launch it as "
            "python -m torch.distributed.run --standalone --nproc_per_node "
            "2 -m repro_torch.launch.train")
        return
    out = calls[what]()
    if what == "plan_zero":
        assert out["embed.table"] == sync.SyncSpec(
            "zero", axis=0, live=(True,), gather=(True,), shards=2)
    if what in ("loop_zero3", "launcher_zero", "launcher_zero3"):
        assert np.isfinite(out.losses).all()
    if what.startswith("launcher"):
        mode = what.split("_")[1]
        lines = capsys.readouterr().out.splitlines()
        rep = out.extras["sync"]
        assert f"grad sync ({mode}): {rep['fraction']:.0%} all-reduce-" \
            f"equivalent bytes ({rep['n_zero']} leaves partitioned over 1 " \
            f"shards, rs {rep['rs_bytes']:.2e}B / ag " \
            f"{rep['ag_bytes']:.2e}B)" in lines
        z3 = out.extras.get("zero3_params")
        assert (z3 is not None) == (mode == "zero3")
        if z3 is not None:
            assert f"param residency (zero3): {z3['fraction']:.0%} of " \
                f"replicated peak ({z3['n_gather_elided']} forward-dead " \
                f"gathers elided, peak unit {z3['peak_unit']})" in lines


@pytest.mark.parametrize("argv", [
    ["--mesh", "data=1"],
    ["--sync-mode", "zero"],
    ["--refresh-every", "2"],
    ["--distributed", "--d2ft", "--sync-mode", "local"],
    ["--elastic"], ["--faults", "plan.json"], ["--resume-from", "c.npz"],
    ["--distributed", "--d2ft", "--elastic", "--mesh", "tensor=2"],
    ["--distributed"],
    ["--distributed", "--d2ft", "--packed"],
    ["--distributed", "--d2ft", "--batch", "6"],
    ["--d2ft", "--packed", "--kernel"]],
    ids=lambda a: " ".join(a))
def test_launcher_refusals_match_jax(argv, monkeypatch):
    """The JAX launcher's refusals of the distributed flags' misuses, with
    its messages (the JAX launcher reads sys.argv)."""
    base = ["--arch", "mamba2-130m", "--steps", "1"]
    monkeypatch.setattr(sys, "argv", ["train"] + base + argv)
    with pytest.raises(SystemExit) as theirs:
        jax_launcher.main()
    with pytest.raises(SystemExit) as mine:
        launcher.main(base + argv + ["--device", "cpu"])
    assert str(mine.value) == str(theirs.value)


@pytest.mark.parametrize("argv,env,match", [
    (["--mesh", "data=3"], {},
     "--distributed needs --n-microbatches divisible by the data-mesh "
     "size: 4 % 3 != 0 (equal-sized shard_map shards)"),
    (["--mesh", "data=2"], {},
     "--mesh data=2 runs one process per rank; launch it as python -m "
     "torch.distributed.run --standalone --nproc_per_node 2 -m "
     "repro_torch.launch.train --arch gemma3-1b --steps 1 --d2ft "
     "--distributed --mesh data=2 --device cpu"),
    (["--mesh", "data=1"], {"WORLD_SIZE": "2"},
     "--mesh data=1 does not match the world of 2 processes"),
    (["--mesh", "data=2,stage=2"], {"WORLD_SIZE": "2"},
     "--mesh data=2,stage=2 does not match the world of 2 processes"),
    (["--mesh", "stage=2,tensor=2"], {},
     "--mesh stage=2,tensor=2 runs one process per rank; launch it as "
     "python -m torch.distributed.run --standalone --nproc_per_node 4 -m "
     "repro_torch.launch.train --arch gemma3-1b --steps 1 --d2ft "
     "--distributed --mesh stage=2,tensor=2 --device cpu"),
    (["--mesh", "data=2,stage=2", "--batch", "4"], {"WORLD_SIZE": "4"},
     "pipeline needs the per-data-shard batch divisible by the microbatch "
     "count: (4 / 2) % 4 != 0")],
    ids=["n_microbatches", "torchrun", "world", "world_of_d_s_t",
         "torchrun_of_d_s_t", "pipeline_shard"])
def test_launcher_mesh_must_match_the_world(argv, env, match, monkeypatch):
    """What the port's process-per-rank launch adds: the world equals
    D x S x T of ``--mesh``, and more than one rank needs
    ``torch.distributed.run`` (where the JAX launcher refuses a mesh of
    more devices than the host has); the n_microbatches % data and
    pipeline-shard refusals are JAX's messages (the JAX launcher reaches
    them only on such a mesh)."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(SystemExit) as e:
        launcher.main(["--arch", "gemma3-1b", "--steps", "1", "--d2ft",
                       "--distributed"] + argv + ["--device", "cpu"])
    assert str(e.value) == match


@pytest.mark.parametrize("argv,env,config", [
    (["--kernel", "--mesh", "tensor=2"], {"WORLD_SIZE": "2"},
     dict(mesh=dict(tensor=2), use_kernel=True)),
    (["--mesh", "stage=2", "--n-microbatches", "0"], {"WORLD_SIZE": "2"},
     dict(mesh=dict(stage=2), microbatches=0)),
    (["--mesh", "tensor=3"], {"WORLD_SIZE": "3"},
     dict(mesh=dict(tensor=3), model=True)),
    (["--mesh", "stage=4"], {"WORLD_SIZE": "4"},
     dict(mesh=dict(stage=4), microbatches=4, model=True))],
    ids=["kernel_tensor", "stage_without_m", "tensor3_on_4_heads",
         "stage4_on_2_layers"])
def test_launcher_mesh_refusals_match_jax(argv, env, config, monkeypatch):
    """The launcher's refusals of a stage or tensor axis, case by case,
    with the error and message of the JAX package's ``ParallelConfig``
    (and ``validate_model`` on the arch's smoke config), before any
    process group is made (the JAX launcher builds its device mesh first,
    which this host's one device cannot hold)."""
    from repro.configs import get_smoke_config as jax_smoke
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    config = dict(config)
    model = config.pop("model", False)

    def theirs():
        c = JaxParallelConfig(**dict(config, mesh=JaxMeshSpec(
            **config["mesh"])))
        if model:
            c.validate_model(jax_smoke("stablelm-3b"))
    assert _outcome(theirs)[0] != "ok"
    assert _outcome(lambda: launcher.main(
        ["--arch", "stablelm-3b", "--steps", "1", "--d2ft",
         "--distributed"] + argv + ["--device", "cpu"])) == \
        _outcome(theirs)


def test_loose_kwargs_are_the_deprecated_spelling():
    cfg = gemma3_1b.smoke_config()
    with pytest.warns(DeprecationWarning, match="is deprecated"):
        loop.make_distributed_train_step(cfg, sgd(0.1), None, None,
                                         sync_mode="local")
    with pytest.raises(TypeError, match="not both"):
        loop.make_distributed_train_step(
            cfg, sgd(0.1), None, None, parallel=ParallelConfig(),
            sync_mode="local")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        loop.make_distributed_train_step(
            cfg, sgd(0.1), None, None,
            parallel=ParallelConfig(sync_mode="local"))


@pytest.mark.parametrize("chunk", [1, 7, 64, 10_000])
@pytest.mark.parametrize("make", [
    lambda: sgd(0.1), lambda: sgd(0.05, weight_decay=0.01, nesterov=True),
    lambda: adamw(1e-3), lambda: adamw(1e-2, weight_decay=0.0)],
    ids=["sgd", "sgd_nesterov_decay", "adamw", "adamw_no_decay"])
def test_chunked_update_is_bit_identical(make, chunk):
    """Three updates, chunk by chunk (1 element, ragged 7, 64, more than a
    leaf), against the unchunked update: parameters, moments and step
    equal bit for bit."""
    rng = np.random.default_rng(chunk)
    shapes = {"w": (33, 17), "b": (5,), "s": ()}
    p0 = {k: torch.as_tensor(rng.standard_normal(s).astype(np.float32))
          for k, s in shapes.items()}
    runs = []
    for opt in (make(), chunked(make(), chunk)):
        params = {k: v.clone() for k, v in p0.items()}
        state = opt.init(params)
        g_rng = np.random.default_rng(1)
        for _ in range(3):
            grads = {k: torch.as_tensor(g_rng.standard_normal(s)
                                        .astype(np.float32))
                     for k, s in shapes.items()}
            opt.update(grads, state, params)
        runs.append((params, state))
    (p1, s1), (p2, s2) = runs
    assert s1["step"] == s2["step"] == 3
    for k in shapes:
        assert torch.equal(p1[k], p2[k]), k
        for m in (key for key in s1 if key != "step"):
            assert torch.equal(s1[m][k], s2[m][k]), (m, k)
    with pytest.raises(ValueError, match="chunk must be >= 1"):
        chunked(sgd(0.1), 0)
