"""The port's multi-axis distributed D2FT (``repro_torch/launch/mesh.py::
make_mesh``, the ``tp`` branches of ``models/transformer.py``,
``sharding/sync.py::apply_tensor_grad_sync``, ``train/pipeline.py`` and the
stage / tensor axes of ``train/loop.py``) against the JAX package on the
CPU, mirroring the arms of ``tests/_dist_parity_multiaxis.py`` on its
model (4 layers, d 64, 4 heads, d_ff 128, vocab 256; G 4, 16
micro-batches, B 32, S 16, its table with a dead and an all-p_f layer, 3
SGD steps):

* one world of 8 gloo processes (``tests/_torch_dist_ranks.py``, which
  imports no jax) runs the five arms one after another: (data=4,
  tensor=2), the same with ZeRO-3, (data=2, stage=2) with M = 4 on ranks
  0-3, (data=2, stage=2, tensor=2), and (data=4, tensor=2) with
  D2FT-LoRA; each rank's losses and parameters are held to jitted JAX's
  single-device gated step (parameters 1e-4, losses 1e-5) and to the
  port's one-rank step (1e-6, the JAX suite's own bar), the ranks of an
  arm to each other bit for bit, and each step's bytes by collective to
  the counts the shapes give (three tests an arm); the pipeline's round report to the JAX
  pipeline's traced one; the f and g operators' values on a tensor axis
  of 2; the launcher at ``--mesh data=4,stage=2`` and ``data=4,tensor=2``
  against its one-rank run, and its stage reports against JAX's
  ``plan_stage_assignment`` on the schedules it planned;
* in-process: ``apply_tensor_grad_sync`` sums exactly the leaves JAX's
  ``_TP_SHARDED`` selects (dense, qwen-smoke with GQA and q / k / v
  biases, olmoe-smoke, whose MoE ``w_up`` stays local).
"""
import contextlib
import io

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_smoke_config as jax_smoke
from repro.core.assignment import plan_stage_assignment as jax_plan_stages
from repro.core.lora import init_lora as jax_init_lora
from repro.core.lora import merge_lora as jax_merge_lora
from repro.core.schedule import Schedule as JaxSchedule
from repro.core.schedule import gates_from_schedule as jax_gates
from repro.data.synthetic import lm_batches, microbatch_assignment
from repro.models.transformer import init_model as jax_init_model
from repro.models.transformer import lm_loss as jax_lm_loss
from repro.optim.optimizers import sgd as jax_sgd
from repro.sharding import sync as jax_sync
from repro.train.loop import make_train_step as jax_train_step
from repro.train.pipeline import analytic_bubble_fraction as jax_bubble
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core.lora import call_with_weights, merge_lora
from repro_torch.core.schedule import Schedule, gates_from_schedule
from repro_torch.interop import lora_from_jax, params_from_jax
from repro_torch.launch import train as launcher
from repro_torch.launch.mesh import CollectiveCounter, make_data_mesh
from repro_torch.models.transformer import init_model, lm_loss
from repro_torch.optim.optimizers import sgd
from repro_torch.sharding import sync
from repro_torch.train.loop import make_train_step

from _torch_dist_ranks import MULTIAXIS_ARMS, start_ranks
from _torch_multiaxis_ref import (DENSE, JCFG, G, L, N, jax_trace_report,
                                  multiaxis_table)

JAX_PARAM_TOL, JAX_LOSS_TOL, PORT_TOL = 1e-4, 1e-5, 1e-6
CFG = ModelConfig(**DENSE)
B, S, STEPS, M = 32, 16, 3, 4
LAUNCHER = ["--arch", "stablelm-3b", "--d2ft", "--distributed", "--batch",
            "16", "--seq", "16", "--steps", "2", "--refresh-every", "1",
            "--optimizer", "sgd", "--device", "cpu"]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The 8-rank run, JAX's references and the port's one-rank ones (the
    references computed while the ranks run)."""
    jparams = jax.jit(jax_init_model, static_argnums=1)(
        jax.random.PRNGKey(0), JCFG)
    table = multiaxis_table()
    jsched = JaxSchedule(table, L, G)
    batch = next(lm_batches(0, CFG.vocab_size, B, S, 1))
    jg = jax_gates(jsched, microbatch_assignment(B, N))
    jopt = jax_sgd(1e-2)
    lora0 = jax_init_lora(jax.random.PRNGKey(3), jparams, rank=2)
    state = params_from_jax(jax.tree.map(np.asarray, jparams))
    lora_state = lora_from_jax(jax.tree.map(np.asarray, lora0), CFG)
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    ranks = start_ranks("multiaxis", tmp_path_factory.mktemp("multiaxis"), {
        "cfg": CFG, "state": state, "lora": lora_state,
        "table": torch.as_tensor(table), "G": G,
        "tokens": tb["tokens"], "labels": tb["labels"]},
        world=8, timeout=400)

    # jitted JAX single-device gated step
    step = jax.jit(jax_train_step(JCFG, jopt, use_gates=True))
    p, st, jlosses = jparams, jopt.init(jparams), []
    for _ in range(STEPS):
        p, st, m = step(p, st, batch, jg)
        jlosses.append(float(m["loss"]))
    jax_final = params_from_jax(jax.tree.map(np.asarray, p))

    # JAX's LoRA reference (adapters only, no clip)
    @jax.jit
    def lora_step(lp, s):
        def loss(lp):
            return jax_lm_loss(jax_merge_lora(jparams, lp, 1.0), JCFG,
                               batch["tokens"], batch["labels"],
                               gates=jg)[0]
        return jopt.update(jax.grad(loss)(lp), s, lp)
    lp, ls = lora0, jopt.init(lora0)
    for _ in range(STEPS):
        lp, ls = lora_step(lp, ls)
    jax_lora = _flat_lora(lora_from_jax(jax.tree.map(np.asarray, lp), CFG))

    # the port's one-rank references
    sched = Schedule(table, L, G)
    gates = gates_from_schedule(sched, microbatch_assignment(B, N), "cpu")
    model = _port(state)
    opt = sgd(1e-2)
    ostate, plosses = opt.init(dict(model.named_parameters())), []
    one = make_train_step(CFG, opt, use_gates=True)
    for _ in range(STEPS):
        _, ostate, m = one(model, ostate, tb, gates)
        plosses.append(float(m["loss"]))
    port_final = {n: q.detach().clone() for n, q in model.named_parameters()}
    port_lora = _port_lora_run(state, lora_state, tb, gates)
    return dict(res=ranks(), jlosses=jlosses, jax_final=jax_final,
                jax_lora=jax_lora, plosses=plosses, port_final=port_final,
                port_lora=port_lora, jparams=jparams, table=table,
                state=state)


def _port(state):
    model = init_model(torch.Generator().manual_seed(0), CFG)
    model.load_state_dict(state)
    return model


def _flat_lora(lora):
    return {f"{n}.{k}": ab[k].detach() for n, ab in lora.items()
            for k in ("a", "b")}


def _port_lora_run(state, lora_state, batch, gates):
    model = _port(state)
    params = dict(model.named_parameters())
    lora = {n: {k: t.clone().requires_grad_() for k, t in ab.items()}
            for n, ab in lora_state.items()}
    lp = {f"{n}.{k}": ab[k] for n, ab in lora.items() for k in ("a", "b")}
    opt = sgd(1e-2)
    st = opt.init(lp)
    for _ in range(STEPS):
        loss, _ = call_with_weights(lm_loss, model,
                                    merge_lora(params, lora, 1.0), CFG,
                                    batch["tokens"], batch["labels"],
                                    gates=gates)
        grads = dict(zip(lp, torch.autograd.grad(loss, list(lp.values()))))
        opt.update(grads, st, lp)
    return _flat_lora(lora)


def _max_diff(mine, theirs):
    return max(float((mine[n] - theirs[n]).abs().max()) for n in theirs)


def _expected_bytes(name, coords, world):
    """The bytes each step hands to each collective on the rank at
    ``coords`` of the arm ``name``: the shapes' own counts."""
    axes = dict(next(a for n, a, _ in MULTIAXIS_ARMS if n == name))
    D, Sg, T = (axes.get(k, 1) for k in ("data", "stage", "tensor"))
    _, s, _ = coords
    model = _port(world["state"])
    nbytes = {n: p.numel() * 4 for n, p in model.named_parameters()}
    act = (B // D) * S * CFG.d_model * 4         # one [B_loc, S, D] float32
    want = {}
    if name == "lora_tp":
        # every adapter's grad summed over the tensor axis, then averaged
        # over the data axis; the f and g operators as in a step, but the
        # first f's backward: nothing upstream of layer 0's attention
        # needs a gradient (the merged weights' base is detached)
        lora = world["port_lora"]
        want["tp_grad"] = sum(t.numel() * 4 for t in lora.values())
        want["all_reduce"] = want["tp_grad"]
        want["tp_act"] = (4 * L - 1) * act
        return want
    plan = sync.grad_sync_plan(model, CFG, Schedule(world["table"], L, G),
                               "zero3" if name == "tp_zero3" else "masked",
                               n_shards=D)
    rep = sync.sync_byte_report(plan, dict(model.named_parameters()),
                                n_shards=D)
    for kind, key in (("all_reduce", "ar_bytes"),
                      ("reduce_scatter", "rs_bytes"),
                      ("all_gather", "ag_bytes")):
        if rep.get(key):
            want[kind] = int(rep[key])
    layers = L
    if Sg > 1:
        from repro_torch.core.assignment import plan_stage_assignment
        b = plan_stage_assignment(Schedule(world["table"], L, G), Sg)[0] \
            .boundaries
        layers = b[s + 1] - b[s]
        want["stage"] = sum(nbytes.values()) + 3 * 4    # + loss, aux, ce
        # M activations forward from every stage but the last, M
        # cotangents back from every stage but the first, one micro-batch
        # each
        want["p2p"] = ((s < Sg - 1) + (s > 0)) * act
    if T > 1:
        # f and g around the attention and around the FFN: four
        # all-reduces of the rank's [B_loc, S, D] activations a layer
        want["tp_act"] = 4 * layers * act
        want["tp_grad"] = sum(v for n, v in nbytes.items()
                              if sync.tensor_sharded(n))
    return want


ARMS = [a[0] for a in MULTIAXIS_ARMS]


def _runs(world, arm):
    runs = [r[arm] for r in world["res"] if arm in r]
    assert len(runs) == (4 if arm == "pipe" else 8)
    return runs


@pytest.mark.parametrize("arm", ARMS)
def test_arm_matches_jax(world, arm):
    """Every rank of the arm against jitted JAX's single-device gated step
    (the LoRA arm: JAX's adapters-only step): each step's loss within
    1e-5, the final parameters within 1e-4."""
    runs = _runs(world, arm)
    theirs = world["jax_lora" if arm == "lora_tp" else "jax_final"]
    if arm != "lora_tp":
        np.testing.assert_allclose(
            np.array([r["losses"] for r in runs]),
            np.array([world["jlosses"]] * len(runs)), atol=JAX_LOSS_TOL,
            rtol=0)
    for r in runs:
        assert _max_diff(r["params"], theirs) <= JAX_PARAM_TOL


@pytest.mark.parametrize("arm", ARMS)
def test_arm_matches_the_one_rank_step(world, arm):
    """Every rank of the arm against the port's one-rank step within 1e-6
    (losses and parameters), and the arm's ranks bitwise equal."""
    runs = _runs(world, arm)
    ours = world["port_lora" if arm == "lora_tp" else "port_final"]
    if arm != "lora_tp":
        np.testing.assert_allclose(
            np.array([r["losses"] for r in runs]),
            np.array([world["plosses"]] * len(runs)), atol=PORT_TOL,
            rtol=0)
    for r in runs:
        assert _max_diff(r["params"], ours) <= PORT_TOL
        for n, t in r["params"].items():
            assert torch.equal(t, runs[0]["params"][n]), (r["coords"], n)


@pytest.mark.parametrize("arm", ARMS)
def test_arm_sends_the_bytes_the_shapes_give(world, arm):
    """Each step's bytes by collective kind on every rank of the arm equal
    the counts the shapes and the plan give (``_expected_bytes``)."""
    for r in _runs(world, arm):
        want = _expected_bytes(arm, r["coords"], world)
        assert r["sent"] == [want] * STEPS, (r["coords"], r["sent"], want)


def test_pipeline_report_matches_jax(world, monkeypatch):
    """The pipeline arm's round report on every stage rank equals JAX's
    for the same boundaries and M (its point-to-point bytes are checked
    with the arm's)."""
    runs = [r["pipe"] for r in world["res"] if "pipe" in r]
    b = runs[0]["boundaries"]
    theirs = jax_trace_report(world["jparams"], b, M, S, monkeypatch)
    assert theirs["trace_ok"]
    for r in runs:
        assert r["boundaries"] == b
        assert r["report"] == theirs


def test_tp_operators_on_a_tensor_axis_of_two(world):
    """f: identity forward, the cotangents summed; g: the inputs summed,
    the cotangent passed through; one all-reduce each."""
    for r in world["res"]:
        ops = r["tp_operators"]
        t = r["tp"]["coords"][2]
        x = torch.arange(6.0) * (1 + t)
        assert torch.equal(ops["copy"]["y"], x)
        assert torch.equal(ops["copy"]["grad"], torch.full((6,), 3.0))
        assert torch.equal(ops["sum"]["y"], torch.arange(6.0) * 3)
        assert torch.equal(ops["sum"]["grad"], torch.full((6,), t + 1.0))
        assert ops["copy"]["calls"] == ops["sum"]["calls"] == 1


@pytest.mark.parametrize("arm", ARMS)
def test_axes_of_one_rank_in_the_world_call_nothing(world, arm):
    """In the world of 8, an axis of one rank is trivial (no group, its
    collectives the identity) and every larger axis is not."""
    for r in _runs(world, arm):
        for ax, (size, trivial) in r["axes"].items():
            assert trivial == (size == 1), (r["coords"], ax)


def test_a_world_of_one_still_calls_its_backend(monkeypatch):
    """``make_data_mesh``'s world of one is the default group, not a
    trivial axis: each of its collectives reaches the backend once."""
    calls = []
    for name in ("all_reduce", "broadcast", "reduce_scatter_tensor",
                 "all_gather_into_tensor"):
        real = getattr(dist, name)
        monkeypatch.setattr(
            dist, name, lambda *a, _n=name, _f=real, **k:
            calls.append(_n) or _f(*a, **k))
    mesh = make_data_mesh(1, "cpu")
    try:
        t, out = torch.arange(4.0), torch.empty(4)
        mesh.all_reduce_(t)
        mesh.broadcast_(t)
        mesh.reduce_scatter_(out, t)
        mesh.all_gather_(out, t)
        assert not mesh.trivial and mesh.size == 1
        assert calls == ["all_reduce", "broadcast", "reduce_scatter_tensor",
                         "all_gather_into_tensor"]
        assert torch.equal(out, torch.arange(4.0))
    finally:
        mesh.close()


def _report_of(sched, n_stages):
    assign, rep = jax_plan_stages(sched, n_stages)
    return dict(rep, bubble_fraction=jax_bubble(assign.loads, M))


@pytest.fixture(scope="module")
def one_rank_launcher():
    """The launcher's one-rank run of ``LAUNCHER`` (its output swallowed)."""
    with contextlib.redirect_stdout(io.StringIO()):
        return launcher.main(LAUNCHER)


@pytest.mark.parametrize("mesh", ["data=4,stage=2", "data=4,tensor=2"])
def test_launcher_runs_the_mesh(world, mesh, one_rank_launcher):
    """The launcher's distributed loop on the mesh: every rank's losses
    equal, within 1e-5 of the launcher's one-rank run; under stage=2 each
    refresh's stage report equals JAX's ``plan_stage_assignment`` (with
    its bubble fraction) on the schedule the run planned."""
    runs = [r["launcher"][mesh] for r in world["res"]]
    one = one_rank_launcher
    for r in runs:
        assert r["losses"] == runs[0]["losses"]
        np.testing.assert_allclose(r["losses"], one.losses, atol=1e-5,
                                   rtol=0)
    cfg = get_smoke_config("stablelm-3b")
    for r in runs:
        assert len(r["tables"]) == len(r["stages"]) == 2
        for table, stages in zip(r["tables"], r["stages"]):
            if mesh.endswith("tensor=2"):
                assert stages is None
                continue
            sched = JaxSchedule(table.numpy().astype(np.int8),
                                cfg.n_layers, cfg.n_heads)
            assert stages == _report_of(sched, 2)


def _selected_by_jax(tree, monkeypatch):
    """The flat port names of the leaves JAX's ``apply_tensor_grad_sync``
    sums (its psum swapped for a marker on a tree of zeros)."""
    zeros = jax.tree.map(lambda x: np.zeros(x.shape, np.float32), tree)
    monkeypatch.setattr(jax.lax, "psum", lambda v, axis: np.ones_like(v))
    marked = jax_sync.apply_tensor_grad_sync(zeros, "tensor")
    monkeypatch.undo()
    return {n for n, t in params_from_jax(marked).items() if t.all()}


class _AddOne:
    """A stand-in tensor axis whose all-reduce adds one, to see which
    leaves the port's sync hands it."""
    size, rank, device = 2, 0, torch.device("cpu")

    def __init__(self):
        self.counter = CollectiveCounter()

    def counted(self, kind, nbytes, call):
        call()
        self.counter.add(kind, nbytes)

    def all_reduce_(self, t):
        return t.add_(1)


@pytest.mark.parametrize("arch", ["dense", "qwen1.5-32b", "olmoe-1b-7b"])
def test_tensor_grad_sync_selects_jax_leaves(arch, monkeypatch):
    """Exactly the leaves JAX's ``_TP_SHARDED`` selects, by parent key
    (the MoE's w_up / w_gate / w_down stay local), in one all-reduce."""
    jcfg = JCFG if arch == "dense" else jax_smoke(arch)
    if arch == "qwen1.5-32b":
        jcfg = jcfg.replace(n_kv_heads=2)             # GQA at T = 2
    shapes = jax.eval_shape(lambda: jax_init_model(jax.random.PRNGKey(0),
                                                   jcfg))
    theirs = _selected_by_jax(shapes, monkeypatch)
    grads = {n: torch.zeros(t.shape) for n, t in params_from_jax(
        jax.tree.map(lambda x: np.zeros(x.shape, np.float32),
                     shapes)).items()}
    axis = _AddOne()
    sync.apply_tensor_grad_sync(grads, axis)
    ours = {n for n, g in grads.items() if g.numel() and bool(g.all())}
    assert ours == theirs and ours
    assert {n.rsplit(".", 1)[-1] for n in ours} >= {"wq", "wk", "wv", "wo"}
    if arch == "qwen1.5-32b":
        assert {"bq", "bk", "bv"} <= {n.rsplit(".", 1)[-1] for n in ours}
    if arch == "olmoe-1b-7b":
        assert not any(".moe." in n for n in ours)
    assert axis.counter.calls == {"tp_grad": 1}
    assert axis.counter.bytes["tp_grad"] == sum(grads[n].numel() * 4
                                                for n in ours)
