"""The port's elastic layer against the JAX package on the CPU: the fault
plans (``launch/faults.py``), the step-level checkpoints
(``train/checkpoints.py``, ``interop.params_to_jax``), the pre-sync guard
(``train/loop.py::_grad_anomaly`` and the guarded steps) and
``train/elastic.py::finetune_elastic``.

* ``FaultPlan`` and ``random_fault_plan`` give JAX's JSON text and queries,
  ``feasible_survivor_count`` its counts; the refresh's capacities and
  makespans are JAX's.
* Checkpoints cross both ways: JAX's ``save_train_state`` file loads into
  the port as the same tensors, and the port's file passes JAX's
  ``load_train_state`` with JAX's own template; empty containers and the
  template-mismatch report are JAX's.
* ``_grad_anomaly`` flags and counts JAX's blocks; a skipped step keeps
  the parameters and the optimizer state bit for bit in every mode.
* ``finetune_elastic`` on a world of one equals JAX's on one device under a
  NaN burst then two dropped syncs into lo-fi (events equal, losses and
  parameters within 1e-5: one JAX call, in a module fixture), and resumed
  from JAX's own ``ckpt_2.npz`` it ends the same. Resumed from its own
  checkpoint it equals the uninterrupted run in the masked, zero, zero3
  and local modes, and without faults it equals ``finetune_distributed``.
* Two gloo ranks (``tests/_torch_dist_ranks.py``, which imports no jax):
  dropout recovery equals a fresh resume of the survivor from the same
  checkpoint, the dropped rank stops, and the lo-fi merges leave both
  ranks bitwise equal.
* The launcher's ``--elastic`` / ``--faults`` / ``--resume-from`` /
  ``--ckpt`` print JAX's lines.
"""
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs.base import D2FTConfig as JaxD2FTConfig
from repro.configs.base import ModelConfig as JaxModelConfig
from repro.core.assignment import plan_device_assignment as jax_assign
from repro.core.assignment import speed_capacities as jax_capacities
from repro.core.assignment import weighted_makespan as jax_makespan
from repro.core.schedule import Schedule as JaxSchedule
from repro.launch.faults import FaultPlan as JaxFaultPlan
from repro.launch.faults import random_fault_plan as jax_random_plan
from repro.launch.mesh import make_data_mesh as jax_data_mesh
from repro.models.transformer import init_model as jax_init_model
from repro.optim.optimizers import adamw as jax_adamw
from repro.optim.optimizers import sgd as jax_sgd
from repro.train import checkpoints as jax_ckpt
from repro.train.elastic import ElasticConfig as JaxElasticConfig
from repro.train.elastic import \
    feasible_survivor_count as jax_survivor_count
from repro.train.elastic import finetune_elastic as jax_finetune_elastic
from repro.train.loop import _grad_anomaly as jax_grad_anomaly
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import D2FTConfig, ModelConfig
from repro_torch.core.assignment import (plan_device_assignment,
                                         speed_capacities, weighted_makespan)
from repro_torch.core.schedule import Schedule, gates_from_schedule
from repro_torch.data.synthetic import lm_batches
from repro_torch.interop import (opt_state_from_jax, opt_state_to_jax,
                                 params_from_jax, params_to_jax)
from repro_torch.launch import train as launcher
from repro_torch.launch.faults import FaultPlan, random_fault_plan
from repro_torch.launch.mesh import make_data_mesh
from repro_torch.launch.parallel import ParallelConfig
from repro_torch.models.transformer import init_model
from repro_torch.optim.optimizers import adamw, sgd
from repro_torch.sharding import sync
from repro_torch.train import checkpoints
from repro_torch.train.elastic import (ElasticConfig,
                                       feasible_survivor_count,
                                       finetune_elastic)
from repro_torch.train.loop import (_block_of, _grad_anomaly,
                                    finetune_distributed,
                                    make_distributed_train_step)

from _torch_dist_ranks import run_ranks

DENSE = dict(name="elastic", arch_type="dense", n_layers=2, d_model=32,
             n_heads=4, n_kv_heads=4, d_ff=64, vocab_size=128)
JCFG, CFG = JaxModelConfig(**DENSE), ModelConfig(**DENSE)
D2 = dict(n_microbatches=4, n_pf=2, n_po=1, head_groups=4)
B, S = 8, 16
TRAJ_TOL = 1e-5
RESUME_TOL = 1e-6
NAN = float("nan")
# the one plan held to JAX's loop: a NaN burst, then two dropped syncs
# into lo-fi (threshold 2), whose last step merges
PLAN = dict(grad_faults=((1, 0, NAN),), dropped_syncs=(2, 3))
STEPS = 5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """torch's intra-op threads at 1 for this file's tests, the old count
    restored after: their many small ops run several times slower across
    threads (and beside the other test processes)."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _batches(n):
    return list(lm_batches(0, CFG.vocab_size, B, S, n))


@pytest.fixture(scope="module")
def tree():
    params = jax.jit(jax_init_model, static_argnums=1)(
        jax.random.PRNGKey(0), JCFG)
    return jax.tree.map(np.asarray, params)


def _port(tree, cfg=CFG):
    model = init_model(torch.Generator().manual_seed(0), cfg)
    model.load_state_dict(params_from_jax(tree))
    return model


def _named(model):
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def _elastic(model, steps, mesh=None, **kw):
    own = mesh is None
    mesh = mesh or make_data_mesh(1, "cpu")
    try:
        return finetune_elastic(model, CFG, D2FTConfig(**D2), kw.pop(
            "opt", sgd(0.1)), _batches(steps), steps=steps, mesh=mesh, **kw)
    finally:
        if own:
            mesh.close()


# ------------------------------------------------------------ fault plans
@pytest.mark.parametrize("seed,steps,n,kw", [
    (7, 20, 8, dict(p_dropout=1.0)), (8, 20, 8, dict(p_dropout=1.0)),
    (0, 6, 2, dict()), (3, 12, 4, dict(p_slow=1.0, p_nan=0.5,
                                      p_sync_drop=0.5))])
def test_random_fault_plan_matches_jax(seed, steps, n, kw):
    """Same seed, same plan: the JSON text, and every query at every step,
    equal JAX's (NaN != NaN in the tuples, so the text is compared)."""
    mine, theirs = random_fault_plan(seed, steps, n, **kw), \
        jax_random_plan(seed, steps, n, **kw)
    assert mine.to_json() == theirs.to_json()
    back = FaultPlan.from_json(theirs.to_json())
    assert back.to_json() == theirs.to_json()
    for i in range(steps):
        np.testing.assert_array_equal(mine.unit_times(i, n),
                                      theirs.unit_times(i, n))
        np.testing.assert_array_equal(mine.grad_fault_vector(i, n),
                                      theirs.grad_fault_vector(i, n))
        assert mine.dropout_at(i) == theirs.dropout_at(i)
        assert mine.sync_dropped(i) == theirs.sync_dropped(i)
    assert mine.any_faults() == theirs.any_faults()


def test_fault_plan_json_matches_jax():
    kw = dict(seed=3, slowdowns=((0, 1.5), (2, 2.25)), slowdown_start=1,
              dropout=(4, 2), grad_faults=((3, 1, float("inf")),
                                           (5, 0, NAN)),
              dropped_syncs=(2, 6))
    text = JaxFaultPlan(**kw).to_json()
    assert FaultPlan(**kw).to_json() == text
    assert FaultPlan.from_json(text).to_json() == text
    assert FaultPlan.from_json("{}").to_json() == \
        JaxFaultPlan.from_json("{}").to_json()


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
def test_feasible_survivor_count_matches_jax(n):
    for n_mb in (1, 4, 7, 8, 12, 16):
        assert feasible_survivor_count(n, n_mb) == \
            jax_survivor_count(n, n_mb)


def test_refresh_capacities_and_makespans_match_jax():
    """The elastic refresh's arithmetic: a 2x straggler's capacities, the
    mitigated and unmitigated assignments and their weighted makespans."""
    rng = np.random.default_rng(0)
    table = rng.choice([1, 2, 3], size=(8, 16), p=[.4, .3, .3]).astype(
        np.int8)
    mine, theirs = Schedule(table, 2, 4), JaxSchedule(table, 2, 4)
    u = np.array([1.0, 1.75, 1.0, 1.0])
    from repro_torch.core.assignment import microbatch_costs
    costs = microbatch_costs(mine)
    caps = speed_capacities(costs, u, 1.1)
    np.testing.assert_array_equal(caps, jax_capacities(costs, u, 1.1))
    for c in (None, caps):
        a, rep = plan_device_assignment(mine, 4, c)
        ja, jrep = jax_assign(theirs, 4, c)
        assert list(a.device_of) == list(ja.device_of) and rep == jrep
        assert weighted_makespan(a, u) == jax_makespan(ja, u)


# ------------------------------------------------------------ checkpoints
def _jax_state(cfg):
    """Jitted JAX params and an AdamW state of JAX's tree (numpy leaves:
    m at 0.5, v at 0, step 3)."""
    params = jax.tree.map(np.asarray, jax.jit(
        jax_init_model, static_argnums=1)(jax.random.PRNGKey(1), cfg))
    shapes = jax.eval_shape(jax_adamw(1e-3).init, params)
    return params, {"m": jax.tree.map(lambda x: np.full(x.shape, 0.5,
                                                         x.dtype), params),
                    "v": jax.tree.map(np.zeros_like, params),
                    "step": np.asarray(3, shapes["step"].dtype)}


@pytest.mark.parametrize("arch", ["dense", "gemma3-1b"])
def test_jax_checkpoint_loads_into_the_port(arch, tmp_path):
    """JAX's ``save_train_state`` (cycles stacked, a remainder block on
    gemma3's smoke config, AdamW's tree, schedule, assignment, extra) ->
    the port's ``load_train_state`` -> the same tensors, by flat name."""
    jcfg = JCFG if arch == "dense" else jax_smoke_config(arch)
    params, state = _jax_state(jcfg)
    table = np.full((jcfg.n_layers * 4, 4), 1, np.int8)
    jsched = JaxSchedule(table, jcfg.n_layers, 4)
    asg, _ = jax_assign(jsched, 2, np.array([3.0, 5.0]))
    path = str(tmp_path / "jax.npz")
    jax_ckpt.save_train_state(path, step=7, params=params, opt_state=state,
                              sched=jsched, assignment=asg,
                              rng=np.arange(2, dtype=np.uint32),
                              extra={"speeds": np.array([1.0, 1.5]),
                                     "local": 0})
    ck = checkpoints.load_train_state(path)
    assert ck["step"] == 7
    np.testing.assert_array_equal(ck["schedule"].table, table)
    assert (ck["schedule"].n_layers, ck["schedule"].n_groups) == \
        (jcfg.n_layers, 4)
    np.testing.assert_array_equal(ck["assignment"].device_of, asg.device_of)
    np.testing.assert_array_equal(ck["assignment"].capacities, [3.0, 5.0])
    np.testing.assert_array_equal(ck["rng"], [0, 1])
    assert ck["extra"]["speeds"].tolist() == [1.0, 1.5]
    mine = params_from_jax(ck["params"])
    theirs = params_from_jax(params)
    assert mine.keys() == theirs.keys()
    for n in theirs:
        assert torch.equal(mine[n], theirs[n]), n
    st = opt_state_from_jax(ck["opt_state"])
    assert st["step"] == 3 and set(st) == {"m", "v", "step"}
    m = params_from_jax(state["m"])
    for n in m:
        assert torch.equal(st["m"][n], m[n]), n
    # the layout round-trips: flat names -> JAX tree -> flat names
    cfg = CFG if arch == "dense" else get_smoke_config(arch)
    back = params_to_jax(mine, cfg)
    assert jax.tree.structure(back) == jax.tree.structure(params)


@pytest.mark.parametrize("opt_name", ["adamw", "sgd"])
def test_port_checkpoint_loads_into_jax(opt_name, tree, tmp_path):
    """The port's file passes JAX's ``load_train_state`` with JAX's own
    params template and its optimizer tree validates against JAX's
    ``opt.init``; the leaves are the port's."""
    model = _port(tree)
    named = dict(model.named_parameters())
    opt = adamw(1e-3) if opt_name == "adamw" else sgd(0.1)
    state = opt.init(named)
    state["step"] = 5
    for k in state:
        if k != "step":
            for t in state[k].values():
                t.add_(0.25)
    sched = Schedule(np.full((CFG.n_layers * 4, 4), 2, np.int8),
                     CFG.n_layers, 4)
    path = str(tmp_path / "port.npz")
    checkpoints.save_train_state(
        path, step=4, params=params_to_jax(named, CFG),
        opt_state=opt_state_to_jax(state, CFG), sched=sched,
        extra={"ema_gnorm": np.nan})
    jparams = jax.eval_shape(lambda k: jax_init_model(k, JCFG),
                             jax.random.PRNGKey(0))
    ck = jax_ckpt.load_train_state(path, params_template=jparams)
    jopt = jax_adamw(1e-3) if opt_name == "adamw" else jax_sgd(0.1)
    jax_ckpt.validate_tree(jax_ckpt._flatten(ck["opt_state"]),
                           jax.eval_shape(jopt.init, jparams),
                           what="optimizer state")
    assert ck["step"] == 4 and int(ck["opt_state"]["step"]) == 5
    assert np.isnan(ck["extra"]["ema_gnorm"])
    np.testing.assert_array_equal(ck["schedule"].table, sched.table)
    theirs = params_from_jax(jax.tree.map(np.asarray, ck["params"]))
    for n, p in named.items():
        assert torch.equal(theirs[n], p.detach()), n
    for k in state:
        if k != "step":
            got = params_from_jax(jax.tree.map(np.asarray,
                                               ck["opt_state"][k]))
            for n, t in state[k].items():
                assert torch.equal(got[n], t), (k, n)


def test_empty_containers_and_mismatch_reports_match_jax(tmp_path):
    """Empty lists and dicts keep their markers and come back; a file
    checked against the wrong template fails with JAX's report, line for
    line."""
    state = {"rest": [], "opt": {}, "w": np.arange(6.0).reshape(2, 3),
             "nest": {"a": [np.int32(1), {"b": np.ones(2, np.float32)}]}}
    mine, theirs = checkpoints._flatten(state), jax_ckpt._flatten(state)
    assert mine.keys() == theirs.keys()
    checkpoints.save_checkpoint(str(tmp_path / "c"), state)
    back = checkpoints.load_checkpoint(str(tmp_path / "c"))
    assert back["rest"] == [] and back["opt"] == {}
    np.testing.assert_array_equal(back["nest"]["a"][1]["b"], np.ones(2))
    jback = jax_ckpt.load_checkpoint(str(tmp_path / "c.npz"))
    assert jax.tree.structure(jback) == jax.tree.structure(
        jax.tree.map(np.asarray, back))
    bad = {"rest": [np.zeros(1)], "w": np.zeros((3, 2)),
           "nest": {"a": [np.float32(1), {"c": np.ones(2)}]}}
    bad_torch = {"rest": [torch.zeros(1, dtype=torch.float64)],
                 "w": torch.zeros((3, 2), dtype=torch.float64),
                 "nest": {"a": [torch.tensor(1.0),
                                {"c": torch.ones(2, dtype=torch.float64)}]}}
    with pytest.raises(ValueError) as e_jax:
        jax_ckpt.load_checkpoint(str(tmp_path / "c.npz"), template=bad)
    for template in (bad, bad_torch):
        with pytest.raises(ValueError) as e_mine:
            checkpoints.load_checkpoint(str(tmp_path / "c.npz"),
                                        template=template)
        assert str(e_mine.value) == str(e_jax.value)


# -------------------------------------------------------------- the guard
@pytest.mark.parametrize("where,scale,thresh", [
    ("none", 1.0, np.inf), ("layer", NAN, np.inf), ("embed", np.inf, np.inf),
    ("all", NAN, np.inf), ("none", 1.0, 0.5), ("none", 1.0, 1e9)])
def test_grad_anomaly_matches_jax(where, scale, thresh, tree):
    """The same grads through JAX's ``_grad_anomaly`` and the port's: the
    same flag and the same count of bad blocks (one a layer, one a
    loss-path subtree)."""
    rng = np.random.default_rng(0)
    grads = jax.tree.map(
        lambda x: rng.standard_normal(x.shape).astype(np.float32), tree)
    if where == "layer":
        grads["cycles"][0]["attn"]["wq"][1, 0, 0] = scale
    elif where == "embed":
        grads["embed"]["table"][0, 0] = scale
    elif where == "all":
        grads = jax.tree.map(lambda x: x * np.float32(scale), grads)
    jbad, jn = jax_grad_anomaly(jax.tree.map(jnp.asarray, grads),
                                np.float32(thresh))
    bad, n = _grad_anomaly(params_from_jax(grads), np.float32(thresh))
    assert bool(bad) == bool(jbad) and float(n) == float(jn)


@pytest.mark.parametrize("mode", ["masked", "zero", "zero3", "local"])
def test_guarded_step_skips_bit_for_bit(mode, tree):
    """A NaN burst on the rank: the step reports skipped / bad_devices /
    bad_blocks, and leaves the parameters and the optimizer state bit for
    bit; all-ones faults give the unguarded step's values."""
    sched = Schedule(np.full((CFG.n_layers * 4, 4), 1, np.int8),
                     CFG.n_layers, 4)
    batch = _batches(1)[0]
    g = gates_from_schedule(sched, np.repeat(np.arange(4), 2), "cpu")
    shard = {k: torch.as_tensor(v) for k, v in batch.items()}
    mesh = make_data_mesh(1, "cpu")
    try:
        runs = {}
        for guard, fault in ((False, None), (True, np.ones(1, np.float32)),
                             (True, np.full(1, NAN, np.float32))):
            model = _port(tree)
            opt = adamw(1e-3)
            plan = None if mode == "local" else sync.grad_sync_plan(
                model, CFG, sched, "masked" if mode == "masked" else mode,
                n_shards=1)
            state = opt.init(dict(model.named_parameters()))
            if mode == "zero3":
                sync.zero3_shard_model_(model, plan, 0)
            step = make_distributed_train_step(
                CFG, opt, mesh, plan, parallel=ParallelConfig(
                    sync_mode=mode, guard=guard))
            before = (_named(model), {k: v if k == "step" else
                                      {n: t.clone() for n, t in v.items()}
                                      for k, v in state.items()})
            args = (fault, np.float32(np.inf)) if guard else ()
            sent = dict(mesh.counter.bytes)
            _, state, metrics = step(model, state, shard, g, *args)
            guard_bytes = mesh.counter.bytes.get("guard", 0) - \
                sent.get("guard", 0)
            runs[(guard, fault is not None and np.isnan(fault[0]))] = (
                before, _named(model), state, metrics, guard_bytes)
    finally:
        mesh.close()
    (b0, p0, s0, m0, _), (_, p1, s1, m1, gb1), (b2, p2, s2, m2, gb2) = \
        runs[(False, False)], runs[(True, False)], runs[(True, True)]
    for n in p0:
        assert torch.equal(p0[n], p1[n]), n
        assert torch.equal(p2[n], b2[0][n]), n
    assert s2["step"] == 0 and s1["step"] == s0["step"] == 1
    for k in ("m", "v"):
        for n, t in s2[k].items():
            assert torch.equal(t, b2[1][k][n]), (k, n)
    assert float(m1["skipped"]) == 0.0 and float(m2["skipped"]) == 1.0
    assert float(m2["bad_devices"]) == 1.0
    # one block a layer and one a loss-path subtree
    assert float(m2["bad_blocks"]) == len({_block_of(n) for n in p0})
    assert float(m0["loss"]) == float(m1["loss"]) == float(m2["loss"])
    assert gb1 == gb2 == (0 if mode == "local" else 8)


# ------------------------------------------- the loop against JAX's loop
@pytest.fixture(scope="module")
def jax_run(tree, tmp_path_factory):
    """JAX's ``finetune_elastic`` on one device under ``PLAN`` (ckpt every
    2 steps, SGD): its params, log and checkpoint directory."""
    d = tmp_path_factory.mktemp("jax_elastic")
    params, _, log = jax_finetune_elastic(
        jax.tree.map(jnp.asarray, tree), JCFG, JaxD2FTConfig(**D2),
        jax_sgd(0.1), _batches(STEPS), steps=STEPS, mesh=jax_data_mesh(1),
        faults=JaxFaultPlan(**PLAN),
        elastic=JaxElasticConfig(ckpt_every=2, ckpt_dir=str(d)))
    return jax.tree.map(np.asarray, params), log, d


def _assert_params(model, jparams, tol):
    theirs = params_from_jax(jparams)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), theirs[name].numpy(),
                                   atol=tol, rtol=0, err_msg=name)


def _events(log):
    return [{k: v for k, v in e.items() if k != "path"}
            for e in log.extras["elastic"]["events"]]


@pytest.mark.parametrize("start", ["fresh", "jax_ckpt_2"])
def test_world_of_one_matches_jax_finetune_elastic(start, tree, jax_run,
                                                   tmp_path):
    """The port's world of one against JAX's one device: the same events
    (guard skip, two sync drops, the lo-fi fallback, the final merge),
    losses and parameters within 1e-5, the same refresh records; resumed
    from JAX's own step-2 checkpoint, the same end."""
    jparams, jlog, jdir = jax_run
    resume = str(jdir / "ckpt_2.npz") if start != "fresh" else None
    model = _port(tree)
    _, state, log = _elastic(model, STEPS, faults=FaultPlan(**PLAN),
                             elastic=ElasticConfig(ckpt_every=2,
                                                   ckpt_dir=str(tmp_path)),
                             resume_from=resume)
    jevents = _events(jlog)
    if resume is None:
        assert _events(log) == jevents
        np.testing.assert_allclose(log.losses, jlog.losses, atol=TRAJ_TOL,
                                   rtol=0)
        mine, theirs = log.extras["refreshes"], jlog.extras["refreshes"]
        assert len(mine) == len(theirs)
        for a, b in zip(mine, theirs):
            assert {k: a[k] for k in ("step", "rebalance", "elastic",
                                      "n_devices", "sync_mode")} == \
                {k: b[k] for k in ("step", "rebalance", "elastic",
                                   "n_devices", "sync_mode")}
        assert [c["step"] for c in log.extras["elastic"]["ckpts"]] == \
            [c["step"] for c in jlog.extras["elastic"]["ckpts"]]
    else:
        assert _events(log)[0] == {"type": "resume", "step": 2}
        assert _events(log)[1:] == [e for e in jevents if e["step"] >= 2]
        np.testing.assert_allclose(log.losses, jlog.losses[-1:],
                                   atol=TRAJ_TOL, rtol=0)
    for k in ("final_mode", "guard_skips", "sync_faults", "merges",
              "n_devices", "unit_times"):
        assert log.extras["elastic"][k] == jlog.extras["elastic"][k], k
    _assert_params(model, jparams, TRAJ_TOL)


@pytest.mark.parametrize("mode", ["masked", "zero", "zero3", "local"])
def test_resume_equals_the_uninterrupted_run(mode, tree, tmp_path):
    """Four AdamW steps re-planned every 2, checkpointed every 2, against
    a fresh loop resumed from the step-2 checkpoint: parameters and
    moments within 1e-6. Without faults the loop equals
    ``finetune_distributed`` (masked, zero, zero3) step for step."""
    runs = []
    for resume in (None, str(tmp_path / "a" / "ckpt_2.npz")):
        model = _port(tree)
        _, state, log = _elastic(
            model, 4, sync_mode=mode, opt=adamw(1e-3),
            elastic=ElasticConfig(ckpt_every=2, refresh_every=2,
                                  merge_every=2, ckpt_dir=str(
                                      tmp_path / ("b" if resume else "a"))),
            resume_from=resume)
        runs.append((_named(model), state, log))
    (p_a, s_a, log_a), (p_b, s_b, log_b) = runs
    assert s_a["step"] == s_b["step"] == 4
    for n in p_a:
        np.testing.assert_allclose(p_a[n], p_b[n], atol=RESUME_TOL, rtol=0)
        for k in ("m", "v"):
            np.testing.assert_allclose(s_a[k][n], s_b[k][n],
                                       atol=RESUME_TOL, rtol=0)
    np.testing.assert_allclose(log_a.losses[2:], log_b.losses,
                               atol=RESUME_TOL, rtol=0)
    if mode == "local":
        assert [e["type"] for e in log_a.extras["elastic"]["events"]] == \
            ["merge", "merge"]
        return
    model = _port(tree)
    mesh = make_data_mesh(1, "cpu")
    try:
        _, state, log = finetune_distributed(
            model, CFG, D2FTConfig(**D2), adamw(1e-3), _batches(4), steps=4,
            mesh=mesh, parallel=ParallelConfig(sync_mode=mode),
            refresh_every=2)
    finally:
        mesh.close()
    assert log.losses == log_a.losses
    for n, p in _named(model).items():
        assert torch.equal(p, p_a[n]), n


def test_local_checkpoint_resumed_on_fewer_ranks_merges_as_jax(tree,
                                                              tmp_path):
    """A lo-fi checkpoint of two replicas (JAX's ``save_train_state``: the
    replica stack, ``live_since_merge``) resumed on a world of one: the
    port merges the stack under that mask as JAX's restore does
    (``lofi_merge`` of the mask's plan), takes replica 0's moments and
    falls back to the masked mode."""
    from repro.sharding.sync import grad_sync_plan as jax_plan
    from repro.sharding.sync import lofi_merge as jax_lofi_merge
    from repro.sharding.sync import stack_replicas as jax_stack
    from repro.train.elastic import _mask_schedule as jax_mask_schedule
    rng = np.random.default_rng(3)
    stacked = jax.tree.map(
        lambda x: np.asarray(jax_stack(x, 2)) + np.stack(
            [np.zeros(x.shape, x.dtype),
             rng.standard_normal(x.shape).astype(x.dtype)]), tree)
    mask = np.zeros((CFG.n_layers, 4), bool)
    mask[1, 2] = True
    state = jax.tree.map(np.asarray, jax_stack(
        jax_sgd(0.1).init(jax.tree.map(jnp.asarray, tree)), 2))
    sched = JaxSchedule(np.full((CFG.n_layers * 4, 4), 1, np.int8),
                        CFG.n_layers, 4)
    path = str(tmp_path / "local.npz")
    jax_ckpt.save_train_state(path, step=2, params=stacked,
                              opt_state=state, sched=sched,
                              extra={"local": 1, "n_devices": 2,
                                     "live_since_merge": mask,
                                     "speeds": np.ones(2)})
    want = jax_lofi_merge(jax.tree.map(jnp.asarray, stacked), jax_plan(
        tree, JCFG, jax_mask_schedule(mask)))
    model = _port(tree)
    _, opt_state, log = _elastic(model, 2, resume_from=path,
                                 elastic=ElasticConfig(
                                     ckpt_dir=str(tmp_path / "c")))
    _assert_params(model, jax.tree.map(np.asarray, want), RESUME_TOL)
    assert log.extras["elastic"]["final_mode"] == "masked"
    assert opt_state["step"] == 0


# ------------------------------------------------------ two gloo ranks
def test_two_gloo_ranks_recover_and_merge(tree, tmp_path):
    """(a) A dropout of rank 1 at step 3 (checkpoints every 2): rank 0
    restores ``ckpt_2`` alone and ends equal (1e-6) to a fresh resume of
    that checkpoint on rank 0 alone; rank 1 ran steps 0-2 and left the
    loop at the dropout. (b) Dropped syncs at steps 1 and 2 into lo-fi,
    merged every 2 steps: after every merge both ranks hold bitwise equal
    parameters, and each merge sends its mask plan's bytes."""
    res = run_ranks("elastic", tmp_path, {
        "cfg": CFG, "state": params_from_jax(tree), "d2": D2,
        "batches": _batches(6), "G": 4,
        "table": torch.ones((CFG.n_layers * 4, 4), dtype=torch.int8)})
    r0, r1 = res
    a0, a1 = r0["dropout"], r1["dropout"]
    assert [e["type"] for e in a0["events"]] == ["dropout_recovery"]
    assert a0["events"][0]["recovery_steps"] == 1
    assert a0["events"][0]["n_devices"] == 1
    assert [e["type"] for e in a1["events"]] == ["dropped"]
    assert a1["steps_run"] == 3
    assert a1["dropped"] and not a0["dropped"]
    for n, p in a0["params"].items():
        np.testing.assert_allclose(p, r0["resumed"]["params"][n],
                                   atol=RESUME_TOL, rtol=0)
    np.testing.assert_allclose(a0["losses"][3:], r0["resumed"]["losses"],
                               atol=RESUME_TOL, rtol=0)
    b0, b1 = r0["lofi"], r1["lofi"]
    kinds = [e["type"] for e in b0["events"]]
    assert kinds[:3] == ["sync_drop", "sync_drop", "lofi_fallback"]
    assert kinds.count("merge") >= 1 and b0["final_mode"] == "local"
    assert b0["events"] == b1["events"]
    assert len(b0["merged"]) == kinds.count("merge") >= 1
    for m0, m1 in zip(b0["merged"], b1["merged"]):
        assert m0.keys() == m1.keys()
        for n in m0:
            assert torch.equal(m0[n], m1[n]), n
    merges = [e for e in b0["events"] if e["type"] == "merge"]
    assert b0["merge_bytes"] == [e["merged_bytes"] for e in merges]


# ------------------------------------------------------------ the launcher
def test_launcher_elastic_prints_jax_lines(tmp_path, capsys):
    """``--elastic --faults plan.json --ckpt out.npz`` on a world of one
    prints the JAX launcher's lines (the elastic summary, one ``event:``
    line each, ``last checkpoint:``, ``saved``), and its ``--ckpt`` file
    holds JAX-layout params; ``--resume-from`` that run's step-2
    checkpoint ends at the same parameters."""
    plan = tmp_path / "plan.json"
    plan.write_text(FaultPlan(grad_faults=((1, 0, NAN),)).to_json())
    base = ["--arch", "gemma3-1b", "--d2ft", "--kernel", "--distributed",
            "--elastic", "--device", "cpu", "--steps", "3", "--batch", "4",
            "--seq", "16", "--ckpt-every", "2"]
    outs = []
    for extra in (["--faults", str(plan), "--ckpt-dir", str(tmp_path / "a"),
                   "--ckpt", str(tmp_path / "out.npz")],
                  ["--resume-from", str(tmp_path / "a" / "ckpt_2.npz"),
                   "--ckpt-dir", str(tmp_path / "b"), "--ckpt",
                   str(tmp_path / "resumed.npz")]):
        log = launcher.main(base + extra)
        outs.append((log, capsys.readouterr().out.splitlines()))
    (log, lines), (rlog, rlines) = outs
    ev = log.extras["elastic"]
    assert f"elastic: final_mode=masked devices=1 guard_skips=1 " \
        f"sync_faults=0 merges=0" in lines
    assert f"  event: {ev['events'][0]}" in lines
    assert ev["events"][0]["type"] == "guard_skip"
    assert f"last checkpoint: {tmp_path / 'a' / 'ckpt_2.npz'}" in lines
    assert lines[-1] == f"saved {tmp_path / 'out.npz'}"
    assert any(x.startswith("assignment: loads ") for x in lines)
    assert f"  event: {rlog.extras['elastic']['events'][0]}" in rlines
    theirs = jax_ckpt.load_checkpoint(str(tmp_path / "out.npz"))
    resumed = checkpoints.load_checkpoint(str(tmp_path / "resumed.npz"))
    jparams = jax.eval_shape(
        lambda k: jax_init_model(k, jax_smoke_config("gemma3-1b")),
        jax.random.PRNGKey(0))
    jax_ckpt.validate_tree(jax_ckpt._flatten(theirs["params"]), jparams)
    a = params_from_jax(jax.tree.map(np.asarray, theirs["params"]))
    b = params_from_jax(resumed["params"])
    for n in a:
        np.testing.assert_allclose(a[n], b[n], atol=RESUME_TOL, rtol=0)
    assert math.isfinite(rlog.losses[-1])
    assert json.loads(plan.read_text())["grad_faults"][0][:2] == [1, 0]
