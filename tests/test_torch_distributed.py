"""The port's data-parallel D2FT loop and step (``repro_torch/train/
loop.py``: ``finetune_distributed``, ``make_distributed_train_step``)
against the JAX package on the CPU, at the small dense config of the JAX
package's own refresh test (``tests/test_distributed.py``: 2 layers, 4
heads of 16 on 4 KV heads, so the KV columns split by group too, d_ff
128, vocab 128; G 4), batch 8 x 8 in 4 micro-batches:

* a world of one: ``finetune_distributed(refresh_every=1)`` against JAX's
  on ``make_data_mesh(1)``, over 2 AdamW steps (a plan at each): losses,
  parameters and the refresh records;
* two gloo ranks (``tests/_torch_dist_ranks.py``, which imports no jax),
  masked and kernel path (the kernels' plain versions on the CPU), 3 SGD
  steps under the paper's concentrated mix, against JAX's single-device
  ``make_train_step`` on the batch permuted by JAX's 2-device
  ``plan_device_assignment`` / ``device_sample_order``; then 2 steps of
  the 2-rank ``finetune_distributed``; every rank's parameters bitwise
  equal;
* the lo-fi local mode, 2 replicas, 3 SGD steps, against JAX's vmapped
  local step (``n_replicas=2``, no mesh).

Where the ranks' gradients are sums of other shards than JAX's, the
steps are SGD (momentum 0.9), as in the JAX package's own distributed
tests: AdamW's first step maps every gradient element to about +-lr
whatever its size, so an element whose gradient is ~1e-8 moves by lr
times its relative rounding error (1.7e-4 in one of layer 3's wv
elements in the local mode).
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.base import D2FTConfig as JaxD2FTConfig
from repro.configs.base import ModelConfig as JaxModelConfig
from repro.core.assignment import device_sample_order as jax_sample_order
from repro.core.assignment import plan_device_assignment as jax_assign
from repro.core.schedule import Schedule as JaxSchedule
from repro.core.schedule import gates_from_schedule as jax_gates
from repro.data.synthetic import microbatch_assignment
from repro.launch.diststep import paper_mix_schedule
from repro.launch.mesh import make_data_mesh as jax_data_mesh
from repro.launch.parallel import MeshSpec as JaxMeshSpec
from repro.launch.parallel import ParallelConfig as JaxParallelConfig
from repro.models.transformer import init_model as jax_init_model
from repro.optim.optimizers import adamw as jax_adamw
from repro.optim.optimizers import sgd as jax_sgd
from repro.sharding.sync import stack_replicas as jax_stack_replicas
from repro.train.loop import finetune_distributed as jax_finetune_dist
from repro.train.loop import make_distributed_train_step as jax_dist_step
from repro.train.loop import make_train_step as jax_train_step
from repro_torch.configs.base import D2FTConfig, ModelConfig
from repro_torch.core.assignment import plan_device_assignment
from repro_torch.core.schedule import Schedule, gates_from_schedule
from repro_torch.data.synthetic import lm_batches
from repro_torch.interop import params_from_jax
from repro_torch.launch.mesh import make_data_mesh
from repro_torch.launch.parallel import MeshSpec, ParallelConfig
from repro_torch.models.transformer import init_model
from repro_torch.optim.optimizers import adamw, sgd
from repro_torch.train.loop import (finetune_distributed,
                                    make_distributed_train_step)

from _torch_dist_ranks import run_ranks

TRAJ_TOL = 1e-4
B, S, G, N_MB = 8, 8, 4, 4
DENSE = dict(name="refresh", arch_type="dense", n_layers=2, d_model=64,
             n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=128)
JCFG, CFG = JaxModelConfig(**DENSE), ModelConfig(**DENSE)
D2 = dict(n_microbatches=N_MB, n_pf=2, n_po=1, head_groups=G)
SYNC_KEYS = ("total_bytes", "ar_bytes", "synced_bytes", "fraction", "wire")


@pytest.fixture(scope="module")
def tree():
    params = jax.jit(jax_init_model, static_argnums=1)(
        jax.random.PRNGKey(0), JCFG)
    return jax.tree.map(np.asarray, params)


def _port(tree):
    model = init_model(torch.Generator().manual_seed(0), CFG)
    model.load_state_dict(params_from_jax(tree))
    return model


def _assert_params(model, jparams, tol=TRAJ_TOL):
    theirs = params_from_jax(jax.tree.map(np.asarray, jparams))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), theirs[name].numpy(),
                                   atol=tol, rtol=0, err_msg=name)


def test_world_of_one_matches_jax_finetune_distributed(tree):
    """Rank 0 scores, plans, broadcasts; every refresh re-runs the
    assignment and the sync plan, as JAX's loop does."""
    steps = 2
    jp, _, jlog = jax_finetune_dist(
        tree, JCFG, JaxD2FTConfig(**D2), jax_adamw(1e-3),
        lm_batches(0, CFG.vocab_size, B, S, steps), steps=steps,
        mesh=jax_data_mesh(1),
        parallel=JaxParallelConfig(mesh=JaxMeshSpec(data=1)),
        refresh_every=1)
    model = _port(tree)
    mesh = make_data_mesh(1, "cpu")
    try:
        model, state, log = finetune_distributed(
            model, CFG, D2FTConfig(**D2), adamw(1e-3),
            lm_batches(0, CFG.vocab_size, B, S, steps), steps=steps,
            mesh=mesh, parallel=ParallelConfig(mesh=MeshSpec(data=1)),
            refresh_every=1)
    finally:
        mesh.close()
    assert state["step"] == steps
    np.testing.assert_allclose(log.losses, jlog.losses, atol=TRAJ_TOL,
                               rtol=0)
    _assert_params(model, jp)
    mine, theirs = log.extras["refreshes"], jlog.extras["refreshes"]
    assert [r["step"] for r in mine] == [r["step"] for r in theirs] == [0, 1]
    for a, b in zip(mine, theirs):
        assert a["device_of"] == b["device_of"]
        assert a["rebalance"] == b["rebalance"]
        assert a["op_counts"] == b["op_counts"]
        for k in SYNC_KEYS:
            assert a["sync"].get(k) == b["sync"].get(k), k
    assert log.extras["sync"] == mine[-1]["sync"]
    assert log.extras["sync_bytes"] == [r["sync"]["ar_bytes"] for r in mine]
    assert len(log.extras["sync_ms"]) == steps


def test_two_gloo_ranks_match_jax_single_device_step(tree, tmp_path):
    """Each rank runs its shard of JAX's 2-device permutation; the ranks'
    mean equals JAX's full-batch step (the masked path, which the JAX
    kernel path equals within 1e-4: tests/test_kernel_grads.py) on the
    port's masked and kernel paths, and every rank ends bit-identical. The 2-rank ``finetune_distributed``
    sends each step exactly its plan's ``ar_bytes``."""
    L = CFG.n_layers
    table = paper_mix_schedule(L, G, N_MB, seed=0).table
    jsched, sched = JaxSchedule(table, L, G), Schedule(table, L, G)
    mb_of = microbatch_assignment(B, N_MB)
    jasg, _ = jax_assign(jsched, 2)
    asg, _ = plan_device_assignment(sched, 2)
    assert list(asg.device_of) == list(jasg.device_of)
    perm = jax_sample_order(jasg, mb_of)
    batch = next(lm_batches(0, CFG.vocab_size, B, S, 1))
    res = run_ranks("train", tmp_path, {
        "cfg": CFG, "state": params_from_jax(tree),
        "table": torch.as_tensor(table), "G": G, "d2": D2,
        "tokens": torch.as_tensor(batch["tokens"]),
        "labels": torch.as_tensor(batch["labels"])})
    gates = jax_gates(jsched, mb_of[perm])
    jbatch = {k: v[perm] for k, v in batch.items()}
    opt = jax_sgd(1e-2)
    step = jax.jit(jax_train_step(JCFG, opt, use_gates=True))
    params, state, losses = tree, opt.init(tree), []
    for _ in range(3):
        params, state, metrics = step(params, state, jbatch, gates)
        losses.append(float(metrics["loss"]))
    for use_kernel in (False, True):
        for r in res:
            np.testing.assert_allclose(r[f"losses_{use_kernel}"], losses,
                                       atol=TRAJ_TOL, rtol=0)
            model = _port(tree)
            model.load_state_dict(r[f"params_{use_kernel}"])
            _assert_params(model, params)
        for name, p in res[0][f"params_{use_kernel}"].items():
            assert torch.equal(p, res[1][f"params_{use_kernel}"][name]), name
    for r in res:
        assert r["loop_sync_bytes"] == r["loop_ar_bytes"]
        assert np.isfinite(r["loop_losses"]).all()
    assert res[0]["loop_losses"] == res[1]["loop_losses"]
    for name, p in res[0]["loop_params"].items():
        assert torch.equal(p, res[1]["loop_params"][name]), name


def test_local_mode_matches_jax_vmapped_replicas(tree):
    """Two replicas, each its half of the batch, no collective: the port's
    local step on each replica against JAX's vmapped local step."""
    L = CFG.n_layers
    table = paper_mix_schedule(L, G, N_MB, seed=3).table
    jsched, sched = JaxSchedule(table, L, G), Schedule(table, L, G)
    mb_of = microbatch_assignment(B, N_MB)
    opt = jax_sgd(1e-2)
    jstep = jax_dist_step(
        JCFG, opt, None, None,
        parallel=JaxParallelConfig(mesh=JaxMeshSpec(data=2),
                                   sync_mode="local"), n_replicas=2)
    jparams = jax_stack_replicas(tree, 2)
    jstate = jax_stack_replicas(opt.init(tree), 2)
    models = [_port(tree) for _ in range(2)]
    states = [sgd(1e-2).init(dict(m.named_parameters())) for m in models]
    step = make_distributed_train_step(
        CFG, sgd(1e-2), None, None,
        parallel=ParallelConfig(mesh=MeshSpec(data=2), sync_mode="local"))
    g_f, g_b = gates_from_schedule(sched, mb_of, "cpu")
    n = B // 2
    for batch in lm_batches(0, CFG.vocab_size, B, S, 3):
        jparams, jstate, jm = jstep(jparams, jstate, batch,
                                    jax_gates(jsched, mb_of))
        losses = []
        for r, (model, state) in enumerate(zip(models, states)):
            rows = slice(r * n, (r + 1) * n)
            _, _, m = step(model, state,
                           {k: torch.as_tensor(v[rows])
                            for k, v in batch.items()},
                           (g_f[:, rows], g_b[:, rows]))
            losses.append(float(m["loss"]))
        np.testing.assert_allclose(np.mean(losses), float(jm["loss"]),
                                   atol=TRAJ_TOL, rtol=0)
    for r, model in enumerate(models):
        _assert_params(model, jax.tree.map(lambda x: x[r], jparams))
    diverged = [not torch.equal(a, b) for a, b in
                zip(models[0].parameters(), models[1].parameters())]
    assert any(diverged)
