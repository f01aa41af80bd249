"""The fine-tune's planning core, data and optimizers in the PyTorch port,
against the JAX package on the CPU: knapsack, schedule, gates, bounds and
cost model equal exactly for the same scores; batches bit-identical for the
same seeds; subnet scores on the smoke ViT with carried weights within
rtol 1e-4 and the schedule they give equal; optimizer updates within 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import vit_small_paper as jax_vit_cfg
from repro.configs.base import D2FTConfig as JaxD2FTConfig
from repro.core import cost_model as jax_cost
from repro.core import d2ft as jax_d2ft
from repro.core import knapsack as jax_knapsack
from repro.core import schedule as jax_schedule
from repro.core.scores import compute_scores as jax_compute_scores
from repro.core.scores import vit_blocks as jax_vit_blocks
from repro.data import synthetic as jax_data
from repro.models.vit import init_vit as jax_init_vit
from repro.models.vit import vit_loss as jax_vit_loss
from repro.optim import optimizers as jax_optim
from repro_torch.configs import vit_small_paper
from repro_torch.configs.base import D2FTConfig
from repro_torch.core import cost_model, d2ft, knapsack, schedule
from repro_torch.core.scores import compute_scores, vit_blocks
from repro_torch.data import synthetic
from repro_torch.interop import vit_params_from_jax
from repro_torch.models.vit import init_vit, vit_loss
from repro_torch.optim import optimizers

OPT_TOL = 1e-6


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_knapsack_solvers_equal_jax(seed):
    rng = np.random.default_rng(seed)
    N = 9
    values = rng.random(N) * 5
    weights = rng.choice([0.4, 1.0], N)
    cap = float(rng.choice([1.2, 2.0, 3.0]))
    np.testing.assert_array_equal(
        knapsack.dp_knapsack(values, weights, cap),
        jax_knapsack.dp_knapsack(values, weights, cap))
    bv, bsel = knapsack.brute_force(values, weights, cap)
    jv, jsel = jax_knapsack.brute_force(values, weights, cap)
    assert bv == jv
    np.testing.assert_array_equal(bsel, jsel)
    fwd = rng.random(N)
    for a, b in zip(knapsack.bilevel_select(values, fwd, 0.4, 0.6, 3.0, 0.4),
                    jax_knapsack.bilevel_select(values, fwd, 0.4, 0.6, 3.0,
                                                0.4)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(
            knapsack.scalarized_select(values, fwd, 0.5, 0.4, 0.6, 2.4),
            jax_knapsack.scalarized_select(values, fwd, 0.5, 0.4, 0.6, 2.4)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n_pf,n_po,exclusive", [(3, 1, True), (2, 2, False),
                                                 (1, 3, True)])
def test_schedule_gates_bounds_and_costs_equal_jax(n_pf, n_po, exclusive):
    L, G, N, B = 3, 6, 5, 20
    rng = np.random.default_rng(n_pf * 10 + n_po)
    bw, fw = rng.random((L * G, N)), rng.random((L * G, N))
    mine = d2ft.plan_schedule(D2FTConfig(n_microbatches=N, n_pf=n_pf,
                                         n_po=n_po), bw, fw, L, G,
                              exclusive_po=exclusive)
    theirs = jax_d2ft.plan_schedule(JaxD2FTConfig(
        n_microbatches=N, n_pf=n_pf, n_po=n_po), bw, fw, L, G,
        exclusive_po=exclusive)
    np.testing.assert_array_equal(mine.table, theirs.table)
    assert d2ft.capacities(D2FTConfig(n_pf=n_pf, n_po=n_po)) == \
        jax_d2ft.capacities(JaxD2FTConfig(n_pf=n_pf, n_po=n_po))
    built = schedule.build_schedule(bw, fw, L, G, c_f=0.4, c_b=0.6,
                                    cap_pf=n_pf, cap_po=0.4 * n_po)
    np.testing.assert_array_equal(
        built.table, jax_schedule.build_schedule(
            bw, fw, L, G, c_f=0.4, c_b=0.6, cap_pf=n_pf,
            cap_po=0.4 * n_po).table)

    mb_of = synthetic.microbatch_assignment(B, N)
    np.testing.assert_array_equal(mb_of,
                                  jax_data.microbatch_assignment(B, N))
    for a, b in zip(schedule.gates_from_schedule(mine, mb_of, "cpu"),
                    jax_schedule.gates_from_schedule(theirs, mb_of)):
        assert a.dtype == torch.float32 and tuple(a.shape) == (L, B, G)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert schedule.live_slice_bounds(mine, mb_of) == \
        jax_schedule.live_slice_bounds(theirs, mb_of)
    for a, b in zip(schedule.packed_indices(mine, mb_of),
                    jax_schedule.packed_indices(theirs, mb_of)):
        np.testing.assert_array_equal(a, b)
    assert schedule.op_counts(mine) == jax_schedule.op_counts(theirs)
    t = mine.table
    assert cost_model.compute_cost(t) == jax_cost.compute_cost(t)
    assert cost_model.comm_cost(t) == jax_cost.comm_cost(t)
    assert cost_model.workload_variance(t) == jax_cost.workload_variance(t)
    np.testing.assert_array_equal(cost_model.per_device_load(t),
                                  jax_cost.per_device_load(t))


def test_batches_are_bit_identical():
    mine = synthetic.make_image_task(3, n_classes=10, image_size=32)
    theirs = jax_data.make_image_task(3, n_classes=10, image_size=32)
    np.testing.assert_array_equal(mine.templates, theirs.templates)
    for (xa, ya), (xb, yb) in zip(synthetic.image_batches(mine, 5, 8, 3),
                                  jax_data.image_batches(theirs, 5, 8, 3)):
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)
    for a, b in zip(synthetic.lm_batches(1, 50, 2, 9, 2),
                    jax_data.lm_batches(1, 50, 2, 9, 2)):
        for key in ("tokens", "labels"):
            np.testing.assert_array_equal(a[key], b[key])
    tree = {"x": np.arange(20).reshape(10, 2), "y": (np.arange(10),)}
    for a, b in zip(synthetic.split_microbatches(tree, 5),
                    jax_data.split_microbatches(tree, 5)):
        np.testing.assert_array_equal(a["x"], np.asarray(b["x"]))
        np.testing.assert_array_equal(a["y"][0], np.asarray(b["y"][0]))
    with pytest.raises(ValueError):
        synthetic.microbatch_assignment(7, 5)


def test_compute_scores_and_schedule_match_jax():
    """Fisher forward and weight-magnitude backward scores on the smoke ViT
    with the JAX package's weights, as the quickstart's scoring pass runs
    them; the knapsack then gives the same table."""
    jcfg = jax_vit_cfg.smoke_config()
    params = jax.jit(jax_init_vit, static_argnums=1)(jax.random.PRNGKey(0),
                                                     jcfg)
    cfg = vit_small_paper.smoke_config()
    model = init_vit(cfg, device="cpu")
    model.load_state_dict(vit_params_from_jax(
        jax.tree.map(np.asarray, params)))
    task = synthetic.make_image_task(3, n_classes=10, image_size=32)
    images, labels = next(synthetic.image_batches(task, 5, 10, 1))
    mbs = list(zip(np.split(images, 5), np.split(labels, 5)))

    def jax_loss(p, mb):
        return jax_vit_loss(p, jnp.asarray(mb[0]), jnp.asarray(mb[1]),
                            jcfg)[0]

    def loss(p, mb):
        return vit_loss(model, torch.from_numpy(mb[0]),
                        torch.from_numpy(mb[1]), cfg)[0]

    jb, jf = jax_compute_scores(jax_loss, params, jax_vit_blocks, mbs,
                                jcfg.n_heads)
    tb, tf = compute_scores(loss, dict(model.named_parameters()), vit_blocks,
                            mbs, cfg.n_heads)
    np.testing.assert_allclose(tb, jb, rtol=1e-4)
    np.testing.assert_allclose(tf, jf, rtol=1e-4)
    d2 = D2FTConfig(n_microbatches=5, n_pf=3, n_po=1)
    np.testing.assert_array_equal(
        d2ft.plan_schedule(d2, tb, tf, cfg.n_layers, cfg.n_heads).table,
        jax_d2ft.plan_schedule(JaxD2FTConfig(n_microbatches=5, n_pf=3,
                                             n_po=1), jb, jf, cfg.n_layers,
                               cfg.n_heads).table)


@pytest.mark.parametrize("which", ["sgd", "sgd_nesterov_wd", "adamw"])
def test_optimizer_updates_match_jax(which):
    rng = np.random.default_rng(len(which))
    shapes = {"a": (4, 3), "b": (5,)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    mk = {"sgd": lambda m: m.sgd(0.05),
          "sgd_nesterov_wd": lambda m: m.sgd(0.1, momentum=0.8,
                                             weight_decay=0.01,
                                             nesterov=True),
          "adamw": lambda m: m.adamw(1e-2)}[which]
    mine_opt, jax_opt = mk(optimizers), mk(jax_optim)
    assert (mine_opt.elidable, mine_opt.n_moments) == \
        (jax_opt.elidable, jax_opt.n_moments)
    mine = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    theirs = {k: jnp.asarray(v) for k, v in params.items()}
    ms, js = mine_opt.init(mine), jax_opt.init(theirs)
    for step in range(3):
        grads = {k: (rng.normal(size=s) * 3).astype(np.float32)
                 for k, s in shapes.items()}
        tg, tn = optimizers.clip_by_global_norm(
            {k: torch.from_numpy(g) for k, g in grads.items()}, 1.0)
        jg, jn = jax_optim.clip_by_global_norm(
            {k: jnp.asarray(g) for k, g in grads.items()}, 1.0)
        np.testing.assert_allclose(float(tn), float(jn), rtol=OPT_TOL)
        mine, ms = mine_opt.update(tg, ms, mine)
        theirs, js = jax_opt.update(jg, js, theirs)
        for k in shapes:
            np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]),
                                       atol=OPT_TOL, rtol=0)
            np.testing.assert_allclose(mine[k].numpy(), np.asarray(theirs[k]),
                                       atol=OPT_TOL, rtol=0)
    assert ms["step"] == int(js["step"]) == 3
    assert float(optimizers.clip_scale(torch.tensor(4.0), 1.0)) == \
        float(jax_optim.clip_scale(jnp.float32(4.0), 1.0))
