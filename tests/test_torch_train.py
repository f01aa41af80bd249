"""The fine-tune slice of the PyTorch port against the JAX package on the
CPU, at the smoke ViT (2 layers, d 96, 6 heads of 16, 32x32 images, S 17):
weights carried over with ``vit_params_from_jax``; the gated ViT's loss and
gradients on the masked path and on the kernel path (whose CPU route is the
kernels' plain version) within 1e-5; a 3-step D2FT ``finetune_vit`` on the
kernel path within 1e-4 of JAX's, losses and parameters; the port's
parameters train, and serving leaves them without gradients.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import vit_small_paper as jax_vit_cfg
from repro.configs.base import D2FTConfig as JaxD2FTConfig
from repro.core.d2ft import plan_schedule as jax_plan_schedule
from repro.models.vit import init_vit as jax_init_vit
from repro.models.vit import vit_loss as jax_vit_loss
from repro.optim.optimizers import sgd as jax_sgd
from repro.train.loop import eval_vit as jax_eval_vit
from repro.train.loop import finetune_vit as jax_finetune_vit
from repro_torch.configs import gemma3_1b, vit_small_paper
from repro_torch.configs.base import D2FTConfig
from repro_torch.core.d2ft import plan_schedule
from repro_torch.data.synthetic import image_batches, make_image_task
from repro_torch.interop import vit_params_from_jax
from repro_torch.models.vit import init_vit, vit_loss
from repro_torch.optim.optimizers import sgd
from repro_torch.serving.engine import Request, make_engine
from repro_torch.train.loop import eval_vit, finetune_vit

STEP_TOL = 1e-5
TRAJ_TOL = 1e-4


@pytest.fixture(scope="module")
def carried():
    """(JAX params, their numpy tree) of the smoke ViT, seed 0."""
    cfg = jax_vit_cfg.smoke_config()
    params = jax.jit(jax_init_vit, static_argnums=1)(jax.random.PRNGKey(0),
                                                     cfg)
    return params, jax.tree.map(np.asarray, params)


def _port_vit(tree):
    model = init_vit(vit_small_paper.smoke_config(), device="cpu")
    model.load_state_dict(vit_params_from_jax(tree))
    return model


def _flat(tree):
    """JAX ViT tree -> {port parameter name: array}."""
    return {k: v.numpy() for k, v in vit_params_from_jax(tree).items()}


def test_vit_params_from_jax_covers_every_parameter(carried):
    _, tree = carried
    state = vit_params_from_jax(tree)
    model = init_vit(vit_small_paper.smoke_config(), device="cpu")
    assert set(state) == set(model.state_dict())
    model.load_state_dict(state)
    np.testing.assert_array_equal(model.blocks[1].attn.wq.detach().numpy(),
                                  tree["blocks"][1]["attn"]["wq"])
    np.testing.assert_array_equal(model.final_norm.bias.detach().numpy(),
                                  tree["final_norm"]["bias"])


@pytest.mark.parametrize("use_kernel", [False, True])
def test_gated_vit_loss_and_grads_match_jax(carried, use_kernel):
    params, tree = carried
    cfg = vit_small_paper.smoke_config()
    rng = np.random.default_rng(int(use_kernel))
    B = 2
    images = rng.normal(size=(B, 32, 32, 3)).astype(np.float32)
    labels = np.array([3, 7], np.int32)
    ops_ = rng.integers(0, 3, (cfg.n_layers, B, cfg.n_heads))
    g_f = (ops_ != 2).astype(np.float32)
    g_b = (ops_ == 0).astype(np.float32)
    bounds = (int((g_f != 0).sum(axis=(1, 2)).max()),
              int((g_b != 0).sum(axis=(1, 2)).max())) if use_kernel else None

    jcfg = jax_vit_cfg.smoke_config()
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jax_vit_loss(p, jnp.asarray(images), jnp.asarray(labels),
                               jcfg, gates=(jnp.asarray(g_f),
                                            jnp.asarray(g_b)),
                               use_kernel=use_kernel, live_bounds=bounds),
        has_aux=True))(params)

    model = _port_vit(tree)
    loss, _ = vit_loss(model, torch.from_numpy(images),
                       torch.from_numpy(labels), cfg,
                       gates=(torch.from_numpy(g_f), torch.from_numpy(g_b)),
                       use_kernel=use_kernel, live_bounds=bounds)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), atol=STEP_TOL,
                               rtol=0)
    theirs = _flat(jax.tree.map(np.asarray, jg))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), theirs[name],
                                   atol=STEP_TOL, rtol=0, err_msg=name)


def test_finetune_vit_trajectory_matches_jax(carried):
    """3 steps of the quickstart's D2FT fine-tune on the kernel path: the
    schedule comes from fixed scores through the knapsack at step 0 and is
    reused, as the quickstart reuses its schedule between refreshes."""
    params, tree = carried
    cfg = vit_small_paper.smoke_config()
    L, G, N = cfg.n_layers, cfg.n_heads, 5
    rng = np.random.default_rng(5)
    bw, fw = rng.random((L * G, N)), rng.random((L * G, N))

    def sched_fn(plan, d2):
        def fn(step, *_):
            return plan(d2, bw, fw, L, G) if step == 0 else None
        return fn

    task = make_image_task(3, n_classes=10, image_size=32)
    jp, _, jlog = jax_finetune_vit(
        params, jax_vit_cfg.smoke_config(), jax_sgd(0.05),
        image_batches(task, 5, 10, 3), steps=3,
        schedule_fn=sched_fn(jax_plan_schedule,
                             JaxD2FTConfig(n_microbatches=N, n_pf=3,
                                           n_po=1)),
        n_microbatches=N, use_kernel=True)
    model = _port_vit(tree)
    model, state, log = finetune_vit(
        model, cfg, sgd(0.05), image_batches(task, 5, 10, 3), steps=3,
        schedule_fn=sched_fn(plan_schedule,
                             D2FTConfig(n_microbatches=N, n_pf=3, n_po=1)),
        n_microbatches=N, use_kernel=True)
    assert state["step"] == 3 and len(log.step_times) == 3
    np.testing.assert_allclose(log.losses, jlog.losses, atol=TRAJ_TOL,
                               rtol=0)
    theirs = _flat(jax.tree.map(np.asarray, jp))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), theirs[name],
                                   atol=TRAJ_TOL, rtol=0, err_msg=name)
    assert eval_vit(model, cfg, image_batches(task, 7, 10, 2)) == \
        jax_eval_vit(jp, jax_vit_cfg.smoke_config(),
                     image_batches(task, 7, 10, 2))


def test_parameters_train_and_serving_leaves_them_without_grads():
    cfg = vit_small_paper.smoke_config()
    model = init_vit(cfg, device="cpu")
    rng = np.random.default_rng(0)
    loss, _ = vit_loss(model, torch.from_numpy(
        rng.normal(size=(2, 32, 32, 3)).astype(np.float32)),
        torch.tensor([1, 2]), cfg)
    loss.backward()
    assert all(p.requires_grad for p in model.parameters())
    assert model.blocks[0].attn.wq.grad is not None
    assert float(model.blocks[0].attn.wq.grad.abs().sum()) > 0

    eng = make_engine(gemma3_1b.smoke_config(), seed=0, device="cpu",
                      page_size=4, n_pages=16, max_seq_len=16)
    assert all(p.requires_grad for p in eng.model.parameters())
    out = eng.run([Request(uid=0, prompt=np.arange(5, dtype=np.int32),
                           max_new_tokens=3)])
    assert len(out[0]) == 8
    assert all(p.grad is None for p in eng.model.parameters())


def test_init_vit_without_device_refuses_silent_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_vit(vit_small_paper.smoke_config())
