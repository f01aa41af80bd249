"""The paper's baseline schedulers in the PyTorch port (``core/
baselines.py``) against the JAX package's: Random (balanced and not),
DPruning and MoE-GShard give the same tables for the same numpy seeds;
and their unbalanced tables, run through the port's packed micro-batch
path, give the masked path's logits and gradients.
"""
import numpy as np
import pytest
import torch

from repro.core import baselines as jax_baselines
from repro_torch.configs.base import ModelConfig
from repro_torch.core import baselines
from repro_torch.core.d2ft import mb_packed_indices, packed_forward_mb
from repro_torch.core.schedule import P_F, gates_from_schedule
from repro_torch.data.synthetic import microbatch_assignment
from repro_torch.models.transformer import forward, init_model

L, G, N = 3, 4, 5


def _tables(seed):
    """{name: (port Schedule, JAX Schedule)} from the same seeds."""
    out = {}
    for balanced in (False, True):
        out[f"random_{balanced}"] = tuple(
            mod.random_schedule(np.random.default_rng(seed), L, G, N, 2, 1,
                                balanced=balanced)
            for mod in (baselines, jax_baselines))
    importance = np.random.default_rng(seed).random(L * G)
    out["dpruning"] = tuple(mod.dpruning_schedule(importance, L, G, N, 0.5)
                            for mod in (baselines, jax_baselines))
    logits = np.random.default_rng(seed + 1).standard_normal((L * G, N))
    out["gshard"] = tuple(
        mod.gshard_schedule(np.random.default_rng(seed), logits, L, G, 2)
        for mod in (baselines, jax_baselines))
    return out


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_baseline_tables_equal_jax(seed):
    for name, (mine, theirs) in _tables(seed).items():
        assert (mine.n_layers, mine.n_groups) == (theirs.n_layers,
                                                  theirs.n_groups), name
        assert mine.table.dtype == theirs.table.dtype, name
        np.testing.assert_array_equal(mine.table, theirs.table, err_msg=name)
    tables = _tables(seed)
    bal = tables["random_True"][0].table
    assert ((bal == P_F).sum(1) == 2).all()
    keep = tables["dpruning"][0].table
    assert ((keep == P_F).all(1) | (keep != P_F).all(1)).all()


@pytest.mark.parametrize("name", ["random_False", "gshard"])
def test_unbalanced_baselines_through_the_packed_path(name):
    """Random and GShard tables give the subnets unequal p_f counts; the
    packed micro-batch path keeps the masked path's values and gradients
    on them."""
    cfg = ModelConfig(name="b", arch_type="dense", n_layers=L, d_model=32,
                      n_heads=G, n_kv_heads=2, d_ff=64, vocab_size=61)
    sched = _tables(3)[name][0]
    t = sched.layer_group_view()
    assert len(np.unique((t == P_F).sum(-1))) > 1          # unbalanced
    B, S = 10, 8
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, 61, (B, S)))
    model = init_model(torch.Generator().manual_seed(0), cfg)
    params = list(model.parameters())

    def run(fn):
        logits, _ = fn()
        grads = torch.autograd.grad(torch.mean(logits ** 2), params,
                                    allow_unused=True)
        return logits.detach().numpy(), [
            np.zeros(p.shape) if g is None else g.numpy()
            for p, g in zip(params, grads)]

    gates = gates_from_schedule(sched, microbatch_assignment(B, N), "cpu")
    lm, gm = run(lambda: forward(model, cfg, toks, gates=gates))
    lp, gp = run(lambda: packed_forward_mb(model, cfg, toks,
                                           mb_packed_indices(sched, N), N))
    np.testing.assert_allclose(lp, lm, atol=1e-5, rtol=0)
    for a, b in zip(gp, gm):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)
