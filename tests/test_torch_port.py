"""PyTorch port, package level: import hygiene (no jax, no triton, nothing
of ``repro``), the config copy, the weight carry-over layout and the
no-silent-CPU rule of the entry points."""
import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import gemma3_1b as jax_gemma
from repro.configs import mamba2_130m as jax_mamba
from repro.models.transformer import init_model as jax_init_model
from repro_torch.configs import (gemma3_1b, get_config, get_smoke_config,
                                 mamba2_130m)
from repro_torch.interop import params_from_jax
from repro_torch.models.transformer import init_model
from repro_torch.serving.engine import make_engine

SLICE_MODULES = [
    "repro_torch",
    "repro_torch.configs",
    "repro_torch.configs.base",
    "repro_torch.configs.gemma3_1b",
    "repro_torch.configs.mamba2_130m",
    "repro_torch.configs.vit_small_paper",
    "repro_torch.core.cost_model",
    "repro_torch.core.d2ft",
    "repro_torch.core.knapsack",
    "repro_torch.core.schedule",
    "repro_torch.core.scores",
    "repro_torch.data.synthetic",
    "repro_torch.interop",
    "repro_torch.launch",
    "repro_torch.launch.train",
    "repro_torch.kernels",
    "repro_torch.kernels.build",
    "repro_torch.kernels.contract",
    "repro_torch.kernels.d2ft_attention",
    "repro_torch.kernels.d2ft_ssd",
    "repro_torch.kernels.ops",
    "repro_torch.kernels.paged_decode",
    "repro_torch.models.attention",
    "repro_torch.models.layers",
    "repro_torch.models.ssm",
    "repro_torch.models.transformer",
    "repro_torch.models.vit",
    "repro_torch.optim.optimizers",
    "repro_torch.serving.engine",
    "repro_torch.serving.paged_decode",
    "repro_torch.serving.pages",
    "repro_torch.train.loop",
]


def test_port_imports_no_jax_triton_or_reference_package():
    code = (
        "import sys, importlib\n"
        f"for m in {SLICE_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'triton', 'repro'))\n"
        "print(','.join(bad))\n")
    src = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
    env = dict(os.environ, PYTHONPATH=src)
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "", f"port pulled in: {res.stdout.strip()}"


@pytest.mark.parametrize("arch,mod,ref_mod", [
    ("gemma3-1b", gemma3_1b, jax_gemma),
    ("mamba2-130m", mamba2_130m, jax_mamba)])
@pytest.mark.parametrize("which", ["full", "smoke"])
def test_config_copy_matches_reference(which, arch, mod, ref_mod):
    mine = mod.CONFIG if which == "full" else mod.smoke_config()
    ref = ref_mod.CONFIG if which == "full" else ref_mod.smoke_config()
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert mine.layer_kinds == ref.layer_kinds
    lookup = get_config if which == "full" else get_smoke_config
    assert lookup(arch) == mine


def test_params_from_jax_unstacks_cycles_into_flat_layers():
    """Cycle c, position j -> layer c*P + j; the remainder follows. Every
    port parameter is covered, with the JAX leaf's exact values."""
    cfg = jax_gemma.smoke_config()              # 7 layers: 1 cycle of 6 + 1
    params = jax.jit(jax_init_model, static_argnums=1)(
        jax.random.PRNGKey(0), cfg)
    tree = jax.tree.map(np.asarray, params)
    state = params_from_jax(tree)
    model = init_model(torch.Generator().manual_seed(0),
                       gemma3_1b.smoke_config())
    assert set(state) == set(model.state_dict())
    model.load_state_dict(state)
    P = len(cfg.block_pattern)
    n_cycles = cfg.n_layers // P
    for i in range(cfg.n_layers):
        c, j = divmod(i, P)
        leaf = tree["cycles"][j]["attn"]["wq"][c] if c < n_cycles else \
            tree["rest"][i - n_cycles * P]["attn"]["wq"]
        np.testing.assert_array_equal(model.layers[i].attn.wq.detach().numpy(),
                                      leaf)
    np.testing.assert_array_equal(model.embed.table.detach().numpy(),
                                  tree["embed"]["table"])


def test_init_model_is_seeded_and_on_generator_device():
    cfg = gemma3_1b.smoke_config()
    a = init_model(torch.Generator().manual_seed(3), cfg)
    b = init_model(torch.Generator().manual_seed(3), cfg)
    for (na, ta), (nb, tb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert na == nb and torch.equal(ta, tb)
        assert ta.device.type == "cpu" and ta.dtype == torch.float32
    assert len(a.layers) == cfg.n_layers


def test_make_engine_without_device_refuses_silent_cpu():
    """No device named and no card present: the entry point raises rather
    than carry on on the CPU. With a card it would run there, so the check
    is made only where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_engine(gemma3_1b.smoke_config(), seed=0)
    eng = make_engine(gemma3_1b.smoke_config(), seed=0, device="cpu",
                      page_size=4, n_pages=8, max_seq_len=16)
    assert eng.device.type == "cpu"
