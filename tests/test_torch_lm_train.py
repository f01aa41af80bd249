"""The LLM fine-tune slice of the PyTorch port against the JAX package on
the CPU, at three smoke configs: mamba2 (2 SSD layers, d 128, 16 heads of
P 16, state 16, chunk 8, vocab 512), gemma3 (7 attention layers, one
cycle of 5 local + 1 global plus a local remainder, d 128, 4 query heads
and 1 KV head of 32, window 8, vocab 512, tied embeddings, softcap 30) and
recurrentgemma (one cycle of RG-LRU, RG-LRU, local attention, d 128, LRU
width 128, 4 query heads and 1 KV head of 32, window 16, vocab 512):
weights carried over with ``params_from_jax``; the scores over
``transformer_blocks`` and the schedule they give; a 3-step D2FT
``finetune`` within 1e-4 of JAX's; the SSD H % G != 0 branch's fallback
report; the launcher on the CPU, on the packed path too, and what it
refuses. ``forward`` and ``lm_loss`` against JAX's are in
``test_torch_lm_forward.py`` (the cases of both files:
``_torch_lm_cases.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import mamba2_130m as jax_mamba
from repro.kernels import contract as jax_contract
from repro.models.transformer import forward as jax_forward
from repro_torch.configs import mamba2_130m
from repro_torch.interop import params_from_jax
from repro_torch.kernels import contract
from repro_torch.launch import train as launcher
from repro_torch.models.transformer import forward, init_model

from _torch_lm_cases import (ARCHS, B, S, STEP_TOL, _carried, _gates,
                             _port, finetune_case, scores_case)


@pytest.fixture(scope="module")
def carried():
    return _carried("mamba2")


def test_params_from_jax_carries_ssd_blocks(carried):
    _, tree = carried
    state = params_from_jax(tree)
    model = init_model(torch.Generator().manual_seed(0),
                       mamba2_130m.smoke_config())
    assert set(state) == set(model.state_dict())
    model.load_state_dict(state)
    for i in range(2):
        for leaf in ("w_in", "conv_w", "A_log", "norm_scale", "w_out"):
            np.testing.assert_array_equal(
                getattr(model.layers[i].ssd, leaf).detach().numpy(),
                tree["cycles"][0]["ssd"][leaf][i])
    assert not hasattr(model.layers[0], "norm2")        # mamba2: no FFN


@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_scores_give_the_jax_schedule(arch, G):
    scores_case(arch, G)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_finetune_trajectory_matches_jax(arch, use_kernel):
    finetune_case(arch, use_kernel)


def test_heads_not_tiling_groups_report_their_fallback(carried):
    """G = 3 does not divide the 16 SSD heads: the kernel path takes JAX's
    coarse block-granularity mix and says so through on_fallback."""
    params, tree = carried
    cfg = mamba2_130m.smoke_config()
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    g_f, g_b = _gates(rng, cfg.n_layers, 3)
    seen, jseen = [], []
    contract.on_fallback = lambda kind, why: seen.append((kind, why))
    jax_contract.on_fallback = lambda kind, why: jseen.append((kind, why))
    try:
        with torch.no_grad():
            logits, _ = forward(_port(tree), cfg, torch.from_numpy(tokens),
                                gates=(torch.from_numpy(g_f),
                                       torch.from_numpy(g_b)),
                                use_kernel=True)
        jlogits, _ = jax_forward(params, jax_mamba.smoke_config(),
                                 tokens=jnp.asarray(tokens),
                                 gates=(jnp.asarray(g_f), jnp.asarray(g_b)),
                                 use_kernel=True)
    finally:
        contract.on_fallback = None
        jax_contract.on_fallback = None
    assert seen == jseen and len(seen) == cfg.n_layers
    assert seen[0] == ("ssd", "H=16 not divisible by G=3 gate groups")
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=STEP_TOL, rtol=0)


def test_launcher_runs_the_fine_tune_on_the_cpu(capsys):
    log = launcher.main(["--arch", "mamba2-130m", "--d2ft", "--kernel",
                         "--n-pf", "2", "--n-po", "1", "--batch", "8",
                         "--seq", "16", "--steps", "2", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "arch=mamba2-130m layers=2 d_model=128 device=cpu"
    assert out[1] == ("D2FT: 2 p_f + 1 p_o of 4 micro-batches "
                      "(compute 60%)")
    assert out[2].startswith("2 steps in ")
    assert len(log.losses) == 2 and np.isfinite(log.losses).all()


# every flag of the JAX launcher is ported: a mesh with a stage or a
# tensor axis asks for its processes (torch.distributed.run), the elastic
# flags give the JAX launcher's refusals where they are misused, and
# --ckpt saves the final parameters in the JAX package's layout
NOT_PORTED_WITH = {"--distributed": ["--d2ft", "--mesh", "data=1,stage=2"],
                   "--mesh=data=2": ["--distributed", "--d2ft",
                                     "--mesh=data=2,tensor=2"]}
REFUSED = {"--elastic": "--elastic requires --distributed",
           "--faults=f.json": "--faults/--resume-from/--sync-mode local "
                              "require --elastic",
           "--resume-from=c.npz": "--faults/--resume-from/--sync-mode local"
                                  " require --elastic"}


@pytest.mark.parametrize("flag", ["--distributed", "--elastic",
                                  "--mesh=data=2", "--faults=f.json",
                                  "--resume-from=c.npz", "--ckpt=c.npz"])
def test_launcher_refuses_what_is_not_ported(flag, tmp_path, monkeypatch):
    if flag == "--ckpt=c.npz":
        from repro_torch.interop import params_from_jax
        from repro_torch.train.checkpoints import load_checkpoint
        monkeypatch.chdir(tmp_path)
        launcher.main(["--arch", "mamba2-130m", flag, "--device", "cpu",
                       "--steps", "1", "--batch", "2", "--seq", "8"])
        saved = params_from_jax(load_checkpoint("c.npz")["params"])
        assert "layers.0.ssd.w_in" in saved and \
            all(np.isfinite(t.numpy()).all() for t in saved.values())
        return
    match = "runs one process per rank" if flag in NOT_PORTED_WITH \
        else REFUSED[flag]
    with pytest.raises(SystemExit, match=match):
        launcher.main(["--arch", "mamba2-130m", flag, "--device", "cpu"]
                      + NOT_PORTED_WITH.get(flag, []))


def test_launcher_runs_the_packed_path_on_the_cpu(capsys):
    log = launcher.main(["--arch", "gemma3-1b", "--d2ft", "--packed",
                         "--batch", "8", "--seq", "16", "--steps", "2",
                         "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "arch=gemma3-1b layers=7 d_model=128 device=cpu"
    assert out[2].startswith("2 steps in ")
    assert len(log.losses) == 2 and np.isfinite(log.losses).all()
    assert set(log.metrics[0]) == {"ce", "loss", "grad_norm"}


@pytest.mark.parametrize("arch,argv,match", [
    ("gemma3-1b", ["--kernel"], "--packed and --kernel are exclusive"),
    ("gemma3-1b", [], "add --d2ft"),
    ("mamba2-130m", ["--d2ft"], r"\['ssd'\] blocks"),
    ("recurrentgemma-2b", ["--d2ft"], r"\['rglru'\] blocks"),
    ("olmoe-1b-7b", ["--d2ft"], "an MoE FFN")])
def test_launcher_refuses_what_the_packed_path_cannot_run(arch, argv,
                                                          match):
    with pytest.raises(SystemExit, match=match):
        launcher.main(["--arch", arch, "--packed", "--steps", "1",
                       "--device", "cpu"] + argv)


def test_launcher_without_device_refuses_silent_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launcher.main(["--arch", "mamba2-130m", "--steps", "1"])
