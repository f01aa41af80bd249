"""The port's CUDA kernels on a card, against their plain PyTorch versions.

These tests need a CUDA card (marker ``gpu``) and skip inside the test
where there is none: a CUDA kernel has no CPU mode. They import nothing of
JAX, so they run on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py

Tolerance 1e-5 abs in float32: the same softmax over the same positions,
summed in another order."""
import numpy as np
import pytest
import torch

from repro_torch.configs.gemma3_1b import smoke_config
from repro_torch.kernels.ops import paged_decode_attention
from repro_torch.kernels.paged_decode import (paged_decode_ref,
                                              paged_flash_decode)
from repro_torch.models.transformer import init_model
from repro_torch.serving.engine import PagedServingEngine, Request

TOL = 1e-5


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _case(seed, B, H, n_kv, hd, ps, n_pages, n_pmax, lengths, gated=()):
    """Random pools and queries on the card; each slot's table holds
    distinct random pages up to its length, null-padded past it."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((B, H, hd), generator=gen, device="cuda")
    kp = torch.randn((n_pages, ps, n_kv, hd), generator=gen, device="cuda")
    vp = torch.randn((n_pages, ps, n_kv, hd), generator=gen, device="cuda")
    perm = torch.randperm(n_pages - 1, generator=gen, device="cuda") + 1
    table = torch.zeros((B, n_pmax), dtype=torch.int32, device="cuda")
    for b, t in enumerate(lengths):
        n = t // ps + 1
        table[b, :n] = perm[b * n_pmax:b * n_pmax + n]
    g = torch.ones((B, H), device="cuda")
    for b, h in gated:
        g[b, h] = 0.0
    ln = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    return q, kp, vp, table, ln, g


def test_flash_decode_refuses_cpu_tensors():
    """No silent CPU path inside the launcher: CPU tensors are the plain
    version's business (``ops.paged_decode_attention`` routes them)."""
    q = torch.zeros((1, 2, 32))
    pools = torch.zeros((4, 4, 1, 32))
    table = torch.zeros((1, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        paged_flash_decode(q, pools, pools, table,
                           torch.zeros((1,), dtype=torch.int32),
                           torch.ones((1, 2)))


@pytest.mark.gpu
@pytest.mark.parametrize("window", [0, 512])
def test_kernel_matches_plain_at_gemma_shapes(window):
    """gemma3-1b decode shapes (H=4, n_kv=1, hd=256, ps=16): lengths at and
    around page boundaries and past the window, null-padded tables, a slot
    with every head gated off and one with one head gated off."""
    _need_card()
    args = _case(0, 4, 4, 1, 256, 16, 600, 130, [15, 16, 700, 2047],
                 [(1, 0), (1, 1), (1, 2), (1, 3), (2, 1)])
    before = paged_flash_decode.launches
    out = paged_decode_attention(*args[:5], g_f=args[5], window=window)
    torch.cuda.synchronize()
    assert paged_flash_decode.launches == before + 1
    ref = paged_decode_ref(*args, window=window)
    assert float((out - ref).abs().max()) <= TOL
    assert float(out[1].abs().max()) == 0.0
    assert float(out[2, 1].abs().max()) == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("hd,H,n_kv,window", [(32, 4, 1, 8), (64, 4, 2, 0),
                                              (128, 8, 1, 5), (256, 2, 2, 0)])
def test_kernel_head_dims_and_groups(hd, H, n_kv, window):
    _need_card()
    args = _case(1, 3, H, n_kv, hd, 4, 64, 9, [0, 13, 35], [(2, 0)])
    out = paged_decode_attention(*args[:5], g_f=args[5], window=window)
    torch.cuda.synchronize()
    ref = paged_decode_ref(*args, window=window)
    assert float((out - ref).abs().max()) <= TOL


@pytest.mark.gpu
def test_kernel_rejects_what_it_does_not_take():
    _need_card()
    q, kp, vp, table, ln, g = _case(2, 2, 4, 1, 32, 4, 16, 3, [3, 9])
    with pytest.raises(TypeError, match="float32"):
        paged_flash_decode(q.double(), kp, vp, table, ln, g)
    with pytest.raises(TypeError, match="int32"):
        paged_flash_decode(q, kp, vp, table.long(), ln, g)
    with pytest.raises(ValueError, match="contiguous"):
        paged_flash_decode(q.transpose(0, 1).contiguous().transpose(0, 1),
                           kp, vp, table, ln, g)
    with pytest.raises(ValueError, match="head_dim"):
        paged_flash_decode(q[..., :24].contiguous(), kp[..., :24].contiguous(),
                           vp[..., :24].contiguous(), table, ln, g)


@pytest.mark.gpu
def test_engine_kernel_path_matches_plain_path_on_card():
    """gemma3-1b smoke size on the card: the kernel path launches once per
    attention layer per decode step and gives the plain path's tokens."""
    _need_card()
    cfg = smoke_config()
    model = init_model(torch.Generator(device="cuda").manual_seed(0), cfg)
    rng = np.random.RandomState(0)
    reqs = [Request(uid=i, prompt=rng.randint(0, cfg.vocab_size, size=s)
                    .astype(np.int32), max_new_tokens=6)
            for i, s in enumerate([5, 9, 24, 7, 13])]
    kw = dict(page_size=4, n_pages=40, max_slots=3, max_seq_len=32)
    before = paged_flash_decode.launches
    eng = PagedServingEngine(model, cfg, use_kernel=True, **kw)
    out = eng.run(reqs)
    assert paged_flash_decode.launches - before == cfg.n_layers * eng.n_steps
    plain = PagedServingEngine(model, cfg, use_kernel=False, **kw).run(reqs)
    for r in reqs:
        np.testing.assert_array_equal(out[r.uid], plain[r.uid])
    assert eng.pm.n_free == eng.pm.capacity
