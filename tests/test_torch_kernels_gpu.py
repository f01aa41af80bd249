"""The port's CUDA kernels on a card, against their plain PyTorch versions.

These tests need a CUDA card (marker ``gpu``) and skip inside the test
where there is none: a CUDA kernel has no CPU mode. They import nothing of
JAX, so they run on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py

Tolerance 1e-5 abs in float32 for outputs: the same softmax over the same
positions, summed in another order (the attention forward's products in
3xTF32 on the tensor cores, at float32 accuracy); 1e-4 for the gated
attention's gradients; 1e-5 for the gated SSD scan's y and prevs and 1e-4
for its gradients; 1e-5 x max(1, max |plain|) for the fused LoRA matmul
(sums of up to 1152 products of values of ~1, where float32 rounds at
~1e-7 of the sum); 1e-5 (h) and 1e-4 (dla, db) x max(1, max |plain|) for
the gated RG-LRU scan (a segmented float32 recurrence against the plain
version's chunked log-space sums); 1e-5 (y) and 1e-4 (dx, dW) x max(1,
max |plain|) for the gated MoE expert FFN (sums of up to 2048 products in
another order than cuBLAS's)."""
import numpy as np
import pytest
import torch

from repro_torch.configs import (gemma3_1b, mamba2_130m, olmoe_1b_7b,
                                 recurrentgemma_2b, vit_small_paper)
from repro_torch.configs.base import D2FTConfig
from repro_torch.configs.gemma3_1b import smoke_config
from repro_torch.configs.mamba2_130m import smoke_config as mamba2_smoke
from repro_torch.core.d2ft import plan_schedule
from repro_torch.core.lora import init_lora
from repro_torch.data.synthetic import (image_batches, lm_batches,
                                        make_image_task)
from repro_torch.kernels import contract, ops
from repro_torch.kernels import d2ft_attention as d2a
from repro_torch.kernels import d2ft_moe as d2m
from repro_torch.kernels import d2ft_rglru as d2r
from repro_torch.kernels import d2ft_ssd as d2s
from repro_torch.kernels import lora_matmul as lm
from repro_torch.kernels.ops import paged_decode_attention
from repro_torch.kernels.paged_decode import (paged_decode_ref,
                                              paged_flash_decode)
from repro_torch.models.transformer import init_model
from repro_torch.models.vit import init_vit
from repro_torch.optim.optimizers import adamw, sgd
from repro_torch.serving.engine import PagedServingEngine, Request
from repro_torch.train.loop import finetune, finetune_vit

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
                                              (128, 8, 1, 5), (256, 2, 2, 0),
                                              (256, 10, 1, 2048),
                                              (32, 10, 1, 8), (64, 9, 1, 0),
                                              (32, 16, 1, 0), (80, 4, 2, 0),
                                              (96, 4, 1, 5), (80, 32, 32, 0),
                                              (96, 32, 32, 8)])
def test_kernel_head_dims_and_groups(hd, H, n_kv, window):
    """Every head dim the kernel takes and query heads per KV head from 1
    to 16: past 8 the kernel splits a KV head's heads into groups of at
    most 8 (recurrentgemma-2b's 10 on 1: two groups of 5)."""
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


# the CPU emulation's cases (tests/test_torch_paged_decode.py), three runs
# of 64 positions a table, and gemma3-1b's decode at phase 5's lengths:
# (B, H, n_kv, hd, ps, n_pages, n_pmax, lengths, gated heads, window)
SPLIT_CASES = {
    "run_boundaries": (4, 4, 1, 32, 8, 100, 24, [63, 64, 127, 128], (), 0),
    "window_cuts_runs": (3, 4, 2, 32, 8, 80, 24, [100, 150, 191], (), 40),
    "padded_past_runs": (3, 4, 1, 32, 16, 48, 12, [10, 70, 5], ((1, 1),),
                         0),
    "slot_gated": (3, 4, 1, 32, 8, 80, 24, [90, 130, 20],
                   ((1, 0), (1, 1), (1, 2), (1, 3)), 64),
    "rep8": (2, 8, 1, 32, 8, 64, 24, [77, 140], ((0, 5),), 0),
    "batch1": (1, 4, 2, 64, 4, 64, 40, [129], (), 100),
    "gemma_global": (4, 4, 1, 256, 16, 600, 129, [731, 1131, 1551, 2063],
                     ((2, 1),), 0),
    "gemma_window": (4, 4, 1, 256, 16, 600, 129, [731, 1131, 1551, 2063],
                     ((0, 0), (0, 1), (0, 2), (0, 3)), 512),
    # recurrentgemma-2b's decode (10 query heads on 1 KV head of 256,
    # window 2048) and the head dims 80 and 96
    "rep10": (2, 10, 1, 32, 8, 64, 24, [70, 150], ((1, 3), (1, 8)), 0),
    "recurrentgemma": (4, 10, 1, 256, 16, 600, 129, [731, 1131, 1551, 2063],
                       ((2, 0), (2, 9)), 2048),
    "hd80": (2, 4, 2, 80, 8, 64, 24, [64, 140], ((0, 2),), 40),
    "hd96": (2, 4, 1, 96, 8, 64, 24, [127, 5], (), 0),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(SPLIT_CASES))
def test_split_kv_decode_matches_plain_and_is_bitwise_deterministic(name):
    """The split-KV kernel and its merge against the plain version at run
    boundaries, a window that cuts a run, tables null-padded over whole
    runs, a slot with every head gated, rep 8, rep 10, B 1, gemma3-1b's
    and recurrentgemma-2b's shapes and head dims 80 and 96; two calls give
    bitwise-equal outputs (the runs are merged in
    a fixed order, no float atomics), each call one launch."""
    _need_card()
    *shape, window = SPLIT_CASES[name]
    args = _case(7, *shape)
    before = paged_flash_decode.launches
    out = paged_flash_decode(*args, window=window)
    again = paged_flash_decode(*args, window=window)
    torch.cuda.synchronize()
    assert paged_flash_decode.launches == before + 2
    ref = paged_decode_ref(*args, window=window)
    assert torch.isfinite(out).all()
    assert float((out - ref).abs().max()) <= TOL
    assert torch.equal(out, again)
    dead = args[5] == 0
    if dead.any():
        assert float(out[dead].abs().max()) == 0.0


@pytest.mark.gpu
def test_kernel_refuses_unaligned_pools():
    """The kernels copy K/V rows in 16 bytes; pools too large to copy that
    start off a 16-byte boundary are refused."""
    _need_card()
    q, kp, vp, table, ln, g = _case(2, 2, 4, 1, 32, 4, 16, 3, [3, 9])
    off = torch.empty(kp.numel() + 1, device="cuda")[1:].view_as(kp)
    off.copy_(kp)
    with pytest.raises(ValueError, match="16-byte"):
        paged_flash_decode(q, off, vp, table, ln, g)


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


# ------------------------------------------------- d2ft gated attention
# Tolerances in float32 with TF32 off: o and lse 1e-5, gradients 1e-4 (sums
# over up to 197 keys in another order than the plain version's).
GRAD_TOL = 1e-4


def test_d2ft_kernels_refuse_cpu_tensors():
    """CPU tensors are the plain version's business: the launchers raise."""
    x = torch.zeros((1, 2, 5, 32))
    g = torch.ones((1, 2))
    with pytest.raises(ValueError, match="CUDA tensors"):
        d2a.flash_fwd(x, x, x, g, causal=False)
    with pytest.raises(ValueError, match="CUDA tensors"):
        d2a.flash_bwd(x, x, x, g, x, torch.zeros((1, 2, 5)), x, causal=False)


def _attn_case(seed, B, H, S, hd):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn((B, H, S, hd), generator=gen, device="cuda")
                   for _ in range(4))
    ops_ = torch.randperm(B * H, generator=gen, device="cuda") % 3
    g_f = (ops_ != 2).float().reshape(B, H)
    g_b = (ops_ == 0).float().reshape(B, H)
    return q, k, v, do, g_f, g_b


@pytest.mark.gpu
@pytest.mark.parametrize("hd,S,causal,window", [
    *[(hd, S, causal, window) for hd in (16, 32, 64, 80, 96, 128, 256)
      for S in (1, 63, 197)
      for causal, window in ((False, 0), (True, 0), (True, 40))],
    (256, 1024, True, 0), (256, 1024, True, 512), (80, 1024, True, 0),
    (96, 1024, True, 0)])
def test_d2ft_kernels_match_plain(hd, S, causal, window):
    """Forward and backward kernels against the plain version and its
    autograd gradients, with compaction bounds above the live counts;
    exact zeros on gated slices, LSE_MASKED on dead ones, and executed
    tiles = live slices x live tiles per slice of each kernel. hd 256
    takes 32-row forward tiles and 64 x 32 backward ones (ragged at S 63
    and 197); hd 80 and 96 rows padded to a pitch of 96 floats in shared
    memory; S 1024 is gemma3-1b's fine-tune length, with its 512 window
    and without, and stablelm-3b's (hd 80) and phi3-vision-42b's (hd 96)
    causal."""
    _need_card()
    B, H = 3, 4
    q, k, v, do, g_f, g_b = _attn_case(hd + S, B, H, S, hd)
    n_f, n_b = int((g_f != 0).sum()), int((g_b != 0).sum())
    f0, b0 = d2a.flash_fwd.launches, d2a.flash_bwd.launches
    with contract.count_tiles("cuda") as tc:
        qk, kk, vk = (t.clone().requires_grad_() for t in (q, k, v))
        out = d2a.gated_flash_attention(qk, kk, vk, g_f, g_b, causal=causal,
                                        window=window, live_fwd=n_f + 1,
                                        live_bwd=n_b + 2)
        out.backward(do)
        counts = tc.read()
    assert d2a.flash_fwd.launches == f0 + 1
    assert d2a.flash_bwd.launches == b0 + 1
    _, lse = d2a.flash_fwd(q, k, v, g_f, causal=causal, window=window,
                           live=n_f + 1)
    qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))
    ref = d2a.gated_attention_ref(qr, kr, vr, g_f, g_b, causal=causal,
                                  window=window)
    ref.backward(do)
    lse_ref = d2a.gated_attention_lse_ref(q, k, g_f, causal=causal,
                                          window=window)
    out, ref = out.detach(), ref.detach()
    assert float((out - ref).abs().max()) <= TOL
    assert float((lse - lse_ref).abs().max()) <= TOL
    for a, b in ((qk, qr), (kk, kr), (vk, vr)):
        assert float((a.grad - b.grad).abs().max()) <= GRAD_TOL
        assert float(a.grad[g_b == 0].abs().max()) == 0.0
    assert float(out[g_f == 0].abs().max()) == 0.0
    assert bool((lse[g_f == 0] == d2a.LSE_MASKED).all())
    tiles = {kind: d2a.kernel_live_tiles(S, causal, window, hd, kind)
             for kind in d2a.KERNEL_KINDS}
    assert counts == {"fwd": n_f * tiles["fwd"],
                      "bwd_dkdv": n_b * tiles["bwd_dkdv"],
                      "bwd_dq": n_b * tiles["bwd_dq"], "ssd_fwd": 0,
                      "ssd_bwd": 0, "rglru_fwd": 0, "rglru_bwd": 0,
                      "moe_fwd": 0, "moe_bwd": 0}


@pytest.mark.gpu
@pytest.mark.parametrize("hd,S,causal,window", [
    (64, 197, False, 0), (256, 1024, True, 512), (256, 197, True, 40),
    (80, 1024, True, 0), (96, 197, True, 40)])
def test_d2ft_backward_is_bitwise_deterministic(hd, S, causal, window):
    """Two backward launches on the same inputs give bitwise-equal dq, dk
    and dv: FA2's split sums every gradient in one block, in a fixed order,
    with no float atomics (the fine-tunes compare trajectories)."""
    _need_card()
    q, k, v, do, g_f, g_b = _attn_case(hd + S, 3, 4, S, hd)
    n_f, n_b = int((g_f != 0).sum()), int((g_b != 0).sum())
    o, lse = d2a.flash_fwd(q, k, v, g_f, causal=causal, window=window,
                           live=n_f)
    first = d2a.flash_bwd(q, k, v, g_b, o, lse, do, causal=causal,
                          window=window, live=n_b)
    second = d2a.flash_bwd(q, k, v, g_b, o, lse, do, causal=causal,
                           window=window, live=n_b)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.isfinite(a).all()
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("hd", d2a.KERNEL_HEAD_DIMS)
@pytest.mark.parametrize("S,causal,window", [
    (197, False, 0), (197, True, 0), (197, True, 40), (1024, False, 0),
    (1024, True, 0), (1024, True, 512)])
def test_d2ft_forward_matches_plain_and_is_bitwise_deterministic(hd, S,
                                                                 causal,
                                                                 window):
    """The forward kernel (3xTF32 on the tensor cores) against the plain
    version's o and lse at every head dim, bidirectional, causal and
    windowed, at ViT-small's S 197 and gemma3-1b's S 1024; two launches
    give bitwise-equal o and lse (every sum in one block, in a fixed
    order)."""
    _need_card()
    q, k, v, _, g_f, g_b = _attn_case(3 * hd + S + window, 2, 4, S, hd)
    n_f = int((g_f != 0).sum())
    o, lse = d2a.flash_fwd(q, k, v, g_f, causal=causal, window=window,
                           live=n_f)
    o2, lse2 = d2a.flash_fwd(q, k, v, g_f, causal=causal, window=window,
                             live=n_f)
    torch.cuda.synchronize()
    ref = d2a.gated_attention_ref(q, k, v, g_f, g_b, causal=causal,
                                  window=window)
    lse_ref = d2a.gated_attention_lse_ref(q, k, g_f, causal=causal,
                                          window=window)
    assert float((o - ref).abs().max()) <= TOL
    assert float((lse - lse_ref).abs().max()) <= TOL
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    assert float(o[g_f == 0].abs().max()) == 0.0
    assert bool((lse[g_f == 0] == d2a.LSE_MASKED).all())


@pytest.mark.gpu
def test_d2ft_forward_copies_unaligned_views():
    """The forward streams rows with 16-byte cp.async: a view that starts
    off a 16-byte boundary is copied by the launcher, with the same
    result."""
    _need_card()
    q, k, v, _, g_f, _ = _attn_case(5, 2, 3, 37, 64)
    off = torch.empty(q.numel() + 1, device="cuda")[1:].view_as(q)
    off.copy_(q)
    assert off.data_ptr() % 16
    o, lse = d2a.flash_fwd(q, k, v, g_f, causal=True)
    o2, lse2 = d2a.flash_fwd(off, k, v, g_f, causal=True)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)


@pytest.mark.gpu
def test_d2ft_kernels_refuse_what_they_do_not_take():
    _need_card()
    q, k, v, do, g_f, g_b = _attn_case(0, 2, 3, 20, 32)
    with pytest.raises(TypeError, match="float32"):
        d2a.flash_fwd(q.double(), k, v, g_f, causal=True)
    with pytest.raises(ValueError, match="contiguous"):
        d2a.flash_fwd(q.transpose(2, 3).contiguous().transpose(2, 3), k, v,
                      g_f, causal=True)
    with pytest.raises(ValueError, match="head_dim"):
        x = q[..., :24].contiguous()
        d2a.flash_fwd(x, x, x, g_f, causal=True)
    with pytest.raises(ValueError, match="below the live gate count"):
        ops.gated_attention(q, k, v, g_f, g_b,
                            live_fwd=int((g_f != 0).sum()) - 1)
    with pytest.raises(ValueError, match="g_b <= g_f"):
        ops.gated_attention(q, k, v, g_b, g_f)


@pytest.mark.gpu
def test_finetune_vit_kernel_path_matches_masked_path_on_card():
    """Two D2FT steps on the smoke ViT: the kernel path launches one forward
    and one backward per layer per step and its losses match the masked
    path's from the same weights and schedule."""
    _need_card()
    cfg = vit_small_paper.smoke_config()
    L, G, N = cfg.n_layers, cfg.n_heads, 5
    rng = np.random.default_rng(0)
    bw, fw = rng.random((L * G, N)), rng.random((L * G, N))
    sched = plan_schedule(D2FTConfig(n_microbatches=N, n_pf=3, n_po=1), bw,
                          fw, L, G)
    task = make_image_task(3, n_classes=10, image_size=32)
    losses = {}
    for use_kernel in (True, False):
        f0, b0 = d2a.flash_fwd.launches, d2a.flash_bwd.launches
        model = init_vit(cfg, seed=0, device="cuda")
        _, _, log = finetune_vit(model, cfg, sgd(0.05),
                                 image_batches(task, 5, 10, 2), steps=2,
                                 schedule_fn=lambda *a: sched,
                                 n_microbatches=N, use_kernel=use_kernel)
        assert d2a.flash_fwd.launches - f0 == (2 * L if use_kernel else 0)
        assert d2a.flash_bwd.launches - b0 == (2 * L if use_kernel else 0)
        losses[use_kernel] = log.losses
    np.testing.assert_allclose(losses[True], losses[False], atol=1e-4,
                               rtol=0)


# ------------------------------------------------------------ d2ft gated SSD
# Tolerances in float32 with TF32 off: y and prevs 1e-5, dx / ddA / dB / dC
# 1e-4 against the plain version's autograd gradients. The kernels sum the
# in-chunk decays in the plain version's order, so both take the same
# decays; the operands are the JAX block-kernel tests' (N(0, 1) x), at
# few slices.
def _ssd_case(seed, B, H, S, P, N):
    """Operands in the JAX block-kernel tests' distributions and a p_f /
    p_o / p_s gate mix with every op present."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((B, S, H, P), generator=gen, device="cuda")
    da = -torch.nn.functional.softplus(
        torch.randn((B, S, H), generator=gen, device="cuda"))
    Bm = torch.randn((B, S, N), generator=gen, device="cuda") * 0.5
    Cm = torch.randn((B, S, N), generator=gen, device="cuda") * 0.5
    dy = torch.randn((B, S, H, P), generator=gen, device="cuda")
    ops_ = torch.randperm(B * H, generator=gen, device="cuda") % 3
    g_f = (ops_ != 2).float().reshape(B, H)
    g_b = (ops_ == 0).float().reshape(B, H)
    return x, da, Bm, Cm, dy, g_f, g_b


def test_ssd_kernels_refuse_cpu_tensors():
    x = torch.zeros((1, 8, 2, 16))
    d, bc, g = torch.zeros((1, 8, 2)), torch.zeros((1, 8, 16)), \
        torch.ones((1, 2))
    with pytest.raises(ValueError, match="CUDA tensors"):
        d2s.ssd_fwd(x, d, bc, bc, g, chunk=8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        d2s.ssd_bwd(x, d, bc, bc, g, torch.zeros((2, 1, 16, 16)), x, chunk=8)


@pytest.mark.gpu
@pytest.mark.parametrize("P,N,chunk,S", [
    (16, 16, 8, 24), (16, 16, 8, 21), (64, 128, 256, 256),
    (64, 128, 256, 300), (64, 128, 256, 100), (64, 128, 64, 200)])
@pytest.mark.parametrize("bounded", [False, True])
def test_ssd_kernels_match_plain(P, N, chunk, S, bounded):
    """Forward and backward kernels through ``ops.gated_ssd_scan`` (the pad
    path where S is not a chunk multiple) against the plain version and
    its autograd gradients, with and without compaction bounds above the
    live counts; prevs against the plain version's; exact zeros on gated
    slices; executed steps = live slices x chunks."""
    _need_card()
    B, H = 2, 6
    x, da, Bm, Cm, dy, g_f, g_b = _ssd_case(S + P + bounded, B, H, S, P, N)
    n_f, n_b = int((g_f != 0).sum()), int((g_b != 0).sum())
    live = (n_f + 1, n_b + 2) if bounded else (None, None)
    f0, b0 = d2s.ssd_fwd.launches, d2s.ssd_bwd.launches
    with contract.count_tiles("cuda") as tc:
        ins = [t.clone().requires_grad_() for t in (x, da, Bm, Cm)]
        y = ops.gated_ssd_scan(*ins, g_f, g_b, chunk=chunk, live_fwd=live[0],
                               live_bwd=live[1])
        y.backward(dy)
        counts = tc.read()
    assert d2s.ssd_fwd.launches == f0 + 1
    assert d2s.ssd_bwd.launches == b0 + 1
    refs = [t.clone().requires_grad_() for t in (x, da, Bm, Cm)]
    Q, Sp = ops._scan_pad(S, chunk)
    pad = Sp - S
    padded = [torch.nn.functional.pad(refs[0], (0, 0, 0, 0, 0, pad))] + [
        torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in refs[1:]]
    ref = d2s.gated_ssd_ref(*padded, g_f, g_b, chunk=Q)[:, :S]
    ref.backward(dy)
    assert float((y.detach() - ref.detach()).abs().max()) <= TOL
    for a, b in zip(ins, refs):
        assert float((a.grad - b.grad).abs().max()) <= GRAD_TOL
    assert float(y.detach().transpose(1, 2)[g_f == 0].abs().max()) == 0.0
    assert float(ins[0].grad.transpose(1, 2)[g_b == 0].abs().max()) == 0.0
    assert float(ins[1].grad.transpose(1, 2)[g_b == 0].abs().max()) == 0.0
    with torch.no_grad():
        pin = [t.detach().contiguous() for t in padded]
        _, prevs = d2s.ssd_fwd(*pin, g_f, chunk=Q, live=live[0])
        prevs_ref = d2s.gated_ssd_prevs_ref(*pin, g_f, chunk=Q)
    assert float((prevs - prevs_ref).abs().max()) <= TOL
    assert float(prevs[g_f.reshape(-1) == 0].abs().max()) == 0.0
    nc = Sp // Q
    assert counts["ssd_fwd"] == n_f * nc and counts["ssd_bwd"] == n_b * nc


@pytest.mark.gpu
def test_ssd_kernels_refuse_what_they_do_not_take():
    _need_card()
    x, da, Bm, Cm, dy, g_f, g_b = _ssd_case(0, 2, 3, 32, 64, 128)
    with pytest.raises(TypeError, match="float32"):
        d2s.ssd_fwd(x.double(), da, Bm, Cm, g_f, chunk=16)
    with pytest.raises(ValueError, match="contiguous"):
        d2s.ssd_fwd(x.transpose(1, 2).contiguous().transpose(1, 2), da, Bm,
                    Cm, g_f, chunk=16)
    with pytest.raises(ValueError, match="no kernel"):
        xs = x[..., :32].contiguous()
        d2s.ssd_fwd(xs, da, Bm, Cm, g_f, chunk=16)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        d2s.ssd_fwd(x, da, Bm, Cm, g_f, chunk=24)
    with pytest.raises(ValueError, match="below the live gate count"):
        ops.gated_ssd_scan(x, da, Bm, Cm, g_f, g_b,
                           chunk=16, live_fwd=int((g_f != 0).sum()) - 1)
    with pytest.raises(ValueError, match="g_b <= g_f"):
        ops.gated_ssd_scan(x, da, Bm, Cm, g_b, g_f, chunk=16)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["mamba2-smoke", "mamba2-widths",
                                  "gemma3-smoke", "gemma3-widths"])
def test_finetune_kernel_path_matches_masked_path_on_card(arch):
    """Two D2FT steps of the launcher's loop: the smoke mamba2 (P 16, N 16,
    chunk 8), mamba2-130m's widths at depth 2 (P 64, N 128, chunk 256,
    S 300: the pad path), the smoke gemma3 (hd 32, window 8) and
    gemma3-1b's widths at depth 6 (one cycle of 5 local + 1 global, hd 256,
    window 512, S 600: ragged 32-row tiles). The kernel path launches one
    forward and one backward per layer per step and its losses match the
    masked path's from the same weights and schedule."""
    _need_card()
    cfg, seq = {
        "mamba2-smoke": (mamba2_smoke(), 16),
        "mamba2-widths": (mamba2_130m.CONFIG.replace(n_layers=2,
                                                     vocab_size=512), 300),
        "gemma3-smoke": (smoke_config(), 16),
        "gemma3-widths": (gemma3_1b.CONFIG.replace(n_layers=6,
                                                   vocab_size=512), 600),
    }[arch]
    kernel = (d2s.ssd_fwd, d2s.ssd_bwd) if arch.startswith("mamba2") \
        else (d2a.flash_fwd, d2a.flash_bwd)
    d2 = D2FTConfig(n_microbatches=4, n_pf=2, n_po=1, head_groups=4)
    losses = {}
    for use_kernel in (True, False):
        f0, b0 = kernel[0].launches, kernel[1].launches
        model = init_model(torch.Generator(device="cuda").manual_seed(0), cfg)
        _, _, log = finetune(model, cfg, d2, adamw(1e-3),
                             lm_batches(0, cfg.vocab_size, 8, seq, 2),
                             steps=2, use_kernel=use_kernel)
        L = cfg.n_layers
        assert kernel[0].launches - f0 == (2 * L if use_kernel else 0)
        assert kernel[1].launches - b0 == (2 * L if use_kernel else 0)
        losses[use_kernel] = log.losses
    assert np.isfinite(losses[True]).all()
    np.testing.assert_allclose(losses[True], losses[False], atol=1e-4,
                               rtol=0)


def _ssd_alone(x, da, Bm, Cm, dy, g_f, g_b, Q, nd, fill=float("nan")):
    """Both directions' kernels alone, into outputs and workspaces filled
    with ``fill``, dispatching nd = (forward, backward) slices; returns
    [y, prevs, dx, ddA, dB, dC]."""
    N = Bm.shape[-1]
    fb, bb = d2s._fwd_buffers(x, N, Q), d2s._bwd_buffers(x, N, Q)
    for t in list(fb.values()) + list(bb.values()):
        if t is not None:
            t.fill_(fill)
    d2s._fwd_call(x, da, Bm, Cm, g_f, fb, nd[0], Q)
    d2s._bwd_call(x, da, Bm, Cm, g_b, fb["prevs"], dy, bb, nd[1], Q)
    torch.cuda.synchronize()
    return [fb["y"], fb["prevs"], bb["dx"], bb["dda"], bb["db"], bb["dc"]]


@pytest.mark.gpu
@pytest.mark.parametrize("P,N,H,S,chunk", [(16, 16, 6, 24, 8),
                                           (64, 128, 24, 512, 256),
                                           (64, 128, 9, 192, 64)])
def test_ssd_kernels_are_bitwise_deterministic(P, N, H, S, chunk):
    """Two calls of each SSD launcher on the same operands give bitwise
    equal outputs: every sum, dB and dC over the heads included (one head
    group at H 6, three at H 24, a short second one at H 9), runs in a
    fixed order with no float atomics."""
    _need_card()
    x, da, Bm, Cm, dy, g_f, g_b = _ssd_case(P + H, 2, H, S, P, N)
    Q = min(chunk, S)
    outs = []
    for _ in range(2):
        y, prevs = d2s.ssd_fwd(x, da, Bm, Cm, g_f, chunk=Q)
        outs.append([y, prevs, *d2s.ssd_bwd(x, da, Bm, Cm, g_b, prevs, dy,
                                            chunk=Q)])
    torch.cuda.synchronize()
    assert all(torch.equal(u, v) for u, v in zip(*outs))
    assert all(bool(torch.isfinite(t).all()) for t in outs[0])


@pytest.mark.gpu
@pytest.mark.parametrize("P,N,H,S,chunk", [(16, 16, 6, 24, 8),
                                           (64, 128, 24, 512, 256),
                                           (64, 128, 9, 192, 64)])
def test_ssd_kernels_write_every_output_under_a_bound(P, N, H, S, chunk):
    """The launchers allocate unfilled outputs and workspaces: into
    NaN-filled ones, with the dispatch bounded two slices below the live
    counts, every output is finite; y, prevs (forward) and dx, ddA
    (backward) are exact zeros on the slices that do not run (gated, or
    live past the first n_disp live ones) and bitwise equal to an
    unbounded call's on the rest."""
    _need_card()
    Bsz = 2
    x, da, Bm, Cm, dy, g_f, g_b = _ssd_case(P + H + 1, Bsz, H, S, P, N)
    Q = min(chunk, S)
    n = Bsz * H
    nd = (int((g_f != 0).sum()) - 2, int((g_b != 0).sum()) - 2)
    full = _ssd_alone(x, da, Bm, Cm, dy, g_f, g_b, Q, (n, n))
    out = _ssd_alone(x, da, Bm, Cm, dy, g_f, g_b, Q, nd)
    assert all(bool(torch.isfinite(t).all()) for t in out)
    for i, (g, k) in enumerate(((g_f, nd[0]), (g_f, nd[0]), (g_b, nd[1]),
                                (g_b, nd[1]))):
        live = g.reshape(-1) != 0
        runs = live & (torch.cumsum(live.int(), 0) <= k)
        t, f = out[i], full[i]
        if i != 1:                       # [B, S, H, ...]: slices first
            t, f = (u.transpose(1, 2).reshape(n, -1) for u in (t, f))
        assert bool((t[~runs] == 0).all())
        assert torch.equal(t[runs], f[runs])
    # dB and dC hold only the dispatched slices' share: a call whose
    # outputs start at zero instead of NaN gives the same bits
    again = _ssd_alone(x, da, Bm, Cm, dy, g_f, g_b, Q, nd, fill=0.0)
    assert all(torch.equal(u, v) for u, v in zip(out, again))


@pytest.mark.gpu
def test_heads_not_tiling_groups_refuse_the_kernel_path_on_card():
    """G = 3 does not divide the smoke mamba2's 16 SSD heads: there is no
    kernel route, and on the card the kernel path raises instead of taking
    the plain block-granularity mix."""
    _need_card()
    from repro_torch.models.transformer import forward
    cfg = mamba2_smoke()
    model = init_model(torch.Generator(device="cuda").manual_seed(0), cfg)
    tokens = torch.zeros((2, 16), dtype=torch.int64, device="cuda")
    gates = torch.ones((cfg.n_layers, 2, 3), device="cuda")
    with pytest.raises(ValueError, match="no kernel route"):
        forward(model, cfg, tokens, gates=(gates, gates), use_kernel=True)


# ------------------------------------------------------- d2ft gated RG-LRU
def _rglru_case(seed, B, S, W, G):
    """Operands in the JAX block-kernel tests' distributions (la =
    -softplus(N(0, 1)), b and the cotangent N(0, 1)) and a p_f / p_o / p_s
    gate mix with every op present."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    la = -torch.nn.functional.softplus(
        torch.randn((B, S, W), generator=gen, device="cuda"))
    b = torch.randn((B, S, W), generator=gen, device="cuda")
    dy = torch.randn((B, S, W), generator=gen, device="cuda")
    ops_ = torch.randperm(B * G, generator=gen, device="cuda") % 3
    g_f = (ops_ != 2).float().reshape(B, G)
    g_b = (ops_ == 0).float().reshape(B, G)
    return la, b, dy, g_f, g_b


def test_rglru_kernels_refuse_cpu_tensors():
    """CPU tensors are the plain version's business: the launchers raise."""
    la = torch.zeros((1, 8, 32))
    g = torch.ones((1, 4))
    with pytest.raises(ValueError, match="CUDA tensors"):
        d2r.rglru_fwd(la, la, g, chunk=8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        d2r.rglru_bwd(la, g, la, la, chunk=8)


@pytest.mark.gpu
@pytest.mark.parametrize("W,G,chunk,S", [
    (128, 4, 8, 24), (128, 4, 8, 21), (320, 10, 128, 512),
    (2560, 10, 128, 512), (2560, 10, 128, 500), (128, 1, 128, 4096),
    (96, 2, 128, 300)])
@pytest.mark.parametrize("bounded", [False, True])
def test_rglru_kernels_match_plain(W, G, chunk, S, bounded):
    """Forward and backward kernels through ``ops.gated_rglru_scan`` (the
    pad path where S is not a chunk multiple) against the plain version and
    its autograd gradients, with and without compaction bounds above the
    live counts, at band widths Wg 32, 256, 128 and 48; exact zeros on
    gated bands; executed steps = live slices x chunks."""
    _need_card()
    B = 3
    la, b, dy, g_f, g_b = _rglru_case(S + W + bounded, B, S, W, G)
    n_f, n_b = int((g_f != 0).sum()), int((g_b != 0).sum())
    live = (n_f + 1, n_b + 2) if bounded else (None, None)
    f0, b0 = d2r.rglru_fwd.launches, d2r.rglru_bwd.launches
    with contract.count_tiles("cuda") as tc:
        ins = [t.clone().requires_grad_() for t in (la, b)]
        h = ops.gated_rglru_scan(*ins, g_f, g_b, chunk=chunk,
                                 live_fwd=live[0], live_bwd=live[1])
        h.backward(dy)
        counts = tc.read()
    assert d2r.rglru_fwd.launches == f0 + 1
    assert d2r.rglru_bwd.launches == b0 + 1
    refs = [t.clone().requires_grad_() for t in (la, b)]
    Q, Sp = ops._scan_pad(S, chunk)
    padded = [torch.nn.functional.pad(t, (0, 0, 0, Sp - S)) for t in refs]
    ref = d2r.gated_rglru_ref(*padded, g_f, g_b, chunk=Q)[:, :S]
    ref.backward(dy)
    scale = max(1.0, float(ref.detach().abs().max()))
    assert float((h.detach() - ref.detach()).abs().max()) <= TOL * scale
    for a, r in zip(ins, refs):
        assert float((a.grad - r.grad).abs().max()) <= \
            GRAD_TOL * max(1.0, float(r.grad.abs().max()))
    Wg = W // G

    def bands(t):
        return t.detach().reshape(B, S, G, Wg).transpose(1, 2)
    assert float(bands(h)[g_f == 0].abs().max()) == 0.0
    for a in ins:
        assert float(bands(a.grad)[g_b == 0].abs().max()) == 0.0
    nc = Sp // Q
    assert counts["rglru_fwd"] == n_f * nc and counts["rglru_bwd"] == n_b * nc
    assert counts["ssd_fwd"] == counts["fwd"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("W,G,S,bounds", [
    (2560, 10, 512, "live"), (2560, 80, 512, "live"), (128, 1, 4096, None),
    (96, 2, 384, "above"), (36, 4, 40, "live")])
def test_rglru_kernels_write_their_zeros_and_are_bitwise_deterministic(
        W, G, S, bounds):
    """Compacted and uncompacted calls of both kernels into NaN-filled
    outputs (the launchers fill nothing): every slice is written, exact
    zeros on gated and undispatched ones, finite elsewhere; two calls give
    bitwise-equal h, dla and db (segments combined in a fixed order, no
    atomics on values). Wg 256, 32, 128, 48 and 9 (the 4-byte path)."""
    _need_card()
    B, chunk = 3, 128 if S % 128 == 0 else 8
    la, b, dy, g_f, g_b = _rglru_case(W + S, B, S, W, G)
    n_f, n_b = int((g_f != 0).sum()), int((g_b != 0).sum())
    live = {None: (None, None), "live": (n_f, n_b),
            "above": (n_f + 1, n_b + 2)}[bounds]
    Wg = W // G

    def bands(t):
        return t.reshape(B, S, G, Wg).transpose(1, 2)
    runs = []
    for _ in range(2):
        h, dla, db = (torch.full_like(la, float("nan")) for _ in range(3))
        _, Q, nf = d2r._prepare(la, g_f, chunk, live[0])
        d2r._fwd_call(la, b, g_f, h, nf, G, Q)
        _, _, nb = d2r._prepare(la, g_b, chunk, live[1])
        d2r._bwd_call(la, h, dy, g_b, dla, db, nb, G, Q)
        runs.append((h, dla, db))
    torch.cuda.synchronize()
    h, dla, db = runs[0]
    for t in runs[0]:
        assert torch.isfinite(t).all()
    assert float(bands(h)[g_f == 0].abs().max()) == 0.0
    for t in (dla, db):
        assert float(bands(t)[g_b == 0].abs().max()) == 0.0
    for u, v in zip(*runs):
        assert torch.equal(u, v)
    ref = d2r.gated_rglru_ref(la, b, g_f, g_b, chunk=chunk)
    assert float((h - ref).abs().max()) <= \
        TOL * max(1.0, float(ref.abs().max()))


@pytest.mark.gpu
def test_rglru_kernels_refuse_what_they_do_not_take():
    _need_card()
    la, b, dy, g_f, g_b = _rglru_case(0, 2, 32, 64, 4)
    with pytest.raises(TypeError, match="float32"):
        d2r.rglru_fwd(la.double(), b, g_f, chunk=16)
    with pytest.raises(ValueError, match="contiguous"):
        d2r.rglru_fwd(la.transpose(0, 1).contiguous().transpose(0, 1), b,
                      g_f, chunk=16)
    with pytest.raises(ValueError, match="not divisible by G=3"):
        d2r.rglru_fwd(la, b, torch.ones((2, 3), device="cuda"), chunk=16)
    with pytest.raises(ValueError, match="not divisible by G=3"):
        g3 = torch.ones((2, 3), device="cuda")
        ops.gated_rglru_scan(la, b, g3, g3, chunk=16)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        d2r.rglru_fwd(la, b, g_f, chunk=24)
    with pytest.raises(ValueError, match="below the live gate count"):
        ops.gated_rglru_scan(la, b, g_f, g_b, chunk=16,
                             live_fwd=int((g_f != 0).sum()) - 1)
    with pytest.raises(ValueError, match="g_b <= g_f"):
        ops.gated_rglru_scan(la, b, g_b, g_f, chunk=16)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["recurrentgemma-smoke",
                                  "recurrentgemma-widths"])
def test_recurrentgemma_kernel_path_matches_masked_path_on_card(arch):
    """Two D2FT steps of the launcher's loop on the hybrid model: the smoke
    config (W 128, G 4: Wg 32, hd 32, window 16, S 40: past the window)
    and recurrentgemma-2b's widths at one cycle (RG-LRU, RG-LRU, local
    attention; W 2560, G 10: Wg 256, hd 256, 10 query heads on 1 KV head,
    S 300: the scan's pad path). The kernel path launches one forward and
    one backward RG-LRU kernel per RG-LRU layer and attention kernel per
    attention layer per step; its losses match the masked path's from the
    same weights and schedule."""
    _need_card()
    cfg, seq, G = {
        "recurrentgemma-smoke": (recurrentgemma_2b.smoke_config(), 40, 4),
        "recurrentgemma-widths": (recurrentgemma_2b.CONFIG.replace(
            n_layers=3, vocab_size=512), 300, 10),
    }[arch]
    d2 = D2FTConfig(n_microbatches=4, n_pf=2, n_po=1, head_groups=G)
    n_rg = cfg.layer_kinds.count("rglru")
    n_at = cfg.n_layers - n_rg
    losses = {}
    for use_kernel in (True, False):
        r0, a0 = d2r.rglru_bwd.launches, d2a.flash_bwd.launches
        model = init_model(torch.Generator(device="cuda").manual_seed(0), cfg)
        _, _, log = finetune(model, cfg, d2, sgd(1e-3),
                             lm_batches(0, cfg.vocab_size, 4, seq, 2),
                             steps=2, use_kernel=use_kernel)
        assert d2r.rglru_bwd.launches - r0 == \
            (2 * n_rg if use_kernel else 0)
        assert d2a.flash_bwd.launches - a0 == \
            (2 * n_at if use_kernel else 0)
        losses[use_kernel] = log.losses
    assert np.isfinite(losses[True]).all()
    np.testing.assert_allclose(losses[True], losses[False], atol=1e-4,
                               rtol=0)


@pytest.mark.gpu
def test_width_not_tiling_groups_refuses_the_kernel_path_on_card():
    """An LRU width of 126 does not tile into G = 4 gate groups: there is no
    kernel route, and on the card the kernel path raises instead of taking
    the plain block-granularity mix."""
    _need_card()
    from repro_torch.configs.base import RGLRUConfig
    from repro_torch.models.transformer import forward
    cfg = recurrentgemma_2b.smoke_config().replace(
        rglru=RGLRUConfig(lru_width=126, conv_width=4))
    model = init_model(torch.Generator(device="cuda").manual_seed(0), cfg)
    tokens = torch.zeros((2, 16), dtype=torch.int64, device="cuda")
    gates = torch.ones((cfg.n_layers, 2, 4), device="cuda")
    with pytest.raises(ValueError, match="no kernel route"):
        forward(model, cfg, tokens, gates=(gates, gates), use_kernel=True)


# ------------------------------------------------------- fused LoRA matmul
def _lora_case(seed, M, K, N, r):
    """x ~ N(0, 1) and W, A, B at the model's scales (dense_init's and
    init_lora's 1/sqrt(fan-in), B as a trained adapter's ~N(0, 1/r))."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((M, K), generator=gen, device="cuda")
    w = torch.randn((K, N), generator=gen, device="cuda") / K ** 0.5
    a = torch.randn((K, r), generator=gen, device="cuda") / K ** 0.5
    b = torch.randn((r, N), generator=gen, device="cuda") / r ** 0.5
    return x, w, a, b


def test_lora_matmul_refuses_cpu_tensors():
    """CPU tensors are the plain version's business (``ops.lora_linear``
    routes them): the launcher raises."""
    x, w = torch.zeros((4, 8)), torch.zeros((8, 6))
    with pytest.raises(ValueError, match="CUDA tensors"):
        lm.lora_matmul(x, w, torch.zeros((8, 2)), torch.zeros((2, 6)))


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N", [(4096, 1152, 256), (4095, 1152, 1000),
                                   (130, 97, 70), (1, 33, 5)])
@pytest.mark.parametrize("r", [1, 8, 64, 240, 256])
def test_lora_matmul_matches_plain(M, K, N, r):
    """The kernel against ``lora_matmul_ref`` and against the merged product
    x @ (W + s·A@B): gemma3-1b's wk shape, ragged M, N and K (4095 x 1000,
    odd sizes, a single row), the paper's ranks and the kernel's largest
    (256, its third width). Through ``ops.lora_linear``
    once, 2-D and 3-D."""
    _need_card()
    x, w, a, b = _lora_case(M + N + r, M, K, N, r)
    before = lm.lora_matmul.launches
    y = lm.lora_matmul(x, w, a, b, 0.7)
    torch.cuda.synchronize()
    assert lm.lora_matmul.launches == before + 1
    ref = lm.lora_matmul_ref(x, w, a, b, 0.7)
    merged = x @ (w + 0.7 * a @ b)
    tol = TOL * max(1.0, float(ref.abs().max()))
    assert torch.isfinite(y).all()
    assert float((y - ref).abs().max()) <= tol
    assert float((y - merged).abs().max()) <= tol
    y3 = ops.lora_linear(x[None], w, a, b, 0.7)
    assert tuple(y3.shape) == (1, M, N) and torch.equal(y3[0], y)


@pytest.mark.gpu
def test_lora_matmul_refuses_what_it_does_not_take():
    _need_card()
    x, w, a, b = _lora_case(0, 64, 32, 48, 8)
    with pytest.raises(TypeError, match="float32"):
        lm.lora_matmul(x.double(), w, a, b)
    with pytest.raises(ValueError, match="contiguous"):
        lm.lora_matmul(x, w.t().contiguous().t(), a, b)
    with pytest.raises(ValueError, match="no kernel instantiation"):
        big = torch.zeros((32, 257), device="cuda")
        lm.lora_matmul(x, w, big, torch.zeros((257, 48), device="cuda"))
    with pytest.raises(ValueError, match="do not chain"):
        lm.lora_matmul(x, w, a, b[:, :40].contiguous())
    with pytest.raises(ValueError, match="do not chain"):
        lm.lora_matmul(x, w[:31].contiguous(), a, b)
    with pytest.raises(ValueError, match="requires grad"):
        lm.lora_matmul(x, w, a.clone().requires_grad_(), b)
    with pytest.raises(ValueError, match="requires grad"):
        ops.lora_linear(x, w.clone().requires_grad_(), a, b)


@pytest.mark.gpu
def test_lora_example_kernel_path_matches_masked_path_on_card():
    """The D2FT-LoRA example end to end on the card (its config, 3 steps):
    the fused call launches the LoRA kernel once and matches its plain
    version; the kernel path launches the attention kernels once per layer
    per step, its losses match the masked path's on the same schedule, and
    the base model is never written."""
    _need_card()
    from repro_torch.examples import lora_finetune as ex
    f0, l0 = d2a.flash_fwd.launches, lm.lora_matmul.launches
    model, lora, sched, y, log_k = ex.run(device="cuda", steps=3,
                                          use_kernel=True)
    assert lm.lora_matmul.launches == l0 + 1
    assert d2a.flash_fwd.launches - f0 == 3 * ex.CFG.n_layers
    fresh = init_model(torch.Generator(device="cuda").manual_seed(0), ex.CFG)
    for (n, p), (_, q) in zip(model.named_parameters(),
                              fresh.named_parameters()):
        assert torch.equal(p, q), n
    x = torch.randn((128, ex.CFG.d_model),
                    generator=torch.Generator(device="cuda").manual_seed(2),
                    device="cuda")
    ab = init_lora(torch.Generator(device="cuda").manual_seed(1),
                   dict(fresh.named_parameters()), rank=ex.RANK)
    ab = ab["layers.0.attn.wq"]
    ref = lm.lora_matmul_ref(x, fresh.layers[0].attn.wq.detach(),
                             ab["a"].detach(), ab["b"].detach(),
                             ex.FUSED_SCALE)
    assert float((y - ref).abs().max()) <= \
        TOL * max(1.0, float(ref.abs().max()))
    _, _, _, _, log_m = ex.run(device="cuda", steps=3, sched=sched)
    assert d2a.flash_fwd.launches - f0 == 3 * ex.CFG.n_layers
    np.testing.assert_allclose(log_k.losses, log_m.losses, atol=1e-4, rtol=0)


# ------------------------------------------------------- d2ft gated MoE FFN
def _moe_case(seed, E, C, D, F, live_blocks=None, bc=16):
    """N(0, 1) buffer and cotangent, weights scaled by 1/sqrt(fan-in), and
    front-packed slot masks as the dispatch makes them: per expert a random
    count of forward-live slots (zero for expert 0: an expert with no live
    slot), the first of them backward-live, none past ``live_blocks``
    capacity blocks."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    xb = torch.randn((E, C, D), generator=gen, device="cuda")
    wu = torch.randn((E, D, F), generator=gen, device="cuda") / D ** 0.5
    wg = torch.randn((E, D, F), generator=gen, device="cuda") / D ** 0.5
    wd = torch.randn((E, F, D), generator=gen, device="cuda") / F ** 0.5
    dy = torch.randn((E, C, D), generator=gen, device="cuda")
    top = C if live_blocks is None else min(C, live_blocks * bc)
    n_f = torch.randint(0, top + 1, (E,), generator=gen, device="cuda")
    n_f[0] = 0
    n_b = (n_f.float() * torch.rand((E,), generator=gen,
                                    device="cuda")).long()
    slot = torch.arange(C, device="cuda")[None, :]
    return (xb, wu, wg, wd, dy, (slot < n_f[:, None]).float(),
            (slot < n_b[:, None]).float())


def _moe_vs_plain(xb, wu, wg, wd, dy, fs, bs, *, act, block_c, live=None,
                  live_b=None, need=(True, True, True)):
    """Kernels through ``ops.gated_moe_ffn``, with requires_grad on xb and
    the weights ``need`` names, against the plain version's autograd;
    returns (errors, scales, outputs, counts, masks), a weight gradient
    not needed as None in outputs and as 0.0 in errors."""
    masks = {}
    d2m.dispatch = lambda kind, grid, m: masks.__setitem__(kind, m.clone())
    try:
        with contract.count_tiles("cuda") as tc:
            ins = [xb.clone().requires_grad_()] + [
                w.clone().requires_grad_(n)
                for w, n in zip((wu, wg, wd), need)]
            y = ops.gated_moe_ffn(*ins, fs, bs, act=act, block_c=block_c,
                                  live_slots=live, live_bwd_slots=live_b)
            y.backward(dy)
            counts = tc.read()
    finally:
        d2m.dispatch = None
    E, C, _ = xb.shape
    fm, bm = _moe_block_masks(fs, bs, block_c)
    bc = min(block_c, C)
    refs = [t.clone().requires_grad_() for t in (xb, wu, wg, wd)]
    Cp = fm.shape[1] * bc
    pad = [torch.nn.functional.pad(refs[0], (0, 0, 0, Cp - C))] + refs[1:]
    ref = d2m.gated_moe_ffn_ref(*pad, fm, bm, act=act, block_c=bc)[:, :C]
    ref.backward(dy)
    mine = [y.detach()] + [t.grad for t in ins]
    theirs = [ref.detach()] + [t.grad for t in refs]
    errs = [0.0 if a is None else float((a - b).abs().max())
            for a, b in zip(mine, theirs)]
    scales = [max(1.0, float(t.abs().max())) for t in theirs]
    return errs, scales, mine, counts, masks


def _moe_block_masks(fs, bs, block_c):
    """The wrapper's slot -> block reduction, for the plain version."""
    C = fs.shape[1]
    bc = min(block_c, C)
    Cp = -(-C // bc) * bc
    f = torch.nn.functional.pad(fs, (0, Cp - C)).reshape(fs.shape[0], -1, bc)
    b = torch.nn.functional.pad(bs, (0, Cp - C)).reshape(bs.shape[0], -1, bc)
    return (f.sum(-1) > 0).float(), (b.sum(-1) > 0).float()


# which of (dW_up, dW_gate, dW_down) autograd asks for: all (scoring, full
# fine-tuning), dW_up alone (D2FT-LoRA), dW_gate with dW_down (the dW
# kernel's one-output case on dg), none
MOE_NEEDS = [(True, True, True), (True, False, False), (False, True, True),
             (False, False, False)]


@pytest.mark.gpu
@pytest.mark.parametrize("need", MOE_NEEDS, ids=lambda n: "".join(
    "ugd"[i] if w else "-" for i, w in enumerate(n)))
@pytest.mark.parametrize("E,C,D,F,block_c,act,bounds", [
    (4, 64, 16, 32, 16, "silu", None),
    (4, 57, 40, 72, 16, "gelu", None),
    (3, 300, 96, 200, 128, "relu", None),
    (8, 384, 256, 128, 128, "silu", "live"),
    (6, 64, 48, 80, 16, "gelu", "live"),
    (2, 20, 24, 40, 7, "silu", None),
    (3, 128, 34, 70, 128, "silu", None)])
def test_moe_kernels_match_plain(E, C, D, F, block_c, act, bounds, need):
    """Forward and backward kernels against the plain version and its
    autograd gradients: y <= 1e-5, dx / dW <= 1e-4, each x max(1, max
    |plain|); exact zeros on dead tiles and for the expert with no live
    slot; executed tiles = the launched block masks' sums; one launch
    each. The shapes take ragged C (the pad path), D and F off the tiles
    (D 34 and F 70: rows not a multiple of 4 floats, copied a float at a
    time), block sizes 7, 16 and 128, and both truncation bounds (the live
    slots of at most 3 of 6 blocks forward). Only the weight gradients in
    ``need`` require grad: the others come back None, and those that do
    equal the all-three call's bit for bit."""
    _need_card()
    bc = min(block_c, C)
    live_blocks = 3 if bounds else None
    xb, wu, wg, wd, dy, fs, bs = _moe_case(E * C + D, E, C, D, F,
                                           live_blocks, bc)
    live = live_b = None
    if bounds:
        live = int(fs.sum(1).max())
        live_b = int(bs.sum(1).max())
    f0, b0 = d2m.moe_fwd.launches, d2m.moe_bwd.launches
    errs, scales, mine, counts, masks = _moe_vs_plain(
        xb, wu, wg, wd, dy, fs, bs, act=act, block_c=block_c, live=live,
        live_b=live_b, need=need)
    assert d2m.moe_fwd.launches == f0 + 1 and d2m.moe_bwd.launches == b0 + 1
    tols = [TOL] + [GRAD_TOL] * 4
    for name, e, s, tol in zip(("y", "dx", "dwu", "dwg", "dwd"), errs,
                               scales, tols):
        assert e <= tol * s, (name, e, s)
    if not all(need):
        full = _moe_vs_plain(xb, wu, wg, wd, dy, fs, bs, act=act,
                             block_c=block_c, live=live, live_b=live_b)[2]
        for a, b in zip(mine, full):
            assert a is None or torch.equal(a, b)
    assert [g is None for g in mine[2:]] == [not n for n in need]
    y, dx, dwu, dwg, dwd = mine
    slot_f = torch.nn.functional.pad(
        fs, (0, -C % bc)).reshape(E, -1, bc).sum(-1) > 0
    rows_f = slot_f.repeat_interleave(bc, 1)[:, :C]
    rows_b = (torch.nn.functional.pad(bs, (0, -C % bc)).reshape(
        E, -1, bc).sum(-1) > 0).repeat_interleave(bc, 1)[:, :C]
    assert float(y[~rows_f].abs().max()) == 0.0
    assert float(dx[~rows_b].abs().max()) == 0.0
    for g in (dwu, dwg, dwd):
        if g is not None:                               # expert 0: no slot
            assert float(g[0].abs().max()) == 0.0
    assert counts["moe_fwd"] == int(masks["fwd"].sum())
    assert counts["moe_bwd"] == int(masks["bwd"].sum())
    assert counts["moe_bwd"] == int(rows_b[:, ::bc].sum())
    assert counts["fwd"] == counts["rglru_fwd"] == 0
    if bounds:
        assert masks["fwd"].shape[1] <= 3


@pytest.mark.gpu
@pytest.mark.parametrize("E,C,D,F,block_c,nb", [
    (4, 384, 256, 128, 128, 3), (6, 64, 48, 80, 16, 3),
    (3, 128, 34, 70, 128, 1)])
def test_moe_kernels_are_bitwise_deterministic(E, C, D, F, block_c, nb):
    """Two launches of each launcher on the same inputs give bitwise-equal
    outputs: dW sums each expert's live rows in ascending order in one
    block, with no float atomics (the fine-tunes compare trajectories);
    with every dW and with dW_up alone."""
    _need_card()
    xb, wu, wg, wd, dy, fs, bs = _moe_case(E * D + F, E, C, D, F)
    fm, bm = _moe_block_masks(fs, bs, block_c)
    bm[:, nb:] = 0.0
    kw = dict(act="silu", block_c=block_c)
    first = d2m.moe_fwd(xb, wu, wg, wd, fm, **kw)
    assert torch.equal(first, d2m.moe_fwd(xb, wu, wg, wd, fm, **kw))
    for need in ((True, True, True), (True, False, False)):
        first = d2m.moe_bwd(xb, wu, wg, wd, bm, dy, bwd_blocks=nb,
                            need=need, **kw)
        second = d2m.moe_bwd(xb, wu, wg, wd, bm, dy, bwd_blocks=nb,
                             need=need, **kw)
        torch.cuda.synchronize()
        for a, b in zip(first, second):
            assert (a is None) == (b is None)
            if a is not None:
                assert torch.isfinite(a).all() and torch.equal(a, b)


@pytest.mark.gpu
def test_moe_kernels_refuse_what_they_do_not_take():
    _need_card()
    xb, wu, wg, wd, dy, fs, bs = _moe_case(0, 2, 32, 16, 24)
    fm = torch.ones((2, 2), device="cuda")
    with pytest.raises(TypeError, match="float32"):
        d2m.moe_fwd(xb.double(), wu, wg, wd, fm, act="silu", block_c=16)
    with pytest.raises(ValueError, match="contiguous"):
        d2m.moe_fwd(xb.transpose(1, 2).contiguous().transpose(1, 2), wu, wg,
                    wd, fm, act="silu", block_c=16)
    with pytest.raises(ValueError, match="multiple of"):
        d2m.moe_fwd(xb, wu, wg, wd, fm, act="silu", block_c=24)
    with pytest.raises(ValueError, match="unknown activation"):
        d2m.moe_fwd(xb, wu, wg, wd, fm, act="tanh", block_c=16)
    with pytest.raises(ValueError, match="w_down must be"):
        d2m.moe_fwd(xb, wu, wg, wu, fm, act="silu", block_c=16)
    with pytest.raises(ValueError, match="is on cpu"):
        d2m.moe_bwd(xb, wu, wg, wd, fm, dy.cpu(), act="silu", block_c=16)
    with pytest.raises(ValueError, match="bwd_slots <= fwd_slots"):
        ops.gated_moe_ffn(xb, wu, wg, wd, bs, fs)


@pytest.mark.gpu
def test_olmoe_kernel_path_matches_masked_path_on_card():
    """Two D2FT steps of the launcher's loop on olmoe-1b-7b's smoke config
    at S 40, G 4: one forward and one backward MoE launch per layer per
    step beside the attention kernels; losses equal to the masked path's
    from the same weights and schedule."""
    _need_card()
    cfg = olmoe_1b_7b.smoke_config()
    d2 = D2FTConfig(n_microbatches=4, n_pf=2, n_po=1, head_groups=4)
    losses = {}
    for use_kernel in (True, False):
        m0, a0 = d2m.moe_bwd.launches, d2a.flash_bwd.launches
        model = init_model(torch.Generator(device="cuda").manual_seed(0), cfg)
        _, _, log = finetune(model, cfg, d2, sgd(1e-2),
                             lm_batches(0, cfg.vocab_size, 8, 40, 2),
                             steps=2, use_kernel=use_kernel)
        n = 2 * cfg.n_layers if use_kernel else 0
        assert d2m.moe_bwd.launches - m0 == n
        assert d2a.flash_bwd.launches - a0 == n
        losses[use_kernel] = log.losses
    assert np.isfinite(losses[True]).all()
    np.testing.assert_allclose(losses[True], losses[False], atol=1e-4,
                               rtol=0)


NEW_ARCHS = ["stablelm-3b", "qwen1.5-32b", "mixtral-8x22b",
             "moonshot-v1-16b-a3b", "phi-3-vision-4.2b", "hubert-xlarge"]


@pytest.mark.gpu
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_zoo_arch_kernel_route_matches_masked_path_on_card(arch):
    """Each arch's smoke config (hd 32; q / k / v biases, GQA, a window,
    MoE with no dense FFN or with shared experts, a vision prefix, a
    bidirectional audio encoder) under a p_f / p_o / p_s mix (G 4, B 2, S
    16) and the launcher's bounds: ``use_kernel=True`` launches B2 (and
    B8 / B9 under an MoE FFN), takes no non-kernel route, and its loss
    and gradients equal the masked path's (1e-5; 1e-4 x max(1, max
    |masked|))."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.schedule import (P_F, P_O, P_S, Schedule,
                                           gates_from_schedule,
                                           live_slice_bounds)
    from repro_torch.data.synthetic import microbatch_assignment
    from repro_torch.models.transformer import lm_loss
    _need_card()
    cfg = get_smoke_config(arch)
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = init_model(gen, cfg)
    B, S, G = 2, 16, 4
    batch = {}
    n_text = S
    if cfg.frontend == "audio_stub":
        batch["features"] = torch.randn((B, S, cfg.frontend_dim),
                                        generator=gen, device="cuda")
        n_text = 0
    elif cfg.frontend == "vision_stub":
        batch["features"] = torch.randn(
            (B, cfg.frontend_tokens, cfg.frontend_dim), generator=gen,
            device="cuda")
        n_text = S - cfg.frontend_tokens
    if n_text:
        batch["tokens"] = torch.randint(0, cfg.vocab_size, (B, n_text),
                                        generator=gen, device="cuda")
    batch["labels"] = torch.randint(0, cfg.vocab_size, (B, n_text or S),
                                    generator=gen, device="cuda")
    rng = np.random.default_rng(11)
    table = rng.choice([P_F, P_O, P_S], size=(cfg.n_layers * G, 2),
                       p=[.4, .3, .3]).astype(np.int8)
    table[0, 0] = P_F
    sched = Schedule(table, cfg.n_layers, G)
    mb_of = microbatch_assignment(B, 2)
    gates = gates_from_schedule(sched, mb_of, "cuda")
    params = list(model.parameters())

    def refuse(kind, why):
        raise AssertionError(f"{kind} took a non-kernel route: {why}")
    out = {}
    for use_kernel in (True, False):
        a0, m0 = d2a.flash_fwd.launches, d2m.moe_fwd.launches
        contract.on_fallback = refuse
        try:
            loss, _ = lm_loss(model, cfg, batch.get("tokens"),
                              batch["labels"],
                              features=batch.get("features"), gates=gates,
                              use_kernel=use_kernel,
                              live_bounds=live_slice_bounds(sched, mb_of))
        finally:
            contract.on_fallback = None
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        launched = (d2a.flash_fwd.launches - a0, d2m.moe_fwd.launches - m0)
        assert launched == ((cfg.n_layers, cfg.n_layers if cfg.moe else 0)
                            if use_kernel else (0, 0))
        out[use_kernel] = (float(loss), grads)
    assert np.isfinite(out[True][0])
    assert abs(out[True][0] - out[False][0]) <= TOL
    for (name, _), gk, gm in zip(model.named_parameters(), out[True][1],
                                 out[False][1]):
        assert (gk is None) == (gm is None), name
        if gk is not None:
            lim = 1e-4 * max(1.0, float(gm.abs().max()))
            assert float((gk - gm).abs().max()) <= lim, name
