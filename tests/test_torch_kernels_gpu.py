"""The port's CUDA kernels on a card, against their plain PyTorch versions.

These tests need a CUDA card (marker ``gpu``) and skip inside the test
where there is none: a CUDA kernel has no CPU mode. They import nothing of
JAX, so they run on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py

Tolerance 1e-5 abs in float32 for outputs: the same softmax over the same
positions, summed in another order; 1e-4 for the gated attention's
gradients; 1e-5 for the gated SSD scan's y and prevs and 1e-4 for its
gradients."""
import numpy as np
import pytest
import torch

from repro_torch.configs import mamba2_130m, vit_small_paper
from repro_torch.configs.base import D2FTConfig
from repro_torch.configs.gemma3_1b import smoke_config
from repro_torch.configs.mamba2_130m import smoke_config as mamba2_smoke
from repro_torch.core.d2ft import plan_schedule
from repro_torch.data.synthetic import (image_batches, lm_batches,
                                        make_image_task)
from repro_torch.kernels import contract, ops
from repro_torch.kernels import d2ft_attention as d2a
from repro_torch.kernels import d2ft_ssd as d2s
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
@pytest.mark.parametrize("hd", [16, 32, 64, 128])
@pytest.mark.parametrize("S", [1, 63, 197])
@pytest.mark.parametrize("causal,window", [(False, 0), (True, 0), (True, 40)])
def test_d2ft_kernels_match_plain(hd, S, causal, window):
    """Forward and backward kernels against the plain version and its
    autograd gradients, with compaction bounds above the live counts;
    exact zeros on gated slices, LSE_MASKED on dead ones, and executed
    tiles = live slices x live tiles per slice."""
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
    tiles = d2a.kernel_live_tiles(S, causal, window)
    assert counts == {"fwd": n_f * tiles, "bwd_dkdv": n_b * tiles,
                      "bwd_dq": n_b * tiles, "ssd_fwd": 0, "ssd_bwd": 0}


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
@pytest.mark.parametrize("smoke", [True, False])
def test_finetune_kernel_path_matches_masked_path_on_card(smoke):
    """Two D2FT steps of the launcher's loop: the smoke mamba2 (P 16, N 16,
    chunk 8) and mamba2-130m's widths at depth 2 (P 64, N 128, chunk 256,
    S 300: the pad path). The kernel path launches one forward and one
    backward per layer per step and its losses match the masked path's from
    the same weights and schedule."""
    _need_card()
    cfg = mamba2_smoke() if smoke else \
        mamba2_130m.CONFIG.replace(n_layers=2, vocab_size=512)
    seq = 16 if smoke else 300
    d2 = D2FTConfig(n_microbatches=4, n_pf=2, n_po=1, head_groups=4)
    losses = {}
    for use_kernel in (True, False):
        f0, b0 = d2s.ssd_fwd.launches, d2s.ssd_bwd.launches
        model = init_model(torch.Generator(device="cuda").manual_seed(0), cfg)
        _, _, log = finetune(model, cfg, d2, adamw(1e-3),
                             lm_batches(0, cfg.vocab_size, 8, seq, 2),
                             steps=2, use_kernel=use_kernel)
        L = cfg.n_layers
        assert d2s.ssd_fwd.launches - f0 == (2 * L if use_kernel else 0)
        assert d2s.ssd_bwd.launches - b0 == (2 * L if use_kernel else 0)
        losses[use_kernel] = log.losses
    assert np.isfinite(losses[True]).all()
    np.testing.assert_allclose(losses[True], losses[False], atol=1e-4,
                               rtol=0)


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
