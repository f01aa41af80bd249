#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``src/repro_torch``).

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, one line each (any failure raises and exits non-zero):

1. device — the card's name and power limit; TF32 off for matmuls and
   cuDNN, so float32 means float32.
2. build — every ``src/repro_torch/kernels/csrc/*.cu`` compiled with nvcc
   for sm_90a (one nvcc per source, all started together), the build
   seconds and the ``-Xptxas -v`` report.
3. kernel vs plain — the paged flash-decode kernel against its plain
   PyTorch version at gemma3-1b decode shapes, <= 1e-5 in float32.
4. serve — the paged serving engine on gemma3-1b at full width (random
   weights from seed 0) answers 8 requests through 4 slots with the kernel
   on; launches == 26 x decode steps, every request finishes, every page
   returns, and the greedy tokens equal those of the plain gather path.
   Then a profiler window over five decode steps of the four longest
   requests: device busy and idle share per step, top kernels.
5. kernel timing — CUDA-event times of the decode kernel, its plain
   version and one PyTorch library call (gather +
   scaled_dot_product_attention, a yardstick the port never calls) at the
   trace's final lengths, beside the bytes bound.
6. attention kernels vs plain — the gated flash-attention forward and
   backward kernels against their plain version and its autograd
   gradients: ViT-small shapes (B 40, H 6, S 197, hd 64, bidirectional)
   under a p_f / p_o / p_s mix, without, with and above compaction
   bounds; causal S 256 hd 128; window 128 at S 512 hd 64. o and lse
   <= 1e-5, dq/dk/dv <= 1e-4, exact zeros on gated slices, lse = 2^30 on
   dead ones, executed tiles = live slices x live tiles per slice.
7. fine-tune — the paper's D2FT fine-tune of ViT-small at full size
   (12 layers, d 384, S 197, random weights from seed 0) on the synthetic
   image task, batch 40 in 5 micro-batches, n_pf 3 / n_po 1, SGD, 8 steps:
   scores and knapsack at step 0, then the gated kernel path. 12 forward
   and 12 backward kernel launches per step, executed tile fractions 0.800
   forward and 0.600 backward, finite losses within 1e-4 x max(1, |loss|)
   of the masked plain path on the same weights and schedule. p50 step
   ms of the kernel path, the masked path and standard full fine-tuning
   (each run twice, in turns), images/s, peak memory; then a profiler
   window over 3 kernel-path steps.
8. attention kernel timing — CUDA-event times of the forward and backward
   kernels at the fine-tune's shapes and (192, 144) bounds, L2 flushed,
   beside their plain version's, the bound, and the library yardstick
   (scaled_dot_product_attention forward and its autograd backward on the
   live slices, which the port never calls).

Then one JSON line of kernel records, the card line again, and as the last
line ``{"ok": true, "device": {...}}``. Exits non-zero, printing no
result, without a card or without the repo's sources beside this file.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# gemma3-1b serving trace: more requests than slots (admission mid-flight);
# 1536 and 2048 are multiples of the 512 window above twice it (block-local
# prefill); decode positions pass 512, so local layers skip pages
PROMPT_LENS = (24, 130, 333, 511, 700, 1100, 1536, 2048)
MAX_NEW = (32, 32, 32, 32, 32, 32, 16, 16)
PAGE_SIZE = 16
MAX_SLOTS = 4
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
FP32_FLOP_PER_S = 67e12            # H100 SXM, non-tensor-core float32
KERNEL_TOL = 1e-5
GRAD_TOL = 1e-4                    # gated attention dq/dk/dv, float32

# the D2FT fine-tune: the quickstart's batch, split and 68 % budget
FT_BATCH = 40
FT_STEPS = 8
FT_D2FT = dict(n_microbatches=5, n_pf=3, n_po=1)
FT_LR = 0.05


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def paged_inputs(torch, gen, lengths, *, n_pages, n_pmax, H=4, n_kv=1,
                 hd=256, ps=PAGE_SIZE, gated=()):
    """Random pools and queries on the card; each slot's table holds
    distinct pages up to its length and is null-padded past it."""
    dev = gen.device
    B = len(lengths)
    q = torch.randn((B, H, hd), generator=gen, device=dev)
    kp = torch.randn((n_pages, ps, n_kv, hd), generator=gen, device=dev)
    vp = torch.randn((n_pages, ps, n_kv, hd), generator=gen, device=dev)
    perm = torch.randperm(n_pages - 1, generator=gen, device=dev) + 1
    table = torch.zeros((B, n_pmax), dtype=torch.int32, device=dev)
    for b, t in enumerate(lengths):
        n = t // ps + 1
        table[b, :n] = perm[b * n_pmax:b * n_pmax + n]
    g = torch.ones((B, H), device=dev)
    for b, h in gated:
        g[b, h] = 0.0
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, kp, vp, table, ln, g


def bound(lengths, window, *, H, n_kv, hd, n_pmax, itemsize=4):
    """Least time (ms) for one launch: K/V rows each slot must read, once,
    plus q, the output, the table, lengths and gates, over HBM bandwidth;
    against the QK and PV flops over the float32 peak. Returns (ms, by)."""
    rows = sum(min(t + 1, window) if window else t + 1 for t in lengths)
    B = len(lengths)
    nbytes = (2 * rows * n_kv * hd + 2 * B * H * hd + B * H) * itemsize \
        + (B * n_pmax + B) * 4
    flops = 4 * rows * H * hd                      # QK and PV, 2 each
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def attn_inputs(torch, gen, B, H, S, hd):
    """q, k, v, a cotangent and a p_f / p_o / p_s gate mix in the
    fine-tune's 3 : 1 : 1 proportions (slice op = random permutation mod
    5), on the card."""
    q, k, v, do = (torch.randn((B, H, S, hd), generator=gen, device="cuda")
                   for _ in range(4))
    op = torch.randperm(B * H, generator=gen, device="cuda") % 5
    g_f = (op != 4).float().reshape(B, H)
    g_b = (op <= 2).float().reshape(B, H)
    return q, k, v, do, g_f, g_b


def roofline(nbytes, flops):
    """(ms, by): the larger of bytes over HBM bandwidth and FLOPs over the
    float32 peak, and which of the two it is."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def time_ms(torch, fn, *, iters=50, warmup=5):
    """Median CUDA-event time of one call, with L2 flushed before each
    (decode finds a layer's pages cold: 26 layers of pools and 4 GB of
    weights pass through L2 between two launches of one layer)."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def attention_vs_plain(torch, gen):
    """Phase 6. Returns the largest errors {"fwd": o/lse, "bwd": grads}."""
    from repro_torch.kernels import contract
    from repro_torch.kernels import d2ft_attention as d2a
    worst = {"fwd": 0.0, "bwd": 0.0}
    # (B, H, S, hd, causal, window, bounds): ViT-small without bounds, at
    # the live counts and above them; causal; sliding window
    cases = [(40, 6, 197, 64, False, 0, None),
             (40, 6, 197, 64, False, 0, "exact"),
             (40, 6, 197, 64, False, 0, "above"),
             (4, 8, 256, 128, True, 0, "above"),
             (4, 4, 512, 64, True, 128, "exact")]
    for B, H, S, hd, causal, window, mode in cases:
        q, k, v, do, g_f, g_b = attn_inputs(torch, gen, B, H, S, hd)
        n_f, n_b = int((g_f != 0).sum()), int((g_b != 0).sum())
        live = {None: (None, None), "exact": (n_f, n_b),
                "above": (n_f + 7, n_b + 5)}[mode]
        with contract.count_tiles("cuda") as tc:
            qk, kk, vk = (t.clone().requires_grad_() for t in (q, k, v))
            out = d2a.gated_flash_attention(
                qk, kk, vk, g_f, g_b, causal=causal, window=window,
                live_fwd=live[0], live_bwd=live[1])
            out.backward(do)
            o2, lse = d2a.flash_fwd(q, k, v, g_f, causal=causal,
                                    window=window, live=live[0])
            torch.cuda.synchronize()
            counts = tc.read()
        qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))
        ref = d2a.gated_attention_ref(qr, kr, vr, g_f, g_b, causal=causal,
                                      window=window)
        ref.backward(do)
        lse_ref = d2a.gated_attention_lse_ref(q, k, g_f, causal=causal,
                                              window=window)
        out, ref = out.detach(), ref.detach()
        e_f = max(float((out - ref).abs().max()),
                  float((lse - lse_ref).abs().max()))
        e_b = max(float((a.grad - b.grad).abs().max())
                  for a, b in ((qk, qr), (kk, kr), (vk, vr)))
        zeros = (float(out[g_f == 0].abs().max()) == 0.0
                 and torch.equal(o2, out.detach())
                 and bool((lse[g_f == 0] == d2a.LSE_MASKED).all())
                 and all(float(t.grad[g_b == 0].abs().max()) == 0.0
                         for t in (qk, kk, vk)))
        tiles = d2a.kernel_live_tiles(S, causal, window)
        want = {"fwd": 2 * n_f * tiles, "bwd_dkdv": n_b * tiles,
                "bwd_dq": n_b * tiles}
        what = (f"B {B} H {H} S {S} hd {hd} causal {causal} window "
                f"{window} bounds {live}")
        if e_f > KERNEL_TOL or e_b > GRAD_TOL or not zeros or \
                counts != want or not torch.isfinite(out).all():
            raise AssertionError(
                f"attention kernels vs plain, {what}: o/lse err {e_f} (tol "
                f"{KERNEL_TOL}), grad err {e_b} (tol {GRAD_TOL}), exact "
                f"zeros {zeros}, tiles {counts} != {want}")
        worst = {"fwd": max(worst["fwd"], e_f), "bwd": max(worst["bwd"], e_b)}
        print(f"[attention vs plain] {what}: live {n_f}/{n_b} of {B * H}, "
              f"o/lse err {e_f:.3e}, grad err {e_b:.3e}, zeros exact, "
              f"tiles {counts}", flush=True)
    print(f"[attention vs plain] max abs err fwd {worst['fwd']:.3e} <= "
          f"{KERNEL_TOL}, bwd {worst['bwd']:.3e} <= {GRAD_TOL}", flush=True)
    return worst


def finetune(torch, np, tag):
    """Phase 7. Returns {"launches": {"fwd", "bwd"}, "bounds": ...}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import vit_small_paper
    from repro_torch.configs.base import D2FTConfig
    from repro_torch.core.cost_model import compute_cost
    from repro_torch.core.d2ft import plan_schedule
    from repro_torch.core.schedule import (gates_from_schedule,
                                           live_slice_bounds)
    from repro_torch.core.scores import compute_scores, vit_blocks
    from repro_torch.data.synthetic import (image_batches, make_image_task,
                                            microbatch_assignment)
    from repro_torch.kernels import contract
    from repro_torch.kernels import d2ft_attention as d2a
    from repro_torch.models.vit import init_vit, vit_loss
    from repro_torch.optim.optimizers import sgd
    from repro_torch.train.loop import finetune_vit, make_vit_step

    cfg = vit_small_paper.CONFIG
    d2 = D2FTConfig(**FT_D2FT)
    n_mb = d2.n_microbatches
    task = make_image_task(3, n_classes=cfg.n_classes,
                           image_size=cfg.image_size)
    scheds = []

    def schedule_fn(step, model, images, labels):       # the quickstart's
        if step % 16 != 0:
            return None
        mbs = list(zip(np.split(images, n_mb), np.split(labels, n_mb)))

        def loss_fn(p, mb):
            return vit_loss(model, torch.as_tensor(mb[0], device="cuda"),
                            torch.as_tensor(mb[1], device="cuda"), cfg)[0]

        bw, fw = compute_scores(loss_fn, dict(model.named_parameters()),
                                vit_blocks, mbs, cfg.n_heads)
        scheds.append(plan_schedule(d2, bw, fw, cfg.n_layers, cfg.n_heads))
        return scheds[-1]

    def run(use_kernel, sched_fn):
        model = init_vit(cfg, seed=0, device="cuda")
        _, _, log = finetune_vit(model, cfg, sgd(FT_LR),
                                 image_batches(task, 5, FT_BATCH, FT_STEPS),
                                 steps=FT_STEPS, schedule_fn=sched_fn,
                                 n_microbatches=n_mb, use_kernel=use_kernel)
        return model, log

    torch.cuda.reset_peak_memory_stats()
    d2a.flash_fwd.launches = d2a.flash_bwd.launches = 0
    with contract.count_tiles("cuda") as tc:
        model, log_k = run(True, schedule_fn)
        counts = tc.read()
    launches = {"fwd": d2a.flash_fwd.launches, "bwd": d2a.flash_bwd.launches}
    peak = torch.cuda.max_memory_allocated()
    sched = scheds[0]
    mb_of = microbatch_assignment(FT_BATCH, n_mb)
    bounds = live_slice_bounds(sched, mb_of)
    N = FT_BATCH * cfg.n_heads
    tiles = d2a.kernel_live_tiles(cfg.n_patches + 1, False, 0)
    total = FT_STEPS * cfg.n_layers * N * tiles
    frac = {k: counts[k] / total for k in counts}
    per_step = cfg.n_layers * FT_STEPS
    if launches != {"fwd": per_step, "bwd": per_step}:
        raise AssertionError(f"kernel launches {launches} != {cfg.n_layers} "
                             f"per step x {FT_STEPS} steps each")
    if frac != {"fwd": 0.8, "bwd_dkdv": 0.6, "bwd_dq": 0.6} or \
            bounds != (192, 144):
        raise AssertionError(f"executed tile fractions {frac} (want 0.800 "
                             f"fwd, 0.600 bwd), live bounds {bounds}")
    losses = np.asarray(log_k.losses)
    if not np.isfinite(losses).all():
        raise AssertionError(f"non-finite losses {losses}")

    def replay(step, *_):
        return sched if step == 0 else None
    del model
    _, log_m = run(False, replay)
    if d2a.flash_fwd.launches != launches["fwd"]:
        raise AssertionError("the masked path launched the kernel")
    diff = np.abs(losses - np.asarray(log_m.losses))
    lim = 1e-4 * np.maximum(1.0, np.abs(np.asarray(log_m.losses)))
    if not (diff <= lim).all():
        raise AssertionError(f"kernel-path losses {losses.tolist()} vs "
                             f"masked {log_m.losses}: diff {diff.tolist()}")
    # timed in turns, kernel masked full full masked kernel, so that no
    # path gains from running later in the process
    _, log_f = run(True, None)
    rounds = {"kernel": [log_k.step_times], "masked": [log_m.step_times],
              "full": [log_f.step_times]}
    for name in ("full", "masked", "kernel"):
        _, lg = run(name != "masked", None if name == "full" else replay)
        rounds[name].append(lg.step_times)
    p50 = {k: 1e3 * float(np.median(r[0] + r[1])) for k, r in rounds.items()}
    print(f"[fine-tune] ViT-small full size ({cfg.n_layers} layers, d "
          f"{cfg.d_model}, {cfg.n_heads} heads, S {cfg.n_patches + 1}, f32, "
          f"seed 0), batch {FT_BATCH} in {n_mb} micro-batches, n_pf "
          f"{d2.n_pf} n_po {d2.n_po} (compute {compute_cost(sched.table):.0%}),"
          f" SGD lr {FT_LR}, {FT_STEPS} steps: kernel launches {launches}, "
          f"live (sample, group) bounds {bounds} x "
          f"{cfg.n_heads // sched.n_groups} heads per group, executed tile "
          f"fractions fwd {frac['fwd']:.3f} bwd "
          f"{frac['bwd_dkdv']:.3f}/{frac['bwd_dq']:.3f}", flush=True)
    print(f"[fine-tune] losses kernel {[round(float(x), 6) for x in losses]}"
          f" | masked {[round(x, 6) for x in log_m.losses]} | max diff "
          f"{float(diff.max()):.3e}", flush=True)
    print(f"[fine-tune] p50 step ms over 2 x {FT_STEPS} steps: kernel path "
          f"{p50['kernel']:.3f}, masked path {p50['masked']:.3f}, standard "
          f"full fine-tuning (kernel, all-ones gates) {p50['full']:.3f}; "
          f"per round " + ", ".join(
              f"{k} {1e3 * float(np.median(r[0])):.3f} / "
              f"{1e3 * float(np.median(r[1])):.3f}"
              for k, r in rounds.items()) + f" {tag}")
    print(f"[fine-tune] images/s: kernel path "
          f"{FT_BATCH / p50['kernel'] * 1e3:.1f}, masked "
          f"{FT_BATCH / p50['masked'] * 1e3:.1f}, full "
          f"{FT_BATCH / p50['full'] * 1e3:.1f} {tag}")
    print(f"[fine-tune] max_memory_allocated (kernel path, scoring "
          f"included) {peak} bytes ({peak / 2**30:.2f} GiB) {tag}",
          flush=True)

    # where a kernel-path step's time goes
    model = init_vit(cfg, seed=0, device="cuda")
    opt = sgd(FT_LR)
    state = opt.init(dict(model.named_parameters()))
    step = make_vit_step(cfg, opt, True, use_kernel=True)
    gates = gates_from_schedule(sched, mb_of, "cuda")
    images, labels = next(image_batches(task, 5, FT_BATCH, 1))
    x = torch.as_tensor(images, device="cuda")
    y = torch.as_tensor(labels, device="cuda")
    step(model, state, x, y, gates, bounds)
    torch.cuda.synchronize()
    n_prof = 3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_prof):
            step(model, state, x, y, gates, bounds)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = sorted(((e.self_device_time_total, e.count, e.key)
                  for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA), reverse=True)
    busy_us = sum(t for t, _, _ in dev)
    if busy_us <= 0:
        raise AssertionError("the profiler saw no device time")
    attn_us = sum(t for t, _, k in dev if "d2ft_attn" in k)
    print(f"[profile] {n_prof} kernel-path fine-tune steps: device busy "
          f"{busy_us / 1e3 / n_prof:.3f} ms per step, wall "
          f"{1e3 * wall / n_prof:.3f} ms per step under the profiler, idle "
          f"share {1 - busy_us / 1e6 / wall:.1%}; d2ft attention kernels "
          f"{attn_us / 1e3 / n_prof:.3f} ms per step "
          f"({attn_us / busy_us:.1%} of busy) {tag}")
    print("[profile] top device time per step: " + "; ".join(
        f"{k[:60]} x{c // n_prof}: {t / 1e3 / n_prof:.3f} ms"
        for t, c, k in dev[:8]), flush=True)
    return {"launches": launches}


def attention_timing(torch, gen, tag):
    """Phase 8. Returns {"fwd"|"bwd": (ms, plain_ms, library_ms, bound_ms,
    bound_by)} at the fine-tune's shapes and live counts."""
    import torch.nn.functional as F
    from repro_torch.kernels import d2ft_attention as d2a
    B, H, S, hd = FT_BATCH, 6, 197, 64
    q, k, v, do, g_f, g_b = attn_inputs(torch, gen, B, H, S, hd)
    n_f, n_b = int((g_f != 0).sum()), int((g_b != 0).sum())
    if (n_f, n_b) != (192, 144):
        raise AssertionError(f"live slices {n_f}/{n_b} != 192/144")
    o, lse = d2a.flash_fwd(q, k, v, g_f, causal=False, live=n_f)

    qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))
    ref = d2a.gated_attention_ref(qr, kr, vr, g_f, g_b, causal=False)

    def flat(t, gate):                     # [live, S, hd], gathered once
        return t.reshape(B * H, S, hd)[gate.reshape(-1) != 0].contiguous()

    lq, lk, lv = (flat(t, g_f) for t in (q, k, v))
    bq, bk, bv = (flat(t, g_b).requires_grad_() for t in (q, k, v))
    lib_o = F.scaled_dot_product_attention(bq, bk, bv)
    ldo = flat(do, g_b)
    out = {}
    fwd_bytes = 4 * (3 * n_f * S * hd + B * H * S * hd + B * H * S)
    fwd_flops = n_f * 2 * 2 * S * S * hd
    out["fwd"] = (
        time_ms(torch, lambda: d2a.flash_fwd(q, k, v, g_f, causal=False,
                                             live=n_f)),
        time_ms(torch, lambda: d2a.gated_attention_ref(q, k, v, g_f, g_b,
                                                       causal=False)),
        time_ms(torch, lambda: F.scaled_dot_product_attention(lq, lk, lv)),
        *roofline(fwd_bytes, fwd_flops))
    # backward: q, k, v, o, do and lse of each live slice read once, dq, dk,
    # dv written for every slice; 5 products per live slice (s recomputed)
    bwd_bytes = 4 * (5 * n_b * S * hd + n_b * S + 3 * B * H * S * hd)
    bwd_flops = n_b * 5 * 2 * S * S * hd
    out["bwd"] = (
        time_ms(torch, lambda: d2a.flash_bwd(q, k, v, g_b, o, lse, do,
                                             causal=False, live=n_b)),
        time_ms(torch, lambda: torch.autograd.grad(
            ref, (qr, kr, vr), do, retain_graph=True)),
        time_ms(torch, lambda: torch.autograd.grad(
            lib_o, (bq, bk, bv), ldo, retain_graph=True)),
        *roofline(bwd_bytes, bwd_flops))
    for kind, (k_ms, p_ms, l_ms, b_ms, by) in out.items():
        print(f"[attention timing] d2ft_attention_{kind} B {B} H {H} S {S} "
              f"hd {hd}, live {n_f if kind == 'fwd' else n_b} of {B * H}: "
              f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, library (sdpa "
              f"{'forward' if kind == 'fwd' else 'autograd backward'} on "
              f"the live slices) {l_ms:.4f} ms, bound {b_ms:.5f} ms by "
              f"{by}, {b_ms / k_ms:.1%} of bound {tag}", flush=True)
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are not under {SRC}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    import numpy as np
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels.ops import paged_decode_attention
    from repro_torch.kernels.paged_decode import (paged_decode_ref,
                                                  paged_flash_decode)
    from repro_torch.serving.engine import (PagedServingEngine, Request,
                                            make_engine)
    from repro_torch.serving.pages import pages_needed

    # 1. device -----------------------------------------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"[device] {name} | nvidia-smi: {card} | torch {torch.__version__} "
          f"cuda {torch.version.cuda} | matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32}", flush=True)

    # 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    libs = build.build_all()
    print(f"[build] {sorted(libs)} in {time.perf_counter() - t0:.2f} s "
          f"-> {build.build_dir()}", flush=True)
    print(build.ptxas_report(), flush=True)

    # 3. kernel vs plain --------------------------------------------------
    gen = torch.Generator(device="cuda").manual_seed(0)
    n_pmax = 130
    max_err = 0.0
    for lengths, gated in (
            ([15, 16, 17, 700], ((1, 0), (1, 1), (1, 2), (1, 3), (2, 2))),
            ([511, 512, 1500, 2063], ((0, 1), (3, 0), (3, 1), (3, 2),
                                      (3, 3)))):
        for window in (0, 512):
            args = paged_inputs(torch, gen, lengths, n_pages=600,
                                n_pmax=n_pmax, gated=gated)
            out = paged_decode_attention(*args[:5], g_f=args[5],
                                         window=window)
            torch.cuda.synchronize()
            ref = paged_decode_ref(*args, window=window)
            err = float((out - ref).abs().max())
            dead = args[5] == 0
            if err > KERNEL_TOL or not torch.isfinite(out).all() or \
                    float(out[dead].abs().max()) != 0.0:
                raise AssertionError(
                    f"kernel vs plain: lengths {lengths} window {window}: "
                    f"max abs err {err} (tol {KERNEL_TOL}), dead heads "
                    f"{float(out[dead].abs().max())}")
            max_err = max(max_err, err)
    print(f"[kernel vs plain] paged_decode f32 B=4 H=4 n_kv=1 hd=256 "
          f"ps={PAGE_SIZE} n_pmax={n_pmax}, windows 0/512, null-padded "
          f"tables, gated heads: max abs err {max_err:.3e} <= {KERNEL_TOL}",
          flush=True)

    # 4. serve ------------------------------------------------------------
    cfg = get_config("gemma3-1b")
    max_seq = max(s + m for s, m in zip(PROMPT_LENS, MAX_NEW))
    n_pages = MAX_SLOTS * pages_needed(max_seq, PAGE_SIZE) + 1
    kw = dict(page_size=PAGE_SIZE, n_pages=n_pages, max_slots=MAX_SLOTS,
              max_seq_len=max_seq)
    rng = np.random.RandomState(0)
    reqs = [Request(uid=i, prompt=rng.randint(0, cfg.vocab_size, size=s)
                    .astype(np.int32), max_new_tokens=m)
            for i, (s, m) in enumerate(zip(PROMPT_LENS, MAX_NEW))]
    t0 = time.perf_counter()
    eng = make_engine(cfg, seed=0, device="cuda", use_kernel=True, **kw)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    with torch.inference_mode():                   # the repo's output check
        logits, _ = eng._prefill(torch.from_numpy(
            reqs[0].prompt.astype(np.int64)).cuda()[None])
    if tuple(logits.shape) != (1, PROMPT_LENS[0], cfg.vocab_size) or \
            not torch.isfinite(logits).all():
        raise AssertionError(f"prefill logits {tuple(logits.shape)} "
                             "not finite or misshapen")
    PagedServingEngine(eng.model, cfg, use_kernel=True, **kw).run(
        [Request(uid=0, prompt=reqs[0].prompt, max_new_tokens=4)])  # warm-up

    prefill_s, step_s = [], []

    def timed(fn, sink):
        def call(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            sink.append(time.perf_counter() - t)
            return out
        return call

    eng._prefill = timed(eng._prefill, prefill_s)
    eng._step = timed(eng._step, step_s)
    torch.cuda.reset_peak_memory_stats()
    paged_flash_decode.launches = 0
    t0 = time.perf_counter()
    out = eng.run(reqs)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = paged_flash_decode.launches
    peak = torch.cuda.max_memory_allocated()

    n_attn = len(cfg.layer_kinds)
    if launches != n_attn * eng.n_steps or launches == 0:
        raise AssertionError(f"kernel launches {launches} != {n_attn} x "
                             f"{eng.n_steps} decode steps")
    for r in reqs:
        got = out.get(r.uid)
        if got is None or len(got) != r.prompt_len + r.max_new_tokens or \
                not np.array_equal(got[:r.prompt_len], r.prompt) or \
                got.min() < 0 or got.max() >= cfg.vocab_size:
            raise AssertionError(f"request {r.uid} did not finish cleanly")
    if eng.pm.n_free != eng.pm.capacity or eng.n_live or eng.waiting:
        raise AssertionError(f"pages leaked: {eng.stats()}")
    plain = PagedServingEngine(eng.model, cfg, use_kernel=False, **kw)
    plain_step_s = []
    plain._step = timed(plain._step, plain_step_s)
    plain_out = plain.run(reqs)
    if paged_flash_decode.launches != launches:
        raise AssertionError("the plain path launched the kernel")
    diff = [r.uid for r in reqs if not np.array_equal(out[r.uid],
                                                      plain_out[r.uid])]
    if diff:
        raise AssertionError(f"kernel-path tokens differ from the plain "
                             f"gather path for requests {diff}")
    n_gen = sum(MAX_NEW)
    p50_step = 1e3 * float(np.median(step_s))
    tag = f"[{card}]"
    print(f"[serve] gemma3-1b full width (26 layers, d 1152, vocab 262144, "
          f"f32, seed 0), {len(reqs)} requests / {MAX_SLOTS} slots, "
          f"ps {PAGE_SIZE}, {n_pages} pages: {eng.n_steps} decode steps, "
          f"kernel launches {launches} = {n_attn} x {eng.n_steps}, all "
          f"finished, pool drained, tokens == plain path; init "
          f"{init_s:.1f} s", flush=True)
    print(f"[serve] generated tokens/s {n_gen / run_s:.2f} ({n_gen} tokens "
          f"in {run_s:.3f} s incl. prefill) {tag}")
    print(f"[serve] p50 decode step ms {p50_step:.3f} (min "
          f"{1e3 * min(step_s):.3f}, max {1e3 * max(step_s):.3f}, "
          f"{len(step_s)} steps; plain gather path p50 "
          f"{1e3 * float(np.median(plain_step_s)):.3f}) {tag}")
    print("[serve] prefill ms per request " + ", ".join(
        f"S={s}: {1e3 * t:.2f}" for s, t in zip(PROMPT_LENS, prefill_s))
        + f" {tag}")
    print(f"[serve] max_memory_allocated {peak} bytes "
          f"({peak / 2**30:.2f} GiB) {tag}", flush=True)

    # 4b. where a decode step's time goes --------------------------------
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    prof_eng = PagedServingEngine(eng.model, cfg, use_kernel=True, **kw)
    for r in reqs[-MAX_SLOTS:]:                    # the four longest prompts
        prof_eng.submit(r)
    prof_eng.step()                                # admits all four
    torch.cuda.synchronize()
    n_prof = 5
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_prof):
            prof_eng.step()
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    dev = sorted(((e.self_device_time_total, e.count, e.key)
                  for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA),
                 reverse=True)
    busy_us = sum(t for t, _, _ in dev)
    if busy_us <= 0:
        raise AssertionError("the profiler saw no device time")
    attn_us = sum(t for t, _, k in dev if "paged_decode" in k)
    print(f"[profile] {n_prof} decode steps, 4 live slots (lengths from "
          f"{[r.prompt_len for r in reqs[-MAX_SLOTS:]]}): device busy "
          f"{busy_us / 1e3 / n_prof:.3f} ms per step, wall "
          f"{1e3 * prof_wall / n_prof:.3f} ms per step under the profiler, "
          f"idle share {1 - busy_us / 1e6 / prof_wall:.1%}; paged_decode "
          f"kernel {attn_us / 1e3 / n_prof:.3f} ms per step "
          f"({attn_us / busy_us:.1%} of busy) {tag}")
    print("[profile] top device time per step: " + "; ".join(
        f"{k[:60]} x{c // n_prof}: {t / 1e3 / n_prof:.3f} ms"
        for t, c, k in dev[:6]), flush=True)

    # 5. kernel timing ----------------------------------------------------
    final = sorted(s + m - 1 for s, m in zip(PROMPT_LENS, MAX_NEW))[-4:]
    npm = pages_needed(max_seq, PAGE_SIZE)
    args = paged_inputs(torch, gen, final, n_pages=n_pages, n_pmax=npm)
    B, H, hd = args[0].shape
    L = npm * PAGE_SIZE

    def library(window):
        q, kp, vp, table, ln, _ = args
        idx = table.long()
        keys = kp[idx].reshape(B, L, 1, hd).transpose(1, 2)
        vals = vp[idx].reshape(B, L, 1, hd).transpose(1, 2)
        pos = torch.arange(L, device="cuda")[None, :]
        t = ln.long()[:, None]
        mask = pos <= t
        if window:
            mask &= pos > t - window
        return F.scaled_dot_product_attention(
            q[:, :, None, :], keys, vals, attn_mask=mask[:, None, None, :],
            enable_gqa=True)[:, :, 0]

    records = {}
    for window in (0, cfg.window):
        ref = paged_decode_ref(*args, window=window)
        lib_err = float((library(window) - ref).abs().max())
        k_ms = time_ms(torch, lambda: paged_flash_decode(
            *args, window=window))
        p_ms = time_ms(torch, lambda: paged_decode_ref(*args, window=window))
        l_ms = time_ms(torch, lambda: library(window))
        b_ms, by = bound(final, window, H=H, n_kv=1, hd=hd, n_pmax=npm)
        records[window] = (k_ms, p_ms, l_ms, b_ms, by)
        print(f"[kernel timing] paged_decode window={window} lengths "
              f"{final}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
              f"library (gather+sdpa) {l_ms:.4f} ms (max abs diff "
              f"{lib_err:.1e}), bound {b_ms:.5f} ms by {by}, "
              f"{b_ms / k_ms:.1%} of bound {tag}", flush=True)

    paged = records[0]
    del eng, plain, prof_eng, args
    torch.cuda.empty_cache()

    # 6. attention kernels vs plain ----------------------------------------
    errs = attention_vs_plain(torch, gen)

    # 7. fine-tune --------------------------------------------------------
    train = finetune(torch, np, tag)

    # 8. attention kernel timing ------------------------------------------
    timing = attention_timing(torch, gen, tag)

    k_ms, p_ms, l_ms, b_ms, by = paged
    kernels = [{
        "name": "paged_decode", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_decode.cu",
        "replaces": "src/repro/kernels/paged_decode.py:54",
        "launches": launches, "max_abs_err": max_err, "ms": k_ms,
        "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": by,
        "library_ms": l_ms}]
    for kind, line in (("fwd", 133), ("bwd", 273)):
        k_ms, p_ms, l_ms, b_ms, by = timing[kind]
        kernels.append({
            "name": f"d2ft_attention_{kind}", "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/d2ft_attention_{kind}.cu",
            "replaces": f"src/repro/kernels/d2ft_attention.py:{line}",
            "launches": train["launches"][kind], "max_abs_err": errs[kind],
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": by,
            "library_ms": l_ms})
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
