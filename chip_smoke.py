#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``src/repro_torch``).

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, one line each (any failure raises and exits non-zero):

1. device — the card's name and power limit; TF32 off for matmuls and
   cuDNN, so float32 means float32.
2. build — every ``src/repro_torch/kernels/csrc/*.cu`` compiled with nvcc
   for sm_90a, the build seconds and the ``-Xptxas -v`` report.
3. kernel vs plain — the paged flash-decode kernel against its plain
   PyTorch version at gemma3-1b decode shapes, <= 1e-5 in float32.
4. serve — the paged serving engine on gemma3-1b at full width (random
   weights from seed 0) answers 8 requests through 4 slots with the kernel
   on; launches == 26 x decode steps, every request finishes, every page
   returns, and the greedy tokens equal those of the plain gather path.
   Then a profiler window over five decode steps of the four longest
   requests: device busy and idle share per step, top kernels.
5. kernel timing — CUDA-event times of the kernel, its plain version and
   one PyTorch library call (gather + scaled_dot_product_attention, a
   yardstick the port never calls) at the trace's final lengths, beside
   the bytes bound.

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

    k_ms, p_ms, l_ms, b_ms, by = records[0]
    print(json.dumps({"kernels": [{
        "name": "paged_decode", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_decode.cu",
        "replaces": "src/repro/kernels/paged_decode.py:54",
        "launches": launches, "max_abs_err": max_err, "ms": k_ms,
        "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": by,
        "library_ms": l_ms}]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
