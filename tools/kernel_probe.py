#!/usr/bin/env python3
"""Quick on-card probe of the paged decode and the gated attention kernels
of the PyTorch port: build every kernel, hold the decode and the attention
forward against their plain versions (1e-5, exact zeros on gated heads,
bitwise equal across two calls) at chip_smoke.py's shapes, at every head
dim and at 10 query heads on one KV head (recurrentgemma-2b's), the
attention backward at every head dim (1e-4), then time them roughly (CUDA
events, L2 flushed) beside one PyTorch library call.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 tools/kernel_probe.py

It takes seconds where ``chip_smoke.py`` takes minutes, and exits non-zero
when a check fails. The records' numbers come from ``chip_smoke.py``."""
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

TOL = 1e-5


def flat(t, gate, B, H, S, hd):
    """The live slices of [B, H, S, hd] as [live, S, hd]."""
    return t.reshape(B * H, S, hd)[gate.reshape(-1) != 0].contiguous()


def main() -> int:
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("kernel_probe: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import d2ft_attention as d2a
    from repro_torch.kernels import paged_decode as pd

    t0 = time.perf_counter()
    build.build_all()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    for name in ("paged_decode", "d2ft_attention_fwd",
                 "d2ft_attention_bwd"):
        print(name, build.resources(name), flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    ok = True
    for lengths, gated in (
            ([15, 16, 17, 700], ((1, 0), (1, 1), (1, 2), (1, 3), (2, 2))),
            ([511, 512, 1500, 2063], ((0, 1),)),
            ([63, 64, 127, 128], ()),
            ([0, 5, 2000, 2063], ())):
        for window in (0, 512, 40):
            args = cs.paged_inputs(torch, gen, lengths, n_pages=600,
                                   n_pmax=130, gated=gated)
            out = pd.paged_flash_decode(*args, window=window)
            again = pd.paged_flash_decode(*args, window=window)
            torch.cuda.synchronize()
            err = float((out - pd.paged_decode_ref(*args, window=window))
                        .abs().max())
            dead = args[5] == 0
            zeros = not dead.any() or float(out[dead].abs().max()) == 0.0
            good = err <= TOL and torch.equal(out, again) and zeros
            ok &= good
            print(f"paged {lengths} window {window}: err {err:.3e}, "
                  f"bitwise {torch.equal(out, again)}, zeros {zeros}",
                  flush=True)
    for hd, H, n_kv, window in ((32, 4, 1, 8), (64, 4, 2, 0), (128, 8, 1, 5),
                                (256, 2, 2, 0), (64, 8, 1, 100),
                                (256, 10, 1, 2048), (80, 32, 32, 0),
                                (96, 32, 32, 0), (80, 12, 2, 40),
                                (96, 24, 2, 0), (32, 9, 1, 0)):
        args = cs.paged_inputs(torch, gen, [0, 13, 35, 300], n_pages=200,
                               n_pmax=40, H=H, n_kv=n_kv, hd=hd, ps=8,
                               gated=((1, H - 1), (2, 0)))
        out = pd.paged_flash_decode(*args, window=window)
        again = pd.paged_flash_decode(*args, window=window)
        torch.cuda.synchronize()
        err = float((out - pd.paged_decode_ref(*args, window=window))
                    .abs().max())
        dead = args[5] == 0
        good = (err <= TOL and torch.equal(out, again)
                and float(out[dead].abs().max()) == 0.0)
        ok &= good
        print(f"paged hd {hd} H {H} n_kv {n_kv} window {window}: err "
              f"{err:.3e}, bitwise and zeros {good}", flush=True)
    args = cs.paged_inputs(torch, gen, [731, 1131, 1551, 2063], n_pages=600,
                           n_pmax=129)
    out = torch.empty_like(args[0])
    ws = torch.empty(pd.workspace_floats(4, 4, 256, 129, cs.PAGE_SIZE),
                     device="cuda")
    for window in (0, 512):
        call = cs.time_ms(torch, lambda: pd.paged_flash_decode(
            *args, window=window))
        alone = cs.time_ms(torch, lambda: pd._decode_call(
            *args, out, ws, window=window))
        print(f"paged timing window {window}: launcher call {call:.4f} ms, "
              f"alone {alone:.4f} ms", flush=True)

    for hd in d2a.KERNEL_HEAD_DIMS:
        for S in (1, 63, 197, 1024):
            for causal, window in ((False, 0), (True, 0), (True, 40),
                                   (True, 512)):
                q, k, v, _, g_f, g_b = cs.attn_inputs(torch, gen, 3, 4, S,
                                                      hd)
                live = int((g_f != 0).sum()) + 1
                o, lse = d2a.flash_fwd(q, k, v, g_f, causal=causal,
                                       window=window, live=live)
                o2, lse2 = d2a.flash_fwd(q, k, v, g_f, causal=causal,
                                         window=window, live=live)
                torch.cuda.synchronize()
                e_o = float((o - d2a.gated_attention_ref(
                    q, k, v, g_f, g_b, causal=causal, window=window))
                    .abs().max())
                e_l = float((lse - d2a.gated_attention_lse_ref(
                    q, k, g_f, causal=causal, window=window)).abs().max())
                bitwise = torch.equal(o, o2) and torch.equal(lse, lse2)
                good = e_o <= TOL and e_l <= TOL and bitwise
                ok &= good
                if not good or S in (197, 1024):
                    print(f"fwd hd {hd} S {S} causal {causal} window "
                          f"{window}: o err {e_o:.3e}, lse err {e_l:.3e}, "
                          f"bitwise {bitwise}", flush=True)

    for hd in d2a.KERNEL_HEAD_DIMS:
        for S, causal, window in ((63, False, 0), (197, True, 40),
                                  (1024, True, 0)):
            q, k, v, do, g_f, g_b = cs.attn_inputs(torch, gen, 2, 4, S, hd)
            e_f, e_b, _, _, zeros, counts, want = cs.attention_case(
                torch, q, k, v, do, g_f, g_b, causal=causal, window=window,
                live=(int((g_f != 0).sum()) + 1, int((g_b != 0).sum())))
            good = e_f <= TOL and e_b <= 1e-4 and zeros and counts == want
            ok &= good
            print(f"fwd+bwd hd {hd} S {S} causal {causal} window {window}: "
                  f"o/lse err {e_f:.3e}, grad err {e_b:.3e}, zeros and "
                  f"tiles {zeros and counts == want}", flush=True)

    B, H, S, hd = cs.FT_BATCH, 6, 197, 64
    q, k, v, _, g_f, _ = cs.attn_inputs(torch, gen, B, H, S, hd)
    n_f = int((g_f != 0).sum())
    lq, lk, lv = (flat(t, g_f, B, H, S, hd) for t in (q, k, v))
    call = cs.time_ms(torch, lambda: d2a.flash_fwd(q, k, v, g_f,
                                                   causal=False, live=n_f))
    alone = cs.attention_fwd_alone(torch, q, k, v, g_f, causal=False,
                                   window=0, live=n_f)
    sdpa = cs.time_ms(torch, lambda: F.scaled_dot_product_attention(
        lq, lk, lv))
    print(f"fwd timing hd 64, {n_f} live: launcher call {call:.4f} ms, "
          f"alone {alone:.4f} ms, sdpa {sdpa:.4f} ms", flush=True)
    g_f = torch.ones((4, 4), device="cuda")
    for window in (512, 0):
        q, k, v = (torch.randn((4, 4, 1024, 256), generator=gen,
                               device="cuda") for _ in range(3))
        mask = d2a._mask(1024, True, window, "cuda")
        lq, lk, lv = (t.reshape(16, 1024, 256) for t in (q, k, v))
        call = cs.time_ms(torch, lambda: d2a.flash_fwd(
            q, k, v, g_f, causal=True, window=window, live=16))
        alone = cs.attention_fwd_alone(torch, q, k, v, g_f, causal=True,
                                       window=window, live=16)
        sdpa = cs.time_ms(torch, lambda: F.scaled_dot_product_attention(
            lq, lk, lv, attn_mask=mask))
        print(f"fwd timing hd 256 window {window}: launcher call "
              f"{call:.4f} ms, alone {alone:.4f} ms, sdpa {sdpa:.4f} ms",
              flush=True)
    print(f"[{cs.card_line()}]")
    print("ok" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
