#!/usr/bin/env python3
"""Quick on-card probe of the gated MoE expert FFN kernels of the PyTorch
port: build every kernel, print the MoE sources' registers and spills,
hold both launchers against their plain version at olmoe-1b-7b's layer-0
operands (the dispatched capacity buffer E 64, C 320 -> 384, D 2048, F
1024, block_c 128, under 3 p_f and 1 p_o samples) with every weight
gradient and with dW_up alone, check two calls for equal bits, then time
them roughly (CUDA events, L2 flushed) beside their library calls.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 tools/moe_probe.py

It takes about a minute where ``chip_smoke.py`` takes many, and exits
non-zero when a check fails. The records' numbers come from
``chip_smoke.py``."""
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main() -> int:
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("moe_probe: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke as cs
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import d2ft_moe as d2m

    t0 = time.perf_counter()
    build.build_all()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    for name in ("d2ft_moe_fwd", "d2ft_moe_bwd"):
        print(name, build.resources(name), flush=True)

    op = torch.tensor([0, 0, 0, 1], device="cuda")[:, None].repeat(1, 16)
    g_f, g_b = (op != 2).float(), (op == 0).float()
    xb, wu, wg, wd, fs, bs, live, live_b = cs.moe_operands(
        torch, (g_f, g_b), (int(g_f.sum()), int(g_b.sum())))
    calls = []
    with torch.no_grad(), cs.capture(d2m, "gated_moe_ffn", calls):
        ops._gated_moe_impl(xb, wu, wg, wd, fs, bs, act="silu",
                            block_c=cs.MO_BLOCK_C, live_slots=live,
                            live_bwd_slots=live_b)
    (xs, _, _, _, fm, bm), kw = calls[0]
    xs, fm, bm = (t.contiguous() for t in (xs, fm, bm))
    bc, nb = kw["block_c"], kw["bwd_blocks"]
    E, Cr, D = xs.shape
    Fd = wu.shape[2]
    cb = nb * bc
    dy = torch.randn(xs.shape, generator=torch.Generator(
        device="cuda").manual_seed(22), device="cuda")
    print(f"E {E} C {xb.shape[1]} -> {Cr} D {D} F {Fd} block_c {bc}: "
          f"{int(fm.sum())} live forward tiles, {int(bm[:, :nb].sum())} "
          f"backward of grid ({E}, {nb})", flush=True)

    ok = True
    refs = [t.clone().requires_grad_() for t in (xs, wu, wg, wd)]
    ref = d2m.gated_moe_ffn_ref(*refs, fm, bm, act="silu", block_c=bc)
    want = torch.autograd.grad(ref, refs, dy)
    ref = ref.detach()
    y = d2m.moe_fwd(xs, wu, wg, wd, fm, act="silu", block_c=bc)
    y2 = d2m.moe_fwd(xs, wu, wg, wd, fm, act="silu", block_c=bc)
    scale = max(1.0, float(ref.abs().max()))
    err = float((y - ref).abs().max())
    good = err <= cs.KERNEL_TOL * scale and torch.equal(y, y2)
    ok &= good
    print(f"fwd: err {err:.3e} (max |plain| {scale:.3g}), bitwise "
          f"{torch.equal(y, y2)}", flush=True)
    full = None
    for need in ((True, True, True), (True, False, False)):
        got = d2m.moe_bwd(xs, wu, wg, wd, bm, dy, act="silu", block_c=bc,
                          bwd_blocks=nb, need=need)
        again = d2m.moe_bwd(xs, wu, wg, wd, bm, dy, act="silu", block_c=bc,
                            bwd_blocks=nb, need=need)
        torch.cuda.synchronize()
        full = full or got
        for name, a, b, w, f_ in zip(("dx", "dw_up", "dw_gate", "dw_down"),
                                     got, again, want, full):
            if a is None:
                continue
            s = max(1.0, float(w.abs().max()))
            e = float((a - w).abs().max())
            same = torch.equal(a, b) and torch.equal(a, f_)
            good = e <= cs.GRAD_TOL * s and same
            ok &= good
            print(f"bwd need {need} {name}: err {e:.3e} (max |plain| "
                  f"{s:.3g}), bitwise across calls and = all-three {same}",
                  flush=True)

    def library(x, u, g, d):
        return torch.bmm(F.silu(torch.bmm(x, g)) * torch.bmm(x, u), d)
    lib_all = [t.clone().requires_grad_() for t in (xs[:, :cb], wu, wg, wd)]
    lib_up = [xs[:, :cb].clone().requires_grad_(), wu.clone()
              .requires_grad_(), wg, wd]
    out_all, out_up = library(*lib_all), library(*lib_up)
    rows = [
        ("fwd launcher", lambda: d2m.moe_fwd(xs, wu, wg, wd, fm, act="silu",
                                             block_c=bc)),
        ("fwd library", lambda: library(xs, wu, wg, wd)),
        ("bwd launcher, all dW", lambda: d2m.moe_bwd(
            xs, wu, wg, wd, bm, dy, act="silu", block_c=bc, bwd_blocks=nb)),
        ("bwd library, all dW", lambda: torch.autograd.grad(
            out_all, lib_all, dy[:, :cb], retain_graph=True)),
        ("bwd launcher, dW_up", lambda: d2m.moe_bwd(
            xs, wu, wg, wd, bm, dy, act="silu", block_c=bc, bwd_blocks=nb,
            need=(True, False, False))),
        ("bwd library, dW_up", lambda: torch.autograd.grad(
            out_up, lib_up[:2], dy[:, :cb], retain_graph=True))]
    for name, fn in rows:
        print(f"{name}: {cs.time_ms(torch, fn, iters=10):.4f} ms",
              flush=True)
    # the launchers' kernels by name, device time of one call each
    for name, fn in rows[::2]:
        prof = cs.profile_steps(torch, fn, "moe_", n_prof=3)
        print(f"{name} kernels: " + "; ".join(
            f"{k} {ms:.3f} ms" for k, (ms, _) in sorted(
                prof[-1].items(), key=lambda kv: -kv[1][0])), flush=True)
    print(f"[{cs.card_line()}]")
    print("ok" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
