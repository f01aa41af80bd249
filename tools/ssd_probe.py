"""Quick on-card timing of the gated SSD chunked-scan kernels of the
PyTorch port: build them, print their registers and spills, then time both
launchers at the three shapes of ``TIMING``: chip_smoke.py phase 11's (B 8,
S 2048, H 24 under the fine-tune's 2 : 1 : 1 split, 144 / 96 of 192 live),
the same with every slice live, and the prefill of one request (B 1, S
8192). Each timing is the launcher call and its kernels alone (outputs,
workspaces and, in trees that build one, the compaction table made outside
the window), CUDA events with L2 flushed, beside both bounds (float32 FMA;
3xTF32 on the tensor cores), and each kernel's device time from a profiler
window. The checks against the plain version are
``tests/test_torch_kernels_gpu.py``'s.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 tools/ssd_probe.py
    python3 tools/ssd_probe.py --src DIR

``--src`` times the port found at ``DIR/src`` instead, for example an
earlier commit unpacked with ``git archive``: the launchers' Python
interface is the same since the kernels were first ported, and the kernels
alone are called through whichever C interface that tree has (the earlier
table-driven one or this one), so one call can time two versions in turn
(``A B B A``). It takes about a minute."""
import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

H, P, N, Q = 24, 64, 128, 256          # mamba2-130m's SSD widths, chunk 256
# (name, B, S, gates): "mix" is the fine-tune's p_f / p_o / p_s split, "all"
# every slice live both ways
TIMING = (("phase 11", 8, 2048, "mix"), ("all live", 8, 2048, "all"),
          ("prefill B 1", 1, 8192, "all"))


def _alone(torch, cs, d2s, args, lf, lb):
    """(forward, backward) callables of the kernels alone, their outputs,
    workspaces and (in trees that build one) compaction table made once."""
    x, da, Bm, Cm, dy, g_f, g_b = args
    prevs = d2s.ssd_fwd(x, da, Bm, Cm, g_f, chunk=Q, live=lf)[1]
    if hasattr(d2s, "_fwd_call"):
        return cs.ssd_alone(torch, d2s, x, da, Bm, Cm, dy, g_f, g_b, prevs,
                            Q, (lf, lb))
    # the earlier FMA kernels: a table and zero-filled outputs per call
    Bsz, S = x.shape[:2]
    nc = S // Q
    stream = torch.cuda.current_stream().cuda_stream

    def ptr(t):
        return None if t is None else t.data_ptr()
    _, _, nf, idf = d2s._prepare(x, da, Bm, Cm, g_f, Q, lf)
    y, pv = torch.zeros_like(x), torch.zeros_like(prevs)
    tf = torch.empty((nf, nc), device="cuda")
    _, _, nb, idb = d2s._prepare(x, da, Bm, Cm, g_b, Q, lb)
    dx, dda = torch.zeros_like(x), torch.zeros_like(da)
    dbs, dcs = (torch.zeros((Bsz, H, S, N), device="cuda") for _ in range(2))
    ds = torch.empty((nb, nc, P, N), device="cuda")
    tb = torch.empty((nb, nc), device="cuda")
    fl, bl = d2s._fwd_lib(), d2s._bwd_lib()
    return (lambda: fl.d2ft_ssd_fwd_f32(
                ptr(x), ptr(da), ptr(Bm), ptr(Cm), ptr(g_f), ptr(idf),
                ptr(y), ptr(pv), ptr(tf), None, nf, S, H, P, N, Q, stream),
            lambda: bl.d2ft_ssd_bwd_f32(
                ptr(x), ptr(da), ptr(Bm), ptr(Cm), ptr(g_b), ptr(idb),
                ptr(prevs), ptr(dy), ptr(dx), ptr(dda), ptr(dbs), ptr(dcs),
                ptr(ds), ptr(tb), None, nb, S, H, P, N, Q, stream))


def timing(torch, cs, d2s):
    """Launcher and alone ms of both kernels at each ``TIMING`` shape, the
    dispatch bounds at the live counts."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    for name, Bsz, S, gates in TIMING:
        g = None
        if gates == "all":
            g = (torch.ones((Bsz, H), device="cuda"),) * 2
        args = cs.ssd_inputs(torch, gen, Bsz, H, S, P, N, g=g)
        x, da, Bm, Cm, dy, g_f, g_b = args
        lf, lb = int((g_f != 0).sum()), int((g_b != 0).sum())
        prevs = d2s.ssd_fwd(x, da, Bm, Cm, g_f, chunk=Q, live=lf)[1]
        fl = d2s.needed_flops(g_f.cpu().numpy(), g_b.cpu().numpy(), S, P, N,
                              chunk=Q)
        by = d2s.needed_bytes(g_f.cpu().numpy(), g_b.cpu().numpy(), S, P,
                              N, chunk=Q)
        alone = _alone(torch, cs, d2s, args, lf, lb)
        calls = {"fwd": lambda: d2s.ssd_fwd(x, da, Bm, Cm, g_f, chunk=Q,
                                            live=lf),
                 "bwd": lambda: d2s.ssd_bwd(x, da, Bm, Cm, g_b, prevs, dy,
                                            chunk=Q, live=lb)}
        for i, (kind, fn) in enumerate(calls.items()):
            ms = cs.time_ms(torch, fn, iters=20)
            ams = cs.time_ms(torch, alone[i], iters=20)
            fma, _ = cs.roofline(by[i], fl[i])
            tc, tc_by = cs.tc_roofline(by[i], fl[i])
            named = cs.profile_steps(torch, fn, "ssd", n_prof=5)[-1]
            print(f"timing {name} {kind}: B {Bsz} S {S} H {H} P {P} N {N} "
                  f"chunk {Q}, live {lf if kind == 'fwd' else lb} of "
                  f"{Bsz * H}: launcher {ms:.4f} ms, alone {ams:.4f} ms; "
                  f"bounds FMA {fma:.5f} ms, 3xTF32 {tc:.5f} ms by {tc_by} "
                  f"({fl[i] / 1e9:.3f} GFLOP, {by[i] / 1e6:.1f} MB); "
                  f"{tc / ms:.1%} of the 3xTF32 bound ({tc / ams:.1%} "
                  f"alone); device ms a call by kernel: " + "; ".join(
                      f"{k} {t:.4f}" for k, (t, _) in sorted(
                          named.items(), key=lambda kv: -kv[1][0])),
                  flush=True)
        del args, x, da, Bm, Cm, dy, prevs, alone
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", type=Path, default=ROOT,
                    help="time the port at SRC/src (default: this "
                    "checkout's)")
    args = ap.parse_args()
    sys.path[:0] = [str(args.src.resolve() / "src"), str(ROOT)]
    import torch
    if not torch.cuda.is_available():
        print("ssd_probe: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import d2ft_ssd as d2s
    print(f"port at {Path(d2s.__file__).resolve().parents[3]}", flush=True)
    t0 = time.perf_counter()
    build.build_all()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    for name in ("d2ft_ssd_fwd", "d2ft_ssd_bwd"):
        print(name, build.resources(name), flush=True)
    timing(torch, cs, d2s)
    print(f"[{cs.card_line()}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
