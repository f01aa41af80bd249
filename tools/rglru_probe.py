"""Quick on-card probe of the gated RG-LRU scan kernels of the PyTorch port:
build them, print their registers and spills, hold both against their
plain version (h 1e-5, dla / db 1e-4, each x max(1, max |plain|); exact
zeros on gated and undispatched slices written by the kernel into
NaN-filled outputs; bitwise equal across two calls), then time both
launchers at several shapes (``TIMING``): recurrentgemma-2b's (chip_smoke.py
phase 18: B 4, S 512, W 2560, G 10), the same at B 1, and phase 16's long
case (B 4, S 4096, W 256, G 1). Each timing is the launcher call (CUDA
events, L2 flushed) and the device time of its kernels from a profiler
window (those named ``rglru``, and every kernel of the call).

Run from the root of a checkout, on a machine with one CUDA card:

    python3 tools/rglru_probe.py
    python3 tools/rglru_probe.py --src DIR

``--src`` times (and only times) the port found at ``DIR/src`` instead,
for example an earlier commit unpacked with ``git archive``: the
launchers' interface is the same since the kernels were first ported, so
one call can time two versions in turn (``A B B A``). It takes about a
minute where ``chip_smoke.py`` takes minutes, and exits non-zero when a
check fails. The records' numbers at phase 18's shapes come from
``chip_smoke.py``."""
import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

# (name, B, S, W, G): shapes timed, each with every slice forward-live and
# every fourth slice (in flat order) frozen backward (p_o)
TIMING = (("recurrentgemma-2b", 4, 512, 2560, 10),
          ("recurrentgemma-2b B 1", 1, 512, 2560, 10),
          ("long (phase 16)", 4, 4096, 256, 1))


def timing(torch, cs, d2r):
    """Launcher ms and its kernels' device ms at each ``TIMING`` shape,
    chunk 128, dispatch bounds at the live counts."""
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(18)
    for name, B, S, W, G in TIMING:
        la = -F.softplus(torch.randn((B, S, W), generator=gen,
                                     device="cuda"))
        b, dy = (torch.randn((B, S, W), generator=gen, device="cuda")
                 for _ in range(2))
        g_f = torch.ones((B, G), device="cuda")
        g_b = g_f.clone()
        g_b.view(-1)[::4] = 0.0
        lf, lb = B * G, int((g_b != 0).sum())
        h = d2r.rglru_fwd(la, b, g_f, chunk=128, live=lf)
        nb = d2r.needed_bytes(g_f.cpu().numpy(), g_b.cpu().numpy(), S,
                              W // G)
        calls = {"fwd": lambda: d2r.rglru_fwd(la, b, g_f, chunk=128,
                                              live=lf),
                 "bwd": lambda: d2r.rglru_bwd(la, g_b, h, dy, chunk=128,
                                              live=lb)}
        for i, (kind, fn) in enumerate(calls.items()):
            bound = 1e3 * nb[i] / cs.HBM_BYTES_PER_S
            ms = cs.time_ms(torch, fn)
            busy, _, _, kern, _, _, named = cs.profile_steps(
                torch, fn, "rglru", n_prof=20)
            print(f"timing {name} {kind}: B {B} S {S} W {W} G {G}, live "
                  f"{lf if kind == 'fwd' else lb} of {B * G}: launcher "
                  f"{ms:.4f} ms ({bound / ms:.1%} of the bytes bound "
                  f"{bound:.5f} ms), rglru kernels {kern:.4f} ms on the "
                  f"device ({bound / kern:.1%}; {sorted(named)}), all "
                  f"kernels of the call {busy:.4f} ms", flush=True)
        del la, b, dy, h
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", type=Path, default=ROOT,
                    help="time only the port at SRC/src (default: this "
                    "checkout's, checked and timed)")
    args = ap.parse_args()
    sys.path[:0] = [str(args.src.resolve() / "src"), str(ROOT)]
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("rglru_probe: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as cs
    from repro_torch.kernels import build, contract, ops
    from repro_torch.kernels import d2ft_rglru as d2r
    print(f"port at {Path(d2r.__file__).resolve().parents[3]}", flush=True)
    if args.src.resolve() != ROOT:
        timing(torch, cs, d2r)
        print(f"[{cs.card_line()}]")
        return 0

    t0 = time.perf_counter()
    build.build_all()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    for name in ("d2ft_rglru_fwd", "d2ft_rglru_bwd"):
        print(name, build.resources(name), flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    ok = True
    for B, S, W, G, chunk in ((3, 24, 128, 4, 8), (3, 21, 128, 4, 8),
                              (3, 512, 320, 10, 128),
                              (4, 512, 2560, 10, 128),
                              (4, 500, 2560, 80, 128),
                              (2, 4096, 256, 1, 128), (3, 300, 96, 2, 128),
                              (2, 40, 36, 4, 8)):
        for bounded in (False, True):
            la = -F.softplus(torch.randn((B, S, W), generator=gen,
                                         device="cuda"))
            b, dy = (torch.randn((B, S, W), generator=gen, device="cuda")
                     for _ in range(2))
            g_f, g_b = cs.rglru_gates(torch, gen, B, G)
            n_f, n_b = int((g_f != 0).sum()), int((g_b != 0).sum())
            live = (n_f, n_b) if bounded else (None, None)
            with contract.count_tiles("cuda") as tc:
                ins = [t.clone().requires_grad_() for t in (la, b)]
                h = ops.gated_rglru_scan(*ins, g_f, g_b, chunk=chunk,
                                         live_fwd=live[0], live_bwd=live[1])
                h.backward(dy)
                counts = tc.read()
            refs = [t.clone().requires_grad_() for t in (la, b)]
            Q, Sp = ops._scan_pad(S, chunk)
            ref = d2r.gated_rglru_ref(
                *[F.pad(t, (0, 0, 0, Sp - S)) for t in refs], g_f, g_b,
                chunk=Q)[:, :S]
            ref.backward(dy)
            errs = [float((u - v).abs().max()) / max(1.0, float(
                v.abs().max())) for u, v in ((h.detach(), ref.detach()),
                                             (ins[0].grad, refs[0].grad),
                                             (ins[1].grad, refs[1].grad))]
            steps = (counts["rglru_fwd"] == n_f * (Sp // Q)
                     and counts["rglru_bwd"] == n_b * (Sp // Q))
            good = errs[0] <= 1e-5 and max(errs[1:]) <= 1e-4 and steps
            ok &= good
            print(f"vs plain B {B} S {S} W {W} G {G} chunk {chunk} bounds "
                  f"{live}: scaled errs h {errs[0]:.2e} dla {errs[1]:.2e} db "
                  f"{errs[2]:.2e}, steps {steps}", flush=True)

            # compacted calls into NaN-filled outputs: the kernel writes
            # every slice, zeros on gated and undispatched ones; bitwise
            # equal across two calls
            Wg = W // G
            pad = [F.pad(t, (0, 0, 0, Sp - S)).contiguous()
                   for t in (la, b, dy)]
            outs = []
            for _ in range(2):
                hh = torch.full_like(pad[0], float("nan"))
                dla = torch.full_like(pad[0], float("nan"))
                db = torch.full_like(pad[0], float("nan"))
                _, _, nd_f = d2r._prepare(pad[0], g_f, Q, n_f)
                d2r._fwd_call(pad[0], pad[1], g_f, hh, nd_f, G, Q)
                _, _, nd_b = d2r._prepare(pad[0], g_b, Q, n_b)
                d2r._bwd_call(pad[0], hh, pad[2], g_b, dla, db, nd_b, G, Q)
                outs.append((hh, dla, db))
            torch.cuda.synchronize()

            def bands(t):
                return t.reshape(B, Sp, G, Wg).transpose(1, 2)
            zeros = (bool((bands(outs[0][0])[g_f == 0] == 0).all())
                     and all(bool((bands(t)[g_b == 0] == 0).all())
                             for t in outs[0][1:])
                     and all(bool(torch.isfinite(t).all())
                             for t in outs[0]))
            bitwise = all(torch.equal(u, v) for u, v in zip(*outs))
            ok &= zeros and bitwise
            if not (zeros and bitwise):
                print(f"  zeros {zeros} bitwise {bitwise}", flush=True)

    timing(torch, cs, d2r)
    print(f"[{cs.card_line()}]")
    print("ok" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
