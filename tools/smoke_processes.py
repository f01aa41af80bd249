#!/usr/bin/env python
"""Run ``chip_smoke.py`` and list the processes it left running.

``chip_smoke.py`` must stop every process it starts. This runs it with
no arguments from ``--dir`` (default: the repo root; give the directory
of a ``git archive`` of the tree to check what git would commit), samples
the machine's processes every few seconds while it runs, and five seconds
after it exits lists every process that was not running before it
started, then stops them. Writes the script's output, errors and the
sampled processes under ``--out``. Run it on the machine with the card:

    python3 tools/smoke_processes.py --dir DIR --out OUT

Prints ``smoke rc=R seconds=S``, one ``left`` line a process and ``left
count N``; exits with the script's code, or 1 when it left a process.
"""
from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def processes():
    """pid -> (ppid, session, state, command line) of every process."""
    out = {}
    for proc in Path("/proc").iterdir():
        if not proc.name.isdigit():
            continue
        try:
            stat = (proc / "stat").read_text()
            cmd = (proc / "cmdline").read_bytes().replace(b"\0", b" ")
        except OSError:
            continue
        rest = stat[stat.rfind(")") + 2:].split()
        out[int(proc.name)] = (int(rest[1]), int(rest[3]), rest[0],
                               cmd.decode(errors="replace")[:240])
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dir", type=Path, default=ROOT)
    ap.add_argument("--out", type=Path, required=True)
    ap.add_argument("--every", type=float, default=5.0)
    args = ap.parse_args()
    args.out.mkdir(parents=True, exist_ok=True)
    before = processes()
    t0 = time.perf_counter()
    with open(args.out / "smoke.out", "w") as so, \
            open(args.out / "smoke.err", "w") as se, \
            open(args.out / "smoke_processes.log", "w") as log:
        child = subprocess.Popen([sys.executable, "chip_smoke.py"],
                                 cwd=args.dir, stdout=so, stderr=se)
        seen = set()
        while child.poll() is None:
            time.sleep(args.every)
            for pid, (ppid, sid, state, cmd) in processes().items():
                if pid not in before and (pid, cmd) not in seen:
                    seen.add((pid, cmd))
                    log.write(f"{time.perf_counter() - t0:8.1f} pid {pid} "
                              f"ppid {ppid} sid {sid} {state} {cmd}\n")
            log.flush()
    seconds = time.perf_counter() - t0
    time.sleep(5)
    left = {pid: v for pid, v in processes().items()
            if pid not in before and pid != os.getpid()}
    print(f"smoke rc={child.returncode} seconds={seconds:.1f}")
    for pid, (ppid, sid, state, cmd) in left.items():
        print(f"left pid {pid} ppid {ppid} sid {sid} {state} {cmd}")
        try:
            os.kill(pid, signal.SIGKILL)
        except OSError:
            pass
    print(f"left count {len(left)}")
    print((args.out / "smoke.out").read_text()[-3000:])
    return child.returncode or (1 if left else 0)


if __name__ == "__main__":
    sys.exit(main())
