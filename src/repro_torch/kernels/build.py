"""Build of the hand-written CUDA kernels, at first use.

Every ``csrc/*.cu`` source compiles with ``nvcc`` for Hopper (``sm_90a``)
into a shared library with a plain C interface, loaded with ``ctypes``: no
PyTorch headers, so a build takes seconds. All sources compile at once,
one ``nvcc`` each, started together. Output goes to ``build/<hash>/``
beside this file (listed in ``.gitignore``), keyed by a hash of the sources
and flags, so an edited source never loads a stale library. Each library's
``-Xptxas -v`` report (registers, shared memory, spills) is kept beside it
as ``<name>.log``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _sources() -> Dict[str, Path]:
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):          # sources and headers
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def build_all() -> Dict[str, Path]:
    """Compile every source not yet built; returns name -> library path.
    Raises with the compiler's output when a source fails to build."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {name: out_dir / f"lib{name}.so" for name in _sources()}
    todo = {n: p for n, p in _sources().items() if not libs[n].exists()}
    if not todo:
        return libs
    nvcc = _nvcc()
    procs = {}
    for name, src in todo.items():
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        procs[name] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", tmp, str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        (out_dir / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, libs[name])   # atomic: concurrent builds race safely
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return libs


def ptxas_report() -> str:
    """The ``-Xptxas -v`` reports of the current build, one per source."""
    out_dir = build_dir()
    return "\n".join(f"== {name}.cu\n{(out_dir / f'{name}.log').read_text()}"
                     for name in _sources()
                     if (out_dir / f"{name}.log").exists())


def _demangle(sym: str) -> str:
    """``foo_kernel<64, 256>`` from a mangled kernel symbol (the name
    that ends in ``_kernel`` and its integer template arguments)."""
    pos = 3 if sym.startswith("_ZN") else 2          # <length><name>...
    while (m := re.match(r"\d+", sym[pos:])):
        start = pos + m.end()
        name, pos = sym[start:start + int(m.group())], start + int(m.group())
        if name.endswith("_kernel"):
            rest = sym[pos:]
            args = (re.findall(r"Li(\d+)E", rest[:rest.find("EEv")])
                    if rest.startswith("I") else [])
            return name + (f"<{', '.join(args)}>" if args else "")
    return sym


def resources(name: str):
    """Each kernel of ``csrc/<name>.cu`` with the registers a thread uses
    and its spill stores and loads in bytes, from the build's ``-Xptxas
    -v`` report: [(kernel, registers, spill stores, spill loads)], the
    kernel as its name and template arguments (``foo_kernel<64, 256>``)."""
    out, entry, spills = [], None, (0, 0)
    for line in (build_dir() / f"{name}.log").read_text().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = _demangle(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry is not None:
            out.append((entry, int(m.group(1)), *spills))
            entry, spills = None, (0, 0)
    return out


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu`` (building at first use)."""
    return ctypes.CDLL(str(build_all()[name]))
