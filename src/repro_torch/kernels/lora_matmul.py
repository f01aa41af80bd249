"""Fused LoRA matmul ``y = x·W + s·(x·A)·B``: the Hopper port of the Pallas
TPU kernel ``repro/kernels/lora_matmul.py::_kernel`` (launcher
``lora_matmul``). Forward only, as the TPU kernel is.

Here live:

* ``lora_matmul_ref``, the plain PyTorch version (the JAX package's
  ``kernels/ref.py::lora_matmul_ref``), which the CPU path, the CPU tests
  and the on-card comparison use;
* ``needed_flops`` / ``needed_bytes``, the work the function needs, for the
  bound: operations decide it at fine-tuning widths (``csrc/
  lora_matmul.cu`` has the numbers);
* ``lora_matmul``, the launcher of ``csrc/lora_matmul.cu``, with a
  ``.launches`` counter. It takes CUDA tensors only; ``ops.lora_linear``
  routes CPU tensors to the plain version.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

MAX_RANK = 256          # the paper's rank-matched R 1/60/200/240 fit


def lora_matmul_ref(x, w, a, b, scale: float):
    """y = x @ w + scale * (x @ a) @ b.   x: [M, K]; w: [K, N]; a: [K, r];
    b: [r, N]."""
    base = x @ w
    delta = (x @ a) @ b
    return base + scale * delta.to(base.dtype)


def needed_flops(M: int, K: int, N: int, r: int) -> int:
    """Operations the function needs: the base product and both low-rank
    products, 2MKN + 2MKr + 2MrN."""
    return 2 * M * K * N + 2 * M * K * r + 2 * M * r * N


def needed_bytes(M: int, K: int, N: int, r: int, itemsize: int = 4) -> int:
    """Bytes the function must move: x, W, A and B read once, y written
    once."""
    return itemsize * (M * K + K * N + K * r + r * N + M * N)


@functools.cache
def _lib():
    lib = build.load("lora_matmul")
    lib.lora_matmul_f32.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
        + [ctypes.c_float, ctypes.c_void_p])
    lib.lora_matmul_f32.restype = ctypes.c_int
    lib.lora_matmul_error_string.argtypes = [ctypes.c_int]
    lib.lora_matmul_error_string.restype = ctypes.c_char_p
    return lib


def lora_matmul(x, w, a, b, scale: float = 1.0):
    """Launch the fused kernel (one launch, counted in
    ``lora_matmul.launches``). x [M, K], w [K, N], a [K, r], b [r, N]:
    float32, contiguous, on one CUDA device, none requiring grad (the
    kernel has no backward); 1 <= r <= MAX_RANK. Returns y [M, N]."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"the LoRA matmul kernel needs CUDA tensors, got "
                         f"{dev}")
    for name, t in (("x", x), ("w", w), ("a", a), ("b", b)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be torch.float32, got {t.dtype}")
        if t.ndim != 2:
            raise ValueError(f"{name} must be 2-D, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.requires_grad:
            raise ValueError(f"{name} requires grad, but the LoRA matmul "
                             "kernel is forward only")
    M, K = x.shape
    N = w.shape[1]
    r = a.shape[1]
    if w.shape[0] != K or a.shape[0] != K or tuple(b.shape) != (r, N):
        raise ValueError(f"shapes do not chain: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)}")
    if not 1 <= r <= MAX_RANK:
        raise ValueError(f"rank {r} has no kernel instantiation (1 to "
                         f"{MAX_RANK})")
    if min(M, K, N) < 1:
        raise ValueError(f"empty operand: M {M}, K {K}, N {N}")
    y = torch.empty((M, N), dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.lora_matmul_f32(x.data_ptr(), w.data_ptr(), a.data_ptr(),
                                  b.data_ptr(), y.data_ptr(), M, K, N, r,
                                  float(scale), stream)
    if err != 0:
        raise RuntimeError("LoRA matmul launch failed: "
                           + lib.lora_matmul_error_string(err).decode())
    lora_matmul.launches += 1
    return y


lora_matmul.launches = 0
