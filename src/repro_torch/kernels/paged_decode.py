"""Paged flash decode: the Hopper port of the Pallas TPU kernel
``repro/kernels/paged_decode.py::_paged_decode_kernel`` (launcher
``paged_flash_decode``).

Single-token decode against a paged KV cache: each sequence's history lives
in fixed-size pages of a shared pool ``[n_pages, page_size, n_kv, hd]``,
addressed through a per-sequence page table. Two versions of one function:

* ``paged_flash_decode`` launches the hand-written CUDA kernels
  (``csrc/paged_decode.cu``, built by ``kernels/build.py`` at first use) on
  CUDA tensors, on PyTorch's current stream. It checks what the kernels
  take and raises on anything else: there is no fallback.
* ``paged_decode_ref`` is the plain PyTorch version: gather the pages into
  a contiguous view, mask, softmax in f32. The CPU path and the on-card
  comparison use it.

The kernel is a split-KV decode. Each (slot, kv head)'s history is cut
into runs of ``split_len(page_size)`` positions (``KV_SPLIT``, 64, or its
least common multiple with the page size); the grid is (n_kv · n_hg, B,
n_split) with ``n_split = n_splits(n_pmax, page_size)`` from the table's
width, so no host sync sizes it, and n_hg = ceil(rep / 8) groups of at
most 8 of a kv head's rep = H / n_kv query heads (one group up to rep 8;
recurrentgemma-2b's rep 10 is two groups of 5). Each block writes its
run's unnormalised accumulator, max and exp-sum into a float32 workspace
this launcher allocates (``workspace_floats``), and a second kernel of the
same call merges the runs of each (slot, head) in split order: bitwise the
same on every call. At gemma3-1b's 129-page tables (page size 16) that
is 33 runs and 132 blocks for 4 slots, where one block per (slot, kv
head) left 128 of the 132 SMs idle.

What bounds the kernel on an H100: bytes, the K/V rows of the positions
each (slot, kv head) must read, once, over 3.35 TB/s; at decode's batch
that is ~3 us, under two launches' latency. The design is set out in the
source's header.

The public entry with the JAX package's checks is
``repro_torch.kernels.ops.paged_decode_attention``.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build

NEG_INF = -2.0 ** 30
# positions of a slot's history one block of the split kernel walks: a
# multiple of the kernel's 64-position tile (csrc/paged_decode.cu kTile)
KV_SPLIT = 64


def split_len(page_size: int) -> int:
    """The run length at a page size: KV_SPLIT, or its least common
    multiple with the page size, so that runs hold whole pages."""
    return math.lcm(KV_SPLIT, page_size)


def n_splits(n_pmax: int, page_size: int) -> int:
    """Runs a table of n_pmax pages covers: the split kernel's third grid
    dimension, from the table's width alone."""
    return -(-n_pmax * page_size // split_len(page_size))


def workspace_floats(B: int, H: int, hd: int, n_pmax: int,
                     page_size: int) -> int:
    """Floats of the partials' workspace: the unnormalised accumulators
    [B, H, n_split, hd], then the runs' max and exp-sum [B, H, n_split]
    each."""
    return B * H * n_splits(n_pmax, page_size) * (hd + 2)


def paged_decode_ref(q, k_pages, v_pages, page_table, lengths, g_f, *,
                     window: int = 0):
    """Plain PyTorch version of the kernel.

    q: [B, H, hd] post-rope queries at position ``lengths[b]``; pools
    [n_pages, page_size, n_kv, hd]; page_table [B, n_pmax] int; lengths [B];
    g_f [B, H]. Attends over positions ``<= lengths[b]`` (and
    ``> lengths[b] - window`` when window > 0) in f32. Rows with no such
    position and heads with ``g_f == 0`` are exact zeros; other heads are
    scaled by ``g_f``. Returns [B, H, hd] in q's dtype."""
    B, H, hd = q.shape
    _, ps, n_kv, _ = k_pages.shape
    n_pmax = page_table.shape[1]
    L = n_pmax * ps
    idx = page_table.long()
    keys = k_pages[idx].reshape(B, L, n_kv, hd).float()
    vals = v_pages[idx].reshape(B, L, n_kv, hd).float()
    rep = H // n_kv
    keys = keys.repeat_interleave(rep, dim=2)                # [B, L, H, hd]
    vals = vals.repeat_interleave(rep, dim=2)
    s = torch.einsum("bhd,blhd->bhl", q.float() * (1.0 / hd ** 0.5), keys)
    pos = torch.arange(L, device=q.device)[None, :]
    t = lengths.long()[:, None]
    valid = pos <= t
    if window and window > 0:
        valid &= pos > t - window
    s = torch.where(valid[:, None, :], s, torch.tensor(NEG_INF,
                                                       device=q.device))
    pr = torch.exp(s - s.amax(dim=-1, keepdim=True))
    out = torch.einsum("bhl,blhd->bhd", pr, vals) / pr.sum(-1, keepdim=True)
    g = g_f.float()[:, :, None]
    live = valid.any(dim=-1)[:, None, None] & (g != 0)
    out = torch.where(live, out * g, torch.zeros((), device=q.device))
    return out.to(q.dtype)


def _check(name, x, dtype, device):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, q on {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


@functools.cache
def _lib():
    lib = build.load("paged_decode")
    lib.paged_decode_f32.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
        + [ctypes.c_float, ctypes.c_void_p])
    lib.paged_decode_f32.restype = ctypes.c_int
    lib.paged_decode_error_string.argtypes = [ctypes.c_int]
    lib.paged_decode_error_string.restype = ctypes.c_char_p
    lib.paged_decode_supports_head_dim.argtypes = [ctypes.c_int]
    lib.paged_decode_supports_head_dim.restype = ctypes.c_int
    return lib


def _prepare(q, k_pages, v_pages, page_table, lengths, g_f):
    """The launcher's checks; returns q (copied when it is not 16-byte
    aligned)."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"paged_flash_decode needs CUDA tensors, got {dev}")
    for name, x, dt in (("q", q, torch.float32),
                        ("k_pages", k_pages, torch.float32),
                        ("v_pages", v_pages, torch.float32),
                        ("page_table", page_table, torch.int32),
                        ("lengths", lengths, torch.int32),
                        ("g_f", g_f, torch.float32)):
        _check(name, x, dt, dev)
    B, H, hd = q.shape
    n_kv = k_pages.shape[2]
    lib = _lib()
    if not lib.paged_decode_supports_head_dim(hd):
        raise ValueError(f"head_dim {hd} has no kernel instantiation")
    if H % n_kv:
        raise ValueError(f"H={H} is not a multiple of n_kv={n_kv}")
    # the kernels copy rows in 16 bytes: the pools are too large to copy
    for name, x in (("k_pages", k_pages), ("v_pages", v_pages)):
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    return q if q.data_ptr() % 16 == 0 else q.clone()


def paged_flash_decode(q, k_pages, v_pages, page_table, lengths, g_f, *,
                       window: int = 0):
    """Launch the CUDA kernels (the split kernel and the merge: one
    launcher call, counted in ``paged_flash_decode.launches``). Arguments
    as ``paged_decode_ref``; q, pools and g_f float32, page_table and
    lengths int32, all contiguous on one CUDA device, the pools 16-byte
    aligned. Raises on anything else and on a launch error."""
    q = _prepare(q, k_pages, v_pages, page_table, lengths, g_f)
    B, H, hd = q.shape
    _, ps, _, _ = k_pages.shape
    out = torch.empty_like(q)
    ws = torch.empty(workspace_floats(B, H, hd, page_table.shape[1], ps),
                     dtype=torch.float32, device=q.device)
    _decode_call(q, k_pages, v_pages, page_table, lengths, g_f, out, ws,
                 window=window)
    paged_flash_decode.launches += 1
    return out


def _decode_call(q, k_pages, v_pages, page_table, lengths, g_f, out, ws, *,
                 window: int):
    """The kernels on buffers ``paged_flash_decode`` checked and allocated
    (out and the workspace); uncounted."""
    lib = _lib()
    B, H, hd = q.shape
    _, ps, n_kv, _ = k_pages.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.paged_decode_f32(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            page_table.data_ptr(), lengths.data_ptr(), g_f.data_ptr(),
            out.data_ptr(), ws.data_ptr(), B, H, n_kv, hd, ps,
            page_table.shape[1], split_len(ps), int(window),
            1.0 / hd ** 0.5, stream)
    if err != 0:
        raise RuntimeError("paged_decode kernel launch failed: "
                           + lib.paged_decode_error_string(err).decode())


paged_flash_decode.launches = 0
