"""D2FT-gated RG-LRU scan, forward and gate-aware backward: the Hopper port
of the Pallas TPU kernels ``repro/kernels/d2ft_rglru.py::_fwd_kernel``
(launcher ``_forward``) and ``_bwd_kernel`` (launcher ``_backward``).

The recurrence is ``h_t = exp(la_t) · h_{t-1} + b_t`` per channel, with
la <= 0 the per-step log-decay. The subnet axis is the flattened (sample,
channel band) slice: the G gate groups cut the width W into G contiguous
bands of Wg = W / G channels, slice s = b·G + g. Per slice, ``g_f == 0``
(p_s) runs no forward work and gives exact-zero h; ``g_b == 0`` (p_o and
p_s) runs no backward work and gives exact-zero dla and db. Operands are
those of the kernel boundary of the JAX package: la, b [B, S, W] float32.
S must be a multiple of the chunk Q = min(chunk, S): the caller zero-pads
(``kernels.ops.gated_rglru_scan``), and a padded row has la = 0 (identity
decay) and b = 0.

Four groups of things live here:

* the plain PyTorch version, ``rglru_scan_ref`` / ``gated_rglru_ref``,
  the counterpart of ``repro/kernels/ref.py::rglru_scan_ref`` /
  ``gated_rglru_ref`` in JAX's chunked log-space form; the CPU path, the
  CPU tests, the model's masked path and the on-card comparison use it;
* accounting: ``gated_rglru_flops`` (identical to the JAX package's), and
  the operations and bytes the function needs (``needed_flops``,
  ``needed_bytes``), the bound's numerators; the TPU's
  ``gated_rglru_dispatched_bytes`` counts BlockSpec streams and does not
  apply;
* the launchers of the CUDA kernels, ``rglru_fwd``
  (``csrc/d2ft_rglru_fwd.cu``) and ``rglru_bwd``
  (``csrc/d2ft_rglru_bwd.cu``), each with a ``.launches`` counter: one
  kernel launch a call, on outputs allocated unfilled (the kernel writes
  every slice, the zeros of dead and undispatched ones too) and with no
  compaction table (block y holds slice y and counts the live gates
  before it);
* ``gated_rglru_scan``, an autograd function whose forward is the forward
  kernel (saving h) and whose backward is the backward kernel. On CPU
  tensors it takes the plain version; on CUDA tensors it launches the
  kernels or raises. There is no fallback.

What bounds the kernels on an H100: bytes. A live slice needs about 3
operations per element forward (exp, multiply, add) and 5 backward
against 12 and 20 bytes of its own operands, far below the ~20 operations
per byte at which float32 FMA (67 TFLOP/s) and not HBM (3.35 TB/s) would
become the limit. The TPU's ``2·Q²·Wg`` per chunk is the cost of its
quadratic chunk form, not of the function. The kernels stream each operand
once (16-byte cp.async copies into shared memory, one tile ahead) and
combine time segments in registers, shuffles and shared memory
(``csrc/d2ft_rglru_common.cuh``).

The backward uses the sequential form of the TPU kernel's sums. With
``a = exp(la)`` and ``g_t = dy_t + a_{t+1} · g_{t+1}`` (the cotangent of
h_t, carried backwards):

    db_t  = g_t
    dla_t = g_t · a_t · h_{t-1}        (h the forward's output, h_{-1} = 0)

which is the TPU kernel's ``db_k = Σ_{q>=k} exp(lc_q - lc_k) dh_q`` and
``dla = reverse_cumsum(dh·h - b·db)`` with the carry on each chunk's last
row: the reverse cumulative sum telescopes to ``g_t · (h_t - b_t)``, and
``h_t - b_t = a_t · h_{t-1}``, which the kernel takes directly (the
difference cancels when a is small). b is not needed.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import build, contract


# ========================================================= plain versions
def rglru_scan_ref(la, b, chunk: int):
    """Ungated RG-LRU chunked scan (``repro/kernels/ref.py::
    rglru_scan_ref``): ``h_q = Σ_{k<=q} exp(lc_q - lc_k) b_k + exp(lc_q) ·
    h_prev`` inside each chunk (lc the in-chunk cumulative log-decay),
    the last row carried to the next chunk. la, b: [B, S, W], S a multiple
    of min(chunk, S). Returns h [B, S, W] (float32, or float64 for float64
    inputs).

    As in ``d2ft_ssd.ssd_scan_ref``, the causal decay is ``exp(where(
    causal, diff, -inf))`` instead of JAX's ``where(causal, exp(diff),
    0)``: the same values, and a finite gradient where a chunk's decay sum
    passes ~88 and exp overflows above the diagonal (JAX's gives 0 · inf =
    NaN there; at the model's initial decays a chunk sums to at most ~13.5,
    so the two agree).

    The in-chunk sum is an elementwise product and a sum over k, not an
    einsum: a batched matmul takes the process's matmul settings (bf16
    products under ``torch.set_float32_matmul_precision("medium")`` on a
    CPU with bf16 units, TF32 on a card that allows it), and the plain
    version the kernels are held to must not."""
    Bsz, S, W = la.shape
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"S={S} is not a multiple of the chunk {Q}: pad "
                         "first (kernels.ops.gated_rglru_scan does)")
    acc = torch.promote_types(la.dtype, torch.float32)
    nc = S // Q
    lac = la.reshape(Bsz, nc, Q, W).to(acc)
    bc = b.reshape(Bsz, nc, Q, W).to(acc)
    lc = torch.cumsum(lac, dim=2)                           # [B,nc,Q,W]
    diff = lc[:, :, :, None, :] - lc[:, :, None, :, :]      # [B,nc,Q,Q,W]
    causal = torch.ones((Q, Q), dtype=torch.bool, device=la.device).tril()
    Lm = torch.exp(torch.where(causal[:, :, None], diff,
                               torch.tensor(float("-inf"), device=la.device,
                                            dtype=acc)))
    h_intra = (Lm * bc[:, :, None]).sum(dim=3)              # [B,nc,Q,W]
    carry = torch.zeros((Bsz, W), dtype=acc, device=la.device)
    hs = []
    for c in range(nc):
        h = h_intra[:, c] + torch.exp(lc[:, c]) * carry[:, None, :]
        hs.append(h)
        carry = h[:, -1]
    return torch.stack(hs, dim=1).reshape(Bsz, S, W)


def gated_rglru_ref(la, b, g_f, g_b, *, chunk: int):
    """Plain version of the kernels, differentiable by autograd: the G gate
    groups (``g_f.shape[1]``) slice W into G contiguous bands; g_f gates
    the forward per (sample, band); the (1 - g_b) share goes through
    ``detach``, so p_o bands keep their value but get no gradient."""
    h = rglru_scan_ref(la, b, chunk)
    Bsz, S, W = h.shape
    G = g_f.shape[1]
    hg = h.reshape(Bsz, S, G, W // G)
    gf = g_f[:, None, :, None].to(h.dtype)
    gb = g_b[:, None, :, None].to(h.dtype)
    hg = gf * (gb * hg + (1.0 - gb) * hg.detach())
    return hg.reshape(Bsz, S, W)


# ======================================================== analytic accounting
def gated_rglru_flops(g_f, g_b, S: int, Wg: int, *, chunk: int):
    """Executed FLOPs (fwd, bwd) of the JAX package's TPU kernels under
    concrete gates: the dominant [Q, Q, Wg] intra-chunk contraction
    (2·Q·Q·Wg) per live (slice, chunk), one forward (h_intra), one
    backward (db)."""
    Q = min(chunk, S)
    nc = -(-S // Q)
    per = 2 * Q * Q * Wg
    return (float(np.sum(np.asarray(g_f) != 0)) * nc * per,
            float(np.sum(np.asarray(g_b) != 0)) * nc * per)


def needed_flops(g_f, g_b, S: int, Wg: int):
    """Operations (fwd, bwd) the gated function needs for these gates, the
    numerator of the operations bound: per element of a live slice, exp,
    multiply and add forward (``h = a·h + b``); exp, the carry's multiply
    and add, and the two multiplies of ``dla = g·a·h_prev`` backward."""
    n_f = int(np.sum(np.asarray(g_f) != 0))
    n_b = int(np.sum(np.asarray(g_b) != 0))
    return float(3 * n_f * S * Wg), float(5 * n_b * S * Wg)


def needed_bytes(g_f, g_b, S: int, Wg: int, *, itemsize: int = 4):
    """Bytes (fwd, bwd) the gated function must move, each input read once
    and each output written once: la and b of the g_f-live slices read, h
    written for every slice (zeros on dead ones); la, h and dy of the
    g_b-live slices read, dla and db written for every slice. The
    sequential backward needs no b (see the module docstring)."""
    gf = np.asarray(g_f) != 0
    gb = np.asarray(g_b) != 0
    n_slices = gf.size
    e = S * Wg
    return (float((2 * gf.sum() + n_slices) * e * itemsize),
            float((3 * gb.sum() + 2 * n_slices) * e * itemsize))


# ============================================================ CUDA launchers
def _check(name, t, device, shape):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, la on {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be torch.float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}, got "
                         f"{tuple(t.shape)}")


@functools.cache
def _fwd_lib():
    lib = build.load("d2ft_rglru_fwd")
    lib.d2ft_rglru_fwd_f32.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    lib.d2ft_rglru_fwd_f32.restype = ctypes.c_int
    lib.d2ft_rglru_fwd_error_string.argtypes = [ctypes.c_int]
    lib.d2ft_rglru_fwd_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _bwd_lib():
    lib = build.load("d2ft_rglru_bwd")
    lib.d2ft_rglru_bwd_f32.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    lib.d2ft_rglru_bwd_f32.restype = ctypes.c_int
    lib.d2ft_rglru_bwd_error_string.argtypes = [ctypes.c_int]
    lib.d2ft_rglru_bwd_error_string.restype = ctypes.c_char_p
    return lib


def _check_gates(la, g_f, g_b=None):
    """The gates' shape, [B, G] each, and W % G == 0; returns G."""
    B, W = la.shape[0], la.shape[-1]
    if g_f.dim() != 2 or g_f.shape[0] != B or (
            g_b is not None and tuple(g_b.shape) != tuple(g_f.shape)):
        shapes = " / ".join(str(tuple(g.shape)) for g in (g_f, g_b)
                            if g is not None)
        raise ValueError(f"gates must be [B={B}, G], got {shapes}")
    G = g_f.shape[1]
    if G < 1 or W % G:
        raise ValueError(f"lru width {W} not divisible by G={G} gate groups")
    return G


def _prepare(la, gate, chunk, live, tensors=()):
    """Checks shared by both launchers; returns (G, Q, n_disp): the gate
    groups, the chunk and the dispatch count (a live slice with that many
    live slices before it writes zeros, as one past the compaction table's
    first n_disp entries would)."""
    dev = la.device
    if dev.type != "cuda":
        raise ValueError(f"the d2ft RG-LRU kernels need CUDA tensors, got "
                         f"{dev}")
    if la.dim() != 3:
        raise ValueError(f"la must be [B, S, W], got {tuple(la.shape)}")
    B, S, W = la.shape
    G = _check_gates(la, gate)
    for name, t, shape in (("la", la, (B, S, W)), ("gate", gate, (B, G)),
                           *tensors):
        _check(name, t, dev, shape)
    Q = min(chunk, S)
    if S < 1 or Q < 1 or S % Q:
        raise ValueError(f"S={S} must be a positive multiple of the chunk "
                         f"min({chunk}, S) (pad first)")
    return G, Q, contract.dispatch_count(live, B * G)


def _counter_slot(kind):
    tc = contract.tile_counter
    return tc.slot(kind) if tc is not None else None


def rglru_fwd(la, b, g_f, *, chunk: int, live=None):
    """Launch the forward kernel (one launch, counted in
    ``rglru_fwd.launches``). la, b [B, S, W] float32 contiguous on one CUDA
    device, S a multiple of the chunk, g_f [B, G] with W % G == 0;
    ``live`` is an optional upper bound on the g_f != 0 slice count.
    Returns h [B, S, W], exact zeros on slices with g_f == 0 or not
    dispatched."""
    G, Q, n_disp = _prepare(la, g_f, chunk, live, (("b", b, la.shape),))
    h = torch.empty(la.shape, dtype=torch.float32, device=la.device)
    _fwd_call(la, b, g_f, h, n_disp, G, Q)
    rglru_fwd.launches += 1
    return h


def _fwd_call(la, b, g_f, h, n_disp, G, Q):
    """The forward kernel on buffers ``rglru_fwd`` checked and allocated;
    uncounted."""
    lib = _fwd_lib()
    B, S, W = la.shape
    with torch.cuda.device(la.device):
        stream = torch.cuda.current_stream(la.device).cuda_stream
        err = lib.d2ft_rglru_fwd_f32(
            la.data_ptr(), b.data_ptr(), g_f.data_ptr(), h.data_ptr(),
            _counter_slot("rglru_fwd"), B * G, n_disp, S, W, G, Q, stream)
    if err != 0:
        raise RuntimeError("d2ft RG-LRU forward launch failed: "
                           + lib.d2ft_rglru_fwd_error_string(err).decode())


rglru_fwd.launches = 0


def rglru_bwd(la, g_b, h, dy, *, chunk: int, live=None):
    """Launch the backward kernel (one launch, counted in
    ``rglru_bwd.launches``). la and g_b as ``rglru_fwd``'s, h the forward's
    output, dy its cotangent; ``live`` bounds the g_b != 0 slice count.
    Returns (dla, db), exact zeros from g_b == 0 slices."""
    G, Q, n_disp = _prepare(la, g_b, chunk, live, (("h", h, la.shape),
                                                   ("dy", dy, la.shape)))
    dla = torch.empty(la.shape, dtype=torch.float32, device=la.device)
    db = torch.empty_like(dla)
    _bwd_call(la, h, dy, g_b, dla, db, n_disp, G, Q)
    rglru_bwd.launches += 1
    return dla, db


def _bwd_call(la, h, dy, g_b, dla, db, n_disp, G, Q):
    """The backward kernel on buffers ``rglru_bwd`` checked and allocated;
    uncounted."""
    lib = _bwd_lib()
    B, S, W = la.shape
    with torch.cuda.device(la.device):
        stream = torch.cuda.current_stream(la.device).cuda_stream
        err = lib.d2ft_rglru_bwd_f32(
            la.data_ptr(), h.data_ptr(), dy.data_ptr(), g_b.data_ptr(),
            dla.data_ptr(), db.data_ptr(), _counter_slot("rglru_bwd"),
            B * G, n_disp, S, W, G, Q, stream)
    if err != 0:
        raise RuntimeError("d2ft RG-LRU backward launch failed: "
                           + lib.d2ft_rglru_bwd_error_string(err).decode())


rglru_bwd.launches = 0


# =============================================================== autograd
class _GatedRGLRU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, la, b, g_f, g_b, chunk, live_fwd, live_bwd):
        h = rglru_fwd(la, b, g_f, chunk=chunk, live=live_fwd)
        ctx.save_for_backward(la, g_b, h)
        ctx.args = (chunk, live_bwd)
        return h

    @staticmethod
    def backward(ctx, dh):
        la, g_b, h = ctx.saved_tensors
        chunk, live_bwd = ctx.args
        dla, db = rglru_bwd(la, g_b, h, dh.contiguous(), chunk=chunk,
                            live=live_bwd)
        return dla, db, None, None, None, None, None


def gated_rglru_scan(la, b, g_f, g_b, *, chunk: int, live_fwd=None,
                     live_bwd=None):
    """Differentiable gated RG-LRU scan core (S a multiple of min(chunk,
    S); ``kernels.ops.gated_rglru_scan`` pads). g_f, g_b: [B, G] float
    {0, 1} with g_b <= g_f and W % G == 0. The forward is g_f-gated per
    (sample, band); the backward computes dla / db only on g_b != 0
    slices; gates get no gradient. ``live_fwd`` / ``live_bwd`` are upper
    bounds on the live slice counts (None dispatches every slice).

    Only shapes are checked, so the model path pays no host sync; the value
    contracts are ``kernels.ops.gated_rglru_scan``'s, or the caller's (the
    fine-tune checks its schedule's gates on the host). CPU tensors take
    the plain version, CUDA tensors the kernels."""
    _check_gates(la, g_f, g_b)
    if la.device.type == "cpu":
        return gated_rglru_ref(la, b, g_f, g_b, chunk=chunk)
    # the model's layer gates are [B, G] slices of the schedule's [L, B, G]
    # gates, which need not be laid out layer-major
    return _GatedRGLRU.apply(la.contiguous(), b.contiguous(),
                             g_f.contiguous(), g_b.contiguous(), chunk,
                             live_fwd, live_bwd)
