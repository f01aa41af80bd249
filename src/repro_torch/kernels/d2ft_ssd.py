"""D2FT-gated SSD chunked scan, forward and gate-aware backward: the Hopper
port of the Pallas TPU kernels ``repro/kernels/d2ft_ssd.py::_fwd_kernel``
(launcher ``_forward``) and ``_bwd_kernel`` (launcher ``_backward``).

The subnet axis is the flattened (sample, SSD head) slice. Per slice,
``g_f == 0`` (p_s) runs no forward work and gives zero ``y`` and zero
``prevs``; ``g_b == 0`` (p_o and p_s) runs no backward work and gives
exact-zero dx / ddA / dB / dC. Operands are those of the kernel boundary
of the JAX package: x [B,S,H,P] the dt-weighted input, da [B,S,H] the
per-step log-decay ``dt * A`` (negative), Bm / Cm [B,S,N] shared by the H
heads. S must be a multiple of the chunk Q = min(chunk, S): the caller
zero-pads (``kernels.ops.gated_ssd_scan``), and a padded row has da = 0
(identity decay) and x = 0 (no state contribution).

Four groups of things live here:

* the plain PyTorch version, ``ssd_scan_ref`` / ``gated_ssd_ref`` /
  ``gated_ssd_prevs_ref``, the counterpart of ``repro/kernels/ref.py::
  gated_ssd_ref`` and of the masked mix in ``models/ssm.apply_ssd``; the
  CPU path, the CPU tests and the on-card comparison use it;
* accounting: ``gated_ssd_flops`` (identical to the JAX package's), and
  the operations and bytes the function needs (``needed_flops``,
  ``needed_bytes``), the bound's numerators; the TPU's
  ``gated_ssd_dispatched_bytes`` counts BlockSpec streams and does not
  apply;
* the launchers of the CUDA kernels, ``ssd_fwd`` (``csrc/d2ft_ssd_fwd.cu``)
  and ``ssd_bwd`` (``csrc/d2ft_ssd_bwd.cu``), each with a ``.launches``
  counter;
* ``gated_ssd_scan``, an autograd function whose forward is the forward
  kernel (saving ``prevs``) and whose backward is the backward kernel. On
  CPU tensors it takes the plain version; on CUDA tensors it launches the
  kernels or raises. There is no fallback.

What bounds the kernels on an H100: operations. A live (slice, chunk) of
Q = 256, P = 64, N = 128 needs about 13 MFLOP forward (the causal half of
the Q x Q products, the state products) against about 0.2 MB of its own
inputs and outputs, ~60 FLOP per byte, above the ~20 at which float32 FMA
(67 TFLOP/s, TF32 off) and not HBM becomes the limit. The design is
Mamba-2's own GPU split (see the sources' headers): chunk states in
parallel over (slice, chunk), one short sequential pass over the chunks,
then the outputs in parallel over (slice, chunk), so that the grid holds
B·H·live share·n_chunks blocks instead of one block per slice.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import build, contract

# The largest chunk the CUDA kernels take (four of their 64-row tiles).
KERNEL_MAX_CHUNK = 256
# (P, N) pairs with a kernel instantiation: the smoke config's and
# mamba2-130m's.
KERNEL_SHAPES = ((16, 16), (64, 128))


# ========================================================= plain versions
def ssd_scan_ref(x, da, Bm, Cm, chunk: int, *, return_prevs: bool = False):
    """Ungated SSD chunked scan (``repro/kernels/ref.py::ssd_scan_ref``).
    x: [B,S,H,P]; da: [B,S,H]; Bm, Cm: [B,S,N]; S a multiple of
    min(chunk, S). Returns y [B,S,H,P] and, with ``return_prevs``, the state
    entering each chunk [B,nc,H,P,N] (float32, or float64 for float64
    inputs: the on-card checks evaluate this version in float64 as the
    reference of the float32 kernels).

    One deliberate difference from the JAX package: the causal decay is
    ``exp(where(causal, diff, -inf))`` instead of ``where(causal,
    exp(diff), 0)``. The values are identical; but when the decay within a
    chunk sums past ~88, exp overflows above the diagonal, and the JAX
    form's gradient there is 0 * inf = NaN, which poisons ddA. At chunk
    256 and the model's dt ~ 0.7 that is the common case."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"S={S} is not a multiple of the chunk {Q}: pad "
                         "first (kernels.ops.gated_ssd_scan does)")
    acc = torch.promote_types(x.dtype, torch.float32)   # state dtype
    nc = S // Q
    dac = da.reshape(Bsz, nc, Q, H)
    xc = x.reshape(Bsz, nc, Q, H, P)
    Bc = Bm.reshape(Bsz, nc, Q, N)
    Cc = Cm.reshape(Bsz, nc, Q, N)
    cum = torch.cumsum(dac, dim=2)                          # [B,nc,Q,H]
    total = cum[:, :, -1]                                   # [B,nc,H]
    # intra-chunk: L[q, k] = exp(cum_q - cum_k) on k <= q, else 0
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]    # [B,nc,Q,Q,H]
    causal = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    L = torch.exp(torch.where(causal[:, :, None], diff,
                              torch.tensor(float("-inf"), device=x.device)))
    CB = torch.einsum("bcqn,bckn->bcqk", Cc, Bc)            # [B,nc,Q,Q]
    y_intra = torch.einsum("bcqkh,bckhp->bcqhp", CB[..., None] * L, xc)
    # chunk states: sum_k exp(total - cum_k) x_k B_k^T
    decay_to_end = torch.exp(total[:, :, None] - cum)       # [B,nc,Q,H]
    states = torch.einsum("bckhp,bckn->bchpn",
                          xc * decay_to_end[..., None], Bc).to(acc)
    # inter-chunk recurrence, emitting the state *before* each chunk
    carry = torch.zeros((Bsz, H, P, N), dtype=acc, device=x.device)
    prevs = []
    for c in range(nc):
        prevs.append(carry)
        carry = carry * torch.exp(total[:, c].to(acc))[:, :, None, None] \
            + states[:, c]
    prev_states = torch.stack(prevs, dim=1)                 # [B,nc,H,P,N]
    y_inter = torch.einsum("bcqn,bchpn->bcqhp", Cc.to(acc), prev_states) \
        * torch.exp(cum)[..., None]
    y = (y_intra.to(acc) + y_inter).reshape(Bsz, S, H, P).to(x.dtype)
    return (y, prev_states) if return_prevs else y


def gated_ssd_ref(x, da, Bm, Cm, g_f, g_b, *, chunk: int):
    """Plain version of the kernels, differentiable by autograd: g_f gates
    the forward per (sample, head); the (1 - g_b) share goes through
    ``detach``, so p_o heads keep their value but get no gradient."""
    y = ssd_scan_ref(x, da, Bm, Cm, chunk)
    gf = g_f[:, None, :, None].to(y.dtype)
    gb = g_b[:, None, :, None].to(y.dtype)
    return gf * (gb * y + (1.0 - gb) * y.detach())


def gated_ssd_prevs_ref(x, da, Bm, Cm, g_f, *, chunk: int):
    """Plain version of the forward kernel's second output: the state
    entering each chunk, [B*H, nc, P, N] float32, zeros on g_f == 0."""
    _, prevs = ssd_scan_ref(x, da, Bm, Cm, chunk, return_prevs=True)
    B, nc, H, P, N = prevs.shape
    prevs = prevs * (g_f != 0).to(prevs.dtype)[:, None, :, None, None]
    return prevs.permute(0, 2, 1, 3, 4).reshape(B * H, nc, P, N)


# ======================================================== analytic accounting
def _chunk_flops(Q: int, P: int, N: int):
    """The JAX package's matmul list per live chunk (FLOPs = 2·m·n·k each):
    fwd CB [Q,Q,N], y_intra [Q,Q,P], y_inter and state-add [Q,P,N] x 2;
    bwd gqk + dx_intra [Q,Q,P] x 2, dc_intra + db_intra [Q,Q,N] x 2, five
    [Q,P,N] products."""
    fwd = 2 * (Q * Q * N + Q * Q * P + 2 * Q * P * N)
    bwd = 2 * (2 * Q * Q * P + 2 * Q * Q * N + 5 * Q * P * N)
    return fwd, bwd


def gated_ssd_flops(g_f, g_b, S: int, P: int, N: int, *, chunk: int):
    """Executed FLOPs (fwd, bwd) of the JAX package's TPU kernels under
    concrete gates: live slices x chunks x the per-chunk list above (CB
    counted once per (slice, chunk), full Q x Q tiles)."""
    Q = min(chunk, S)
    nc = -(-S // Q)
    f, b = _chunk_flops(Q, P, N)
    return (float(np.sum(np.asarray(g_f) != 0)) * nc * f,
            float(np.sum(np.asarray(g_b) != 0)) * nc * b)


def needed_flops(g_f, g_b, S: int, P: int, N: int, *, chunk: int):
    """Operations (fwd, bwd) the gated function needs for these gates, the
    numerator of the operations bound: the causal half (Q(Q+1)/2 pairs) of
    every Q x Q product, and CB = C·B^T once per (sample, chunk) of a
    sample with a live head, since B and C are shared by the H heads (the
    backward needs CB too). ``gated_ssd_flops`` counts it per (slice,
    chunk) on full tiles."""
    gf, gb = np.asarray(g_f) != 0, np.asarray(g_b) != 0
    Q = min(chunk, S)
    nc = -(-S // Q)
    tri = Q * (Q + 1) // 2
    cb = 2 * tri * N
    fwd = gf.sum() * nc * 2 * (tri * P + 2 * Q * P * N) \
        + gf.any(axis=1).sum() * nc * cb
    bwd = gb.sum() * nc * 2 * (2 * tri * P + 2 * tri * N + 5 * Q * P * N) \
        + gb.any(axis=1).sum() * nc * cb
    return float(fwd), float(bwd)


def needed_bytes(g_f, g_b, S: int, P: int, N: int, *, chunk: int,
                 itemsize: int = 4):
    """Bytes (fwd, bwd) the gated function must move, each input read once
    and each output written once: the live slices' x and da (and, backward,
    prevs and dy), B and C of the samples with a live head; y and prevs
    (forward), dx, ddA, dB and dC (backward) for every slice."""
    gf, gb = np.asarray(g_f) != 0, np.asarray(g_b) != 0
    B, H = gf.shape
    Q = min(chunk, S)
    nc = -(-S // Q)
    state = nc * P * N
    fwd = (gf.sum() * (S * P + S) + gf.any(axis=1).sum() * 2 * S * N
           + B * H * (S * P + state))
    bwd = (gb.sum() * (2 * S * P + S + state) + gb.any(axis=1).sum()
           * 2 * S * N + B * H * (S * P + S) + B * 2 * S * N)
    return float(fwd * itemsize), float(bwd * itemsize)


# ============================================================ CUDA launchers
def _check(name, t, device, shape):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, x on {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be torch.float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}, got "
                         f"{tuple(t.shape)}")


@functools.cache
def _fwd_lib():
    lib = build.load("d2ft_ssd_fwd")
    lib.d2ft_ssd_fwd_f32.argtypes = (
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    lib.d2ft_ssd_fwd_f32.restype = ctypes.c_int
    lib.d2ft_ssd_fwd_error_string.argtypes = [ctypes.c_int]
    lib.d2ft_ssd_fwd_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _bwd_lib():
    lib = build.load("d2ft_ssd_bwd")
    lib.d2ft_ssd_bwd_f32.argtypes = (
        [ctypes.c_void_p] * 15 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    lib.d2ft_ssd_bwd_f32.restype = ctypes.c_int
    lib.d2ft_ssd_bwd_error_string.argtypes = [ctypes.c_int]
    lib.d2ft_ssd_bwd_error_string.restype = ctypes.c_char_p
    return lib


def _prepare(x, da, Bm, Cm, gate, chunk, live, tensors=()):
    """Checks shared by both launchers; returns (Q, nc, n_disp, idx) with
    idx the int32 compaction table (None when every slice runs)."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"the d2ft SSD kernels need CUDA tensors, got {dev}")
    if x.dim() != 4:
        raise ValueError(f"x must be [B, S, H, P], got {tuple(x.shape)}")
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    for name, t, shape in (("x", x, (B, S, H, P)), ("da", da, (B, S, H)),
                           ("Bm", Bm, (B, S, N)), ("Cm", Cm, (B, S, N)),
                           ("gate", gate, (B, H)), *tensors):
        _check(name, t, dev, shape)
    if (P, N) not in KERNEL_SHAPES:
        raise ValueError(f"(head_dim P, state N) = ({P}, {N}) has no kernel "
                         f"instantiation (supported: {KERNEL_SHAPES})")
    Q = min(chunk, S)
    if S < 1 or Q > KERNEL_MAX_CHUNK or S % Q:
        raise ValueError(f"S={S} must be a positive multiple of the chunk "
                         f"min({chunk}, S) <= {KERNEL_MAX_CHUNK} (pad first)")
    NS = B * H
    n_disp = contract.dispatch_count(live, NS)
    idx = None
    if n_disp < NS:
        idx = contract.live_permutation(gate.reshape(NS), n_disp).to(
            torch.int32)
    return Q, S // Q, n_disp, idx


def _counter_slot(kind):
    tc = contract.tile_counter
    return tc.slot(kind) if tc is not None else None


def ssd_fwd(x, da, Bm, Cm, g_f, *, chunk: int, live=None):
    """Launch the forward kernels (one launcher call, counted in
    ``ssd_fwd.launches``). Operands float32 contiguous on one CUDA device,
    S a multiple of the chunk; ``live`` is an optional upper bound on the
    g_f != 0 slice count. Returns (y [B,S,H,P], prevs [B*H, nc, P, N]);
    slices not dispatched are zeros."""
    Q, nc, n_disp, idx = _prepare(x, da, Bm, Cm, g_f, chunk, live)
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    alloc = torch.empty if idx is None else torch.zeros
    y = alloc(x.shape, dtype=torch.float32, device=x.device)
    prevs = alloc((B * H, nc, P, N), dtype=torch.float32, device=x.device)
    tot = torch.empty((n_disp, nc), dtype=torch.float32, device=x.device)
    lib = _fwd_lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.d2ft_ssd_fwd_f32(
            x.data_ptr(), da.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            g_f.data_ptr(), None if idx is None else idx.data_ptr(),
            y.data_ptr(), prevs.data_ptr(), tot.data_ptr(),
            _counter_slot("ssd_fwd"), n_disp, S, H, P, N, Q, stream)
    if err != 0:
        raise RuntimeError("d2ft SSD forward launch failed: "
                           + lib.d2ft_ssd_fwd_error_string(err).decode())
    ssd_fwd.launches += 1
    return y, prevs


ssd_fwd.launches = 0


def ssd_bwd(x, da, Bm, Cm, g_b, prevs, dy, *, chunk: int, live=None):
    """Launch the backward kernels (one launcher call, counted in
    ``ssd_bwd.launches``). Arguments as ``ssd_fwd`` plus the forward's
    prevs and the cotangent dy; ``live`` bounds the g_b != 0 slice count.
    Returns (dx, ddA, dB, dC), dB and dC summed over the heads, exact
    zeros from g_b == 0 slices."""
    Q, nc, n_disp, idx = _prepare(x, da, Bm, Cm, g_b, chunk, live,
                                  (("dy", dy, x.shape),))
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    _check("prevs", prevs, x.device, (B * H, nc, P, N))
    alloc = torch.empty if idx is None else torch.zeros
    dx = alloc(x.shape, dtype=torch.float32, device=x.device)
    dda = alloc(da.shape, dtype=torch.float32, device=x.device)
    db_s = alloc((B, H, S, N), dtype=torch.float32, device=x.device)
    dc_s = alloc((B, H, S, N), dtype=torch.float32, device=x.device)
    ds = torch.empty((n_disp, nc, P, N), dtype=torch.float32,
                     device=x.device)
    tot = torch.empty((n_disp, nc), dtype=torch.float32, device=x.device)
    lib = _bwd_lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.d2ft_ssd_bwd_f32(
            x.data_ptr(), da.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            g_b.data_ptr(), None if idx is None else idx.data_ptr(),
            prevs.data_ptr(), dy.data_ptr(), dx.data_ptr(), dda.data_ptr(),
            db_s.data_ptr(), dc_s.data_ptr(), ds.data_ptr(), tot.data_ptr(),
            _counter_slot("ssd_bwd"), n_disp, S, H, P, N, Q, stream)
    if err != 0:
        raise RuntimeError("d2ft SSD backward launch failed: "
                           + lib.d2ft_ssd_bwd_error_string(err).decode())
    ssd_bwd.launches += 1
    # B and C are shared by the heads: sum the per-slice cotangents, in
    # float64 and in a fixed order, so the sum adds one rounding and does
    # not change from run to run
    return (dx, dda, db_s.sum(dim=1, dtype=torch.float64).float(),
            dc_s.sum(dim=1, dtype=torch.float64).float())


ssd_bwd.launches = 0


# =============================================================== autograd
class _GatedSSD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, da, Bm, Cm, g_f, g_b, chunk, live_fwd, live_bwd):
        y, prevs = ssd_fwd(x, da, Bm, Cm, g_f, chunk=chunk, live=live_fwd)
        ctx.save_for_backward(x, da, Bm, Cm, g_b, prevs)
        ctx.args = (chunk, live_bwd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, da, Bm, Cm, g_b, prevs = ctx.saved_tensors
        chunk, live_bwd = ctx.args
        dx, dda, db, dc = ssd_bwd(x, da, Bm, Cm, g_b, prevs, dy.contiguous(),
                                  chunk=chunk, live=live_bwd)
        return dx, dda, db, dc, None, None, None, None, None


def gated_ssd_scan(x, da, Bm, Cm, g_f, g_b, *, chunk: int, live_fwd=None,
                   live_bwd=None):
    """Differentiable gated SSD scan core (S a multiple of min(chunk, S);
    ``kernels.ops.gated_ssd_scan`` pads). g_f, g_b: [B, H] float {0, 1}
    with g_b <= g_f. The forward is g_f-gated; the backward computes dx /
    ddA / dB / dC only from g_b != 0 slices; gates get no gradient.
    ``live_fwd`` / ``live_bwd`` are upper bounds on the live slice counts
    (None dispatches every slice).

    Only shapes are checked, so the model path pays no host sync; the value
    contracts are ``kernels.ops.gated_ssd_scan``'s, or the caller's (the
    fine-tune checks its schedule's gates on the host). CPU tensors take
    the plain version, CUDA tensors the kernels."""
    B, H = x.shape[0], x.shape[2]
    if tuple(g_f.shape) != (B, H) or tuple(g_b.shape) != (B, H):
        raise ValueError(f"gates must be [B={B}, H={H}], got "
                         f"{tuple(g_f.shape)} / {tuple(g_b.shape)}")
    if x.device.type == "cpu":
        return gated_ssd_ref(x, da, Bm, Cm, g_f, g_b, chunk=chunk)
    # the kernels read dense rows; B and C arrive as column slices of the
    # conv output
    return _GatedSSD.apply(x.contiguous(), da.contiguous(), Bm.contiguous(),
                           Cm.contiguous(), g_f, g_b, chunk, live_fwd,
                           live_bwd)
