"""D2FT-gated MoE expert FFN, forward and gate-aware backward: the Hopper
port of the Pallas TPU kernels ``repro/kernels/d2ft_moe.py::_fwd_kernel``
(launcher ``_forward``) and ``_bwd_kernel`` (launcher ``_backward``).

The function is the gated expert MLP ``y = (act(x·W_gate) ⊙ x·W_up)·W_down``
over the ``[E, C, D]`` capacity buffer that ``models/moe.py``'s dispatch
fills, on a grid of (expert, capacity-block) tiles of ``block_c`` slots.
The schedule gate meets the router upstream: gate-dead assignments never
take a slot, and backward-live ones pack first in each expert's segment.
Per tile, ``fm == 0`` runs no forward work and gives exact-zero y;
``bm == 0`` runs no backward work, gives exact-zero dx and adds nothing to
the expert's dW. The backward runs on its own grid of the first
``bwd_blocks`` capacity blocks (the g_b bound; every bm bit past it is
zero by the dispatch's packing) and dx is zero beyond it.

Four groups of things live here:

* ``act_pair`` and the plain PyTorch version ``gated_moe_ffn_ref`` (the
  counterpart of ``repro/kernels/ref.py::gated_moe_ffn_ref``: the dense
  per-expert gated MLP with the block masks as a stop-gradient mix); the
  CPU route, the CPU tests and the on-card comparison use it;
* accounting: ``gated_moe_flops`` and ``gated_moe_dispatched_bytes``
  (identical to the JAX package's), and ``needed_bytes``, the bytes the
  function must move, for the bound (operations decide it:
  ``csrc/d2ft_moe_fwd.cu`` has the numbers);
* the launchers ``moe_fwd`` (``csrc/d2ft_moe_fwd.cu``) and ``moe_bwd``
  (``csrc/d2ft_moe_bwd.cu``), each with a ``.launches`` counter and the
  ``dispatch`` hook (JAX's ``on_dispatch``). On CUDA tensors they launch
  the kernels or raise; on CPU tensors they compute the plain version on
  the same grid (forward: the masked dense MLP; backward: its autograd
  gradients on the truncated grid), without counting a launch. The
  backward computes only the weight gradients it is asked for (``need``);
* ``gated_moe_ffn``, an autograd function whose forward is ``moe_fwd`` and
  whose backward is ``moe_bwd``, asked for the weight gradients autograd
  needs (D2FT-LoRA's merged w_gate and w_down are frozen: dW_up alone);
  the masks get no gradient.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import build, contract

# Hook: when set, every launcher call reports ``dispatch(kind, grid, mask)``
# with kind "fwd" or "bwd", the (expert, capacity-block) grid it launches
# (JAX's ``on_dispatch`` grid) and the launched tiles' block mask [E, n]
# (a device tensor, not read here), from which a caller can mirror the
# executed-tile count without reading the device counter.
dispatch = None

ACTS = ("silu", "gelu", "relu")         # the kernels' activation codes


def _report(kind: str, grid, mask):
    if dispatch is not None:
        dispatch(kind, tuple(grid), mask)


# ========================================================= plain versions
def act_pair(name: str):
    """(f, df) for the expert activation, as ``models.layers._act``: silu,
    gelu (tanh approximation, ``jax.nn.gelu``'s default), relu; df is the
    explicit derivative the backward kernel takes."""
    if name == "silu":
        def df(g):
            s = torch.sigmoid(g)
            return s * (1.0 + g * (1.0 - s))
        return F.silu, df
    if name == "gelu":
        c = math.sqrt(2.0 / math.pi)

        def df(g):
            t = torch.tanh(c * (g + 0.044715 * g ** 3))
            return 0.5 * (1.0 + t) + \
                0.5 * g * (1.0 - t ** 2) * c * (1.0 + 3 * 0.044715 * g ** 2)
        return (lambda g: F.gelu(g, approximate="tanh")), df
    if name == "relu":
        return F.relu, (lambda g: (g > 0).to(g.dtype))
    raise ValueError(f"unknown activation {name!r}")


def _block_rows(mask, block_c: int, C: int):
    """[E, n] block mask -> [E, C, 1] per-slot mask."""
    return mask.repeat_interleave(block_c, dim=1)[:, :C, None]


def gated_moe_ffn_ref(xb, w_up, w_gate, w_down, fwd_mask, bwd_mask, *,
                      act: str, block_c: int):
    """Plain version, differentiable by autograd: the dense per-expert
    gated MLP with the (expert, capacity-block) masks as a stop-gradient
    mix. xb: [E, C, D]; w_up / w_gate: [E, D, F]; w_down: [E, F, D];
    fwd_mask / bwd_mask: [E, n] {0, 1} over capacity blocks of ``block_c``
    slots (bwd <= fwd, n·block_c >= C)."""
    C = xb.shape[1]
    f, _ = act_pair(act)
    h = torch.bmm(xb, w_up)
    g = torch.bmm(xb, w_gate)
    y = torch.bmm(f(g) * h, w_down)
    mf = _block_rows(fwd_mask, block_c, C).to(y.dtype)
    mb = _block_rows(bwd_mask, block_c, C).to(y.dtype)
    return mf * (mb * y + (1.0 - mb) * y.detach())


# ======================================================== analytic accounting
FWD_MATMULS_PER_TILE = 3   # x·w_up, x·w_gate, (act·h)·w_down
BWD_MATMULS_PER_TILE = 8   # h, g recompute; dmid; dwd; dx (2); dwu; dwg
ALL_DW = (True, True, True)   # (dW_up, dW_gate, dW_down) wanted


def gated_moe_flops(fm, bm, block_c: int, D: int, F: int):
    """Executed FLOPs (fwd, bwd) under concrete block masks: live tiles x
    matmuls per tile x 2·bc·D·F each — the kernels' own skip, mirrored (the
    JAX package's function). It is also what the function needs on these
    masks, the numerator of the operations bound."""
    per = 2 * block_c * D * F
    return (float(np.sum(np.asarray(fm) != 0)) * FWD_MATMULS_PER_TILE * per,
            float(np.sum(np.asarray(bm) != 0)) * BWD_MATMULS_PER_TILE * per)


def bwd_flops(bm, block_c: int, D: int, F: int, need=ALL_DW):
    """Executed backward FLOPs under a block mask when only the weight
    gradients in ``need`` are computed: the recompute of h and g, dmid and
    dx's two products (5 matmuls a live tile) and one matmul per wanted dW.
    With every dW wanted, ``gated_moe_flops``' backward."""
    per = 2 * block_c * D * F
    return float(np.sum(np.asarray(bm) != 0)) * (5 + sum(map(bool, need))) \
        * per


def gated_moe_dispatched_bytes(E: int, n_cb: int, block_c: int, D: int,
                               F: int, *, itemsize: int = 4,
                               n_cb_bwd: Optional[int] = None):
    """(fwd_bytes, bwd_bytes) the TPU kernels stream for grids of (E, n_cb)
    (the JAX package's function): expert weights fetched once per expert,
    x/y/dy/dx once per tile, dW written once per expert; ``n_cb_bwd``
    prices the backward's own truncation."""
    nb = n_cb if n_cb_bwd is None else n_cb_bwd
    wb = 3 * D * F * itemsize
    tile = block_c * D * itemsize
    fwd = E * (wb + n_cb * 2 * tile)
    bwd = E * (wb + nb * 3 * tile + wb)
    return fwd, bwd


def needed_bytes(fm, bm, block_c: int, D: int, F: int, *,
                 itemsize: int = 4, need=ALL_DW):
    """Bytes (fwd, bwd) the gated function must move on these masks, each
    input read once and each output written once: forward, the weights of
    experts with a live tile and x of live tiles read, y written for every
    launched tile; backward, the weights of experts with a live backward
    tile and x, dy of live tiles read, dx of every launched tile and the
    wanted dW (``need``: dW_up, dW_gate, dW_down) of every expert
    written."""
    fm, bm = np.asarray(fm) != 0, np.asarray(bm) != 0
    E = fm.shape[0]
    w = 3 * D * F
    tile = block_c * D
    fwd = fm.any(1).sum() * w + fm.sum() * tile + fm.size * tile
    bwd = bm.any(1).sum() * w + 2 * bm.sum() * tile + bm.size * tile + \
        E * sum(map(bool, need)) * D * F
    return float(fwd * itemsize), float(bwd * itemsize)


# ============================================================ CUDA launchers
def _check(name, t, device, shape):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, xb on {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be torch.float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}, got "
                         f"{tuple(t.shape)}")


def _prepare(xb, w_up, w_gate, w_down, mask, block_c, act, tensors=()):
    """Checks shared by both launchers; returns (E, C, D, F, n_cb)."""
    if xb.dim() != 3 or w_up.dim() != 3:
        raise ValueError(f"xb must be [E, C, D] and w_up [E, D, F], got "
                         f"{tuple(xb.shape)} / {tuple(w_up.shape)}")
    if act not in ACTS:
        raise ValueError(f"unknown activation {act!r}")
    E, C, D = xb.shape
    F_ = w_up.shape[-1]
    if block_c < 1 or C % block_c or C == 0:
        raise ValueError(f"capacity {C} must be a positive multiple of "
                         f"block_c={block_c} (pad first: ops.gated_moe_ffn "
                         "does)")
    n_cb = C // block_c
    dev = xb.device
    for name, t, shape in (("xb", xb, (E, C, D)), ("w_up", w_up, (E, D, F_)),
                           ("w_gate", w_gate, (E, D, F_)),
                           ("w_down", w_down, (E, F_, D)),
                           ("mask", mask, (E, n_cb)), *tensors):
        _check(name, t, dev, shape)
    return E, C, D, F_, n_cb


def _counter_slot(kind):
    tc = contract.tile_counter
    return tc.slot(kind) if tc is not None else None


@functools.cache
def _fwd_lib():
    lib = build.load("d2ft_moe_fwd")
    lib.d2ft_moe_fwd_f32.argtypes = (
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    lib.d2ft_moe_fwd_f32.restype = ctypes.c_int
    lib.d2ft_moe_fwd_error_string.argtypes = [ctypes.c_int]
    lib.d2ft_moe_fwd_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _bwd_lib():
    lib = build.load("d2ft_moe_bwd")
    lib.d2ft_moe_bwd_f32.argtypes = (
        [ctypes.c_void_p] * 14 + [ctypes.c_int] * 9 + [ctypes.c_void_p])
    lib.d2ft_moe_bwd_f32.restype = ctypes.c_int
    lib.d2ft_moe_bwd_error_string.argtypes = [ctypes.c_int]
    lib.d2ft_moe_bwd_error_string.restype = ctypes.c_char_p
    return lib


def moe_fwd(xb, w_up, w_gate, w_down, fm, *, act: str, block_c: int):
    """The forward over the (E, C / block_c) grid. xb [E, C, D], w_up /
    w_gate [E, D, F], w_down [E, F, D], fm [E, C / block_c] {0, 1}: float32,
    contiguous, on one device, C a multiple of block_c. Returns y [E, C, D],
    exact zeros on fm == 0 tiles. On CUDA tensors: one launcher call of the
    kernels, counted in ``moe_fwd.launches``; on CPU tensors the plain
    version."""
    E, C, D, F_, n_cb = _prepare(xb, w_up, w_gate, w_down, fm, block_c, act)
    _report("fwd", (E, n_cb), fm)
    if xb.device.type == "cpu":
        with torch.no_grad():
            return gated_moe_ffn_ref(xb, w_up, w_gate, w_down, fm, fm,
                                     act=act, block_c=block_c)
    y = torch.empty_like(xb)
    mid = torch.empty((E, C, F_), dtype=torch.float32, device=xb.device)
    work = torch.empty((E * n_cb + 1,), dtype=torch.int32, device=xb.device)
    _fwd_call(xb, w_up, w_gate, w_down, fm, y, mid, work, block_c, act)
    moe_fwd.launches += 1
    return y


def _fwd_call(xb, w_up, w_gate, w_down, fm, y, mid, work, block_c, act):
    """The forward kernels on buffers ``moe_fwd`` checked and allocated;
    uncounted."""
    lib = _fwd_lib()
    E, C, D = xb.shape
    F_ = w_up.shape[-1]
    with torch.cuda.device(xb.device):
        stream = torch.cuda.current_stream(xb.device).cuda_stream
        err = lib.d2ft_moe_fwd_f32(
            xb.data_ptr(), w_up.data_ptr(), w_gate.data_ptr(),
            w_down.data_ptr(), fm.data_ptr(), y.data_ptr(), mid.data_ptr(),
            work.data_ptr(), _counter_slot("moe_fwd"), E, C, block_c,
            D, F_, ACTS.index(act), stream)
    if err != 0:
        raise RuntimeError("d2ft MoE forward launch failed: "
                           + lib.d2ft_moe_fwd_error_string(err).decode())


moe_fwd.launches = 0


def moe_bwd(xb, w_up, w_gate, w_down, bm, dy, *, act: str, block_c: int,
            bwd_blocks: Optional[int] = None, need=ALL_DW):
    """The backward over the (E, nb) grid, nb = min(bwd_blocks, C /
    block_c) (None: every block). Operands as ``moe_fwd``'s, bm [E, C /
    block_c] {0, 1} with every bit past nb zero, dy [E, C, D] the
    cotangent of y; ``need`` says which of (dw_up, dw_gate, dw_down) to
    compute. Returns (dx, dw_up, dw_gate, dw_down), None for each dW not
    needed: dx exact zeros on bm == 0 tiles and past nb, dW summed over
    each expert's live tiles in ascending block order (exact zeros for an
    expert with none), the same bits whichever others are needed. On CUDA
    tensors: one launcher call of the kernels, counted in
    ``moe_bwd.launches``; on CPU tensors the plain version's autograd
    gradients on the same grid."""
    E, C, D, F_, n_cb = _prepare(xb, w_up, w_gate, w_down, bm, block_c, act,
                                 (("dy", dy, xb.shape),))
    need = tuple(bool(n) for n in need)
    if len(need) != 3:
        raise ValueError(f"need must name (dw_up, dw_gate, dw_down), got "
                         f"{need}")
    nb = n_cb if bwd_blocks is None else max(1, min(int(bwd_blocks), n_cb))
    cr = nb * block_c
    _report("bwd", (E, nb), bm[:, :nb])
    if xb.device.type == "cpu":
        with torch.enable_grad():
            ins = [xb[:, :cr].detach().requires_grad_()] + [
                w.detach().requires_grad_(n)
                for w, n in zip((w_up, w_gate, w_down), need)]
            y = gated_moe_ffn_ref(*ins, bm[:, :nb], bm[:, :nb], act=act,
                                  block_c=block_c)
            wanted = [ins[0]] + [w for w, n in zip(ins[1:], need) if n]
            got = iter(torch.autograd.grad(y, wanted, dy[:, :cr]))
            dx = next(got)
            dws = [next(got) if n else None for n in need]
        return (F.pad(dx, (0, 0, 0, C - cr)), *dws)
    dx = torch.empty_like(xb)
    if cr < C:
        dx[:, cr:].zero_()
    dws = [torch.empty_like(w) if n else None
           for w, n in zip((w_up, w_gate, w_down), need)]
    dhg = torch.empty((E, cr, 2 * F_), dtype=torch.float32,
                      device=xb.device)
    ah = torch.empty((E, cr, F_), dtype=torch.float32,
                     device=xb.device) if need[2] else None
    work = torch.empty((E * nb + 1,), dtype=torch.int32, device=xb.device)
    _bwd_call(xb, w_up, w_gate, w_down, bm, dy, dx, *dws, dhg, ah, work, nb,
              block_c, act)
    moe_bwd.launches += 1
    return (dx, *dws)


def _bwd_call(xb, w_up, w_gate, w_down, bm, dy, dx, dwu, dwg, dwd, dhg, ah,
              work, nb, block_c, act):
    """The backward kernels on buffers ``moe_bwd`` checked and allocated
    (dx zeroed past nb·block_c); a dW output that is None is not computed
    (and ah, None, is needed only for dW_down); uncounted."""
    lib = _bwd_lib()
    E, C, D = xb.shape
    F_ = w_up.shape[-1]
    want = sum(1 << i for i, t in enumerate((dwu, dwg, dwd)) if t is not None)

    def ptr(t):
        return None if t is None else t.data_ptr()
    with torch.cuda.device(xb.device):
        stream = torch.cuda.current_stream(xb.device).cuda_stream
        err = lib.d2ft_moe_bwd_f32(
            xb.data_ptr(), w_up.data_ptr(), w_gate.data_ptr(),
            w_down.data_ptr(), bm.data_ptr(), dy.data_ptr(), dx.data_ptr(),
            ptr(dwu), ptr(dwg), ptr(dwd), dhg.data_ptr(), ptr(ah),
            work.data_ptr(), _counter_slot("moe_bwd"), E, C, C // block_c,
            nb, block_c, D, F_, ACTS.index(act), want, stream)
    if err != 0:
        raise RuntimeError("d2ft MoE backward launch failed: "
                           + lib.d2ft_moe_bwd_error_string(err).decode())


moe_bwd.launches = 0


# =============================================================== autograd
class _GatedMoE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xb, w_up, w_gate, w_down, fm, bm, act, block_c,
                bwd_blocks):
        y = moe_fwd(xb, w_up, w_gate, w_down, fm, act=act, block_c=block_c)
        ctx.save_for_backward(xb, w_up, w_gate, w_down, bm)
        ctx.args = (act, block_c, bwd_blocks)
        return y

    @staticmethod
    def backward(ctx, dy):
        xb, w_up, w_gate, w_down, bm = ctx.saved_tensors
        act, block_c, bwd_blocks = ctx.args
        # only the weight gradients autograd asks for: D2FT-LoRA's merged
        # w_gate and w_down are frozen
        dx, dwu, dwg, dwd = moe_bwd(xb, w_up, w_gate, w_down, bm,
                                    dy.contiguous(), act=act,
                                    block_c=block_c, bwd_blocks=bwd_blocks,
                                    need=ctx.needs_input_grad[1:4])
        return dx, dwu, dwg, dwd, None, None, None, None, None


def gated_moe_ffn(xb, w_up, w_gate, w_down, fm, bm, *, act: str,
                  block_c: int, bwd_blocks: Optional[int] = None):
    """Differentiable doubly-sparse MoE expert FFN core (the JAX package's
    custom-VJP ``gated_moe_ffn``). xb: [E, C, D] capacity buffer, C a
    multiple of block_c (``kernels.ops.gated_moe_ffn`` pads and truncates);
    w_up / w_gate: [E, D, F]; w_down: [E, F, D]; fm / bm: [E, C / block_c]
    float {0, 1} block masks with bm <= fm. The forward skips fm == 0
    tiles, the backward bm == 0 tiles and every block past ``bwd_blocks``,
    and computes the gradient of a weight only when it requires one; the
    masks get no gradient. Only shapes are checked, so the model path
    pays no host sync."""
    return _GatedMoE.apply(xb.contiguous(), w_up.contiguous(),
                           w_gate.contiguous(), w_down.contiguous(),
                           fm.contiguous(), bm.contiguous(), act, block_c,
                           bwd_blocks)
