"""D2FT-gated flash attention, forward and gate-aware backward: the Hopper
port of the Pallas TPU kernels ``repro/kernels/d2ft_attention.py::
_fwd_kernel`` (launcher ``_forward``) and ``_bwd_fused_kernel`` (launcher
``_backward``).

Per (sample, head) slice, ``g_f == 0`` (p_s) skips the forward and writes
zeros; ``g_b == 0`` (p_o and p_s) skips every backward product and writes
zero gradients. That skip is the paper's training-compute saving.

Four groups of things live here:

* accounting identical to the JAX package's (``select_blocks``,
  ``pad_to_blocks``, ``live_block_count``, ``gated_attention_flops``), plus
  the CUDA kernels' own tiling (``kernel_block``, a function of head_dim
  and of the kernel: the forward's 64 query rows against 64 or 32 key
  rows, the backward's rectangular ones; ``kernel_live_tiles``,
  ``kernel_flops``, ``kernel_bytes``);
* the plain PyTorch version ``gated_attention_ref`` (with
  ``attention_ref``, ``d2ft_attention_ref`` and the forward's logsumexp
  ``gated_attention_lse_ref``), which the CPU path, the CPU tests and the
  on-card comparison use;
* the launchers of the CUDA kernels, ``flash_fwd`` (``csrc/
  d2ft_attention_fwd.cu``) and ``flash_bwd`` (``csrc/
  d2ft_attention_bwd.cu``), each with a ``.launches`` counter, and their
  uncounted C calls on buffers they checked and allocated (``_fwd_call``,
  ``_bwd_call``: the kernels alone, for timing);
* ``gated_flash_attention``, an autograd function whose forward is the
  forward kernel and whose backward is the backward kernels. On CPU
  tensors it takes the plain version; on CUDA tensors it launches the
  kernels or raises. There is no fallback.

What bounds the kernels on an H100: operations. A live slice of S = 197,
hd = 64 does 4·S²·hd FLOP forward against about 4·S·hd·4 bytes, far above
the ~20 FLOP/byte where float32 arithmetic becomes the limit. Both kernels
run their products on the tensor cores in 3xTF32 (``csrc/tf32x3.cuh``:
float32 accuracy, three TF32 products a step, 165 TFLOP/s of such work
against 67 TFLOP/s of float32 FMA), so the least time is the live tiles'
FLOPs over that rate. The design (one block per (dispatched slice, tile)
that walks the other axis itself: FlashAttention-2's forward with the
scores, softmax state and output in registers, and its deterministic dQ /
dK-dV split of the backward; slice ids from the compaction table instead
of gather/scatter copies; the ragged edge masked in-kernel instead of
padded copies) is set out in the sources' headers.
"""
from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import build, contract

NEG_INF = -2.0 ** 30
# logsumexp stored for rows that never saw a live key: large positive, so
# exp(s - LSE_MASKED) is exactly 0 in the backward for any score.
LSE_MASKED = 2.0 ** 30

# the head dims of the repo's configs (16: the smoke ViT's; 80:
# stablelm-3b's and hubert-xlarge's; 96: phi3-vision-42b's); others raise
KERNEL_HEAD_DIMS = (16, 32, 64, 80, 96, 128, 256)
# the kernels with a tile counter: the forward, and the backward's dQ and
# dK/dV roles (one launch, a counter cell each)
KERNEL_KINDS = ("fwd", "bwd_dq", "bwd_dkdv")


def kernel_block(hd: int, kind: str = "fwd"):
    """(block_q, block_k): the tiles of one CUDA kernel at head_dim hd,
    fixed at compile time. The forward's hold 64 query rows (4 warps of
    16) against key tiles of 64 rows up to hd 64 and 32 above, so that two
    cp.async stages fit beside q (two blocks an SM up to hd 128). The
    backward's hold 64 rows resident (queries in the dQ role, keys in the
    dK/dV role) against a walked tile of 64 rows, or 32 at hd 256, where a
    64-row walked tile would take more shared memory than a block may
    have."""
    fk = 32 if hd > 64 else 64        # the forward's key tile
    b = 32 if hd > 128 else 64        # the backward's walked tile
    blocks = {"fwd": (64, fk), "bwd_dq": (64, b), "bwd_dkdv": (b, 64)}
    if kind not in blocks:
        raise ValueError(f"unknown kernel {kind!r}; one of {KERNEL_KINDS}")
    return blocks[kind]


# ======================================================= tile selection
def _largest_divisor(S: int, block: int) -> int:
    b = min(block, S)
    while S % b:
        b -= 1
    return b


def select_blocks(S: int, block_q: int, block_k: int):
    """(block_q, block_k, padded_S) of the JAX package's TPU tiling: exact
    fit when S divides the tiles; else a divisor within 2x of the request;
    else the requested tiles with S padded to a common multiple. Kept as
    accounting identical to JAX's; the CUDA kernels do not pad."""
    bq = min(block_q, S)
    bk = min(block_k, S)
    if S % bq == 0 and S % bk == 0:
        return bq, bk, S
    dq_ = _largest_divisor(S, bq)
    dk_ = _largest_divisor(S, bk)
    if dq_ >= bq // 2 and dk_ >= bk // 2:
        return dq_, dk_, S
    m = math.lcm(bq, bk)
    return bq, bk, -(-S // m) * m


def pad_to_blocks(q, k, v, block_q: int, block_k: int):
    """select_blocks plus zero-padding of the sequence axis, as the JAX
    package's kernel entries do. Returns (q, k, v, bq, bk, S, Sp)."""
    S = q.shape[2]
    bq, bk, Sp = select_blocks(S, block_q, block_k)
    if Sp != S:
        pad = (0, 0, 0, Sp - S)
        q, k, v = F.pad(q, pad), F.pad(k, pad), F.pad(v, pad)
    return q, k, v, bq, bk, S, Sp


# ======================================================== analytic accounting
def _block_live(qpos0: int, kpos0: int, block_q: int, block_k: int,
                causal: bool, window: int, seq_len: int) -> bool:
    """Whether the (iq, ik) tile holds any unmasked in-bounds entry: the
    skip predicate of the JAX kernels and of the CUDA kernels."""
    live = qpos0 < seq_len and kpos0 < seq_len
    if causal:
        live &= kpos0 <= qpos0 + block_q - 1
    if window and window > 0:
        live &= kpos0 + block_k - 1 > qpos0 - window
    return bool(live)


def live_block_count(S: int, block_q: int, block_k: int, causal: bool,
                     window: int, seq_len: int = 0) -> int:
    """(iq, ik) tiles executed per live slice; S is the (padded) grid
    extent, seq_len the true length."""
    seq_len = seq_len or S
    n_q, n_k = S // block_q, S // block_k
    return sum(_block_live(iq * block_q, ik * block_k, block_q, block_k,
                           causal, window, seq_len)
               for iq in range(n_q) for ik in range(n_k))


FWD_MATMULS_PER_TILE = 2   # qk^T, pv
BWD_MATMULS_PER_TILE = 5   # the TPU's fused one-pass backward
# products per tile of each CUDA kernel: the forward's qk^T and pv; the
# backward (FA2's split) 3 in the dQ role (s, dp, ds·k) and 4 in the
# dK/dV role (s^T, dp^T, p^T·do, ds^T·q)
KERNEL_MATMULS_PER_TILE = {"fwd": 2, "bwd_dq": 3, "bwd_dkdv": 4}


def gated_attention_flops(g_f, g_b, S: int, hd: int, *, causal: bool = True,
                          window: int = 0, block_q: int = 128,
                          block_k: int = 128):
    """Executed matmul FLOPs (fwd, bwd) of the JAX package's TPU kernels
    under concrete gates (its tile geometry, padding and skip predicate)."""
    bq, bk, Sp = select_blocks(S, block_q, block_k)
    tiles = live_block_count(Sp, bq, bk, causal, window, seq_len=S)
    per_matmul = 2 * bq * bk * hd
    fwd = float(np.sum(np.asarray(g_f) != 0)) \
        * tiles * FWD_MATMULS_PER_TILE * per_matmul
    bwd = float(np.sum(np.asarray(g_b) != 0)) \
        * tiles * BWD_MATMULS_PER_TILE * per_matmul
    return fwd, bwd


def _live_pairs(S: int, causal: bool, window: int, hd: int, kind: str):
    """The live (q tile, k tile) index pairs of one kernel over S, and the
    real rows of each q tile and each k tile (the last ones ragged)."""
    bq, bk = kernel_block(hd, kind)
    q_rows = [min(bq, S - i) for i in range(0, S, bq)]
    k_rows = [min(bk, S - i) for i in range(0, S, bk)]
    pairs = [(iq, ik) for iq in range(len(q_rows))
             for ik in range(len(k_rows))
             if _block_live(iq * bq, ik * bk, bq, bk, causal, window, S)]
    return pairs, q_rows, k_rows


def kernel_live_tiles(S: int, causal: bool, window: int, hd: int,
                      kind: str = "fwd") -> int:
    """(q tile, k tile) pairs one CUDA kernel (``KERNEL_KINDS``) executes
    per live slice: ``kernel_block(hd, kind)`` tiles over S, the last ones
    ragged and masked in-kernel. Its tile counter counts the same."""
    return len(_live_pairs(S, causal, window, hd, kind)[0])


def kernel_flops(n_live_fwd: int, n_live_bwd: int, S: int, hd: int, *,
                 causal: bool, window: int):
    """FLOPs (fwd, bwd) the CUDA kernels execute for the given live slice
    counts: whole tiles of each kernel, the ragged edge included; the
    backward's are the dQ and dK/dV roles' together."""
    def per_slice(kind):
        bq, bk = kernel_block(hd, kind)
        return (kernel_live_tiles(S, causal, window, hd, kind)
                * KERNEL_MATMULS_PER_TILE[kind] * 2 * bq * bk * hd)
    return (n_live_fwd * per_slice("fwd"),
            n_live_bwd * (per_slice("bwd_dq") + per_slice("bwd_dkdv")))


def kernel_bytes(n_live_fwd: int, n_live_bwd: int, n_fwd_disp: int,
                 n_bwd_disp: int, S: int, hd: int, *, causal: bool,
                 window: int, itemsize: int = 4):
    """Device-memory bytes (fwd, bwd) the CUDA kernels load and store, in
    place of the JAX package's BlockSpec DMA count. Per live slice: the
    forward reads q once and the k and v rows of every live (q tile, k
    tile) pair, and writes o and lse; the backward's delta kernel reads do
    and o and writes delta; its dQ role reads q, do, lse and delta once and
    k, v per live pair, and writes dq; its dK/dV role reads k and v once
    and q, do, lse and delta per live pair, and writes dk and dv. A
    dispatched dead slice only writes its zeros (o and lse; dq, dk and
    dv). Ragged tiles count their real rows only; each kernel's own
    tiles (``kernel_block(hd, kind)``)."""
    def walked(kind, axis):            # rows of the walked axis per slice
        pairs, q_rows, k_rows = _live_pairs(S, causal, window, hd, kind)
        return sum(k_rows[ik] if axis == "k" else q_rows[iq]
                   for iq, ik in pairs)
    row = hd * itemsize
    fwd_live = S * row + 2 * walked("fwd", "k") * row + S * row + S * 4
    bwd_live = (2 * S * row + S * 4                          # delta
                + 2 * S * row + 2 * S * 4 + 2 * walked("bwd_dq", "k") * row
                + S * row                                       # dQ
                + 2 * S * row + walked("bwd_dkdv", "q") * (2 * row + 2 * 4)
                + 2 * S * row)                                  # dK/dV
    return (n_live_fwd * fwd_live + (n_fwd_disp - n_live_fwd) * (S * row
                                                                 + S * 4),
            n_live_bwd * bwd_live + (n_bwd_disp - n_live_bwd) * 3 * S * row)


# ======================================================== plain versions
def _mask(S: int, causal: bool, window: int, device):
    qpos = torch.arange(S, device=device)[:, None]
    kpos = torch.arange(S, device=device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window and window > 0:
        mask &= kpos > qpos - window
    return mask


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """Ungated attention; q, k, v: [B, H, S, hd]. Returns float32."""
    hd = q.shape[-1]
    scale = 1.0 / torch.sqrt(torch.tensor(float(hd), dtype=torch.float32))
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) \
        * scale.to(q.device)
    mask = _mask(q.shape[2], causal, window, q.device)
    s = torch.where(mask[None, None], s,
                    torch.tensor(NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float())


def d2ft_attention_ref(q, k, v, gates, *, causal: bool = True,
                       window: int = 0):
    """Forward-gated attention: gates [B, H] in {0, 1}, 0 gives zeros."""
    out = attention_ref(q, k, v, causal=causal, window=window)
    out = out * gates[:, :, None, None].float()
    return out.to(q.dtype)


def gated_attention_lse_ref(q, k, g_f, *, causal: bool = True,
                            window: int = 0):
    """Plain version of the forward kernel's second output: the row
    logsumexp of the masked scaled scores [B, H, S], LSE_MASKED on g_f == 0
    slices."""
    hd = q.shape[-1]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / hd ** 0.5
    mask = _mask(q.shape[2], causal, window, q.device)
    s = torch.where(mask[None, None], s,
                    torch.tensor(NEG_INF, device=q.device))
    lse = torch.logsumexp(s, dim=-1)
    return torch.where(g_f[:, :, None] != 0, lse,
                       torch.tensor(LSE_MASKED, device=q.device))


def gated_attention_ref(q, k, v, g_f, g_b, *, causal: bool = True,
                        window: int = 0):
    """Plain version of the kernels, differentiable by autograd.

    Forward: g_f * attention (p_s heads zeroed). Backward: gradients flow
    only where g_b == 1; the (1 - g_b) share goes through ``detach``, so
    p_o heads keep their forward value but contribute zero dq/dk/dv."""
    out = attention_ref(q, k, v, causal=causal, window=window)
    gf = g_f[:, :, None, None].float()
    gb = g_b[:, :, None, None].float()
    out = gf * (gb * out + (1.0 - gb) * out.detach())
    return out.to(q.dtype)


# ============================================================ CUDA launchers
def _check(name, x, device):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, q on {device}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name} must be torch.float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


@functools.cache
def _fwd_lib():
    lib = build.load("d2ft_attention_fwd")
    lib.d2ft_attn_fwd_f32.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
        + [ctypes.c_float, ctypes.c_void_p])
    lib.d2ft_attn_fwd_f32.restype = ctypes.c_int
    lib.d2ft_attn_fwd_error_string.argtypes = [ctypes.c_int]
    lib.d2ft_attn_fwd_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _bwd_lib():
    lib = build.load("d2ft_attention_bwd")
    lib.d2ft_attn_bwd_f32.argtypes = (
        [ctypes.c_void_p] * 14 + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.c_void_p])
    lib.d2ft_attn_bwd_f32.restype = ctypes.c_int
    lib.d2ft_attn_bwd_error_string.argtypes = [ctypes.c_int]
    lib.d2ft_attn_bwd_error_string.restype = ctypes.c_char_p
    return lib


def _prepare(q, k, v, gate, live, tensors=()):
    """Checks shared by both launchers; returns (S, hd, n_disp, idx) with
    idx the int32 compaction table (None when every slice runs): every
    slice, live ones first; the kernels dispatch its first n_disp."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"the d2ft attention kernels need CUDA tensors, "
                         f"got {dev}")
    B, H, S, hd = q.shape
    for name, x in (("q", q), ("k", k), ("v", v), ("gate", gate),
                    *tensors):
        _check(name, x, dev)
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v shapes differ: {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if tuple(gate.shape) != (B, H):
        raise ValueError(f"gate must be [B={B}, H={H}], got "
                         f"{tuple(gate.shape)}")
    if hd not in KERNEL_HEAD_DIMS:
        raise ValueError(f"head_dim {hd} has no kernel instantiation "
                         f"(supported: {KERNEL_HEAD_DIMS})")
    if S < 1:
        raise ValueError("empty sequence")
    N = B * H
    n_disp = contract.dispatch_count(live, N)
    idx = None
    if n_disp < N:
        idx = contract.live_permutation(gate.reshape(N), N).to(torch.int32)
    return S, hd, n_disp, idx


def _fwd_outputs(q):
    """o and lse for a forward launch, unfilled: the kernel writes every
    slice's rows, the ones the compaction table leaves out as zeros and
    LSE_MASKED."""
    B, H, S, _ = q.shape
    return (torch.empty_like(q),
            torch.empty((B, H, S), dtype=torch.float32, device=q.device))


def _aligned(*tensors):
    """The kernels stream rows with 16-byte cp.async: a view that starts
    off a 16-byte boundary is copied."""
    return tuple(t if t.data_ptr() % 16 == 0 else t.clone() for t in tensors)


def _counter_slots(*kinds):
    tc = contract.tile_counter
    return [tc.slot(kind) if tc is not None else None for kind in kinds]


def flash_fwd(q, k, v, g_f, *, causal: bool, window: int = 0, live=None):
    """Launch the forward kernel (one launch, counted in
    ``flash_fwd.launches``). q, k, v: [B, H, S, hd] float32 contiguous on
    one CUDA device, kv heads expanded; g_f [B, H] float32. ``live`` is an
    optional upper bound on the g_f != 0 slice count. Returns (o [B, H, S,
    hd], lse [B, H, S]); slices not dispatched are zeros / LSE_MASKED."""
    S, hd, n_disp, idx = _prepare(q, k, v, g_f, live)
    q, k, v = _aligned(q, k, v)
    o, lse = _fwd_outputs(q)
    _fwd_call(q, k, v, g_f, idx, o, lse, n_disp, causal=causal,
              window=window)
    flash_fwd.launches += 1
    return o, lse


def _fwd_call(q, k, v, g_f, idx, o, lse, n_disp, *, causal: bool,
              window: int):
    """The forward kernel on buffers ``flash_fwd`` checked and allocated;
    uncounted."""
    lib = _fwd_lib()
    S, hd = q.shape[2:]
    n_slices = n_disp if idx is None else idx.numel()
    (tiles,) = _counter_slots("fwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.d2ft_attn_fwd_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g_f.data_ptr(),
            None if idx is None else idx.data_ptr(), o.data_ptr(),
            lse.data_ptr(), tiles, n_disp, n_slices, S, hd, int(causal),
            int(window), 1.0 / hd ** 0.5, stream)
    if err != 0:
        raise RuntimeError("d2ft attention forward launch failed: "
                           + lib.d2ft_attn_fwd_error_string(err).decode())


flash_fwd.launches = 0


def flash_bwd(q, k, v, g_b, o, lse, do, *, causal: bool, window: int = 0,
              live=None):
    """Launch the backward (the delta kernel, then the dQ and dK/dV roles
    in one launch; one launcher call counted in ``flash_bwd.launches``).
    Arguments as ``flash_fwd`` plus the forward's o and lse and the
    cotangent do; ``live`` bounds the g_b != 0 slice count. Returns (dq,
    dk, dv), exact zeros on g_b == 0 slices."""
    S, hd, n_disp, idx = _prepare(
        q, k, v, g_b, live, (("o", o), ("lse", lse), ("do", do)))
    if o.shape != q.shape or do.shape != q.shape or \
            lse.shape != q.shape[:3]:
        raise ValueError("o, do must be [B, H, S, hd] and lse [B, H, S]")
    q, k, v, o, do = _aligned(q, k, v, o, do)
    alloc = torch.empty_like if idx is None else torch.zeros_like
    grads = alloc(q), alloc(k), alloc(v)
    delta = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    _bwd_call(q, k, v, o, do, lse, g_b, idx, *grads, delta, n_disp,
              causal=causal, window=window)
    flash_bwd.launches += 1
    return grads


def _bwd_call(q, k, v, o, do, lse, g_b, idx, dq, dk, dv, delta, n_disp, *,
              causal: bool, window: int):
    """The backward kernels on buffers ``flash_bwd`` checked and allocated
    (dq, dk, dv zero-filled where idx compacts the slices); uncounted."""
    lib = _bwd_lib()
    S, hd = q.shape[2:]
    t_dkdv, t_dq = _counter_slots("bwd_dkdv", "bwd_dq")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.d2ft_attn_bwd_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), g_b.data_ptr(),
            None if idx is None else idx.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), delta.data_ptr(), t_dkdv, t_dq,
            n_disp, S, hd, int(causal), int(window), 1.0 / hd ** 0.5, stream)
    if err != 0:
        raise RuntimeError("d2ft attention backward launch failed: "
                           + lib.d2ft_attn_bwd_error_string(err).decode())


flash_bwd.launches = 0


# =============================================================== autograd
class _GatedFlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, g_f, g_b, causal, window, live_fwd, live_bwd):
        o, lse = flash_fwd(q, k, v, g_f, causal=causal, window=window,
                           live=live_fwd)
        ctx.save_for_backward(q, k, v, g_b, o, lse)
        ctx.args = (causal, window, live_bwd)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, g_b, o, lse = ctx.saved_tensors
        causal, window, live_bwd = ctx.args
        dq, dk, dv = flash_bwd(q, k, v, g_b, o, lse, do.contiguous(),
                               causal=causal, window=window, live=live_bwd)
        return dq, dk, dv, None, None, None, None, None, None


def gated_flash_attention(q, k, v, g_f, g_b, *, causal: bool, window: int = 0,
                          live_fwd=None, live_bwd=None):
    """Differentiable gated attention core. q, k, v: [B, H, S, hd] (kv heads
    expanded); g_f, g_b: [B, H] float {0, 1} with g_b <= g_f. The forward is
    g_f-gated; the backward computes dq/dk/dv only where g_b != 0 and gives
    exact zeros elsewhere; gates get no gradient. ``live_fwd`` /
    ``live_bwd`` are upper bounds on the g_f != 0 / g_b != 0 slice counts
    (None dispatches every slice).

    Only shapes are checked, so the model path pays no host sync; the value
    contracts are ``kernels.ops.gated_attention``'s, or the caller's (the
    fine-tune checks its schedule's gates on the host). CPU tensors take
    the plain version, CUDA tensors the kernels."""
    B, H = q.shape[:2]
    if tuple(g_f.shape) != (B, H) or tuple(g_b.shape) != (B, H):
        raise ValueError(f"gates must be [B={B}, H={H}], got "
                         f"{tuple(g_f.shape)} / {tuple(g_b.shape)}")
    if q.device.type == "cpu":
        return gated_attention_ref(q, k, v, g_f, g_b, causal=causal,
                                   window=window)
    return _GatedFlashAttention.apply(q, k, v, g_f, g_b, causal, window,
                                      live_fwd, live_bwd)
