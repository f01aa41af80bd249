"""Public kernel entries with the JAX package's argument checks (port of the
``gated_attention``, ``gated_ssd_scan``, ``gated_rglru_scan``,
``gated_moe_ffn``, ``paged_decode_attention`` and ``lora_linear`` entries
of ``repro/kernels/ops.py``).

Each entry dispatches on where its tensors lie: CPU tensors go to the
kernel's plain PyTorch version, CUDA tensors to the hand-written kernel,
which raises rather than fall back when it cannot run.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import d2ft_moe, d2ft_rglru, d2ft_ssd
from repro_torch.kernels.d2ft_attention import gated_flash_attention
from repro_torch.kernels.lora_matmul import lora_matmul, lora_matmul_ref
from repro_torch.kernels.paged_decode import (paged_decode_ref,
                                              paged_flash_decode)


def check_page_ids(page_table, n_pages: int) -> None:
    """The page-id range check of ``paged_decode_attention``: every table
    entry must be a valid page id in [0, n_pages), or a kernel would read
    outside the pools. A numpy table is read where it lies; a tensor's range
    is read on the host, one device synchronisation on CUDA. Counted in
    ``check_page_ids.calls``. The serving engine checks its host copy of
    the table once a decode step; a direct call of ``paged_decode_step``
    checks its table once a step; the entry below checks on every call."""
    check_page_ids.calls += 1
    if isinstance(page_table, np.ndarray):
        lo, hi = int(page_table.min()), int(page_table.max())
    else:
        lo, hi = torch.stack(torch.aminmax(page_table)).tolist()
    if lo < 0 or hi >= n_pages:
        raise ValueError(
            f"page_table entries must be valid page ids in [0, "
            f"{n_pages}): got range [{lo}, {hi}]")


check_page_ids.calls = 0


def paged_decode_attention(q, k_pages, v_pages, page_table, lengths,
                           g_f=None, *, window: int = 0):
    """One token per sequence against a paged KV cache.

    q: [B, H, hd] post-rope queries (position ``lengths[b]``); k_pages,
    v_pages: [n_pages, page_size, n_kv, hd] shared pools (GQA un-expanded:
    head h reads kv head ``h // (H // n_kv)``); page_table: [B, n_pmax]
    int32, padded with the null page 0 (every entry must be a valid page
    id); lengths: [B] int32 tokens already cached. g_f: optional [B, H]
    forward gates — serving is schedule-free so the default is all-ones;
    gated-off heads write zeros. Returns [B, H, hd].

    The page-id range check (``check_page_ids``) reads the table on the
    host, which costs one device synchronisation per call on CUDA tensors;
    the decode step checks once a step and calls ``_paged_decode_impl``.
    """
    B, H, hd = q.shape
    if q.shape[-1] != k_pages.shape[-1]:
        raise ValueError(f"q head_dim {hd} != pool head_dim "
                         f"{k_pages.shape[-1]}")
    if k_pages.shape != v_pages.shape:
        raise ValueError(f"k/v pool shapes differ: {tuple(k_pages.shape)} vs "
                         f"{tuple(v_pages.shape)}")
    if page_table.shape[0] != B or tuple(lengths.shape) != (B,):
        raise ValueError(
            f"page_table/lengths batch mismatch: {tuple(page_table.shape)}, "
            f"{tuple(lengths.shape)}, B={B}")
    if g_f is not None and tuple(g_f.shape) != (B, H):
        raise ValueError(f"g_f must be [B={B}, H={H}], got "
                         f"{tuple(g_f.shape)}")
    check_page_ids(page_table, k_pages.shape[0])
    return _paged_decode_impl(q, k_pages, v_pages, page_table, lengths, g_f,
                              window=window)


def _paged_decode_impl(q, k_pages, v_pages, page_table, lengths, g_f=None,
                       *, window: int = 0):
    """``paged_decode_attention`` without its checks: the caller has
    checked the table's page ids (once a decode step, not once a layer).
    CPU tensors take the plain version, CUDA tensors the kernels."""
    if g_f is None:
        g_f = torch.ones(q.shape[:2], dtype=torch.float32, device=q.device)
    if q.device.type == "cpu":
        return paged_decode_ref(q, k_pages, v_pages, page_table, lengths,
                                g_f, window=window)
    return paged_flash_decode(q, k_pages, v_pages, page_table, lengths, g_f,
                              window=window)


def _validate_gates(g_f, g_b, B: int, H: int, live_fwd, live_bwd):
    """Shape check, then the two value contracts:

    * ``g_b <= g_f`` elementwise (a p_s head cannot run its backward);
    * ``live_fwd`` / ``live_bwd`` are true upper bounds on the live gate
      counts: an undersized bound would drop live slices from the
      compaction and zero their outputs or gradients.

    The JAX package checks the values only where the gates are concrete;
    here they always are, and reading CUDA gates costs one device
    synchronisation. So this runs on a direct call of ``gated_attention``
    and on the fine-tune's host-side gates, never per layer on the model
    path (which calls ``d2ft_attention.gated_flash_attention``)."""
    if tuple(g_f.shape) != (B, H) or tuple(g_b.shape) != (B, H):
        raise ValueError(f"gates must be [B={B}, H={H}], got "
                         f"{tuple(g_f.shape)} / {tuple(g_b.shape)}")
    cf, cb = g_f.detach().cpu().numpy(), g_b.detach().cpu().numpy()
    if (cb > cf).any():
        bad = np.argwhere(cb > cf)
        raise ValueError(
            "g_b <= g_f violated (a gated-off forward cannot have a live "
            f"backward): g_b > g_f at (sample, head) {bad[:8].tolist()}"
            f"{' ...' if len(bad) > 8 else ''}")
    for name, bound, live in (("live_fwd", live_fwd, int((cf != 0).sum())),
                              ("live_bwd", live_bwd, int((cb != 0).sum()))):
        if bound is not None and bound < live:
            raise ValueError(
                f"{name}={bound} is below the live gate count {live}: the "
                "compaction bound must be an upper bound or live slices "
                "would be silently dropped (did you forget the H//G "
                "heads-per-group scaling?)")


def gated_attention(q, k, v, g_f, g_b=None, *, causal: bool = True,
                    window: int = 0, block_q: int = 128, block_k: int = 128,
                    live_fwd: Optional[int] = None,
                    live_bwd: Optional[int] = None):
    """D2FT-gated flash attention with a gate-aware backward.

    q, k, v: [B, H, S, hd]; g_f, g_b: [B, H] float {0,1} with g_b <= g_f
    (checked). g_f gates the forward (0 -> zeros, no forward work: p_s);
    g_b gates the backward (0 -> zero dq/dk/dv, no backward work: p_o and
    p_s). Omitting g_b uses g_b = g_f, the fully differentiable p_f path.

    live_fwd / live_bwd: optional upper bounds on the number of g_f != 0 /
    g_b != 0 (sample, head) slices (``core.schedule.live_slice_bounds``
    scaled by heads per group). With them the kernels launch that many
    slice blocks, each reading its slice id from a compaction table; the
    rest come out as exact zeros. None dispatches all B*H slices.

    block_q, block_k: the JAX package's TPU tile request, accepted so one
    call site serves both packages. The CUDA kernels' tiles are fixed per
    head_dim and kernel (``d2ft_attention.kernel_block(hd, kind)``: square
    in the forward, 64 resident rows against 64 or, at hd 256, 32 walked
    rows in the backward) and they mask odd lengths themselves, and the
    plain version has no tiles, so neither is read here.

    CPU tensors take the plain version, CUDA tensors the kernels.
    """
    if g_b is None:
        g_b = g_f
    B, H, S, _ = q.shape
    _validate_gates(g_f, g_b, B, H, live_fwd, live_bwd)
    return gated_flash_attention(q, k, v, g_f, g_b, causal=causal,
                                 window=window, live_fwd=live_fwd,
                                 live_bwd=live_bwd)


# ------------------------------------------------------------- gated SSD
def _scan_pad(S: int, chunk: int):
    """(Q, Sp): the chunk size actually used and the padded length. A scan
    cannot shrink its chunk the way attention shrinks its tiles (the chunk
    is the recurrence granularity), so odd lengths zero-pad up to the next
    chunk multiple: a padded row has zero log-decay (identity state update)
    and zero input."""
    Q = min(chunk, S)
    return Q, -(-S // Q) * Q


def _padded_scan(scan, operands, *args, chunk: int, **kw):
    """``scan(*operands, *args, chunk=Q, **kw)`` on operands zero-padded
    along their sequence dimension (dim 1) to a chunk multiple
    (``_scan_pad``), the output sliced back to S (the first of a tuple
    output; the others, such as a final state, pass through)."""
    S = operands[0].shape[1]
    Q, Sp = _scan_pad(S, chunk)
    if Sp != S:
        operands = [F.pad(t, (0, 0) * (t.dim() - 2) + (0, Sp - S))
                    for t in operands]
    y = scan(*operands, *args, chunk=Q, **kw)
    if Sp == S:
        return y
    if isinstance(y, tuple):            # (y, extras): only y has the S axis
        return (y[0][:, :S],) + tuple(y[1:])
    return y[:, :S]


def _gated_ssd_impl(x, da, Bm, Cm, g_f, g_b, *, chunk: int, live_fwd=None,
                    live_bwd=None, plain: bool = False):
    """Pad, scan, slice back; no value checks, so the model path
    (``models/ssm.apply_ssd``) pays no host sync per layer. ``plain`` takes
    the plain version on any device (the model's masked path), else CPU
    tensors take the plain version and CUDA tensors the kernels."""
    if plain:
        return _padded_scan(d2ft_ssd.gated_ssd_ref, (x, da, Bm, Cm), g_f,
                            g_b, chunk=chunk)
    return _padded_scan(d2ft_ssd.gated_ssd_scan, (x, da, Bm, Cm), g_f, g_b,
                        chunk=chunk, live_fwd=live_fwd, live_bwd=live_bwd)


def gated_ssd_scan(x, da, Bm, Cm, g_f, g_b=None, *, chunk: int,
                   live_fwd: Optional[int] = None,
                   live_bwd: Optional[int] = None):
    """D2FT-gated SSD chunked scan with a gate-aware backward.

    x: [B,S,H,P] dt-weighted input, da: [B,S,H] per-step log-decay
    (``dt * A``), Bm/Cm: [B,S,N] (shared across heads); g_f, g_b: [B,H]
    float {0,1} with g_b <= g_f (checked) — g_f == 0 heads produce zeros
    and run no forward work (p_s), g_b == 0 heads run no backward work and
    get zero dx/ddA/dB/dC (p_o and p_s). Omitting g_b uses g_b = g_f.
    live_fwd / live_bwd are upper bounds on the live slice counts
    (``core.schedule.live_slice_bounds`` scaled by heads per group). S that
    is not a chunk multiple is zero-padded and sliced back.

    CPU tensors take the plain version, CUDA tensors the kernels.
    """
    if g_b is None:
        g_b = g_f
    B, S, H, P = x.shape
    _validate_gates(g_f, g_b, B, H, live_fwd, live_bwd)
    return _gated_ssd_impl(x, da, Bm, Cm, g_f, g_b, chunk=chunk,
                           live_fwd=live_fwd, live_bwd=live_bwd)


# ----------------------------------------------------------- gated RG-LRU
def _gated_rglru_impl(la, b, g_f, g_b, *, chunk: int, live_fwd=None,
                      live_bwd=None, plain: bool = False):
    """Pad, scan, slice back; no value checks, so the model path
    (``models/rglru.apply_rglru``) pays no host sync per layer. ``plain``
    takes the plain version on any device (the model's masked path), else
    CPU tensors take the plain version and CUDA tensors the kernels."""
    if plain:
        return _padded_scan(d2ft_rglru.gated_rglru_ref, (la, b), g_f, g_b,
                            chunk=chunk)
    return _padded_scan(d2ft_rglru.gated_rglru_scan, (la, b), g_f, g_b,
                        chunk=chunk, live_fwd=live_fwd, live_bwd=live_bwd)


def gated_rglru_scan(la, b, g_f, g_b=None, *, chunk: int = 128,
                     live_fwd: Optional[int] = None,
                     live_bwd: Optional[int] = None):
    """D2FT-gated RG-LRU scan h_t = exp(la_t) h_{t-1} + b_t with a
    gate-aware backward.

    la, b: [B,S,W] (la <= 0); g_f, g_b: [B,G] float {0,1} with g_b <= g_f
    (checked) per (sample, channel group), W % G == 0 (checked in
    ``d2ft_rglru.gated_rglru_scan``) — the W channels split into G
    contiguous bands gating independently. Returns h [B,S,W]
    float32 with g_f-dead bands exactly zero; g_b-dead bands get zero
    dla/db and run no backward work. Omitting g_b uses g_b = g_f.
    live_fwd / live_bwd are upper bounds on the live (sample, band) slice
    counts (``core.schedule.live_slice_bounds``, unscaled: the slice axis
    is B·G). S that is not a chunk multiple is zero-padded (identity
    decay) and sliced back.

    CPU tensors take the plain version, CUDA tensors the kernels.
    """
    if g_b is None:
        g_b = g_f
    _validate_gates(g_f, g_b, la.shape[0], g_f.shape[1], live_fwd, live_bwd)
    return _gated_rglru_impl(la, b, g_f, g_b, chunk=chunk,
                             live_fwd=live_fwd, live_bwd=live_bwd)


# ------------------------------------------------------------ gated MoE FFN
def _gated_moe_impl(xb, w_up, w_gate, w_down, fwd_slots, bwd_slots, *,
                    act: str, block_c: int, live_slots=None,
                    live_bwd_slots=None):
    """The slot -> block reduction, the capacity pad and the two
    truncations, then ``d2ft_moe.gated_moe_ffn``; no value checks, so the
    model path (``models/moe.apply_moe``) pays no host sync per layer.

    bc = min(block_c, C); C pads to a multiple of bc. The forward grid
    stops at ceil(live_slots / bc) blocks: trailing blocks past the
    schedule's live-slot bound are provably empty, so they are neither
    launched nor read. The backward stops at ceil(live_bwd_slots / bc),
    on its own: the dispatch packs backward-live slots into a capacity
    prefix per expert, so a g_b < g_f mix shrinks the backward grid below
    the forward's."""
    E, C, D = xb.shape
    bc = min(block_c, C)
    Cp = -(-C // bc) * bc
    n_cb = Cp // bc
    if live_slots is not None and live_slots < Cp:
        n_cb = min(n_cb, -(-max(1, int(live_slots)) // bc))
    n_cb_b = n_cb
    if live_bwd_slots is not None:
        n_cb_b = min(n_cb, -(-max(1, int(live_bwd_slots)) // bc))
    Cr = n_cb * bc

    def fit(t):
        """[E, C, ...] padded or cut to Cr rows."""
        if Cr > C:
            return F.pad(t, (0, 0) * (t.dim() - 2) + (0, Cr - C))
        return t[:, :Cr]

    xs = fit(xb)
    fm = (fit(fwd_slots).reshape(E, n_cb, bc).sum(-1) > 0).float()
    bm = (fit(bwd_slots).reshape(E, n_cb, bc).sum(-1) > 0).float()
    y = d2ft_moe.gated_moe_ffn(xs, w_up, w_gate, w_down, fm, bm, act=act,
                               block_c=bc, bwd_blocks=n_cb_b)
    if Cr < C:
        y = F.pad(y, (0, 0, 0, C - Cr))
    return y[:, :C]


def _top_slot(slots) -> int:
    """One past the highest occupied slot of an [E, C] mask (0 if none)."""
    occupied = np.argwhere(slots != 0)
    return int(occupied[:, 1].max()) + 1 if occupied.size else 0


def gated_moe_ffn(xb, w_up, w_gate, w_down, fwd_slots, bwd_slots=None, *,
                  act: str = "silu", block_c: int = 128,
                  live_slots: Optional[int] = None,
                  live_bwd_slots: Optional[int] = None):
    """Doubly-sparse MoE expert FFN over a capacity buffer, with a
    gate-aware backward.

    xb: [E, C, D] front-packed capacity buffer (see ``models/moe.py``'s
    gate-aware dispatch), w_up / w_gate: [E, D, F], w_down: [E, F, D];
    fwd_slots / bwd_slots: [E, C] float {0, 1} slot-occupancy masks with
    bwd <= fwd elementwise (checked). Slots group into capacity blocks of
    ``block_c``; a block computes only when it holds a live slot.
    ``live_slots`` bounds the live slots per expert (schedule live-sample
    bound x top_k): blocks past it are not launched. ``live_bwd_slots``
    bounds the backward-live slots apart (g_b bound x top_k); omitting it
    shares the forward's bound. Both must cover the highest occupied slot
    of their mask (checked), or live outputs or gradients would be zeroed.
    Omitting bwd_slots uses bwd = fwd.

    The value checks read the masks on the host (a device synchronisation
    for CUDA tensors), so they run on a direct call only; the model path
    calls ``_gated_moe_impl``. CPU tensors take the plain version, CUDA
    tensors the kernels.
    """
    if bwd_slots is None:
        bwd_slots = fwd_slots
    E, C, D = xb.shape
    if tuple(fwd_slots.shape) != (E, C) or tuple(bwd_slots.shape) != (E, C):
        raise ValueError(
            f"slot masks must be [E={E}, C={C}], got "
            f"{tuple(fwd_slots.shape)} / {tuple(bwd_slots.shape)}")
    cf = fwd_slots.detach().cpu().numpy()
    cb = bwd_slots.detach().cpu().numpy()
    if np.any(cb > cf):
        raise ValueError("bwd_slots <= fwd_slots violated: a slot with no "
                         "live forward cannot have a live backward")
    top = _top_slot(cf)
    if live_slots is not None and live_slots < top:
        raise ValueError(
            f"live_slots={live_slots} is below the highest occupied slot "
            f"{top}: the capacity-truncation bound must cover every live "
            "slot or their outputs would be zeroed")
    top_b = _top_slot(cb)
    if live_bwd_slots is not None and live_bwd_slots < top_b:
        raise ValueError(
            f"live_bwd_slots={live_bwd_slots} is below the highest occupied "
            f"backward slot {top_b}: the backward truncation bound must "
            "cover every backward-live slot or their gradients would be "
            "zeroed")
    return _gated_moe_impl(xb, w_up, w_gate, w_down, fwd_slots, bwd_slots,
                           act=act, block_c=block_c, live_slots=live_slots,
                           live_bwd_slots=live_bwd_slots)


# ------------------------------------------------------------- fused LoRA
def lora_linear(x, w, a, b, scale: float = 1.0):
    """Fused y = x·W + scale·(x·A)·B for 2-D [M, K] or 3-D [B, S, K] x; w
    [K, N], a [K, r], b [r, N]. Forward only, like the JAX op: tensors that
    require grad are refused, never detached here (pass ``.detach()``
    explicitly). CPU tensors take the plain version, CUDA tensors the
    kernel."""
    if x.ndim not in (2, 3):
        raise ValueError(f"x must be 2-D or 3-D, got {tuple(x.shape)}")
    for name, t in (("x", x), ("w", w), ("a", a), ("b", b)):
        if t.requires_grad:
            raise ValueError(f"{name} requires grad, but lora_linear is "
                             "forward only")
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    if x.device.type == "cpu":
        y = lora_matmul_ref(x2, w, a, b, scale)
    else:
        y = lora_matmul(x2.contiguous(), w, a, b, scale)
    return y.reshape(*shape[:-1], w.shape[-1])
