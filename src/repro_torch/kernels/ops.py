"""Public kernel entries with the JAX package's argument checks (port of the
``gated_attention``, ``gated_ssd_scan`` and ``paged_decode_attention``
entries of ``repro/kernels/ops.py``).

Each entry dispatches on where its tensors lie: CPU tensors go to the
kernel's plain PyTorch version, CUDA tensors to the hand-written kernel,
which raises rather than fall back when it cannot run.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import d2ft_ssd
from repro_torch.kernels.d2ft_attention import gated_flash_attention
from repro_torch.kernels.paged_decode import (paged_decode_ref,
                                              paged_flash_decode)


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

    The page-id range check reads the table on the host, which costs one
    device synchronisation per call on CUDA tensors.
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
    if g_f is None:
        g_f = torch.ones((B, H), dtype=torch.float32, device=q.device)
    elif tuple(g_f.shape) != (B, H):
        raise ValueError(f"g_f must be [B={B}, H={H}], got "
                         f"{tuple(g_f.shape)}")
    n_pages = k_pages.shape[0]
    lo, hi = torch.stack(torch.aminmax(page_table)).tolist()
    if lo < 0 or hi >= n_pages:
        raise ValueError(
            f"page_table entries must be valid page ids in [0, "
            f"{n_pages}): got range [{lo}, {hi}]")
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
    call site serves both packages. The CUDA kernels' tiles are fixed
    (``d2ft_attention.KERNEL_BLOCK``) and they mask odd lengths themselves,
    and the plain version has no tiles, so neither is read here.

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


def _padded_scan(scan, x, da, Bm, Cm, *args, chunk: int, **kw):
    """``scan(x, da, Bm, Cm, *args, chunk=Q, **kw)`` on operands zero-padded
    to a chunk multiple (``_scan_pad``), sliced back to S."""
    S = x.shape[1]
    Q, Sp = _scan_pad(S, chunk)
    if Sp != S:
        pad = Sp - S
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        da = F.pad(da, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    y = scan(x, da, Bm, Cm, *args, chunk=Q, **kw)
    return y[:, :S] if Sp != S else y


def _gated_ssd_impl(x, da, Bm, Cm, g_f, g_b, *, chunk: int, live_fwd=None,
                    live_bwd=None, plain: bool = False):
    """Pad, scan, slice back; no value checks, so the model path
    (``models/ssm.apply_ssd``) pays no host sync per layer. ``plain`` takes
    the plain version on any device (the model's masked path), else CPU
    tensors take the plain version and CUDA tensors the kernels."""
    if plain:
        return _padded_scan(d2ft_ssd.gated_ssd_ref, x, da, Bm, Cm, g_f, g_b,
                            chunk=chunk)
    return _padded_scan(d2ft_ssd.gated_ssd_scan, x, da, Bm, Cm, g_f, g_b,
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
