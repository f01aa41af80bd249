"""Public kernel entries with the JAX package's argument checks (port of the
``paged_decode_attention`` entry of ``repro/kernels/ops.py``).

Each entry dispatches on where its tensors lie: CPU tensors go to the
kernel's plain PyTorch version, CUDA tensors to the hand-written kernel,
which raises rather than fall back when it cannot run.
"""
from __future__ import annotations

import torch

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
