"""Paged decode: one fused step over the active serving batch (port of
``repro/serving/paged_decode.py``).

The continuous-batching engine (serving/engine.py) keeps attention K/V in
fixed-size *pages* owned by a ``PageManager`` (serving/pages.py). This
module is the device side:

* ``init_paged_pools`` — per-layer state, one entry per layer: attention
  layers get K/V page pools ``[n_pages, page_size, n_kv, hd]`` shared by
  every sequence; recurrent layers (SSD / RG-LRU) keep the ordinary dense
  per-slot decode state ``[max_slots, ...]``, since their cache is O(1)
  per sequence.
* ``paged_decode_step`` — one step for the whole slot batch: embed the
  incoming token per slot, write this step's K/V into each sequence's
  current page via its page table, attend over the paged history, advance
  the recurrent state of every slot, run the dense or MoE FFN, and return
  next-token logits.

Two attention paths:
* the gather reference (default): index the pools with the page table,
  reshape to a contiguous [B, n_pmax * page_size, ...] view, masked SDPA.
* ``use_kernel=True`` routes the paged flash-decode entry of
  ``kernels/ops.py`` — on CUDA tensors the hand-written kernel, which
  reads K/V rows by page id with no gathered copy of the history. The
  table's page ids are checked once a step (``ops.check_page_ids``), not
  once a layer: the engine checks its host copy and says so with
  ``tables_checked``.

Unlike the JAX package, which returns new pools, the port updates the
pools in place (``_write_kv``, the recurrent state's ``copy_``,
``dump_prefill_to_pools``) and returns the same objects: a decode step
then moves no pool bytes besides the new rows and states.

Layout/semantics contract (shared with the kernel and the engine):
* ``page_table``: [max_slots, n_pmax] int32. Row b lists the page ids
  holding slot b's history in order; unused entries are 0, the reserved
  *null page* that absorbs inactive-slot writes and is never allocated.
* ``lengths``: [max_slots] int32 = tokens already cached for the slot. The
  incoming token takes position ``lengths[b]`` (its page must already be
  allocated — the engine reserves the worst case at admission).
* Local-window layers keep their full history in pages like global ones
  and enforce the window by masking positions ``<= t - window``.
* Recurrent state of an inactive slot is garbage that admission
  overwrites (``dump_prefill_to_pools`` writes row ``slot``).
"""
from __future__ import annotations

from typing import Dict, List

import torch

from repro_torch.configs.base import (ATTN_GLOBAL, ATTN_LOCAL, RGLRU, SSD,
                                      ModelConfig)
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import attention as attn
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (apply_embedding, apply_norm,
                                       apply_rope, torch_dtype)
from repro_torch.models.transformer import (Transformer, decode_ffn,
                                            decode_recurrent,
                                            logits_from_hidden)

Pools = List[Dict[str, torch.Tensor]]


# ----------------------------------------------------------------- pool init
def init_paged_pools(cfg: ModelConfig, n_pages: int, page_size: int,
                     max_slots: int, *, device) -> Pools:
    """Per-layer device state, flat list of length n_layers.

    Attention layers: ``{"k","v"}: [n_pages, page_size, n_kv, hd]`` zeros —
    page 0 is the null page (write sink for inactive slots, table padding).
    SSD / RG-LRU layers: the ordinary dense decode cache at batch
    ``max_slots`` (their per-sequence state is O(1), nothing to page)."""
    dtype = torch_dtype(cfg.compute_dtype)
    pools: Pools = []
    for kind in cfg.layer_kinds:
        if kind in (ATTN_GLOBAL, ATTN_LOCAL):
            shape = (n_pages, page_size, cfg.n_kv_heads,
                     cfg.resolved_head_dim)
            pools.append({"k": torch.zeros(shape, dtype=dtype, device=device),
                          "v": torch.zeros(shape, dtype=dtype,
                                           device=device)})
        elif kind == SSD:
            pools.append(ssm_mod.init_ssd_cache(max_slots, cfg.d_model,
                                                cfg.ssm, dtype,
                                                device=device))
        elif kind == RGLRU:
            pools.append(rglru_mod.init_rglru_cache(max_slots, cfg.d_model,
                                                    cfg.rglru, dtype,
                                                    device=device))
        else:
            raise ValueError(kind)
    return pools


# ------------------------------------------------------- reference attention
def paged_attention_ref(q, k_pages, v_pages, page_table, lengths, *,
                        window: int = 0):
    """Gather-based paged attention.

    q: [B, 1, H, hd] (post-rope); pools: [n_pages, page_size, n_kv, hd];
    page_table: [B, n_pmax] int32; lengths: [B] int32 — the query token sits
    at position ``lengths[b]`` and its K/V is already written. Attends over
    positions <= lengths[b] (window-masked for local layers).
    Returns [B, 1, H, hd]."""
    B = q.shape[0]
    n_pmax = page_table.shape[1]
    ps = k_pages.shape[1]
    idx = page_table.long()
    # [B, n_pmax, ps, n_kv, hd] -> contiguous-history view [B, L, n_kv, hd]
    keys = k_pages[idx].reshape(B, n_pmax * ps, *k_pages.shape[2:])
    vals = v_pages[idx].reshape(B, n_pmax * ps, *v_pages.shape[2:])
    pos = torch.arange(n_pmax * ps, device=q.device)[None, :]
    t = lengths.long()[:, None]
    valid = pos <= t
    if window and window > 0:
        valid &= pos > t - window
    return attn._sdpa(q, keys, vals, valid[:, None, None, :])


# ------------------------------------------------------------ the fused step
def _write_kv(pool, kv, page_table, lengths, page_size: int):
    """Write this step's per-slot K (or V) [B, 1, n_kv, hd] into each
    slot's current page, in place. Inactive slots (table row all-null)
    write into page 0, the designated sink. Slots that write the same row
    (inactive ones, at length 0) all write the last such slot's values, so
    the row does not depend on the order in which a device orders
    duplicate writes (the JAX package's scatter on the CPU keeps the last
    one); their values differ under an MoE FFN, whose capacity couples
    rows."""
    B = kv.shape[0]
    rows = torch.arange(B, device=kv.device)
    t = lengths.long()
    pidx = page_table.long()[rows, t // page_size]
    off = t % page_size
    key = pidx * page_size + off
    last = torch.where(key[:, None] == key[None, :], rows[None, :],
                       -1).amax(dim=1)
    pool[pidx, off] = kv[last, 0]
    return pool


def paged_decode_step(model: Transformer, pools: Pools, cfg: ModelConfig,
                      token, page_table, lengths, *, page_size: int,
                      use_kernel: bool = False,
                      tables_checked: bool = False):
    """One decode step for the whole slot batch.

    token: [B, 1] int (B = max_slots); page_table: [B, n_pmax] int32;
    lengths: [B] int32 (see module docstring for the contract). Returns
    (logits [B, 1, vocab], pools) with the pools updated in place. Slots
    whose table row is all-null produce garbage logits the engine ignores.

    With ``use_kernel`` the table's page ids are checked here, once for the
    step (one device sync on CUDA), unless the caller has checked them
    (``tables_checked``: the engine checks its host copy); every layer then
    calls the unchecked kernel entry.
    """
    cdt = torch_dtype(cfg.compute_dtype)
    B = token.shape[0]
    attn_pools = [pl for pl, kind in zip(pools, cfg.layer_kinds)
                  if kind in (ATTN_GLOBAL, ATTN_LOCAL)]
    if use_kernel and attn_pools and not tables_checked:
        kernel_ops.check_page_ids(page_table, attn_pools[0]["k"].shape[0])
    x = apply_embedding(model.embed, token).to(cdt)
    pos = lengths.long()[:, None]                                # [B, 1]
    for i, kind in enumerate(cfg.layer_kinds):
        p = model.layers[i]
        h = apply_norm(p.norm1, x, cfg.norm)
        if kind not in (ATTN_GLOBAL, ATTN_LOCAL):
            x = decode_ffn(p, x + decode_recurrent(p, pools[i], h, kind, cfg),
                           cfg)
            continue
        window = cfg.window if kind == ATTN_LOCAL else 0
        hd = cfg.resolved_head_dim
        q, k, v = attn._project_qkv(p.attn, h, cfg.n_heads, cfg.n_kv_heads,
                                    hd)
        if cfg.rope:
            q = apply_rope(q, pos, cfg.rope_theta)
            k = apply_rope(k, pos, cfg.rope_theta)
        kp = _write_kv(pools[i]["k"], k, page_table, lengths, page_size)
        vp = _write_kv(pools[i]["v"], v, page_table, lengths, page_size)
        if use_kernel:
            out = kernel_ops._paged_decode_impl(q[:, 0], kp, vp, page_table,
                                                lengths,
                                                window=window)[:, None]
        else:
            out = paged_attention_ref(q, kp, vp, page_table, lengths,
                                      window=window)
        y = out.reshape(B, 1, cfg.n_heads * hd) @ p.attn.wo
        x = decode_ffn(p, x + y, cfg)
    return logits_from_hidden(model, cfg, x), pools


# --------------------------------------------------------- prefill page dump
def dump_prefill_to_pools(pools: Pools, cache, cfg: ModelConfig, slot: int,
                          pages: List[int], page_size: int, seq_len: int
                          ) -> Pools:
    """Write one sequence's prefill cache (``prefill_forward(...,
    raw_kv=True)`` output, batch 1) into the pools, in place: attention
    K/V into the given pages, zero-padding the last page's tail; recurrent
    state into row ``slot``. Returns the pools."""
    n = len(pages)
    if n * page_size < seq_len:
        raise ValueError(f"{n} pages of {page_size} cannot hold {seq_len} "
                         "tokens")
    for i, kind in enumerate(cfg.layer_kinds):
        if kind not in (ATTN_GLOBAL, ATTN_LOCAL):
            for name, state in cache[i].items():
                pools[i][name][slot].copy_(state[0])
            continue
        for name in ("k", "v"):
            full, pool = cache[i][name], pools[i][name]
            page_ids = torch.as_tensor(pages, dtype=torch.long,
                                       device=pool.device)
            # [S, n_kv, hd] -> [n, page_size, n_kv, hd], zero-padded tail
            chunks = torch.zeros((n * page_size,) + tuple(full.shape[2:]),
                                 dtype=pool.dtype, device=pool.device)
            chunks[:seq_len] = full[0]
            pool[page_ids] = chunks.reshape(n, page_size, *full.shape[2:])
    return pools
