"""D2FT orchestration (port of ``repro/core/d2ft.py``): planning and the
packed execution path.

``plan_schedule``: scores -> bi-level knapsack -> Schedule (host side,
numpy). The masked and kernel paths consume it through
``core.schedule.gates_from_schedule``.

``packed_*``: the deployment path. Each head group gathers the samples
(``packed_forward``, plan from ``core.schedule.packed_indices``) or the
micro-batches (``packed_forward_mb``, plan from ``mb_packed_indices``) its
subnet runs, computes its slice of the block on them, and scatter-adds
the contribution back. The groups' products are batched matmuls
([G, C*S, D] @ [G, D, X]) and their attention is the plain
``models.attention.dense_attention`` with the groups folded into the
batch: the reference runs this path outside any Pallas kernel, so no CUDA
kernel is on it. The plan stays numpy on the host; its sizes (C, n_pf)
are Python ints, and idx / bwd / val cross to the device once a forward.

Differences from the reference, on purpose:

- ``_fo_combine`` keeps the masked path's semantics on every table: a
  p_o micro-batch among the first n_pf columns gets no gradient (the
  reference gives it one where the table is unbalanced);
- the blocks raise ``ValueError`` on what the reference would drop
  without a word: an MoE FFN and biased q / k / v projections;
- gather and scatter add the groups' contributions group by group, in a
  fixed order, so two calls agree bitwise on the card.

The reference's ``_mb_gather`` / ``_mb_scatter`` are the ``_Gather`` /
``_Scatter`` pair here, which the per-sample blocks share; its
``_split_fo`` is the column split inside ``_fo_combine``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import (ATTN_GLOBAL, ATTN_LOCAL, D2FTConfig,
                                      ModelConfig)
from repro_torch.core import knapsack
from repro_torch.core.schedule import P_F, P_O, P_S, Schedule, merge_tables
from repro_torch.models import attention as attn
from repro_torch.models.layers import (_act, apply_embedding, apply_norm,
                                       apply_rope, torch_dtype)
from repro_torch.models.transformer import (Transformer, _not_ported_dist,
                                            logits_from_hidden)


def capacities(d2ft: D2FTConfig) -> Tuple[float, float]:
    """Per-device knapsack capacities from the micro-batch budget."""
    cap_pf = d2ft.n_pf * (d2ft.cost_fwd + d2ft.cost_bwd)
    cap_po = d2ft.n_po * d2ft.cost_fwd
    return cap_pf, cap_po


def plan_schedule(d2ft: D2FTConfig, backward_scores: np.ndarray,
                  forward_scores: np.ndarray, n_layers: int, n_groups: int,
                  cap_pf=None, cap_po=None, exclusive_po: bool = True
                  ) -> Schedule:
    """Bi-level knapsack over every subnet (Alg. 1).

    exclusive_po: zero out p_f-selected micro-batches' forward scores before
    the inner solve so the final table hits the (n_pf, n_po) budget exactly
    (the paper's experimental setups are described in those terms); with
    False the raw Alg. 1 overlap semantics apply (p_f wins conflicts).
    """
    c_f, c_b = d2ft.cost_fwd, d2ft.cost_bwd
    dflt_pf, dflt_po = capacities(d2ft)
    cap_pf = dflt_pf if cap_pf is None else cap_pf
    cap_po = dflt_po if cap_po is None else cap_po
    K, N = backward_scores.shape
    cap_pf_arr = np.broadcast_to(np.asarray(cap_pf, np.float64), (K,))
    cap_po_arr = np.broadcast_to(np.asarray(cap_po, np.float64), (K,))
    sel_pf = np.zeros((K, N), bool)
    sel_po = np.zeros((K, N), bool)
    for k in range(K):
        sel_pf[k] = knapsack.dp_knapsack(
            backward_scores[k], np.full(N, c_f + c_b), cap_pf_arr[k])
        fwd = forward_scores[k].copy()
        if exclusive_po:
            fwd[sel_pf[k]] = 0.0
        sel_po[k] = knapsack.dp_knapsack(fwd, np.full(N, c_f), cap_po_arr[k])
    return Schedule(merge_tables(sel_pf, sel_po), n_layers, n_groups)


# ---------------------------------------------------------------- packed path
def _slice_cols(w, G):
    """[..., X] -> [G, ..., X/G] (contiguous group slices on the last dim;
    a view)."""
    return w.reshape(*w.shape[:-1], G, w.shape[-1] // G).movedim(-2, 0)


def _slice_rows(w, G):
    return w.reshape(G, w.shape[0] // G, *w.shape[1:])


def _kv_slices(p, G, n_kv, head_dim):
    """Per-group KV projection weights of ``p.wk`` / ``p.wv`` [D, n_kv*hd].
    Returns (wk_g, wv_g, kv_per_group), the weights [G, D, kv_pg*hd]."""
    if n_kv % G == 0:
        return _slice_cols(p.wk, G), _slice_cols(p.wv, G), n_kv // G
    if G % n_kv == 0:
        # each group uses exactly one kv head, group g head g // (G / n_kv):
        # a view for n_kv == 1, a copy otherwise
        def one_head(w):
            heads = w.reshape(w.shape[0], n_kv, head_dim).movedim(1, 0)
            return heads[:, None].expand(n_kv, G // n_kv, *heads.shape[1:]) \
                .reshape(G, *heads.shape[1:])
        return one_head(p.wk), one_head(p.wv), 1
    # fallback: replicate the full kv projection per group
    return (p.wk.expand(G, *p.wk.shape), p.wv.expand(G, *p.wv.shape), n_kv)


def _add_groups(vals, idx, n):
    """Adds vals [G, C, ...] into row idx[g, c] of a zero [n, ...] tensor,
    one group after another (a group's valid indices are distinct; its
    padding entries point at row 0 and carry zeros), so the sum's order is
    fixed. ``index_add_`` over all groups at once adds in the order of the
    card's atomics."""
    y = vals.new_zeros((n,) + tuple(vals.shape[2:]))
    for g in range(idx.shape[0]):
        y.index_add_(0, idx[g], vals[g])
    return y


def _take_groups(x, idx):
    """x[idx]: [n, ...] -> [G, C, ...]."""
    return x.index_select(0, idx.reshape(-1)).reshape(
        *idx.shape, *x.shape[1:])


class _Gather(torch.autograd.Function):
    """x[idx] whose backward adds the groups' cotangents in a fixed order
    (``_add_groups``)."""

    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        ctx.n = x.shape[0]
        return _take_groups(x, idx)

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        return _add_groups(g, idx, ctx.n), None


class _Scatter(torch.autograd.Function):
    """``_add_groups``, whose backward is the gather."""

    @staticmethod
    def forward(ctx, vals, idx, n):
        ctx.save_for_backward(idx)
        return _add_groups(vals, idx, n)

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        return _take_groups(g, idx), None, None


def _mix(out, bwd, val):
    """The masked path's gate mix on gathered contributions [G, C, ...]:
    val * (bwd * out + (1 - bwd) * out.detach()); bwd None: val * out."""
    shape = val.shape + (1,) * (out.ndim - 2)
    m_v = val.reshape(shape).to(out.dtype)
    if bwd is None:
        return out * m_v
    m_b = bwd.reshape(shape).to(out.dtype)
    return m_v * (m_b * out + (1 - m_b) * out.detach())


def _group_attention(hg, p, cfg: ModelConfig, kind: str):
    """hg [G, R, S, D]: each group's R gathered rows of normed hidden
    states -> its attention contributions [G, R, S, D]: the group's query
    heads and its slice of wo, attention over the R rows folded into the
    batch ([G*R, S, H/G, hd])."""
    if hasattr(p, "bq"):
        raise ValueError("the packed path computes no q / k / v biases (the "
                         "reference drops them): use the masked path")
    G, R, S, D = hg.shape
    H, hd = cfg.n_heads, cfg.resolved_head_dim
    if H % G:
        raise ValueError(f"{H} heads do not split into {G} groups")
    wk, wv, kv_pg = _kv_slices(p, G, cfg.n_kv_heads, hd)
    h2 = hg.reshape(G, R * S, D)
    q = torch.matmul(h2, _slice_cols(p.wq, G)).reshape(G * R, S, H // G, hd)
    k = torch.matmul(h2, wk).reshape(G * R, S, kv_pg, hd)
    v = torch.matmul(h2, wv).reshape(G * R, S, kv_pg, hd)
    if cfg.rope:
        pos = torch.arange(S, device=hg.device)[None, :]
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    window = cfg.window if kind == ATTN_LOCAL else 0
    o = attn.dense_attention(q, k, v, causal=cfg.causal, window=window)
    out = torch.matmul(o.reshape(G, R * S, (H // G) * hd),
                       _slice_rows(p.wo, G))
    return out.reshape(G, R, S, D)


def _group_mlp(hg, blk, cfg: ModelConfig):
    """The dense FFN's group slices (columns of w_up / w_gate, rows of
    w_down) on each group's gathered rows: [G, R, S, D] -> [G, R, S, D]."""
    if not hasattr(blk, "mlp"):
        raise ValueError("the packed path has no MoE FFN (the reference "
                         "skips it): use the masked or kernel path")
    G, R, S, D = hg.shape
    mlp = blk.mlp
    h2 = hg.reshape(G, R * S, D)
    up = torch.matmul(h2, _slice_cols(mlp.w_up, G))
    if hasattr(mlp, "w_gate"):
        hid = _act(cfg.mlp_act)(torch.matmul(h2, _slice_cols(mlp.w_gate,
                                                             G))) * up
    else:
        hid = _act(cfg.mlp_act)(up)
    return torch.matmul(hid, _slice_rows(mlp.w_down, G)).reshape(G, R, S, D)


def packed_attention_block(p, x, cfg: ModelConfig, idx, bwd, val,
                           kind: str = ATTN_GLOBAL):
    """Packed D2FT attention sub-block of block ``p``.

    x: [B,S,D] residual stream; idx/bwd/val: [G,C] gather indices, backward
    mask (1 = p_f), validity mask (0 = padding). Each head-group g computes
    attention only for its C selected samples.
    Returns the residual contribution [B,S,D].
    """
    h = apply_norm(p.norm1, x, cfg.norm)
    out = _group_attention(_Gather.apply(h, idx), p.attn, cfg, kind)
    return _Scatter.apply(_mix(out, bwd, val), idx, x.shape[0])


def packed_mlp_block(p, x, cfg: ModelConfig, idx, bwd, val):
    """Packed D2FT FFN sub-block (dense MLP). Same contract as above."""
    h = apply_norm(p.norm2, x, cfg.norm)
    out = _group_mlp(_Gather.apply(h, idx), p, cfg)
    return _Scatter.apply(_mix(out, bwd, val), idx, x.shape[0])


def mb_packed_indices(sched: Schedule, n_mb: int):
    """Micro-batch-level gather plan: for each (layer, group) the selected
    micro-batch ids (p_f first, then p_o), plus bwd/valid masks, all padded
    to the max count C_mb. The knapsack's balanced budget makes C_mb equal
    across subnets in the homogeneous case (paper Table I)."""
    t = sched.layer_group_view()                          # [L, G, N]
    L, G, N = t.shape
    if N != n_mb:
        raise ValueError(f"the schedule has {N} micro-batches, not {n_mb}")
    counts = (t != P_S).sum(-1)
    C = int(counts.max())
    idx = np.zeros((L, G, C), np.int32)
    bwd = np.zeros((L, G, C), np.float32)
    val = np.zeros((L, G, C), np.float32)
    for l in range(L):
        for g in range(G):
            f = np.nonzero(t[l, g] == P_F)[0]
            o = np.nonzero(t[l, g] == P_O)[0]
            take = np.concatenate([f, o])[:C]
            idx[l, g, :len(take)] = take
            bwd[l, g, :len(f)] = 1.0
            val[l, g, :len(take)] = 1.0
    return idx, bwd, val


def _fo_combine(run, h, idx, bwd, val, n_pf: int):
    """The p_f part (the first n_pf columns) runs with gradients, mixed by
    its bwd mask as the masked path mixes, so a p_o micro-batch there gets
    no gradient; the p_o part (the other columns) runs under no_grad, so no
    backward graph is built for it. Both add onto h's micro-batch axis.
    run(sub_idx) -> the groups' contributions [G, C_sub, B', S, D]."""
    M = h.shape[0]
    y = None
    if n_pf > 0:
        f = slice(None, n_pf)
        y = _Scatter.apply(_mix(run(idx[:, f]), bwd[:, f], val[:, f]),
                           idx[:, f], M)
    if idx.shape[1] > n_pf:
        o = slice(n_pf, None)
        with torch.no_grad():
            y_o = _add_groups(_mix(run(idx[:, o]), None, val[:, o]),
                              idx[:, o], M)
        y = y_o if y is None else y + y_o
    return torch.zeros_like(h) if y is None else y


def _mb_run(h, group_fn):
    """run(sub_idx) for ``_fo_combine``: gather the micro-batches of h [M,
    B', S, D], apply group_fn on [G, C_sub*B', S, D]."""
    def run(sub_idx):
        hg = _Gather.apply(h, sub_idx)                  # [G, C, B', S, D]
        G, C, Bp, S, D = hg.shape
        return group_fn(hg.reshape(G, C * Bp, S, D)).reshape(G, C, Bp, S, D)
    return run


def packed_attention_block_mb(p, x, cfg: ModelConfig, idx, bwd, val,
                              kind: str = ATTN_GLOBAL, *, n_pf: int):
    """Micro-batch-axis packed attention. x: [M, B', S, D]; idx/bwd/val:
    [G, C] micro-batch ids and masks; n_pf: the p_f columns (a host int)."""
    h = apply_norm(p.norm1, x, cfg.norm)
    return _fo_combine(_mb_run(h, lambda hg: _group_attention(
        hg, p.attn, cfg, kind)), h, idx, bwd, val, n_pf)


def packed_mlp_block_mb(p, x, cfg: ModelConfig, idx, bwd, val, *,
                        n_pf: int):
    h = apply_norm(p.norm2, x, cfg.norm)
    return _fo_combine(_mb_run(h, lambda hg: _group_mlp(hg, p, cfg)), h,
                       idx, bwd, val, n_pf)


def _packable(cfg: ModelConfig, policy):
    if policy is not None:
        raise _not_ported_dist("the sharding policy of the packed path")
    other = sorted(set(cfg.layer_kinds) - {ATTN_GLOBAL, ATTN_LOCAL})
    if other:
        raise ValueError(f"the packed path runs attention blocks only; "
                         f"{cfg.name} has {other} blocks")


def _plan_on(sched_arrays, dev):
    """(idx, bwd, val) on the device: one copy each, none for tensors
    already there."""
    return tuple(torch.as_tensor(a, device=dev) for a in sched_arrays)


def _packed_block(blk, x, cfg, kind, idx, bwd, val):
    x = x + packed_attention_block(blk, x, cfg, idx, bwd, val, kind)
    if hasattr(blk, "norm2"):
        x = x + packed_mlp_block(blk, x, cfg, idx, bwd, val)
    return x


def _packed_block_mb(blk, x, cfg, kind, idx, bwd, val, n_pf):
    x = x + packed_attention_block_mb(blk, x, cfg, idx, bwd, val, kind,
                                      n_pf=n_pf)
    if hasattr(blk, "norm2"):
        x = x + packed_mlp_block_mb(blk, x, cfg, idx, bwd, val, n_pf=n_pf)
    return x


def _layers(block_fn, model: Transformer, cfg: ModelConfig, x, plan,
            remat: bool, *extra):
    """Runs every layer through block_fn (checkpointed one layer at a time
    under remat: the same values and gradients, activations recomputed in
    the backward)."""
    idx, bwd, val = plan
    for l, (blk, kind) in enumerate(zip(model.layers, cfg.layer_kinds)):
        args = (blk, x, cfg, kind, idx[l], bwd[l], val[l]) + extra
        x = checkpoint(block_fn, *args, use_reentrant=False) if remat \
            else block_fn(*args)
    return x


def packed_forward_mb(model: Transformer, cfg: ModelConfig, tokens,
                      sched_arrays, n_mb: int, policy=None,
                      remat: bool = False, n_pf: Optional[int] = None):
    """Micro-batch-axis packed path (deployment form).

    tokens: [B, S] with contiguous micro-batch blocks (sample i belongs to
    micro-batch i // (B/n_mb)); sched_arrays = mb_packed_indices(...) of
    shapes [L, G, C_mb], numpy, or tensors with n_pf given. n_pf: the p_f
    columns, by default the largest p_f count of the plan. Returns
    (logits, aux).
    """
    _packable(cfg, policy)
    if n_pf is None:
        n_pf = int(np.asarray(sched_arrays[1]).sum(-1).max())
    cdt = torch_dtype(cfg.compute_dtype)
    B, S = tokens.shape
    x = apply_embedding(model.embed, tokens).to(cdt)
    x = x.reshape(n_mb, B // n_mb, S, -1)
    x = _layers(_packed_block_mb, model, cfg, x,
                _plan_on(sched_arrays, tokens.device), remat, n_pf)
    logits = logits_from_hidden(model, cfg, x.reshape(B, S, -1))
    return logits, {"aux_loss": torch.zeros((), dtype=torch.float32,
                                            device=logits.device)}


def packed_forward(model: Transformer, cfg: ModelConfig, tokens,
                   sched_arrays, policy=None, remat: bool = False):
    """Packed-path forward for attention-pattern configs.

    sched_arrays = (idx, bwd, val) with shapes [L, G, C] (from
    schedule.packed_indices), numpy or tensors. Only attention blocks with
    a dense FFN are supported; other families use the masked path.
    Returns (logits, aux).
    """
    _packable(cfg, policy)
    cdt = torch_dtype(cfg.compute_dtype)
    x = apply_embedding(model.embed, tokens).to(cdt)
    x = _layers(_packed_block, model, cfg, x,
                _plan_on(sched_arrays, tokens.device), remat)
    logits = logits_from_hidden(model, cfg, x)
    return logits, {"aux_loss": torch.zeros((), dtype=torch.float32,
                                            device=logits.device)}
