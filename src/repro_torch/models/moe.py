"""Mixture-of-Experts layer with sort-based static-capacity dispatch (port of
``init_moe`` and ``apply_moe`` of ``repro/models/moe.py``).

Dispatch is the MaxText-style sort/scatter form (no [T, E, C] one-hot):
the (token, k) assignments are sorted by expert id, ranked within their
expert's segment, dropped beyond capacity, scattered into a dense
[E, C, d] buffer, run through the batched expert MLP, and combined back
per token weighted by the router. Under D2FT gates the schedule meets the
router here: assignments of g_f == 0 samples never take a slot, and in
each expert's segment the g_b == 1 ones sort first, so backward-live slots
fill a capacity prefix (which the kernel's backward truncation relies on).

Two places differ in form, not in value, from the JAX function:

* top-k is a stable descending sort: ``jax.lax.top_k`` breaks ties toward
  the lower index, which ``torch.sort(stable=True)`` does too and
  ``torch.topk`` does not promise;
* the combine gathers each token's K contributions through the inverse
  of the sort and sums them over k (a fixed order on every device), where
  JAX scatter-adds them in sorted order.

The expert-parallel ``apply_moe_ep`` comes with the distributed slice.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import MoEConfig
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models.layers import _act, _param, dense_init


class MoE(nn.Module):
    """router [d, E], w_up / w_gate [E, d, F], w_down [E, F, d] and, with
    shared experts, shared_up / shared_gate [d, S·F], shared_down [S·F, d]:
    the JAX package's leaves and layouts."""

    def __init__(self, router, w_up, w_gate, w_down, shared=None):
        super().__init__()
        self.router = _param(router)
        self.w_up = _param(w_up)
        self.w_gate = _param(w_gate)
        self.w_down = _param(w_down)
        if shared is not None:
            self.shared_up = _param(shared[0])
            self.shared_gate = _param(shared[1])
            self.shared_down = _param(shared[2])


def init_moe(gen: torch.Generator, d_model: int, cfg: MoEConfig,
             dtype) -> MoE:
    """Random init on ``gen.device``, the JAX function's scales (router
    0.02, experts 1/sqrt(fan-in)); the numbers differ from jax.random's."""
    E, F = cfg.n_experts, cfg.d_ff
    dev = gen.device

    def normal(shape, fan_in):
        return (torch.randn(shape, generator=gen, device=dev)
                / np.sqrt(fan_in)).to(dtype)

    router = dense_init(gen, d_model, E, dtype, scale=0.02)
    w_up = normal((E, d_model, F), d_model)
    w_gate = normal((E, d_model, F), d_model)
    w_down = normal((E, F, d_model), F)
    shared = None
    if cfg.n_shared_experts > 0:
        SF = cfg.n_shared_experts * F
        shared = (dense_init(gen, d_model, SF, dtype),
                  dense_init(gen, d_model, SF, dtype),
                  dense_init(gen, SF, d_model, dtype))
    return MoE(router, w_up, w_gate, w_down, shared)


class Dispatch(NamedTuple):
    """The sorted assignments: ``order`` [T·K] (flat assignment ids in slot
    order), their expert ``e_s``, token ``tok_s`` and router weight
    ``w_s``; ``pos`` the rank in the expert's segment, ``pos_c`` the slot
    (``capacity`` for a dropped one), ``keep`` whether it holds a slot,
    ``keep_b`` whether it holds one and is backward-live (None without
    gates), and ``capacity``."""
    order: torch.Tensor
    e_s: torch.Tensor
    tok_s: torch.Tensor
    w_s: torch.Tensor
    pos: torch.Tensor
    pos_c: torch.Tensor
    keep: torch.Tensor
    keep_b: Optional[torch.Tensor]
    capacity: int


def route(top_e, top_w, cfg: MoEConfig, gates=None, S: int = 1) -> Dispatch:
    """The gate-aware sort of ``apply_moe``. top_e, top_w: [T, K] router
    choices (T = B·S tokens); gates: optional (g_f, g_b) per sample [B]."""
    T, K = top_e.shape
    E, dev = cfg.n_experts, top_e.device
    e_flat = top_e.reshape(T * K)
    tok_flat = torch.arange(T, device=dev).repeat_interleave(K)
    w_flat = top_w.reshape(T * K)
    live_a = bwd_a = None
    if gates is None:
        order = torch.argsort(e_flat, stable=True)
        counts = torch.bincount(e_flat, minlength=E)
    else:
        g_f, g_b = gates
        gf_t = g_f.reshape(-1).repeat_interleave(S)            # [T]
        gb_t = g_b.reshape(-1).repeat_interleave(S)
        live_a = gf_t[tok_flat] > 0                             # [T*K]
        bwd_a = gb_t[tok_flat] > 0
        # sort key: (expert, backward-dead last) for live assignments; dead
        # ones past every expert, so they never claim a slot
        key = torch.where(live_a, 2 * e_flat + (~bwd_a).long(),
                          torch.full_like(e_flat, 2 * E))
        order = torch.argsort(key, stable=True)
        counts = torch.bincount(torch.where(live_a, e_flat,
                                            torch.full_like(e_flat, E)),
                                minlength=E + 1)[:E]
    e_s, tok_s, w_s = e_flat[order], tok_flat[order], w_flat[order]
    offsets = torch.cumsum(counts, 0) - counts                  # exclusive
    pos = torch.arange(T * K, device=dev) - offsets[e_s]
    capacity = int(max(1, round(T * K / E * cfg.capacity_factor)))
    keep = pos < capacity
    keep_b = None
    if live_a is not None:
        keep = keep & live_a[order]
        keep_b = keep & bwd_a[order]
    pos_c = torch.where(keep, pos, torch.full_like(pos, capacity))
    return Dispatch(order, e_s, tok_s, w_s, pos, pos_c, keep, keep_b,
                    capacity)


def slot_masks(d: Dispatch, E: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(fwd_slots, bwd_slots) [E, C] float {0, 1}: the slots that hold a
    live (resp. backward-live) assignment."""
    masks = []
    for kept in (d.keep, d.keep_b):
        m = torch.zeros((E, d.capacity + 1), dtype=torch.float32,
                        device=kept.device)
        m.index_put_((d.e_s, d.pos_c), kept.float(), accumulate=True)
        masks.append(m[:, :d.capacity])
    return masks[0], masks[1]


def apply_moe(p: MoE, x, cfg: MoEConfig, act: str = "silu", gates=None,
              use_kernel: bool = False, live_tokens: Optional[int] = None,
              live_bwd_tokens: Optional[int] = None, block_c: int = 128):
    """x: [B, S, d]. Returns (y, aux), aux the load-balance and router-z
    losses and the dropped fraction.

    gates: optional per-sample D2FT gates (g_f, g_b), each [B] in {0, 1}
    with g_b <= g_f: assignments of g_f == 0 samples are dropped at
    dispatch, and backward-live ones pack first in each expert's segment.
    The caller's ``gate_mix`` owns the stop-gradient on the output.
    use_kernel (with gates) runs the expert FFN through the doubly-sparse
    kernels with the slot masks; ``live_tokens`` / ``live_bwd_tokens``
    bound the forward- / backward-live tokens (live samples x S) and so
    the live slots per expert (x top_k), which truncate the kernels'
    grids."""
    B, S, D = x.shape
    T = B * S
    E, K = cfg.n_experts, cfg.top_k
    xt = x.reshape(T, D)

    logits = (xt @ p.router).float()                            # [T, E]
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_e = top_w[:, :K], top_e[:, :K]
    top_w = top_w / torch.clamp_min(top_w.sum(-1, keepdim=True), 1e-9)

    d = route(top_e, top_w, cfg, gates, S)
    C = d.capacity
    buf = torch.zeros((E, C + 1, D), dtype=x.dtype, device=x.device)
    buf = buf.index_put((d.e_s, d.pos_c), xt[d.tok_s])[:, :C]  # [E, C, D]

    if use_kernel and gates is not None:
        fwd_slots, bwd_slots = slot_masks(d, E)
        live_slots = (min(C, int(live_tokens) * K)
                      if live_tokens is not None else None)
        live_bwd_slots = (min(C, int(live_bwd_tokens) * K)
                          if live_bwd_tokens is not None else None)
        out_e = kernel_ops._gated_moe_impl(
            buf, p.w_up, p.w_gate, p.w_down, fwd_slots, bwd_slots, act=act,
            block_c=block_c, live_slots=live_slots,
            live_bwd_slots=live_bwd_slots).to(x.dtype)
    else:
        h = torch.bmm(buf, p.w_up)
        g = torch.bmm(buf, p.w_gate)
        out_e = torch.bmm(_act(act)(g) * h, p.w_down)           # [E, C, D]

    contrib = out_e[d.e_s, torch.clamp_max(d.pos_c, C - 1)]
    contrib = contrib * (d.w_s * d.keep).to(x.dtype)[:, None]
    inv = torch.empty_like(d.order).scatter_(
        0, d.order, torch.arange(T * K, device=x.device))
    y = contrib[inv].reshape(T, K, D).sum(dim=1)

    if hasattr(p, "shared_up"):
        hs = xt @ p.shared_up
        gs = _act(act)(xt @ p.shared_gate)
        y = y + (hs * gs) @ p.shared_down

    # ---- aux losses (GShard/Switch style)
    frac_tokens = torch.nn.functional.one_hot(top_e[:, 0], E).float().mean(0)
    frac_probs = probs.mean(0)
    aux_lb = E * torch.sum(frac_tokens * frac_probs) * cfg.aux_loss
    z = torch.logsumexp(logits, dim=-1)
    aux_z = torch.mean(z ** 2) * cfg.router_z_loss
    dropped = 1.0 - d.keep.float().mean()
    aux = {"load_balance": aux_lb, "router_z": aux_z, "drop_frac": dropped}
    return y.reshape(B, S, D), aux
