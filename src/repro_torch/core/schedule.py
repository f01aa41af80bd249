"""Schedule table construction and gate materialization (paper Algorithm 1);
port of ``repro/core/schedule.py`` (numpy; gates as torch tensors).

A ``ScheduleTable`` is an int8 array [K, N] over subnets k and micro-batches
i with entries  1 = p_f (full),  2 = p_o (forward-only),  3 = p_s (shortcut)
— the exact encoding of Algorithm 1.

Subnets are indexed k = l * G + g for layer l and head-group g; this module
converts tables to the (g_f, g_b) gate tensors consumed by the gated
models (``models/vit.py``, ``models/transformer.py::apply_block``) and to
packed-path gather indices.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device

P_F, P_O, P_S = 1, 2, 3


@dataclass
class Schedule:
    table: np.ndarray          # [K, N] int8 in {1,2,3}
    n_layers: int
    n_groups: int              # G (subnets per layer)

    @property
    def n_microbatches(self) -> int:
        return self.table.shape[1]

    def layer_group_view(self) -> np.ndarray:
        return self.table.reshape(self.n_layers, self.n_groups, -1)


def merge_tables(sel_pf: np.ndarray, sel_po: np.ndarray) -> np.ndarray:
    """Algorithm 1 lines 14-31. sel_pf, sel_po: [K, N] bool."""
    table = np.full(sel_pf.shape, P_S, np.int8)
    table[sel_po] = P_O
    table[sel_pf] = P_F            # p_f wins conflicts (line 23-25)
    return table


def build_schedule(backward_scores: np.ndarray, forward_scores: np.ndarray,
                   n_layers: int, n_groups: int, *, c_f: float, c_b: float,
                   cap_pf, cap_po, resolution: int = 100) -> Schedule:
    """Run the bi-level knapsack for every subnet (= device) independently.

    backward_scores / forward_scores: [K, N]; cap_pf / cap_po: scalar or [K]
    per-device capacities (heterogeneity support, paper §IV-D).
    """
    from repro_torch.core.knapsack import bilevel_select
    K, N = backward_scores.shape
    cap_pf = np.broadcast_to(np.asarray(cap_pf, np.float64), (K,))
    cap_po = np.broadcast_to(np.asarray(cap_po, np.float64), (K,))
    sel_pf = np.zeros((K, N), bool)
    sel_po = np.zeros((K, N), bool)
    for k in range(K):
        sel_pf[k], sel_po[k] = bilevel_select(
            backward_scores[k], forward_scores[k], c_f, c_b,
            cap_pf[k], cap_po[k], resolution)
    return Schedule(merge_tables(sel_pf, sel_po), n_layers, n_groups)


# ------------------------------------------------------------------- gates
def gates_from_schedule(sched: Schedule, mb_of_sample: np.ndarray,
                        device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Materialize (g_f, g_b) float32 tensors [n_layers, B, G] on
    ``device`` (default: the CUDA card; pass "cpu" for host tensors).

    mb_of_sample: [B] micro-batch index of each sample in the batch.
    g_f = 1 where op in {p_f, p_o} (forward runs); g_b = 1 where op == p_f.
    """
    t = sched.layer_group_view()                         # [L, G, N]
    per_sample = t[:, :, mb_of_sample]                   # [L, G, B]
    dev = resolve_device(device)
    g_f = torch.as_tensor((per_sample != P_S).transpose(0, 2, 1),
                          dtype=torch.float32, device=dev)
    g_b = torch.as_tensor((per_sample == P_F).transpose(0, 2, 1),
                          dtype=torch.float32, device=dev)
    return g_f, g_b


def live_slice_bounds(sched: Schedule, mb_of_sample: np.ndarray
                      ) -> Tuple[int, int]:
    """(live_fwd, live_bwd) upper bounds for compaction dispatch.

    Counts, per layer, the (sample, group) slices with g_f != 0 (op in
    {p_f, p_o}) and with g_b != 0 (op == p_f) and takes the max over layers
    — one bound shared by every layer. The kernel consumes per-(sample, head) gates, so
    multiply by heads-per-group (H // G) before passing to
    ``ops.gated_attention`` (models do this). These are Python ints derived
    from the host-side schedule table.
    """
    per_sample = sched.layer_group_view()[:, :, mb_of_sample]   # [L, G, B]
    live_f = int((per_sample != P_S).sum(axis=(1, 2)).max())
    live_b = int((per_sample == P_F).sum(axis=(1, 2)).max())
    return live_f, live_b


def packed_indices(sched: Schedule, mb_of_sample: np.ndarray,
                   pad_to: Optional[int] = None
                   ) -> Tuple[np.ndarray, np.ndarray, int, int]:
    """Gather indices for the packed path.

    Returns (idx [L, G, C], bwd_mask [L, G, C], valid [L, G, C], C_f):
    idx[l, g] lists the samples each subnet processes forward (p_f first,
    then p_o), bwd_mask is 1 for the p_f entries, valid is 0 on padding
    entries (which point at sample 0), and C_f is the largest p_f count.
    C is ``pad_to`` or the largest p_f count plus the largest p_o count;
    the knapsack gives every subnet the same counts when scores are
    positive, so nothing is padded then.
    """
    t = sched.layer_group_view()                         # [L, G, N]
    L, G, N = t.shape
    per_sample = t[:, :, mb_of_sample]                   # [L, G, B]
    B = per_sample.shape[-1]
    counts_f = (per_sample == P_F).sum(-1)
    counts_o = (per_sample == P_O).sum(-1)
    C_f = int(counts_f.max())
    C_o = int(counts_o.max())
    C = pad_to or (C_f + C_o)
    idx = np.zeros((L, G, C), np.int32)
    bwd = np.zeros((L, G, C), np.float32)
    val = np.zeros((L, G, C), np.float32)
    for l in range(L):
        for g in range(G):
            f = np.nonzero(per_sample[l, g] == P_F)[0]
            o = np.nonzero(per_sample[l, g] == P_O)[0]
            take = np.concatenate([f, o])[:C]
            idx[l, g, :len(take)] = take
            bwd[l, g, :len(f)] = 1.0
            val[l, g, :len(take)] = 1.0
    return idx, bwd, val, C_f


def op_counts(sched: Schedule) -> dict:
    t = sched.table
    return {"p_f": int((t == P_F).sum()), "p_o": int((t == P_O).sum()),
            "p_s": int((t == P_S).sum())}
