"""Knapsack machinery for D2FT scheduling (paper Algorithms 1 & 2); port
of ``repro/core/knapsack.py``: numpy, verbatim, and the device-side DP in
torch.

The orchestration problem (Eq. 4) is a multiple-knapsack; the paper's
heuristic decouples it (i) across devices and (ii) per device into a
bi-level pair of 0/1 knapsacks — outer selects p_f micro-batches by the
*backward* score under capacity C_k^{p_f} with item weight (c_f + c_b);
inner selects p_o micro-batches by the *forward* score under C_k^{p_o}
with weight c_f.

Solvers:
  * ``dp_knapsack``        — classic table DP with backtracking (numpy; the
                             production scheduler — host-side, like data
                             ordering in MaxText).
  * ``dp_knapsack_value``  — the optimal value by a DP on the values'
                             device, one vectorised update over the
                             capacity axis per item (the JAX package's
                             ``dp_knapsack_value_jax``; off the fine-tune's
                             path: property tests, on-device scheduling).
  * ``brute_force``        — exhaustive oracle for small N (tests).

Costs are floats; they are scaled to integers with ``resolution`` before the
DP (exact when costs are rationals with small denominators, as in the
paper's c_f = 0.4, c_b = 0.6 setup).
"""
from __future__ import annotations

import itertools
from typing import Tuple

import numpy as np
import torch


def _to_int(weights: np.ndarray, capacity: float, resolution: int):
    w = np.round(np.asarray(weights, np.float64) * resolution).astype(np.int64)
    c = int(round(float(capacity) * resolution))
    return w, c


def dp_knapsack(values: np.ndarray, weights: np.ndarray, capacity: float,
                resolution: int = 100) -> np.ndarray:
    """0/1 knapsack. Returns boolean selection mask of shape [N].

    Matches paper Algorithm 2 (Phase 1 table fill, Phase 2 backtrack).
    """
    values = np.asarray(values, np.float64)
    w, C = _to_int(weights, capacity, resolution)
    N = len(values)
    if C <= 0 or N == 0:
        return np.zeros(N, bool)
    # T[i][c] = best value using items < i with capacity c
    T = np.zeros((N + 1, C + 1), np.float64)
    for i in range(1, N + 1):
        wi, vi = w[i - 1], values[i - 1]
        T[i] = T[i - 1]
        if wi <= C and vi >= 0:
            take = T[i - 1, :C + 1 - wi] + vi
            upd = np.concatenate([T[i - 1, :wi], np.maximum(T[i - 1, wi:], take)])
            T[i] = upd
    sel = np.zeros(N, bool)
    c = C
    for i in range(N, 0, -1):
        if T[i, c] != T[i - 1, c]:
            sel[i - 1] = True
            c -= w[i - 1]
    return sel


def dp_knapsack_value(values, weights_int, capacity_int: int
                      ) -> torch.Tensor:
    """Optimal 0/1 knapsack value, a float32 scalar on the values' device.

    values: [N] float (a tensor, or anything ``torch.as_tensor`` takes);
    weights_int: [N] int; capacity_int: a host int. Items go in order, each
    one update of the whole [C + 1] table, f[c] = max(f[c], f[c - w] + v)
    where c >= w, as the JAX package's ``lax.scan`` makes it."""
    C = int(capacity_int)
    dev = values.device if isinstance(values, torch.Tensor) else None
    values = torch.as_tensor(values, dtype=torch.float32, device=dev)
    weights = torch.as_tensor(weights_int, dtype=torch.int32,
                              device=values.device).long()
    idx = torch.arange(C + 1, device=values.device)
    neg_inf = torch.tensor(float("-inf"), device=values.device)
    f = torch.zeros(C + 1, dtype=torch.float32, device=values.device)
    for v, w in zip(values, weights):
        shifted = f[torch.clamp(idx - w, 0, C)]
        f = torch.maximum(f, torch.where(idx >= w, shifted + v, neg_inf))
    return f[C]


def brute_force(values: np.ndarray, weights: np.ndarray, capacity: float
                ) -> Tuple[float, np.ndarray]:
    """Exhaustive 0/1 knapsack oracle (N <= ~18)."""
    N = len(values)
    best_v, best_sel = 0.0, np.zeros(N, bool)
    for bits in itertools.product([0, 1], repeat=N):
        sel = np.asarray(bits, bool)
        if weights[sel].sum() <= capacity + 1e-9:
            v = values[sel].sum()
            if v > best_v:
                best_v, best_sel = v, sel
    return best_v, best_sel


# --------------------------------------------------------------- bi-level
def bilevel_select(backward_scores: np.ndarray, forward_scores: np.ndarray,
                   c_f: float, c_b: float, cap_pf: float, cap_po: float,
                   resolution: int = 100) -> Tuple[np.ndarray, np.ndarray]:
    """Per-device bi-level solve (Eq. 7 outer / Eq. 8 inner).

    backward_scores, forward_scores: [N] per micro-batch.
    Returns (sel_pf, sel_po) boolean masks — before Alg. 1 merge.
    """
    sel_pf = dp_knapsack(backward_scores,
                         np.full(len(backward_scores), c_f + c_b),
                         cap_pf, resolution)
    sel_po = dp_knapsack(forward_scores,
                         np.full(len(forward_scores), c_f),
                         cap_po, resolution)
    return sel_pf, sel_po


def scalarized_select(backward_scores: np.ndarray, forward_scores: np.ndarray,
                      lam: float, c_f: float, c_b: float, cap_total: float,
                      resolution: int = 100) -> Tuple[np.ndarray, np.ndarray]:
    """'Scaler' baseline from paper §IV-F: a single knapsack over 2N items
    (each micro-batch contributes a p_f item valued by the backward score and
    a p_o item valued by lam * forward score); at most one of the pair is
    kept (p_f wins the conflict, mirroring Alg. 1's merge)."""
    N = len(backward_scores)
    values = np.concatenate([backward_scores, lam * forward_scores])
    weights = np.concatenate([np.full(N, c_f + c_b), np.full(N, c_f)])
    sel = dp_knapsack(values, weights, cap_total, resolution)
    sel_pf, sel_po = sel[:N].copy(), sel[N:].copy()
    sel_po &= ~sel_pf
    return sel_pf, sel_po
