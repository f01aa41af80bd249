"""Baseline schedulers the paper compares against (§III-A).

* Random           — per subnet, random micro-batches for p_f/p_o/p_s at the
                     same budget as D2FT.
* DPruning-M       — dynamic pruning by weight magnitude: top-r fraction of
                     subnets do p_f on every micro-batch, the rest p_s;
                     reselected every ``refresh`` iterations. No p_o option.
* DPruning-M/G     — same with magnitude+gradient importance.
* MoE-GShard       — gate-score routing with expert capacity: each subnet
                     ("expert") takes micro-batches by gate preference until
                     capacity, overflow is dropped (p_s). Mirrors the paper's
                     observation that capacity limits skip samples that
                     needed processing.
All return Schedule tables with the same encoding as D2FT so the cost model
and training paths are shared.

Port of ``repro/core/baselines.py``, verbatim (numpy): the same
generators give the same tables.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.schedule import P_F, P_O, P_S, Schedule


def random_schedule(rng: np.random.Generator, n_layers: int, n_groups: int,
                    n_mb: int, n_pf: int, n_po: int,
                    balanced: bool = False) -> Schedule:
    """Random scheduling at the same *expected* budget as D2FT.

    balanced=False (paper's "Random", Table I variance 0.23): ops drawn
    i.i.d. per (subnet, micro-batch) with probabilities matching the budget,
    so per-device workloads fluctuate. balanced=True fixes exact counts per
    subnet (an ablation knob, not the paper's baseline)."""
    K = n_layers * n_groups
    table = np.full((K, n_mb), P_S, np.int8)
    if balanced:
        for k in range(K):
            perm = rng.permutation(n_mb)
            table[k, perm[:n_pf]] = P_F
            table[k, perm[n_pf:n_pf + n_po]] = P_O
    else:
        probs = [n_pf / n_mb, n_po / n_mb, 1.0 - (n_pf + n_po) / n_mb]
        draws = rng.choice([P_F, P_O, P_S], size=(K, n_mb), p=probs)
        table[:] = draws
    return Schedule(table, n_layers, n_groups)


def dpruning_schedule(importance: np.ndarray, n_layers: int, n_groups: int,
                      n_mb: int, keep_fraction: float) -> Schedule:
    """importance: [K] per-subnet score (M: Σ|w|; M/G: Σ|w| * Σ|∇w|).
    Kept subnets run p_f on all micro-batches; pruned subnets p_s."""
    K = n_layers * n_groups
    n_keep = max(1, int(round(keep_fraction * K)))
    keep = np.argsort(-importance)[:n_keep]
    table = np.full((K, n_mb), P_S, np.int8)
    table[keep] = P_F
    return Schedule(table, n_layers, n_groups)


def gshard_schedule(rng: np.random.Generator, gate_logits: np.ndarray,
                    n_layers: int, n_groups: int, capacity: int) -> Schedule:
    """gate_logits: [K, N] preference of subnet k for micro-batch i.
    Every micro-batch is routed to its top-preference subnets per layer;
    a subnet beyond ``capacity`` drops the overflow (p_s)."""
    K, N = gate_logits.shape
    table = np.full((K, N), P_S, np.int8)
    logits = gate_logits.reshape(n_layers, n_groups, N)
    for l in range(n_layers):
        filled = np.zeros(n_groups, int)
        # route each micro-batch to its best expert in this layer
        order = rng.permutation(N)
        for i in order:
            pref = np.argsort(-logits[l, :, i])
            for g in pref:
                if filled[g] < capacity:
                    table[l * n_groups + g, i] = P_F
                    filled[g] += 1
                    break
    return Schedule(table, n_layers, n_groups)
