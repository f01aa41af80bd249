"""D2FT planning (port of the planning half of ``repro/core/d2ft.py``).

``plan_schedule``: scores -> bi-level knapsack -> Schedule (host side,
numpy). The masked and kernel execution paths consume it through
``core.schedule.gates_from_schedule``. The packed execution path
(``packed_forward`` and its blocks) is not ported yet.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from repro_torch.configs.base import D2FTConfig
from repro_torch.core import knapsack
from repro_torch.core.schedule import Schedule, merge_tables


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
