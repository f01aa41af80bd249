"""Cost accounting for D2FT schedules (paper §III-A metrics, §IV-A analysis);
port of ``repro/core/cost_model.py``, verbatim.

Per micro-batch relative costs (measured by the paper, Table IV):
  compute: p_f = c_f + c_b = 1.0, p_o = c_f = 0.4, p_s = 0
  comm:    p_f = 1.0 (activations fwd + grads bwd), p_o = 0.5, p_s = 0
All costs are reported as a fraction of standard full fine-tuning
(every subnet doing p_f on every micro-batch).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.schedule import P_F, P_O, P_S, Schedule


def compute_cost(table: np.ndarray, c_f: float = 0.4, c_b: float = 0.6
                 ) -> float:
    per_op = np.where(table == P_F, c_f + c_b,
                      np.where(table == P_O, c_f, 0.0))
    return float(per_op.sum() / (table.size * (c_f + c_b)))


def comm_cost(table: np.ndarray) -> float:
    per_op = np.where(table == P_F, 1.0, np.where(table == P_O, 0.5, 0.0))
    return float(per_op.mean())


def per_device_load(table: np.ndarray, c_f: float = 0.4, c_b: float = 0.6
                    ) -> np.ndarray:
    """[K] — compute load per subnet/device for one batch."""
    per_op = np.where(table == P_F, c_f + c_b,
                      np.where(table == P_O, c_f, 0.0))
    return per_op.sum(axis=1)


def workload_variance(table: np.ndarray, c_f: float = 0.4, c_b: float = 0.6
                      ) -> float:
    """Variance of per-device workloads (paper Table I). D2FT's knapsack
    gives every device the same number of p_f / p_o micro-batches when
    capacities are homogeneous, so this is exactly 0."""
    return float(np.var(per_device_load(table, c_f, c_b)))
