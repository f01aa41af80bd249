"""Deterministic fault injection for the elastic train loop (port of
``repro/launch/faults.py``: numpy only, the same plans and the same JSON
text from the same seed).

D2FT's Eq. 4 knapsack assumes a fixed fleet of identical, reliable
devices; the commodity fleets the paper targets are exactly where that
assumption dies. This module is the *fault model* half of the elastic
layer (``train/elastic.py`` is the response half): a ``FaultPlan`` is a
frozen, seedable, JSON-round-trippable description of every failure the
loop will see, so each failure mode has a replayable regression test.

Four fault kinds, matching the four degradation mechanisms:

* **per-device slowdowns** — device d takes ``factor`` times longer per
  unit of assigned schedule cost, from ``slowdown_start`` on. The loop
  takes the plan's synthesized measurement ``measured_time_d = load_d *
  unit_times()[d]`` as the JAX loop does: its EMA consumes only these
  measurements, so the mitigation path (EMA -> capacities -> knapsack) is
  the production code path end to end.
* **device dropout** — device ``dropout[1]`` (a rank of the data mesh)
  dies at step ``dropout[0]``. The loop recovers by shrinking the mesh to
  survivors and restoring from the last step-level checkpoint.
* **non-finite gradient bursts** — ``grad_faults`` entries
  ``(step, device, scale)`` multiply device d's *local gradients* by
  ``scale`` (NaN by default) before the sync, emulating a replica whose
  backward blew up. The train step's guard must neutralize it before the
  sync or every replica is poisoned.
* **dropped sync rounds** — at each step in ``dropped_syncs`` the
  gradient sync round fails (flaky link): the loop discards that step's
  update, and past ``sync_fault_threshold`` failures it falls back to the
  communication-free ``sync_mode="local"``.

Host-side: the plan is consulted between steps; the only thing that
reaches the step is each rank's gradient multiplier.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class FaultPlan:
    """Deterministic per-run fault script (see module docstring).

    slowdowns: ((device, factor), ...) — per-unit-time multipliers >= 1,
    active from ``slowdown_start`` on.
    dropout: (step, device) or None — the device dies *before* executing
    that step.
    grad_faults: ((step, device, scale), ...) — local-grad multiplier for
    one device at one step (NaN/inf to inject a non-finite burst).
    dropped_syncs: steps whose gradient sync round is lost.
    """
    seed: int = 0
    slowdowns: Tuple[Tuple[int, float], ...] = ()
    slowdown_start: int = 0
    dropout: Optional[Tuple[int, int]] = None
    grad_faults: Tuple[Tuple[int, int, float], ...] = ()
    dropped_syncs: Tuple[int, ...] = ()

    # ---------------------------------------------------------- queries
    def unit_times(self, step: int, n_devices: int) -> np.ndarray:
        """[K] synthetic per-unit step time of each device at ``step``
        (1.0 = healthy; the straggler's factor once its slowdown is on)."""
        u = np.ones(n_devices)
        if step >= self.slowdown_start:
            for dev, factor in self.slowdowns:
                if 0 <= dev < n_devices:
                    u[dev] = float(factor)
        return u

    def grad_fault_vector(self, step: int, n_devices: int) -> np.ndarray:
        """[K] float32 multiplier applied to each device's local grads at
        ``step`` (all-ones when no burst is scheduled)."""
        v = np.ones(n_devices, np.float32)
        for s, dev, scale in self.grad_faults:
            if s == step and 0 <= dev < n_devices:
                v[dev] = np.float32(scale)
        return v

    def dropout_at(self, step: int) -> Optional[int]:
        """Device that dies at ``step``, or None."""
        if self.dropout is not None and self.dropout[0] == step:
            return int(self.dropout[1])
        return None

    def sync_dropped(self, step: int) -> bool:
        return step in self.dropped_syncs

    def any_faults(self) -> bool:
        return bool(self.slowdowns or self.dropout is not None
                    or self.grad_faults or self.dropped_syncs)

    # ------------------------------------------------------ serialization
    def to_json(self) -> str:
        return json.dumps({
            "seed": self.seed,
            "slowdowns": [[int(d), float(f)] for d, f in self.slowdowns],
            "slowdown_start": self.slowdown_start,
            "dropout": list(self.dropout) if self.dropout else None,
            "grad_faults": [[int(s), int(d), float(x)]
                            for s, d, x in self.grad_faults],
            "dropped_syncs": sorted(int(s) for s in self.dropped_syncs),
        })

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        d = json.loads(text)
        dropout = d.get("dropout")
        return cls(
            seed=int(d.get("seed", 0)),
            slowdowns=tuple((int(a), float(b))
                            for a, b in d.get("slowdowns", [])),
            slowdown_start=int(d.get("slowdown_start", 0)),
            dropout=(int(dropout[0]), int(dropout[1])) if dropout else None,
            grad_faults=tuple((int(s), int(dv), float(x))
                              for s, dv, x in d.get("grad_faults", [])),
            dropped_syncs=tuple(int(s)
                                for s in d.get("dropped_syncs", [])),
        )


NO_FAULTS = FaultPlan()


def random_fault_plan(seed: int, steps: int, n_devices: int, *,
                      p_slow: float = 0.25, max_factor: float = 3.0,
                      p_dropout: float = 0.0, p_nan: float = 0.1,
                      p_sync_drop: float = 0.1) -> FaultPlan:
    """Seed -> reproducible random plan (same seed, same plan, bit for
    bit) for soak/property tests. Probabilities are per device (slowdown,
    one Bernoulli each) or per step (NaN burst on a uniform device, sync
    drop). At most one dropout, placed uniformly in the middle half of
    the run so a checkpoint exists before it."""
    rng = np.random.default_rng(seed)
    slowdowns = tuple(
        (int(d), float(np.round(rng.uniform(1.5, max_factor), 3)))
        for d in range(n_devices) if rng.random() < p_slow)
    dropout = None
    if rng.random() < p_dropout and steps >= 4:
        step = int(rng.integers(steps // 4 + 1, max(3 * steps // 4, 2)))
        dropout = (step, int(rng.integers(n_devices)))
    grad_faults = tuple(
        (s, int(rng.integers(n_devices)), float("nan"))
        for s in range(steps) if rng.random() < p_nan)
    dropped = tuple(s for s in range(steps) if rng.random() < p_sync_drop)
    return FaultPlan(seed=seed, slowdowns=slowdowns, dropout=dropout,
                     grad_faults=grad_faults, dropped_syncs=dropped)
