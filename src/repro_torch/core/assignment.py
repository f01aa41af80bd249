"""Multiple-knapsack device assignment — the *distributed* half of Eq. 4
(port of ``repro/core/assignment.py``: numpy, the same solver line for
line).

The bi-level knapsack (``core/knapsack.py``) decides WHAT runs: which
micro-batches each subnet treats as p_f / p_o / p_s. This module decides
WHERE: map the N micro-batches onto K devices under per-device capacities
C_k so every device carries a near-equal share of the schedule's live
(g_f, g_b) work. Balance is what turns the schedule's savings into
wall-clock — the slowest device gates the step, and the gradient
all-reduce cannot start until no straggler holds it open.

Solver (deterministic, host-side like the schedule itself):

* **LPT seed** — each micro-batch, heaviest first, goes to the least-loaded
  feasible device; the classic (4/3 - 1/(3K))-approximation for makespan.
* **DP refinement** — when per-device counts are free, a subset-sum
  transfer solved with ``dp_knapsack`` moves items from the max- to the
  min-loaded device (target: half the spread). In ``equal_counts`` mode
  (the shard_map data-parallel step needs equal shard sizes) a best-swap
  pass exchanges one item between the extremes instead. Both repeat until
  the spread stops improving.

Ties always break on the lowest micro-batch / device index, so identical
inputs produce identical assignments (re-planning on a restart is a
no-op). ``rebalance_report`` summarizes per-device cost spread; the
launcher prints it before training starts.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from repro_torch.core.knapsack import dp_knapsack
from repro_torch.core.schedule import P_F, P_O, Schedule, live_slice_bounds


def microbatch_costs(sched: Schedule, c_f: float = 0.4, c_b: float = 0.6
                     ) -> np.ndarray:
    """[N] — schedule cost of each micro-batch summed over all subnets
    (p_f = c_f + c_b, p_o = c_f, p_s = 0): the item weights of Eq. 4."""
    t = sched.table
    per_op = np.where(t == P_F, c_f + c_b, np.where(t == P_O, c_f, 0.0))
    return per_op.sum(axis=0)


@dataclass(frozen=True)
class DeviceAssignment:
    """Result of the multiple-knapsack solve: micro-batch -> device."""
    device_of: np.ndarray                 # [N] int — device per micro-batch
    costs: np.ndarray                     # [N] item costs the solver used
    n_devices: int
    capacities: Optional[np.ndarray] = None   # [K] or None (unconstrained)

    @property
    def loads(self) -> np.ndarray:
        return np.bincount(self.device_of, weights=self.costs,
                           minlength=self.n_devices)

    @property
    def counts(self) -> np.ndarray:
        return np.bincount(self.device_of, minlength=self.n_devices)

    def items_of(self, k: int) -> np.ndarray:
        return np.nonzero(self.device_of == k)[0]


def _spread(loads: np.ndarray) -> float:
    return float(loads.max() - loads.min())


def _dp_transfer(device_of, costs, loads, a: int, b: int, caps,
                 resolution: int) -> bool:
    """Move a dp_knapsack-selected subset from device a to device b.

    Target transfer is half the spread (exact hit zeroes the pair's
    imbalance); the knapsack maximizes moved weight under that capacity, so
    the chosen subset is the closest-from-below subset sum. Returns True if
    a strictly-improving move was applied."""
    items = np.nonzero(device_of == a)[0]
    if len(items) == 0:
        return False
    target = (loads[a] - loads[b]) / 2.0
    if caps is not None:
        target = min(target, caps[b] - loads[b])
    if target <= 0:
        return False
    sel = dp_knapsack(costs[items], costs[items], target, resolution)
    moved = float(costs[items[sel]].sum())
    if moved <= 0:
        return False
    before = _spread(loads)
    loads[a] -= moved
    loads[b] += moved
    if _spread(loads) >= before - 1e-12:
        loads[a] += moved
        loads[b] -= moved
        return False
    device_of[items[sel]] = b
    return True


def _best_swap(device_of, costs, loads, a: int, b: int, caps) -> bool:
    """Exchange one item between the extreme devices (count-preserving).

    Picks the pair whose cost difference d is closest to half the spread
    with 0 < d < spread, i.e. the largest guaranteed spread reduction for a
    single swap. Returns True if an improving swap was applied."""
    ia = np.nonzero(device_of == a)[0]
    ib = np.nonzero(device_of == b)[0]
    if len(ia) == 0 or len(ib) == 0:
        return False
    spread = loads[a] - loads[b]
    half = spread / 2.0
    best = None
    for i in ia:
        for j in ib:
            d = costs[i] - costs[j]
            if d <= 1e-12 or d >= spread:
                continue
            if caps is not None and loads[b] + d > caps[b] + 1e-9:
                continue
            key = (abs(d - half), int(i), int(j))
            if best is None or key < best[0]:
                best = (key, int(i), int(j), d)
    if best is None:
        return False
    _, i, j, d = best
    device_of[i], device_of[j] = b, a
    loads[a] -= d
    loads[b] += d
    return True


def assign_microbatches(costs, n_devices: int, capacities=None, *,
                        equal_counts: bool = False, refine_rounds: int = 32,
                        resolution: int = 100) -> DeviceAssignment:
    """Assign N cost-weighted micro-batches to K devices.

    capacities: scalar or [K] per-device cost budget C_k. Infeasible items
    (no device has room) still get placed on the least-loaded device so
    every micro-batch executes; the violation shows up in
    ``rebalance_report`` rather than raising mid-training.
    equal_counts: force exactly N/K items per device (required by the
    shard_map data-parallel step, whose shards must be equal-sized).
    """
    costs = np.asarray(costs, np.float64)
    N, K = len(costs), int(n_devices)
    assert K >= 1
    caps = None
    if capacities is not None:
        caps = np.broadcast_to(np.asarray(capacities, np.float64), (K,))
    if equal_counts:
        assert N % K == 0, f"equal_counts needs N % K == 0, got {N} % {K}"
    max_count = N // K if equal_counts else N

    device_of = np.full(N, -1, np.int64)
    loads = np.zeros(K)
    counts = np.zeros(K, np.int64)
    # LPT seed: heaviest first; stable sort keeps index order on ties.
    for i in np.argsort(-costs, kind="stable"):
        open_ = counts < max_count
        if caps is not None:
            fits = open_ & (loads + costs[i] <= caps + 1e-9)
            if fits.any():
                open_ = fits
        cand = np.nonzero(open_)[0]
        k = int(cand[np.argmin(loads[cand])])
        device_of[i] = k
        loads[k] += costs[i]
        counts[k] += 1

    for _ in range(refine_rounds):
        a, b = int(np.argmax(loads)), int(np.argmin(loads))
        if a == b or loads[a] - loads[b] <= 1e-12:
            break
        moved = False
        if not equal_counts:
            moved = _dp_transfer(device_of, costs, loads, a, b, caps,
                                 resolution)
        if not moved:
            moved = _best_swap(device_of, costs, loads, a, b, caps)
        if not moved:
            break

    return DeviceAssignment(device_of, costs, K, caps)


def rebalance_report(assignment: DeviceAssignment) -> dict:
    """Per-device cost spread of an assignment (printed by the launcher,
    embedded in the distributed-step bench/dry-run artifacts)."""
    loads = assignment.loads
    counts = assignment.counts
    mean = float(loads.mean())
    over = []
    if assignment.capacities is not None:
        over = [int(k) for k in range(assignment.n_devices)
                if loads[k] > assignment.capacities[k] + 1e-9]
    return {
        "n_devices": assignment.n_devices,
        "n_microbatches": int(len(assignment.device_of)),
        "loads": [round(float(x), 6) for x in loads],
        "counts": [int(c) for c in counts],
        "mean_load": round(mean, 6),
        "max_load": round(float(loads.max()), 6),
        "min_load": round(float(loads.min()), 6),
        "spread": round(_spread(loads), 6),
        "imbalance": round(float(loads.max() / mean), 6) if mean > 0 else 1.0,
        "load_variance": round(float(np.var(loads)), 6),
        "capacity_ok": not over,
        "overloaded_devices": over,
    }


def plan_device_assignment(sched: Schedule, n_devices: int, capacities=None,
                           *, equal_counts: bool = True, c_f: float = 0.4,
                           c_b: float = 0.6
                           ) -> Tuple[DeviceAssignment, dict]:
    """Schedule -> balanced device assignment + rebalance report."""
    assignment = assign_microbatches(
        microbatch_costs(sched, c_f, c_b), n_devices, capacities,
        equal_counts=equal_counts)
    return assignment, rebalance_report(assignment)


def speed_capacities(costs, unit_times, slack: float = 1.1) -> np.ndarray:
    """[K] per-device cost budgets C_k from measured per-unit step times.

    The elastic loop's straggler mitigation: device k's share of the total
    schedule cost is proportional to its *speed* 1/u_k (u_k = the EMA of
    measured step time per unit of assigned cost), so a 2x-slow straggler
    gets half the budget of a healthy device and the knapsack shifts
    p_f-heavy micro-batches off it. ``slack`` > 1 keeps the capacities
    jointly feasible (sum C_k = slack * total cost) — the assigner treats
    a violated capacity as a report entry, not an error, so slack only
    shapes how hard the LPT seed and the refinement push."""
    costs = np.asarray(costs, np.float64)
    u = np.asarray(unit_times, np.float64)
    assert (u > 0).all(), f"unit times must be positive, got {u}"
    speed = 1.0 / u
    return slack * float(costs.sum()) * speed / speed.sum()


def weighted_makespan(assignment: DeviceAssignment,
                      unit_times) -> float:
    """Predicted step time under heterogeneous speeds: the slowest
    device's (assigned cost x per-unit time)."""
    u = np.asarray(unit_times, np.float64)
    return float((assignment.loads * u).max())


# ----------------------------------------------- execution-layer bridging
def device_sample_order(assignment: DeviceAssignment, mb_of: np.ndarray
                        ) -> np.ndarray:
    """[B] sample permutation making the batch device-contiguous.

    After ``batch[perm]``, device k's shard (rows k*B/K : (k+1)*B/K under a
    PartitionSpec("data") sharding) holds exactly the samples of its
    assigned micro-batches. Requires an equal_counts assignment and
    equal-size micro-batches, so every shard comes out the same size."""
    parts = [np.nonzero(np.isin(mb_of, assignment.items_of(k)))[0]
             for k in range(assignment.n_devices)]
    sizes = {len(p) for p in parts}
    assert len(sizes) == 1, \
        f"uneven device shards {[len(p) for p in parts]}: the shard_map " \
        "step needs an equal_counts assignment and equal micro-batches"
    return np.concatenate(parts)


def distributed_live_bounds(sched: Schedule, mb_of: np.ndarray,
                            assignment: DeviceAssignment
                            ) -> Tuple[int, int]:
    """Per-device static (live_fwd, live_bwd) compaction bounds.

    Each device only dispatches its local shard's live slices, so the
    single SPMD program's static bound is the max over devices — much
    tighter than the global-batch bound when the assigner balanced the
    p_f / p_o counts (the whole point of Eq. 4)."""
    live_f = live_b = 0
    for k in range(assignment.n_devices):
        local = mb_of[np.isin(mb_of, assignment.items_of(k))]
        if len(local) == 0:
            continue
        lf, lb = live_slice_bounds(sched, local)
        live_f, live_b = max(live_f, lf), max(live_b, lb)
    return live_f, live_b


# ------------------------------------------------ pipeline stage assignment
def layer_live_costs(sched: Schedule, c_f: float = 0.4, c_b: float = 0.6
                     ) -> np.ndarray:
    """[L] — live schedule cost of each LAYER summed over its head groups
    and every micro-batch (p_f = c_f + c_b, p_o = c_f, p_s = 0): the item
    weights of the pipeline-stage generalization of Eq. 4. A layer whose
    groups are mostly p_s is nearly free, so stages must be balanced by
    this, not by layer count."""
    t = sched.layer_group_view()                       # [L, G, N]
    per_op = np.where(t == P_F, c_f + c_b, np.where(t == P_O, c_f, 0.0))
    return per_op.sum(axis=(1, 2))


@dataclass(frozen=True)
class StageAssignment:
    """Contiguous layer ranges -> pipeline stages.

    boundaries: (S+1,) ints with boundaries[0] == 0 and
    boundaries[S] == L; stage s owns layers
    [boundaries[s], boundaries[s+1]).
    """
    boundaries: Tuple[int, ...]
    costs: np.ndarray                         # [L] layer costs used
    capacities: Optional[np.ndarray] = None   # [S] or None

    @property
    def n_stages(self) -> int:
        return len(self.boundaries) - 1

    @property
    def n_layers(self) -> int:
        return int(self.boundaries[-1])

    @property
    def stage_of(self) -> np.ndarray:
        out = np.zeros(self.n_layers, np.int64)
        for s in range(self.n_stages):
            out[self.boundaries[s]:self.boundaries[s + 1]] = s
        return out

    @property
    def loads(self) -> np.ndarray:
        return np.asarray([float(self.costs[self.boundaries[s]:
                                            self.boundaries[s + 1]].sum())
                           for s in range(self.n_stages)])

    def layer_range(self, s: int) -> Tuple[int, int]:
        return int(self.boundaries[s]), int(self.boundaries[s + 1])


def _uniform_boundaries(L: int, S: int) -> Tuple[int, ...]:
    """Layer-count split (np.array_split sizes): the schedule-blind
    baseline the live-cost assigner is measured against."""
    base, extra = divmod(L, S)
    sizes = [base + (1 if s < extra else 0) for s in range(S)]
    bounds = [0]
    for sz in sizes:
        bounds.append(bounds[-1] + sz)
    return tuple(bounds)


def assign_stages(costs, n_stages: int, capacities=None) -> StageAssignment:
    """Pack L layers into S CONTIGUOUS stages minimizing the bottleneck.

    Exact min-max contiguous-partition DP (O(S * L^2), host-side like the
    micro-batch knapsack): f[s][j] = min over i of
    max(f[s-1][i], w(i, j)) with w(i, j) the cost of layers [i, j) — or
    the *normalized* load w(i, j) / C_s when per-stage ``capacities`` are
    given (heterogeneous stage devices, same convention as
    ``speed_capacities``). Every stage gets at least one layer; ties break
    on the lowest boundary so identical inputs replan identically."""
    costs = np.asarray(costs, np.float64)
    L, S = len(costs), int(n_stages)
    assert S >= 1
    if L < S:
        raise ValueError(f"cannot split {L} layers into {S} non-empty "
                         "contiguous stages")
    caps = None
    if capacities is not None:
        caps = np.broadcast_to(np.asarray(capacities, np.float64), (S,))
        assert (caps > 0).all(), f"stage capacities must be > 0, got {caps}"
    prefix = np.concatenate([[0.0], np.cumsum(costs)])

    def w(s, i, j):
        load = prefix[j] - prefix[i]
        return load / caps[s] if caps is not None else load

    INF = float("inf")
    # f[s][j]: best bottleneck putting the first j layers into s+1 stages
    f = np.full((S, L + 1), INF)
    arg = np.zeros((S, L + 1), np.int64)
    for j in range(1, L + 1):
        f[0][j] = w(0, 0, j)
    for s in range(1, S):
        for j in range(s + 1, L + 1):
            best, best_i = INF, s
            for i in range(s, j):
                v = max(f[s - 1][i], w(s, i, j))
                if v < best - 1e-15:
                    best, best_i = v, i
            f[s][j], arg[s][j] = best, best_i
    bounds = [L]
    for s in range(S - 1, 0, -1):
        bounds.append(int(arg[s][bounds[-1]]))
    bounds.append(0)
    return StageAssignment(tuple(reversed(bounds)), costs, caps)


def stage_report(assignment: StageAssignment) -> dict:
    """Live-cost stage balance vs the layer-count baseline.

    ``makespan_ratio`` < 1 is the live-cost assigner beating the
    schedule-blind equal-layer split (the bench gates < 0.95 on the paper
    mix); == 1 means the uniform split was already optimal."""
    loads = assignment.loads
    uniform = StageAssignment(
        _uniform_boundaries(assignment.n_layers, assignment.n_stages),
        assignment.costs, assignment.capacities)
    uloads = uniform.loads
    umax = float(uloads.max())
    return {
        "n_stages": assignment.n_stages,
        "n_layers": assignment.n_layers,
        "boundaries": [int(b) for b in assignment.boundaries],
        "loads": [round(float(x), 6) for x in loads],
        "makespan": round(float(loads.max()), 6),
        "layer_count_boundaries": [int(b) for b in uniform.boundaries],
        "layer_count_makespan": round(umax, 6),
        "makespan_ratio": round(float(loads.max()) / umax, 6)
        if umax > 0 else 1.0,
    }


def plan_stage_assignment(sched: Schedule, n_stages: int, capacities=None,
                          *, c_f: float = 0.4, c_b: float = 0.6
                          ) -> Tuple[StageAssignment, dict]:
    """Schedule -> live-cost-balanced stage assignment + report. Re-run at
    every schedule refresh, exactly like ``plan_device_assignment``."""
    assignment = assign_stages(layer_live_costs(sched, c_f, c_b), n_stages,
                               capacities)
    return assignment, stage_report(assignment)
