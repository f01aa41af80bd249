"""The port's ``core/assignment.py`` and ``serving/packer.py`` against the
JAX package's: numpy on both sides, so every output must be equal exactly
on seeded inputs (costs, capacities, schedule tables, request queues),
including ``plan_waves``' refusal of a request larger than the pool."""
import numpy as np
import pytest

from repro.core import assignment as jax_asg
from repro.core.schedule import Schedule as JaxSchedule
from repro.serving import packer as jax_packer
from repro_torch.core import assignment as asg
from repro_torch.core.schedule import Schedule
from repro_torch.serving import packer


def _same_assignment(mine, theirs):
    np.testing.assert_array_equal(mine.device_of, theirs.device_of)
    np.testing.assert_array_equal(mine.costs, theirs.costs)
    assert mine.n_devices == theirs.n_devices
    if theirs.capacities is None:
        assert mine.capacities is None
    else:
        np.testing.assert_array_equal(mine.capacities, theirs.capacities)
    np.testing.assert_array_equal(mine.loads, theirs.loads)
    np.testing.assert_array_equal(mine.counts, theirs.counts)


def _tables(seed, L=4, G=3, N=8):
    """A random schedule table [L*G, N] in {1, 2, 3}, in both packages'
    Schedule."""
    t = np.random.RandomState(seed).randint(1, 4, (L * G, N)).astype(np.int8)
    return Schedule(t, L, G), JaxSchedule(t, L, G)


@pytest.mark.parametrize("K,caps,equal", [
    (2, None, False), (3, None, False), (4, None, True), (3, 2.5, False),
    (4, [1.0, 2.0, 3.0, 4.0], False), (2, 0.5, False)])
def test_assign_microbatches_matches_jax(K, caps, equal):
    """LPT seed, DP transfer or best swap, capacities (one infeasible),
    equal counts: the same assignment and report."""
    costs = np.random.RandomState(K).uniform(0.1, 1.0, 12)
    mine = asg.assign_microbatches(costs, K, caps, equal_counts=equal)
    theirs = jax_asg.assign_microbatches(costs, K, caps, equal_counts=equal)
    _same_assignment(mine, theirs)
    assert asg.rebalance_report(mine) == jax_asg.rebalance_report(theirs)


@pytest.mark.parametrize("seed", [0, 1])
def test_schedule_planning_matches_jax(seed):
    """Costs from a schedule table, the device plan and its bridges (sample
    order, per-device live bounds), speed capacities and the makespan,
    the layer costs and the pipeline stage plan."""
    mine_s, their_s = _tables(seed)
    np.testing.assert_array_equal(asg.microbatch_costs(mine_s),
                                  jax_asg.microbatch_costs(their_s))
    a, ra = asg.plan_device_assignment(mine_s, 2)
    b, rb = jax_asg.plan_device_assignment(their_s, 2)
    _same_assignment(a, b)
    assert ra == rb
    mb_of = np.repeat(np.arange(8), 2)
    np.testing.assert_array_equal(asg.device_sample_order(a, mb_of),
                                  jax_asg.device_sample_order(b, mb_of))
    assert asg.distributed_live_bounds(mine_s, mb_of, a) == \
        jax_asg.distributed_live_bounds(their_s, mb_of, b)
    u = np.random.RandomState(seed).uniform(0.5, 2.0, 3)
    costs = asg.microbatch_costs(mine_s)
    np.testing.assert_array_equal(asg.speed_capacities(costs, u),
                                  jax_asg.speed_capacities(costs, u))
    caps = asg.speed_capacities(costs, u)
    a3 = asg.assign_microbatches(costs, 3, caps)
    b3 = jax_asg.assign_microbatches(costs, 3, caps)
    assert asg.weighted_makespan(a3, u) == jax_asg.weighted_makespan(b3, u)
    np.testing.assert_array_equal(asg.layer_live_costs(mine_s),
                                  jax_asg.layer_live_costs(their_s))
    for n_stages, stage_caps in ((2, None), (3, [1.0, 2.0, 1.0])):
        sa, sr = asg.plan_stage_assignment(mine_s, n_stages, stage_caps)
        sb, rb = jax_asg.plan_stage_assignment(their_s, n_stages, stage_caps)
        assert sa.boundaries == sb.boundaries and sr == rb
        np.testing.assert_array_equal(sa.stage_of, sb.stage_of)
        np.testing.assert_array_equal(sa.loads, sb.loads)
    with pytest.raises(ValueError, match="non-empty"):
        asg.assign_stages(np.ones(2), 3)


@pytest.mark.parametrize("seed,budget,slots", [(0, 40, 4), (1, 25, 3),
                                               (2, 100, 8)])
def test_plan_waves_matches_jax(seed, budget, slots):
    """Request costs, worst-case pages, the admission waves and their
    report on a seeded queue of 20 requests."""
    rng = np.random.RandomState(seed)
    reqs = [(int(s), int(m)) for s, m in zip(rng.randint(1, 120, 20),
                                             rng.randint(1, 64, 20))]
    for s, m in reqs[:4]:
        assert packer.request_cost(s, m) == jax_packer.request_cost(s, m)
        assert packer.worst_case_pages(s, m, 16) == \
            jax_packer.worst_case_pages(s, m, 16)
    mine = packer.plan_waves(reqs, page_size=16, page_budget=budget,
                             max_slots=slots)
    theirs = jax_packer.plan_waves(reqs, page_size=16, page_budget=budget,
                                   max_slots=slots)
    assert mine == theirs
    assert packer.pack_report(reqs, mine, page_size=16) == \
        jax_packer.pack_report(reqs, theirs, page_size=16)
    assert packer.plan_waves([], page_size=16, page_budget=budget,
                             max_slots=slots) == []


def test_plan_waves_refuses_an_oversize_request():
    reqs = [(10, 5), (400, 100), (3, 3)]
    for mod in (packer, jax_packer):
        with pytest.raises(ValueError, match=r"requests \[1\] exceed"):
            mod.plan_waves(reqs, page_size=16, page_budget=20, max_slots=4)
