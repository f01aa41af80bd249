"""The port's collective records (``launch/mesh.py``'s
``CollectiveCounter``) and their pricing (``launch/collectives.py``, the
counterpart of ``repro/launch/hlo.py``) against the JAX package on the
CPU, and ``launch/diststep.py::measure_elastic`` on four gloo ranks.

* ``collective_bytes`` and ``collective_counts`` of a record equal JAX's
  on the equivalent HLO instruction (built as ``tests/test_distributed.py``
  builds its lines), for every operation class and k in {2, 4, 8}, one at
  a time and all in one text; a record without a group size takes the
  default, as JAX's ``replica_groups={}`` does; ``compare_collective_bytes``
  is JAX's.
* The mesh records every call it makes under the kind the caller names,
  with the class ``COLLECTIVE_OPS`` gives (the table is checked entry by
  entry); the per-kind totals leave out the recorded-only kinds; an
  unknown kind, a kind of another class, a counted block without a mesh
  call and a recorded-only kind in the totals raise.
* ``measure_elastic(4)`` runs once in a module fixture
  (``tests/_torch_dist_ranks.py``, which imports no jax; JAX's own needs
  four forced host devices and takes minutes), and its record is held to
  what JAX's code gives at four devices: the fault plans read as
  ``FaultPlan`` reads them ((step, device)): the dropout of device 5 at
  step 3 shrinks the world to ``feasible_survivor_count(4, 16)`` = 2
  ranks, which replay 1 step from the step-2 checkpoint and end within
  1e-6 of a fresh resume of it; the NaN burst on device 1 at step 2 is
  the one guard skip (device 6's inf burst at step 3 has no rank); the
  two dropped syncs put the loop in the lo-fi mode at step 2; the
  straggler's mitigation ratio is the port's elastic planner's on the
  recorded unit times.
"""
import numpy as np
import pytest
import torch

from repro.launch import hlo as jax_hlo
from repro.launch.faults import FaultPlan as JaxFaultPlan
from repro.train.elastic import \
    feasible_survivor_count as jax_survivor_count
from repro_torch.core.assignment import (microbatch_costs,
                                         plan_device_assignment,
                                         speed_capacities, weighted_makespan)
from repro_torch.core.schedule import Schedule
from repro_torch.launch import collectives, mesh as mesh_mod
from repro_torch.launch.mesh import (COLLECTIVE_OPS, CollectiveCounter,
                                     CollectiveRecord, make_data_mesh)

from _torch_dist_ranks import run_ranks

OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
       "collective-permute")
ELEMS = 100                              # a line's result elements


def _hlo_line(op, k, n=ELEMS, groups=True):
    """One HLO instruction of ``op`` over a group of k with an f32[n]
    result; (line, the bytes the port's mesh counts for the same call:
    a reduce-scatter's input, an all-gather's output, else the payload)."""
    rg = "replica_groups={{" + ",".join(map(str, range(k))) + "}}" \
        if groups else "replica_groups={}"
    inp = {"all-gather": n // k, "reduce-scatter": n * k}.get(op, n)
    if op == "collective-permute":
        attrs = "source_target_pairs={{0,1},{1,0}}"
    else:
        attrs = rg + ", to_apply=%sum"
    line = (f"%x = f32[{n}]{{0}} {op}(f32[{inp}] %y), channel_id=1, "
            f"{attrs}")
    counted = {"reduce-scatter": n * k}.get(op, n) * 4
    return line, counted


@pytest.mark.parametrize("k", [2, 4, 8])
@pytest.mark.parametrize("op", OPS)
def test_collective_bytes_of_a_record_equal_jaxs_of_its_instruction(op, k):
    line, nbytes = _hlo_line(op, k)
    rec = CollectiveRecord("x", op, nbytes, k, "data")
    want = jax_hlo.collective_bytes(line, default_group_size=2)
    got = collectives.collective_bytes([rec], default_group_size=2)
    assert set(got) == set(want) == {op}
    assert got[op] == pytest.approx(want[op], rel=1e-12)
    assert collectives.collective_counts([rec]) == \
        jax_hlo.collective_counts(line) == {op: 1}


@pytest.mark.parametrize("k", [2, 4, 8])
def test_a_step_of_every_class_prices_as_jaxs_text(k):
    lines, records = [], []
    for i, op in enumerate(OPS):
        for j in range(i + 1):           # i + 1 instructions of class i
            line, nbytes = _hlo_line(op, k, n=ELEMS * (j + 1) * k)
            lines.append(line)
            records.append(CollectiveRecord("x", op, nbytes, k, "data"))
    text = "\n".join(lines)
    want = jax_hlo.collective_bytes(text, default_group_size=k)
    got = collectives.collective_bytes(records, default_group_size=k)
    assert got == pytest.approx(want, rel=1e-12)
    assert collectives.collective_counts(records) == \
        jax_hlo.collective_counts(text)


@pytest.mark.parametrize("k", [2, 4, 8])
def test_a_record_without_a_group_size_takes_the_default(k):
    line, nbytes = _hlo_line("all-reduce", k, groups=False)
    want = jax_hlo.collective_bytes(line, default_group_size=k)
    got = collectives.collective_bytes(
        [CollectiveRecord("x", "all-reduce", nbytes, 0, "data")],
        default_group_size=k)
    assert got == pytest.approx(want, rel=1e-12)


def test_compare_collective_bytes_is_jaxs():
    a_lines, a_recs, b_lines, b_recs = [], [], [], []
    for op in ("all-gather", "reduce-scatter", "all-reduce"):
        line, nbytes = _hlo_line(op, 4)
        a_lines.append(line)
        a_recs.append(CollectiveRecord("x", op, nbytes, 4, "data"))
        for _ in range(2):               # the same bytes in two halves
            line, nbytes = _hlo_line(op, 4, n=ELEMS // 2)
            b_lines.append(line)
            b_recs.append(CollectiveRecord("x", op, nbytes, 4, "data"))
    want = jax_hlo.compare_collective_bytes(
        "\n".join(a_lines), "\n".join(b_lines), default_group_size=4)
    got = collectives.compare_collective_bytes(a_recs, b_recs,
                                               default_group_size=4)
    assert got == pytest.approx(want, rel=1e-12)
    assert got["ratio"] == pytest.approx(1.0)
    assert collectives.compare_collective_bytes([], [])["ratio"] == 1.0


def test_broadcast_and_unknown_classes():
    """A broadcast (JAX's steps emit none) costs (k-1)/k of its payload a
    rank; a class without a formula raises."""
    rec = CollectiveRecord("broadcast", "broadcast", 400, 4, "world")
    assert collectives.collective_bytes([rec]) == {"broadcast": 300.0}
    with pytest.raises(ValueError, match="no traffic formula"):
        collectives.collective_bytes(
            [CollectiveRecord("x", "send", 4, 2, "data")])


def test_the_kinds_map_to_hlo_classes():
    assert COLLECTIVE_OPS == {
        "all_reduce": "all-reduce", "guard": "all-reduce",
        "tp_grad": "all-reduce", "tp_act": "all-reduce",
        "stage": "all-reduce", "merge": "all-reduce",
        "reduce_scatter": "reduce-scatter", "all_gather": "all-gather",
        "ckpt": "all-gather", "p2p": "collective-permute", "reshard": None,
        "metrics": "all-reduce", "barrier": "all-reduce",
        "broadcast": "broadcast"}
    assert mesh_mod.RECORDED_ONLY == {"metrics", "barrier", "broadcast"}
    with pytest.raises(ValueError, match="unknown collective kind"):
        mesh_mod.collective_op("allreduce")


def test_counter_refuses_unknown_kinds_and_wrong_classes():
    c = CollectiveCounter()
    with pytest.raises(ValueError, match="unknown collective kind"):
        c.record("psum", "all-reduce", 4, 2, "data")
    with pytest.raises(ValueError, match="not a all-gather"):
        c.record("ckpt", "all-reduce", 4, 2, "data")
    with pytest.raises(ValueError, match="recorded, not counted"):
        c.add("metrics", 4)
    with pytest.raises(ValueError, match="unknown collective kind"):
        c.add("bogus", 4)
    c.record("reshard", "all-gather", 8, 2, "data")    # whatever it calls
    c.add("reshard", 8)
    assert c.bytes == {"reshard": 8} and len(c.records) == 1


@pytest.fixture
def one():
    """A world of one on the CPU (an in-memory store, gloo)."""
    mesh = make_data_mesh(1, "cpu")
    yield mesh
    mesh.close()


def test_the_mesh_records_every_call(one):
    t, out = torch.arange(4.0), torch.empty(4)
    one.counted("all_reduce", 16, lambda: one.all_reduce_(t))
    one.all_reduce_(torch.zeros(3))
    one.all_reduce_(torch.zeros(1), kind="barrier")
    one.broadcast_(t)
    one.counted("reduce_scatter", 16, lambda: one.reduce_scatter_(out, t))
    one.counted("reshard", 16, lambda: one.all_gather_(out, t))
    one.counted("guard", 8, lambda: one.all_reduce_(torch.zeros(2)))
    recs = one.counter.records
    assert {r.axis for r in recs} == {"data"} and {r.k for r in recs} == {1}
    assert [(r.kind, r.op, r.nbytes) for r in recs] == [
        ("all_reduce", "all-reduce", 16),
        ("metrics", "all-reduce", 12),
        ("barrier", "all-reduce", 4),
        ("broadcast", "broadcast", 16),
        ("reduce_scatter", "reduce-scatter", 16),
        ("reshard", "all-gather", 16),
        ("guard", "all-reduce", 8)]
    # the totals are the counted kinds' alone, as before the records
    assert one.counter.bytes == {"all_reduce": 16, "reduce_scatter": 16,
                                 "reshard": 16, "guard": 8}
    assert one.counter.calls == {"all_reduce": 1, "reduce_scatter": 1,
                                 "reshard": 1, "guard": 1}
    # a group of one sends nothing a rank
    assert collectives.collective_bytes(recs) == {
        "all-reduce": 0.0, "broadcast": 0.0, "reduce-scatter": 0.0,
        "all-gather": 0.0}


def test_counted_blocks_are_checked(one):
    t = torch.zeros(4)
    with pytest.raises(ValueError, match="not a reduce-scatter"):
        one.counted("reduce_scatter", 16, lambda: one.all_reduce_(t))
    with pytest.raises(RuntimeError, match="made no collective"):
        one.counted("all_reduce", 16, lambda: None)
    with pytest.raises(ValueError, match="recorded, not counted"):
        one.counted("metrics", 16, lambda: one.all_reduce_(t))
    assert one.counter.pending is None and one.counter.bytes == {}
    # the block after a refused one records as usual
    one.counted("all_reduce", 16, lambda: one.all_reduce_(t))
    assert one.counter.records[-1].kind == "all_reduce"


def test_a_trivial_axis_records_its_calls_with_k_1():
    mesh = mesh_mod.DataMesh(rank=0, size=1, device=torch.device("cpu"),
                             backend="gloo", owns_group=False,
                             trivial=True)
    t = torch.ones(3)
    mesh.counted("all_reduce", 12, lambda: mesh.all_reduce_(t))
    out = torch.empty(3)
    mesh.counted("all_gather", 12, lambda: mesh.all_gather_(out, t))
    assert [(r.kind, r.k) for r in mesh.counter.records] == [
        ("all_reduce", 1), ("all_gather", 1)]
    assert torch.equal(out, t) and torch.equal(t, torch.ones(3))


# --------------------------------------------------- measure_elastic(4)
N_EL = 4


@pytest.fixture(scope="module")
def elastic_runs(tmp_path_factory):
    """Every rank's (record, captured capacity-mitigated assignments)."""
    outs = run_ranks("elastic_measure", tmp_path_factory.mktemp("elastic"),
                     {}, world=N_EL)
    return [(o["record"], o["mitigated"]) for o in outs]


def test_elastic_record_layout(elastic_runs):
    for rank, (rec, _) in enumerate(elastic_runs):
        assert rec["rank"] == rank and rec["n_devices"] == N_EL
        assert rec["backend"] == "cpu"
        assert rec["model"] == {"name": "elastic", "n_layers": 4,
                                "d_model": 64, "n_heads": 4, "d_ff": 128,
                                "vocab": 256}
        assert rec["shape"] == {"batch": 32, "seq": 16,
                                "n_microbatches": 16}


def test_elastic_dropout_recovers_as_a_fresh_resume(elastic_runs):
    plan = JaxFaultPlan(dropout=(3, 5))
    step, _ = plan.dropout
    for rank, (rec, _) in enumerate(elastic_runs):
        d = rec["dropout"]
        assert d["n_devices_after"] == jax_survivor_count(N_EL, 16) == 2
        if rank < 2:                      # the survivors
            assert d["ckpt_step"] == step // 2 * 2 == 2
            assert d["recovery_steps"] == step - d["ckpt_step"] == 1
            assert d["resume_parity_diff"] <= 1e-6
            assert d["resume_opt_diff"] <= 1e-6
        else:                             # out of the survivors
            assert d["ckpt_step"] is None and "resume_parity_diff" not in d


def test_elastic_guard_skips_the_bursts_that_reach_a_rank(elastic_runs):
    plan = JaxFaultPlan(grad_faults=((2, 1, float("nan")),
                                     (3, 6, float("inf"))))
    want = [s for s in range(8)
            if not np.all(plan.grad_fault_vector(s, N_EL) == 1.0)]
    assert want == [2]
    for rec, _ in elastic_runs:
        g = rec["nan_guard"]
        assert g["skip_steps"] == want and g["steps_skipped"] == 1
        assert g["clean_loss_drop"] > 0
        assert g["gap_fraction"] == pytest.approx(
            g["loss_gap"] / g["clean_loss_drop"], abs=2e-6)
    assert len({rec["nan_guard"]["final_loss_faulted"]
                for rec, _ in elastic_runs}) == 1


def test_elastic_lofi_falls_back_at_the_threshold(elastic_runs):
    for rec, _ in elastic_runs:
        lo = rec["lofi"]
        # syncs dropped at steps 1 and 2 reach the threshold of 2 at step 2
        assert lo["n_fallbacks"] == 1 and lo["fallback_step"] == 2
        assert lo["sync_drops"] == 2
        assert lo["n_merges"] >= 1
        assert lo["final_mode_local"] == 1
        assert lo["loss_drop"] > 0


def test_elastic_straggler_ratio_is_the_planners(elastic_runs):
    rec, mitigated = elastic_runs[0]
    s = rec["straggler"]
    assert s["n_refreshes"] == 3 and s["n_capacity_refreshes"] == 2
    ut = np.asarray(s["unit_times"])
    assert s["straggler_unit_time"] == ut[3] > 1.0
    assert np.all(ut[:3] == 1.0)
    last = mitigated[-1]
    sched = Schedule(last["table"].numpy(), 4, 4)
    caps = speed_capacities(microbatch_costs(sched), ut, 1.1)
    np.testing.assert_allclose(caps, last["caps"].numpy(), rtol=1e-12)
    mit, _ = plan_device_assignment(sched, N_EL, caps)
    base, _ = plan_device_assignment(sched, N_EL, None)
    ratio = weighted_makespan(mit, ut) / weighted_makespan(base, ut)
    assert s["mitigation_ratio"] == round(ratio, 6) < 1.0
    assert s["makespan"] == round(weighted_makespan(mit, ut), 6)
    assert s["unmitigated_makespan"] == round(
        weighted_makespan(base, ut), 6)


def test_elastic_ranks_agree(elastic_runs):
    r0 = elastic_runs[0][0]
    for rec, _ in elastic_runs[1:]:
        for key in ("straggler", "nan_guard", "lofi"):
            a = {k: v for k, v in rec[key].items() if k != "wall_s"}
            b = {k: v for k, v in r0[key].items() if k != "wall_s"}
            assert a == b, key
