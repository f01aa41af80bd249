"""The port's GPipe pipeline (``repro_torch/train/pipeline.py``) against
the JAX package's ``repro/train/pipeline.py`` on the CPU, in one process:

* ``analytic_bubble_fraction`` equals JAX's (hypothesis);
* ``pipeline_loss`` on S stage ranks run as threads, whose stage axis is a
  set of queues: the stages' partial losses and grads sum to the port's
  ``lm_loss`` and its grads (1e-6) and to JAX's loss (1e-5), gated by the
  JAX multi-axis suite's table, at S = 1, 2 (the live-cost boundaries) and
  3, M = 1, 2 and 4; every rank's ``PipelineRecorder.report()`` equals the
  JAX recorder's from tracing its pipeline on the same boundaries and M;
  each rank's point-to-point sends are M a direction.
"""
import queue
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from conftest import optional_hypothesis
from repro.core.schedule import gates_from_schedule as jax_gates
from repro.core.schedule import Schedule as JaxSchedule
from repro.models.transformer import init_model as jax_init_model
from repro.models.transformer import lm_loss as jax_lm_loss
from repro.train.pipeline import analytic_bubble_fraction as jax_bubble
from repro_torch.configs.base import ModelConfig
from repro_torch.core.assignment import plan_stage_assignment
from repro_torch.core.schedule import Schedule, gates_from_schedule
from repro_torch.data.synthetic import lm_batches, microbatch_assignment
from repro_torch.interop import params_from_jax
from repro_torch.launch.mesh import CollectiveCounter
from repro_torch.models.transformer import init_model, lm_loss
from repro_torch.train.loop import _grads
from repro_torch.train.pipeline import (PipelineRecorder,
                                        analytic_bubble_fraction,
                                        pipeline_loss)

from _torch_multiaxis_ref import (DENSE, JCFG, G, L, N, jax_trace_report,
                                  multiaxis_table)

given, settings, st = optional_hypothesis()

CFG = ModelConfig(**DENSE)
B, S = 16, 16


@settings(max_examples=40, deadline=None)
@given(loads=st.lists(st.floats(0.0, 100.0, allow_nan=False), min_size=1,
                      max_size=8),
       n_mb=st.integers(1, 16))
def test_bubble_fraction_matches_jax(loads, n_mb):
    assert analytic_bubble_fraction(loads, n_mb) == jax_bubble(loads, n_mb)


class _QueueAxis:
    """A stage axis of threads: ``send_`` puts a copy in the pair's queue,
    ``recv_`` takes it."""

    def __init__(self, rank, size, boxes):
        self.rank, self.size, self.boxes = rank, size, boxes
        self.counter = CollectiveCounter()

    def send_(self, t, dst):
        self.boxes[(self.rank, dst)].put(t.detach().clone())
        self.counter.add("p2p", t.numel() * t.element_size())

    def recv_(self, t, src):
        t.copy_(self.boxes[(src, self.rank)].get(timeout=120))
        return t


@pytest.fixture(scope="module")
def setup():
    """JAX's params, the table, the batch, JAX's gated loss on it and the
    port's ``lm_loss`` (loss, metrics, grads) on the same."""
    jparams = jax.jit(jax_init_model, static_argnums=1)(
        jax.random.PRNGKey(0), JCFG)
    table = multiaxis_table()
    batch = next(lm_batches(0, CFG.vocab_size, B, S, 1))
    gates = jax_gates(JaxSchedule(table, L, G), microbatch_assignment(B, N))
    jloss = float(jax.jit(lambda p: jax_lm_loss(
        p, JCFG, batch["tokens"], batch["labels"], gates=gates)[0])(jparams))
    ref = init_model(torch.Generator().manual_seed(0), CFG)
    ref.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams)))
    loss, metrics = lm_loss(
        ref, CFG, *(torch.as_tensor(batch[k]) for k in ("tokens", "labels")),
        gates=gates_from_schedule(Schedule(table, L, G),
                                  microbatch_assignment(B, N), "cpu"))
    grads = _grads(loss, dict(ref.named_parameters()))
    port = (loss.detach(), metrics["ce"].detach(), grads)
    return jparams, table, batch, jloss, port


@pytest.mark.parametrize("n_stages,n_mb", [(1, 4), (2, 1), (2, 4),
                                           (3, 2)])
def test_stages_sum_to_the_loss_and_grads(setup, n_stages, n_mb,
                                          monkeypatch):
    jparams, table, batch, jloss, (loss, ce, grads) = setup
    sched = Schedule(table, L, G)
    mb_of = microbatch_assignment(B, N)
    gates = gates_from_schedule(sched, mb_of, "cpu")
    tokens, labels = (torch.as_tensor(batch[k]) for k in ("tokens",
                                                           "labels"))
    if n_stages == 2:
        boundaries = plan_stage_assignment(sched, 2)[0].boundaries
    else:
        boundaries = {1: (0, 4), 3: (0, 1, 3, 4)}[n_stages]
    state = params_from_jax(jax.tree.map(np.asarray, jparams))
    models = []
    for _ in range(n_stages):
        m = init_model(torch.Generator().manual_seed(0), CFG)
        m.load_state_dict(state)
        models.append(m)
    boxes = {(a, b): queue.Queue() for a in range(n_stages)
             for b in range(n_stages)}
    axes = [_QueueAxis(r, n_stages, boxes) for r in range(n_stages)]
    recs = [PipelineRecorder() for _ in range(n_stages)]

    def stage(r):
        return pipeline_loss(
            models[r], CFG, dict(models[r].named_parameters()), tokens,
            labels, gates, boundaries=boundaries, n_microbatches=n_mb,
            stage=axes[r], recorder=recs[r])
    with ThreadPoolExecutor(n_stages) as pool:
        outs = list(pool.map(stage, range(n_stages)))

    got = sum(float(o[0]) for o in outs)
    assert abs(got - float(loss)) <= 1e-6
    assert abs(sum(float(o[1]["ce"]) for o in outs) - float(ce)) <= 1e-6
    assert abs(got - jloss) <= 1e-5
    for n, g in grads.items():
        total = sum(o[2][n] for o in outs)
        assert float((total - g).abs().max()) <= 1e-6, n

    theirs = jax_trace_report(jparams, boundaries, n_mb, S, monkeypatch)
    act = (B // n_mb) * S * CFG.d_model * 4
    for r, (rec, axis) in enumerate(zip(recs, axes)):
        assert rec.report() == theirs
        sends = n_mb * ((r < n_stages - 1) + (r > 0))
        assert axis.counter.calls.get("p2p", 0) == sends
        assert axis.counter.bytes.get("p2p", 0) == sends * act
