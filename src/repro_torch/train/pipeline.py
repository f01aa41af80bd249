"""GPipe-style micro-batch pipeline over the stage axis (port of
``repro/train/pipeline.py``).

Runs on one rank of a ``launch.mesh.Mesh`` with a ``stage`` axis. Each
stage rank owns a contiguous layer range chosen by the schedule-aware
assigner (``core.assignment.plan_stage_assignment``: stages balanced by
*live* cost, not layer count), and the rank's batch is split into M
micro-batches that flow stage to stage by ``send_`` / ``recv_``:

* round t, stage s works micro-batch ``m = t - s`` and is *active* when
  ``0 <= t - s < M``: the GPipe diagonal of ``M + S - 1`` rounds, bubble
  fraction ``(S - 1) / (M + S - 1)`` in round units
  (``analytic_bubble_fraction`` weights it by the stage loads).
* stage 0 embeds its micro-batch; every other stage receives the
  activation stage s - 1 sent in the round before.
* only the last stage runs the final norm, the head and ``fused_xent``.

The JAX package computes every round on every device and masks the bubble
rounds' garbage to exact zeros; here a rank simply works in its active
rounds only, which gives the same values.

The backward crosses the stages the other way: the last stage
differentiates its loss and sends each micro-batch's input cotangent to
stage s - 1, which differentiates its stored outputs against the received
cotangents (one ``torch.autograd.grad`` a stage, with its aux losses) and
sends its own input cotangents on. The returned loss, metrics and grads
are PARTIAL (this stage's layers, the last stage's head): the step sums
them over the stage axis. Each parameter is touched by exactly the
stage(s) that own it (the tied embedding by stage 0's lookup and the last
stage's unembed), so the sum reassembles the full-batch grads without
double counting. The D2FT gates ride along per micro-batch.
"""
from __future__ import annotations

from typing import Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import apply_embedding, torch_dtype
from repro_torch.models.transformer import (Transformer, fused_xent,
                                            logits_from_hidden)


# ----------------------------------------------------------- round records
class PipelineRecorder:
    """Pipeline counters (the JAX package's trace hooks): the rounds this
    rank walked and the round-boundary handoffs, checked against the
    analytic round / send model by ``report()``. ``send()`` counts a round
    boundary, where the JAX package's one ``ppermute`` over the stage axis
    runs (``n_sends = n_rounds - 1`` on every stage; none with one stage,
    as in the JAX package, whose report then says ``trace_ok`` False); the
    point-to-point transfers a rank makes (M forward sends on every stage
    but the last, M backward sends on every stage but the first) are the
    mesh counter's ``p2p`` calls."""

    def __init__(self):
        self.boundaries: Optional[Tuple[int, ...]] = None
        self.n_microbatches: Optional[int] = None
        self.rounds: list = []
        self.n_sends: int = 0

    def setup(self, boundaries, n_microbatches: int):
        self.boundaries = tuple(int(b) for b in boundaries)
        self.n_microbatches = int(n_microbatches)
        self.rounds = []
        self.n_sends = 0

    def round(self, t: int):
        self.rounds.append(int(t))

    def send(self):
        self.n_sends += 1

    @property
    def n_rounds(self) -> int:
        return len(self.rounds)

    def report(self) -> dict:
        S = len(self.boundaries) - 1
        M = self.n_microbatches
        expected_rounds = M + S - 1
        expected_sends = max(expected_rounds - 1, 0)
        return {
            "n_stages": S,
            "n_microbatches": M,
            "n_rounds": self.n_rounds,
            "n_sends": self.n_sends,
            "expected_rounds": expected_rounds,
            "expected_sends": expected_sends,
            "trace_ok": (self.n_rounds == expected_rounds
                         and self.n_sends == expected_sends),
        }


def analytic_bubble_fraction(loads: Sequence[float],
                             n_microbatches: int) -> float:
    """Idle fraction of the GPipe schedule under per-stage loads c_s:
    total time ~ (M + S - 1) * max(c), useful work per rank ~ M * mean(c),
    so bubble = 1 - M * mean(c) / ((M + S - 1) * max(c)). Uniform loads
    reduce to the classic (S - 1) / (M + S - 1)."""
    loads = np.asarray(loads, np.float64)
    S, M = len(loads), int(n_microbatches)
    cmax = float(loads.max())
    if cmax <= 0:
        return 0.0
    return float(1.0 - (M * loads.mean()) / ((M + S - 1) * cmax))


def _layer_params(model: Transformer, cfg: ModelConfig, layer: int):
    """(block, kind) of one layer: the port's layers are a flat list."""
    return model.layers[layer], cfg.layer_kinds[layer]


# ------------------------------------------------------------ pipeline loss
def pipeline_loss(model: Transformer, cfg: ModelConfig,
                  params: Mapping[str, torch.Tensor], tokens, labels, gates,
                  *, boundaries: Sequence[int], n_microbatches: int, stage,
                  tp=None, recorder: Optional[PipelineRecorder] = None):
    """This stage rank's part of the pipelined gated LM loss, forward and
    backward (the backward's cotangents cross the stages, so the two run
    together).

    tokens / labels: this data shard's [B_loc, T]; gates: (g_f, g_b) each
    [L, B_loc, G] or None; boundaries: the stage assigner's (S+1,) layer
    boundaries; stage: the stage axis (``launch.mesh.DataMesh``); params:
    name -> tensor to differentiate against (the model's parameters, or a
    ZeRO-3 step's installed views). ``tp`` threads the tensor axis into
    each block; ``recorder`` is a ``PipelineRecorder``. Returns (loss,
    {"ce", "aux"}, grads), detached and PARTIAL (see the module
    docstring); grads are zeros for the leaves this stage does not
    touch."""
    boundaries = tuple(int(b) for b in boundaries)
    S_stages = len(boundaries) - 1
    M = int(n_microbatches)
    if boundaries[0] != 0 or boundaries[-1] != cfg.n_layers:
        raise ValueError(f"stage boundaries {boundaries} do not cover the "
                         f"{cfg.n_layers} layers")
    if not all(b2 > b1 for b1, b2 in zip(boundaries, boundaries[1:])):
        raise ValueError(f"empty pipeline stage in {boundaries}")
    if stage.size != S_stages:
        raise ValueError(f"{S_stages} stages on a stage axis of "
                         f"{stage.size}")
    B, T = tokens.shape
    if B % M:
        raise ValueError(f"microbatches {M} must divide local batch {B}")
    mb = B // M
    s = stage.rank
    lo, hi = boundaries[s], boundaries[s + 1]
    first, last = s == 0, s == S_stages - 1
    cdt = torch_dtype(cfg.compute_dtype)
    dev = tokens.device
    if recorder is not None:
        recorder.setup(boundaries, M)

    inputs, outputs, ces, auxes = [], [], [], []
    n_rounds = M + S_stages - 1
    for t in range(n_rounds):
        if recorder is not None:
            recorder.round(t)
        m = t - s
        if 0 <= m < M:
            rows = slice(m * mb, (m + 1) * mb)
            if first:
                x = apply_embedding(model.embed, tokens[rows]).to(cdt)
            else:
                x = stage.recv_(torch.empty((mb, T, cfg.d_model), dtype=cdt,
                                            device=dev), s - 1)
                x.requires_grad_()
                inputs.append(x)
            aux = torch.zeros((), dtype=torch.float32, device=dev)
            for layer in range(lo, hi):
                blk, kind = _layer_params(model, cfg, layer)
                lg = None if gates is None else \
                    (gates[0][layer, rows], gates[1][layer, rows])
                x, a = blk(x, kind, cfg, lg, tp=tp)
                if a is not None:
                    aux = aux + a["load_balance"] + a["router_z"]
            auxes.append(aux)
            if last:
                ces.append(fused_xent(logits_from_hidden(model, cfg, x),
                                      labels[rows]))
            else:
                stage.send_(x, s + 1)
                outputs.append(x)
        if t < n_rounds - 1 and S_stages > 1 and recorder is not None:
            recorder.send()

    ce = torch.stack(ces).sum() / M if last else \
        torch.zeros((), dtype=torch.float32, device=dev)
    aux = torch.stack(auxes).sum() / M

    # backward: the last stage starts from its loss; every other stage
    # from the cotangents of its outputs, which stage s + 1 sends in
    # micro-batch order
    if last:
        roots, cots = [ce + aux], [None]
    else:
        roots = outputs
        cots = [stage.recv_(torch.empty_like(y, memory_format=
                                             torch.contiguous_format),
                            s + 1) for y in outputs]
        if aux.requires_grad:
            roots, cots = roots + [aux], cots + [torch.ones_like(aux)]
    names = list(params)
    leaves = [params[n] for n in names]
    got = torch.autograd.grad(roots, leaves + inputs, cots,
                              allow_unused=True)
    del roots, cots, outputs
    grads = {n: torch.zeros_like(p) if g is None else g
             for n, p, g in zip(names, leaves, got[:len(leaves)])}
    for x, g in zip(inputs, got[len(leaves):]):
        stage.send_(torch.zeros_like(x) if g is None else g, s - 1)
    ce, aux = ce.detach(), aux.detach()
    return ce + aux, {"ce": ce, "aux": aux}, grads
