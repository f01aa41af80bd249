"""Collective-traffic accounting of the port's recorded calls (port of
``repro/launch/hlo.py``).

The JAX package lowers and compiles a step and parses the collectives out
of its HLO text. A port step runs eagerly: there is no HLO to parse. The
mesh's ``CollectiveCounter`` records every call a step makes instead
(``launch.mesh.CollectiveRecord``: kind, operation class, bytes, group size
k, axis), and these functions price the records with JAX's formulas, under
JAX's names.

Two differences follow. A record is one call, where an HLO instruction may
stand for a fused or split collective: the port sends one bucket a dtype,
so ``collective_counts`` counts calls. And a record's bytes are the ones
the mesh counts: the payload of an all-reduce, a broadcast or a send, a
reduce-scatter's input and an all-gather's output; JAX's parser reads each
instruction's result, which for a reduce-scatter is the output, so its
``(k - 1) * n_out`` is ``(k - 1) / k`` of the input counted here.
"""
from __future__ import annotations

from collections import Counter
from typing import Dict, Iterable

# per-rank ring traffic a payload byte costs, by operation class, at group
# size k (JAX's ``collective_bytes`` formulas; a broadcast, which JAX's
# steps never emit, as a pipelined ring moves it: (k - 1) / k)
_TRAFFIC = {
    "all-gather": lambda k: (k - 1) / k,
    "all-reduce": lambda k: 2 * (k - 1) / k,
    "reduce-scatter": lambda k: (k - 1) / k,
    "all-to-all": lambda k: (k - 1) / k,
    "collective-permute": lambda k: 1.0,
    "broadcast": lambda k: (k - 1) / k,
}


def collective_bytes(records: Iterable,
                     default_group_size: int = 2) -> Dict[str, float]:
    """Per-rank traffic (bytes) by operation class over ``records``
    (``CollectiveRecord``s, or anything with ``op``, ``nbytes`` and
    ``k``).

    Formulas (ring algorithms, k = group size, n = recorded bytes):
      all-gather: (k-1)/k * n_out ; all-reduce: 2*(k-1)/k * n ;
      reduce-scatter: (k-1)/k * n_in = (k-1) * n_out ;
      all-to-all: (k-1)/k * n ; collective-permute: n ;
      broadcast: (k-1)/k * n.
    default_group_size: the k of a record that carries none (k 0 or
    None). ValueError for an operation class without a formula."""
    out: Dict[str, float] = Counter()
    for r in records:
        k = r.k or default_group_size
        try:
            share = _TRAFFIC[r.op]
        except KeyError:
            raise ValueError(f"no traffic formula for {r.op!r}") from None
        out[r.op] += share(k) * r.nbytes
    return dict(out)


def compare_collective_bytes(a: Iterable, b: Iterable, *,
                             default_group_size: int = 2
                             ) -> Dict[str, float]:
    """Total per-rank collective bytes of two record lists and their
    ratio: the wire-invariance check of streamed ZeRO-3 (its per-unit
    gathers and scatters must move what the unstreamed step moves)."""
    ta = float(sum(collective_bytes(a, default_group_size).values()))
    tb = float(sum(collective_bytes(b, default_group_size).values()))
    return {"a_bytes": ta, "b_bytes": tb,
            "ratio": ta / tb if tb else (1.0 if not ta else float("inf"))}


def collective_counts(records: Iterable) -> Dict[str, int]:
    """Calls by operation class: lets a check ask whether a step made the
    expected collectives (the ZeRO-3 steps all-gather, the masked ones do
    not)."""
    return dict(Counter(r.op for r in records))
