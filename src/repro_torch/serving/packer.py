"""Request-level knapsack: shape the serving queue into admission waves
(port of ``repro/serving/packer.py``: host-side numpy, the same plan).

The training side solves WHERE micro-batches run with a multiple-knapsack
(``core/assignment.py``). Serving has the same shape of problem one level
up: N queued requests with known prompt lengths and generation budgets must
be packed against two hard resources — batch slots and KV pages — so that
no admission wave overflows the page pool and the waves carry near-equal
work (the pool drains wave by wave; a lopsided wave is a straggler exactly
like an overloaded device in training).

We reuse ``assign_microbatches`` verbatim by choosing the item weight to be
the request's **worst-case page count** (prompt + max_new tokens, ceil to
pages). Pages are the binding resource — the reservation-based admission in
``PageManager`` means a wave is feasible iff its summed worst-case pages fit
the pool — and page count is simultaneously a decent proxy for decode-time
attention cost, so balancing pages balances both memory and work. The
per-wave capacity is then literally the pool capacity, in the same units.

``plan_waves`` grows the wave count until the assignment is feasible (no
wave over the page budget, no wave over ``max_slots`` requests) — the
deterministic analogue of admission back-pressure. ``request_cost`` is the
finer FLOP-model cost (linear + quadratic prompt terms) used by the bench
to report imbalance, and available as an alternative weight.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from repro_torch.core.assignment import (assign_microbatches,
                                         rebalance_report)
from repro_torch.serving.pages import pages_needed


def request_cost(prompt_len: int, max_new_tokens: int, *,
                 c_lin: float = 1.0, c_quad: float = 0.01) -> float:
    """FLOP-model cost of one request: prefill is linear + quadratic in the
    prompt (attention), decode adds max_new steps each attending to a
    growing history (~ S + max_new/2 average)."""
    s, m = float(prompt_len), float(max_new_tokens)
    prefill = c_lin * s + c_quad * s * s
    decode = m * (c_lin + c_quad * (s + m / 2.0))
    return prefill + decode


def worst_case_pages(prompt_len: int, max_new_tokens: int,
                     page_size: int) -> int:
    """Pages the request can ever need under reservation-based admission."""
    return pages_needed(prompt_len + max_new_tokens, page_size)


def plan_waves(requests: Sequence[Tuple[int, int]], *, page_size: int,
               page_budget: int, max_slots: int,
               max_waves: int = 1024) -> List[List[int]]:
    """Partition queued requests into admission waves.

    requests: [(prompt_len, max_new_tokens), ...]; page_budget: usable pages
    (``PageManager.capacity``); max_slots: engine batch slots. Returns a
    list of waves, each a list of request indices, such that every wave's
    summed worst-case pages fit the budget and no wave exceeds max_slots.
    Waves are balanced by the multiple-knapsack solver (pages as weights,
    budget as per-wave capacity); the wave count is the smallest feasible
    one, found by growing from the lower bound. Deterministic throughout.
    """
    n = len(requests)
    if n == 0:
        return []
    pages = np.array([worst_case_pages(s, m, page_size)
                      for s, m in requests], np.float64)
    too_big = [i for i in range(n) if pages[i] > page_budget]
    if too_big:
        raise ValueError(
            f"requests {too_big} exceed the page budget {page_budget} even "
            "alone (prompt + max_new too long for the pool)")
    lower = max(int(np.ceil(pages.sum() / page_budget)),
                int(np.ceil(n / max_slots)), 1)
    for n_waves in range(lower, max_waves + 1):
        if n_waves > n:
            break
        asg = assign_microbatches(pages, n_waves, capacities=page_budget)
        counts = asg.counts
        if rebalance_report(asg)["capacity_ok"] and \
                counts.max() <= max_slots:
            return [list(map(int, asg.items_of(k)))
                    for k in range(n_waves)]
    # one request per wave always fits (checked above)
    return [[i] for i in range(n)]


def pack_report(requests: Sequence[Tuple[int, int]],
                waves: List[List[int]], *, page_size: int) -> dict:
    """Imbalance summary for the bench artifact: per-wave pages and
    FLOP-model cost spread."""
    wave_pages = [sum(worst_case_pages(*requests[i], page_size)
                      for i in w) for w in waves]
    wave_cost = [sum(request_cost(*requests[i]) for i in w) for w in waves]
    return {
        "n_waves": len(waves),
        "wave_pages": wave_pages,
        "wave_cost_max": max(wave_cost) if wave_cost else 0.0,
        "wave_cost_mean": (sum(wave_cost) / len(wave_cost))
        if wave_cost else 0.0,
    }
