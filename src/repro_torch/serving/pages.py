"""Paged KV cache: fixed-size pages, per-sequence page tables, free-list.

The serving analogue of vLLM's block manager, host-side and deterministic
(a near-verbatim port of ``repro/serving/pages.py``):
device memory for attention K/V is a pool of ``n_pages`` fixed-size pages
per attention layer, and each live sequence owns a *page table* — the
ordered list of page ids holding its tokens. Admitting a sequence allocates
pages off an explicit free-list; evicting it returns exactly those pages.
Nothing here touches torch: the device-side pools live in
``serving/paged_decode.py`` and are indexed by the int32 table this module
maintains.

Invariants:

* page 0 is the **null page** — permanently reserved, never handed out.
  Inactive batch slots and table padding point at it, so the fused decode
  step can write/gather unconditionally without corrupting live data;
* a page is owned by at most one sequence at a time (alloc/free round-trips
  are a bijection on the free-list);
* capacity is respected: admission *reserves* the worst-case page count
  (prompt + max new tokens) up front, so on-demand growth during decode can
  never fail mid-flight — there is no preemption path to get wrong.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np


def pages_needed(n_tokens: int, page_size: int) -> int:
    """Pages required to hold n_tokens (ceil division; 0 tokens -> 0)."""
    return -(-int(n_tokens) // int(page_size))


@dataclass
class PageManager:
    """Free-list page allocator with per-sequence page tables.

    ``n_pages`` counts the whole pool including the reserved null page 0,
    matching the device pool's leading dimension. ``capacity`` (usable
    pages) is therefore ``n_pages - 1``.
    """
    n_pages: int
    page_size: int
    free: List[int] = field(default_factory=list)
    tables: Dict[int, List[int]] = field(default_factory=dict)
    lengths: Dict[int, int] = field(default_factory=dict)
    reserved: Dict[int, int] = field(default_factory=dict)

    def __post_init__(self):
        assert self.n_pages >= 2, "need at least the null page + one page"
        assert self.page_size >= 1
        # LIFO free-list, low ids first so allocation order is deterministic
        self.free = list(range(self.n_pages - 1, 0, -1))

    # ------------------------------------------------------------- queries
    @property
    def capacity(self) -> int:
        return self.n_pages - 1

    @property
    def n_free(self) -> int:
        return len(self.free)

    @property
    def n_reserved(self) -> int:
        return sum(self.reserved.values())

    def can_admit(self, n_tokens_worst_case: int) -> bool:
        """Whether a sequence whose lifetime needs at most
        ``n_tokens_worst_case`` tokens of KV can be admitted now. Counts
        *reservations*, not just live allocations, so concurrent sequences
        can always grow to their admitted worst case."""
        need = pages_needed(n_tokens_worst_case, self.page_size)
        return self.n_free - self.n_reserved >= need

    def owner_of(self, page: int) -> Optional[int]:
        for sid, tab in self.tables.items():
            if page in tab:
                return sid
        return None

    # ---------------------------------------------------------- transitions
    def admit(self, seq_id: int, n_tokens: int,
              n_tokens_worst_case: Optional[int] = None) -> List[int]:
        """Allocate pages for ``n_tokens`` of prompt KV and reserve headroom
        up to ``n_tokens_worst_case`` (default: no headroom). Returns the
        page table. Raises if the sequence exists or capacity is exceeded —
        callers gate on ``can_admit`` first."""
        if seq_id in self.tables:
            raise ValueError(f"sequence {seq_id} already admitted")
        worst = n_tokens if n_tokens_worst_case is None \
            else max(n_tokens, n_tokens_worst_case)
        if not self.can_admit(worst):
            raise MemoryError(
                f"cannot admit seq {seq_id}: needs "
                f"{pages_needed(worst, self.page_size)} pages, "
                f"{self.n_free - self.n_reserved} unreserved free")
        n = pages_needed(n_tokens, self.page_size)
        table = [self.free.pop() for _ in range(n)]
        self.tables[seq_id] = table
        self.lengths[seq_id] = int(n_tokens)
        self.reserved[seq_id] = pages_needed(worst, self.page_size) - n
        return list(table)

    def append_token(self, seq_id: int) -> Optional[int]:
        """Account one more token for ``seq_id``; allocates (and returns) a
        new page when the token crosses a page boundary, else None. Draws
        from the admission reservation, so it cannot fail."""
        table = self.tables[seq_id]
        self.lengths[seq_id] += 1
        if pages_needed(self.lengths[seq_id], self.page_size) <= len(table):
            return None
        if self.reserved[seq_id] <= 0:
            raise MemoryError(
                f"seq {seq_id} grew past its admission reservation")
        self.reserved[seq_id] -= 1
        page = self.free.pop()
        table.append(page)
        return page

    def free_seq(self, seq_id: int) -> List[int]:
        """Evict: return the sequence's pages (and reservation) to the pool.
        Returns the freed page ids."""
        table = self.tables.pop(seq_id)
        del self.lengths[seq_id]
        del self.reserved[seq_id]
        self.free.extend(reversed(table))
        return list(table)

    # ------------------------------------------------------------ integrity
    def check(self) -> None:
        """Assert the structural invariants (cheap; tests call it after
        every transition)."""
        owned = [p for tab in self.tables.values() for p in tab]
        assert len(owned) == len(set(owned)), "page owned twice"
        assert 0 not in owned and 0 not in self.free, "null page leaked"
        assert not (set(owned) & set(self.free)), "page both owned and free"
        assert len(owned) + len(self.free) == self.capacity, \
            "pages lost or duplicated"
        assert self.n_reserved <= self.n_free, "reservation exceeds free"
        for sid, tab in self.tables.items():
            assert len(tab) == pages_needed(self.lengths[sid],
                                            self.page_size), \
                f"seq {sid}: table size != pages_needed(length)"

    def table_array(self, seq_id: int, width: int) -> np.ndarray:
        """[width] int32 page table row, padded with the null page 0 (the
        decode kernels' index maps require every entry to be a valid page
        id; padded entries are masked by the sequence length)."""
        tab = self.tables[seq_id]
        assert len(tab) <= width, (len(tab), width)
        row = np.zeros(width, np.int32)
        row[:len(tab)] = tab
        return row

    def utilization(self) -> dict:
        """Occupancy counters for the bench/report path."""
        tokens = sum(self.lengths.values())
        in_use = self.capacity - self.n_free
        return {
            "pages_in_use": in_use,
            "pages_free": self.n_free,
            "pages_reserved": self.n_reserved,
            "tokens_cached": tokens,
            "slot_utilization": (tokens / (in_use * self.page_size))
            if in_use else 0.0,
        }
