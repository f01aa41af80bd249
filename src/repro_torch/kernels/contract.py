"""The gated block kernel contract (port of ``repro/kernels/contract.py``).

Every gated kernel speaks one interface:

* **gates** — forward gate ``g_f`` and backward gate ``g_b`` over the
  kernel's subnet axis (flattened (sample, head) slices), float {0, 1},
  with ``g_b <= g_f``: p_f subnets have (1, 1), p_o (1, 0), p_s (0, 0).
  ``g_f == 0`` slices give exact-zero outputs and run no compute;
  ``g_b == 0`` slices give exact-zero gradients and run no compute. Gates
  are schedule constants and get no gradient.
* **compaction bounds** — upper bounds (``live_fwd``, ``live_bwd``) on the
  live slice counts, from ``core/schedule.live_slice_bounds``. With a
  bound, the kernel launches ``dispatch_count(live, N)`` slice blocks
  instead of N; each block reads its slice id from the int32 table that
  ``live_permutation`` returns, so nothing is gathered or scattered.
* **executed-work counter** — in place of the JAX package's
  ``on_backward_block`` debug callback. Inside ``count_tiles(device)``,
  every attention kernel launch adds the number of (q tile, k tile) pairs
  it executed, every SSD and RG-LRU kernel launch the number of (slice,
  chunk) steps it executed, and every MoE kernel launch the number of
  (expert, capacity-block) tiles it executed, to a device int64 counter,
  one atomic per block.
  Reading the counter synchronises, so it is off on the normal path.
* **fallback hook** — a route that takes no kernel despite
  ``use_kernel=True`` reports itself through ``on_fallback``.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterator, Optional

import torch

# Hook: when set to a callable, every place that takes a non-kernel route
# despite use_kernel=True calls ``on_fallback(kind, reason)``.
on_fallback = None


def report_fallback(kind: str, reason: str):
    if on_fallback is not None:
        on_fallback(kind, reason)


def dispatch_count(live, N: int) -> int:
    """Number of slices to launch: the live-count upper bound clamped to
    [1, N]; None disables compaction (dispatch all N slices)."""
    if live is None or live >= N:
        return N
    return max(1, int(live))


def live_permutation(gate_flat: torch.Tensor, n_dispatch: int) -> torch.Tensor:
    """First ``n_dispatch`` entries of the stable permutation that sorts live
    (gate != 0) slices to the front, keeping the original order within each
    class. Dead slices padding the tail carry gate 0 and are skipped inside
    the kernels. Runs on the gates' device without a host sync."""
    dead = (gate_flat == 0).to(torch.int32)
    return torch.argsort(dead, stable=True)[:n_dispatch]


class TileCounter:
    """Executed work per kernel, summed on the device: (q tile, k tile)
    pairs of the attention kernels, ``fwd`` (forward kernel), ``bwd_dkdv``
    and ``bwd_dq`` (the two backward kernels, each of which executes every
    live tile once); (slice, chunk) steps of the SSD kernels, ``ssd_fwd``
    and ``ssd_bwd``, and of the RG-LRU kernels, ``rglru_fwd`` and
    ``rglru_bwd``; (expert, capacity-block) tiles of the MoE kernels,
    ``moe_fwd`` (one per tile with a live forward slot) and ``moe_bwd``
    (one per tile with a live backward slot inside the truncated grid)."""

    KINDS = ("fwd", "bwd_dkdv", "bwd_dq", "ssd_fwd", "ssd_bwd", "rglru_fwd",
             "rglru_bwd", "moe_fwd", "moe_bwd")

    def __init__(self, device):
        self.counts = torch.zeros(len(self.KINDS), dtype=torch.int64,
                                  device=device)

    def slot(self, kind: str) -> int:
        """Device address of ``kind``'s int64 cell, for a kernel launch."""
        return self.counts[self.KINDS.index(kind)].data_ptr()

    def read(self) -> Dict[str, int]:
        """The counts so far (a device synchronisation)."""
        return dict(zip(self.KINDS, self.counts.tolist()))


# Set only inside ``count_tiles``; the kernel launchers read it.
tile_counter: Optional[TileCounter] = None


@contextlib.contextmanager
def count_tiles(device) -> Iterator[TileCounter]:
    """Count the tiles every gated-kernel launch executes inside the block."""
    global tile_counter
    prev, tile_counter = tile_counter, TileCounter(device)
    try:
        yield tile_counter
    finally:
        tile_counter = prev
