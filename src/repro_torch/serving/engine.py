"""Continuous-batching serving engine over the paged KV cache (port of
``repro/serving/engine.py``).

One engine owns: the model, a ``PageManager`` (host-side page accounting,
serving/pages.py), the per-layer device pools (serving/paged_decode.py)
and a fixed bank of ``max_slots`` batch slots. Requests are admitted into
free slots **mid-flight** — a new sequence's prefill lands while older
sequences keep decoding — and every step advances ALL live slots with one
``paged_decode_step``. Finished or evicted sequences return their pages to
the free-list immediately; the next waiting request takes the slot on the
following step. Admission reserves the worst-case page count (prompt +
max_new_tokens), so a live sequence can never fail to grow and nothing is
ever swapped out.

Slot/device contract (shared with ``paged_decode_step``):
* inactive slots keep an all-null page-table row and length 0 — the step
  writes their K/V into the null page sink and their logits are garbage
  the engine never reads. Recurrent (SSD / RG-LRU) slot state is likewise
  garbage for inactive slots and is overwritten at admission.
* batch-independence: a slot's logits depend only on its own row of
  (page_table, lengths) and its own pages and state — admitting or
  evicting a neighbour mid-flight cannot change another sequence's tokens.
  An MoE FFN is the exception, as in the JAX package: its router sees all
  ``max_slots`` rows, inactive ones included, so slots couple through the
  experts' capacity.
* the page ids are checked once a step on the host copy of the table
  (``ops.check_page_ids``), so the kernel path syncs with the device once
  a step, to read the logits, and not once a layer.

Prefill is the batched ``prefill_forward`` (one pass per admitted request)
written straight into pages. Greedy decoding only (argmax, first index on
ties as in ``jnp.argmax``), FIFO admission with head-of-line blocking.

``self._prefill`` and ``self._step`` are the two device calls of the
engine; a caller may wrap them (``chip_smoke.py`` times them that way).
"""
from __future__ import annotations

import functools
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ops import check_page_ids
from repro_torch.models.transformer import (Transformer, init_model,
                                            prefill_forward)
from repro_torch.serving.pages import PageManager, pages_needed
from repro_torch.serving.paged_decode import (dump_prefill_to_pools,
                                              init_paged_pools,
                                              paged_decode_step)


@dataclass(frozen=True)
class Request:
    """One generation request. ``uid`` is caller-chosen and must be unique
    among live + waiting requests."""
    uid: int
    prompt: np.ndarray                    # [S] int32
    max_new_tokens: int

    @property
    def prompt_len(self) -> int:
        return int(len(self.prompt))


@dataclass
class _Sequence:
    """Host-side state of one live slot."""
    req: Request
    slot: int
    n_cached: int                         # tokens whose KV is in pages
    generated: List[int] = field(default_factory=list)


class PagedServingEngine:
    """Continuous-batching engine. See module docstring for the design.
    Runs on the device that holds ``model``."""

    def __init__(self, model: Transformer, cfg: ModelConfig, *,
                 page_size: int = 16, n_pages: int = 256, max_slots: int = 4,
                 max_seq_len: int = 512, eos_id: Optional[int] = None,
                 use_kernel: bool = False):
        if not cfg.causal:
            raise ValueError("serving needs a causal decoder")
        if cfg.frontend != "none":
            raise ValueError("feature-frontend serving unsupported")
        self.model = model
        self.cfg = cfg
        self.device = model.embed.table.device
        self.page_size = int(page_size)
        self.max_slots = int(max_slots)
        self.max_seq_len = int(max_seq_len)
        self.eos_id = eos_id
        self.pm = PageManager(n_pages=n_pages, page_size=page_size)
        self.n_pmax = pages_needed(max_seq_len, page_size)
        self.pools = init_paged_pools(cfg, n_pages, page_size, max_slots,
                                      device=self.device)
        self.page_table = np.zeros((max_slots, self.n_pmax), np.int32)
        self.lengths = np.zeros((max_slots,), np.int32)
        self.free_slots: List[int] = list(range(max_slots - 1, -1, -1))
        self.live: Dict[int, _Sequence] = {}          # slot -> sequence
        self.waiting: deque = deque()
        self.finished: Dict[int, np.ndarray] = {}     # uid -> full tokens
        self.n_steps = 0

        self._step = functools.partial(
            paged_decode_step, model, self.pools, cfg,
            page_size=self.page_size, use_kernel=use_kernel,
            tables_checked=True)
        self._prefill = functools.partial(prefill_forward, model, cfg,
                                          raw_kv=True)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    # ------------------------------------------------------------- frontend
    def submit(self, req: Request) -> None:
        worst = req.prompt_len + req.max_new_tokens
        if worst > self.max_seq_len:
            raise ValueError(
                f"request {req.uid}: prompt {req.prompt_len} + max_new "
                f"{req.max_new_tokens} exceeds max_seq_len "
                f"{self.max_seq_len}")
        if pages_needed(worst, self.page_size) > self.pm.capacity:
            raise MemoryError(
                f"request {req.uid} needs "
                f"{pages_needed(worst, self.page_size)} pages; pool has "
                f"{self.pm.capacity} — it can never be admitted")
        if req.max_new_tokens < 1:
            raise ValueError(f"request {req.uid}: max_new_tokens must be >= 1")
        self.waiting.append(req)

    def can_admit(self, req: Request) -> bool:
        return bool(self.free_slots) and \
            self.pm.can_admit(req.prompt_len + req.max_new_tokens)

    @property
    def n_live(self) -> int:
        return len(self.live)

    # ------------------------------------------------------------ admission
    @torch.inference_mode()
    def _admit(self, req: Request) -> None:
        slot = self.free_slots.pop()
        pages = self.pm.admit(req.uid, req.prompt_len,
                              req.prompt_len + req.max_new_tokens)
        prompt = self._to_device(np.asarray(req.prompt, np.int64))[None]
        logits, cache = self._prefill(prompt)
        dump_prefill_to_pools(self.pools, cache, self.cfg, slot, pages,
                              self.page_size, req.prompt_len)
        self.page_table[slot] = self.pm.table_array(req.uid, self.n_pmax)
        self.lengths[slot] = req.prompt_len
        seq = _Sequence(req=req, slot=slot, n_cached=req.prompt_len)
        seq.generated.append(int(torch.argmax(logits[0, -1])))
        self.live[slot] = seq
        if self._is_finished(seq):
            self._retire(seq)

    def _is_finished(self, seq: _Sequence) -> bool:
        if len(seq.generated) >= seq.req.max_new_tokens:
            return True
        return self.eos_id is not None and seq.generated[-1] == self.eos_id

    # ------------------------------------------------------------- eviction
    def _release(self, seq: _Sequence) -> List[int]:
        freed = self.pm.free_seq(seq.req.uid)
        self.page_table[seq.slot] = 0
        self.lengths[seq.slot] = 0
        del self.live[seq.slot]
        self.free_slots.append(seq.slot)
        return freed

    def _retire(self, seq: _Sequence) -> None:
        self.finished[seq.req.uid] = np.concatenate(
            [np.asarray(seq.req.prompt, np.int32),
             np.asarray(seq.generated, np.int32)])
        self._release(seq)

    def evict(self, uid: int) -> List[int]:
        """Cancel a live or waiting request mid-flight. Returns the freed
        page ids (empty for a waiting request). The partial output is
        recorded in ``finished``."""
        for seq in list(self.live.values()):
            if seq.req.uid == uid:
                self.finished[uid] = np.concatenate(
                    [np.asarray(seq.req.prompt, np.int32),
                     np.asarray(seq.generated, np.int32)])
                return self._release(seq)
        for req in list(self.waiting):
            if req.uid == uid:
                self.waiting.remove(req)
                self.finished[uid] = np.asarray(req.prompt, np.int32)
                return []
        raise KeyError(f"request {uid} is neither live nor waiting")

    # ----------------------------------------------------------------- step
    @torch.inference_mode()
    def step(self) -> List[int]:
        """One engine step: admit what fits (FIFO, head-of-line blocking),
        then advance every live slot by one token with one decode step.
        Returns the uids that finished this step."""
        while self.waiting and self.can_admit(self.waiting[0]):
            self._admit(self.waiting.popleft())
        if not self.live:
            return []

        token = np.zeros((self.max_slots, 1), np.int64)
        for slot, seq in self.live.items():
            token[slot, 0] = seq.generated[-1]
            newp = self.pm.append_token(seq.req.uid)
            if newp is not None:
                self.page_table[slot, seq.n_cached // self.page_size] = newp

        check_page_ids(self.page_table, self.pm.n_pages)
        logits, _ = self._step(self._to_device(token),
                               self._to_device(self.page_table),
                               self._to_device(self.lengths))
        self.n_steps += 1
        nxt = torch.argmax(logits[:, 0], dim=-1).cpu().numpy()

        done = []
        for slot, seq in list(self.live.items()):
            seq.n_cached += 1
            self.lengths[slot] = seq.n_cached
            seq.generated.append(int(nxt[slot]))
            if self._is_finished(seq):
                done.append(seq.req.uid)
                self._retire(seq)
        return done

    # ------------------------------------------------------------ batch run
    def run(self, requests: Sequence[Request]) -> Dict[int, np.ndarray]:
        """Submit all requests and step until drained. Returns
        uid -> full token array (prompt + generated)."""
        for r in requests:
            self.submit(r)
        while self.waiting or self.live:
            before = self.n_live
            self.step()
            if not self.live and self.waiting and before == 0 and \
                    not self.can_admit(self.waiting[0]):
                raise MemoryError(
                    f"deadlock: request {self.waiting[0].uid} cannot be "
                    "admitted into an empty engine")
        return dict(self.finished)

    def stats(self) -> dict:
        u = self.pm.utilization()
        u.update({"n_live": self.n_live, "n_waiting": len(self.waiting),
                  "n_finished": len(self.finished),
                  "n_steps": self.n_steps})
        return u


def make_engine(cfg: ModelConfig, *, seed: int = 0, device=None, **kw
                ) -> PagedServingEngine:
    """Init a model from ``seed`` on ``device`` (CUDA unless the caller
    names another; raises when no card is present and none was named) and
    build an engine around it."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return PagedServingEngine(init_model(gen, cfg), cfg, **kw)
