"""The data mesh of the distributed D2FT step (port of
``repro/launch/mesh.py::make_data_mesh``).

The JAX package runs one program over a ``jax.sharding.Mesh``; the port
runs one process per rank on ``torch.distributed``. ``make_data_mesh``
returns a ``DataMesh``: the process group of the 1-D "data" axis, this
process's rank, the world size and the device the rank computes on, with
the collectives the steps need (a summing ``all_reduce_``, a
``broadcast_``, and the ZeRO modes' summing ``reduce_scatter_`` and
``all_gather_``) and the ``CollectiveCounter`` of the gradient sync.

The group comes from the ``torchrun`` environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``) where it is set, from an already initialised default group
(the CPU tests spawn their ranks and initialise it themselves), and
otherwise is a world of one in an in-memory store.

Backend: NCCL where every rank of the host has a card of its own; gloo on
the CPU, and where more ranks than cards share a card. gloo's collectives
run on host memory, so with CUDA tensors the mesh stages each collective's
buffers (input and output) through pinned host memory itself (``staged``
is True), and a caller's timings show that copy.

``reduce_scatter_`` and ``all_gather_`` call ``reduce_scatter_tensor`` and
``all_gather_into_tensor``, which torch 2.11 (NCCL and gloo) and 2.13
(gloo) both run; 2.13 marks them deprecated, and the warning is
silenced.

A ``torch.distributed.DeviceMesh`` is not used: it binds rank r to the
device of index r, which is wrong when two ranks share the one card, and
the 1-D data axis needs only the group. The multi-axis slice, whose stage
and tensor axes are sub-groups, is where it would serve.
"""
from __future__ import annotations

import os
import warnings
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch
import torch.distributed as dist

from repro_torch import resolve_device


@dataclass
class CollectiveCounter:
    """Bytes handed to each collective and the number of calls, counted
    from the tensors sent, and the host-clock seconds of the syncs that
    sent them (``sharding.sync``'s sync and re-layout functions add to
    it). A reduce-scatter counts its input and an all-gather its output:
    the full-size side, what ``sync_byte_report``'s ``rs_bytes`` and
    ``ag_bytes`` price."""
    bytes: Dict[str, int] = field(default_factory=dict)
    calls: Dict[str, int] = field(default_factory=dict)
    seconds: float = 0.0
    # host-clock seconds of the collective calls alone, by kind
    kind_seconds: Dict[str, float] = field(default_factory=dict)

    def add(self, kind: str, nbytes: int, seconds: float = 0.0):
        self.bytes[kind] = self.bytes.get(kind, 0) + int(nbytes)
        self.calls[kind] = self.calls.get(kind, 0) + 1
        self.kind_seconds[kind] = self.kind_seconds.get(kind, 0.0) + seconds

    def total(self) -> int:
        return sum(self.bytes.values())


@dataclass
class DataMesh:
    rank: int
    size: int
    device: torch.device
    backend: str
    owns_group: bool
    counter: CollectiveCounter = field(default_factory=CollectiveCounter)
    _host: Optional[torch.Tensor] = field(default=None, repr=False)

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.size}

    @property
    def staged(self) -> bool:
        """True when collectives on this rank's device go through host
        memory (gloo with CUDA tensors)."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def _host_buffer(self, n: int, dtype) -> torch.Tensor:
        """A pinned host buffer of at least n elements of ``dtype``,
        kept for the next call (float32 buckets of up to a parameter
        copy: allocating it each step would cost more than the copy)."""
        nbytes = n * torch.empty((), dtype=dtype).element_size()
        if self._host is None or self._host.numel() < nbytes:
            self._host = torch.empty(nbytes, dtype=torch.uint8,
                                     pin_memory=True)
        return self._host[:nbytes].view(dtype)

    def _collective(self, t: torch.Tensor, op):
        if not self.staged:
            op(t)
            return
        flat = t.reshape(-1)
        host = self._host_buffer(flat.numel(), flat.dtype)
        host.copy_(flat)
        op(host)
        flat.copy_(host)
        if flat.data_ptr() != t.data_ptr():
            t.copy_(flat.view(t.shape))

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks, in place; returns ``t``."""
        self._collective(t, dist.all_reduce)
        return t

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Overwrite ``t`` with rank ``src``'s, in place; returns ``t``."""
        self._collective(t, lambda x: dist.broadcast(x, src))
        return t

    def _pair(self, out: torch.Tensor, inp: torch.Tensor, op):
        """``op(out, inp)`` on flat contiguous 1-D tensors, staged through
        one pinned host buffer holding both where the mesh is staged."""
        if not self.staged:
            op(out, inp)
            return
        host = self._host_buffer(inp.numel() + out.numel(), inp.dtype)
        h_in, h_out = host[:inp.numel()], host[inp.numel():]
        h_in.copy_(inp)
        op(h_out, h_in)
        out.copy_(h_out)

    def reduce_scatter_(self, out: torch.Tensor,
                        inp: torch.Tensor) -> torch.Tensor:
        """Sum ``inp`` (flat, ``size`` x ``out.numel()`` elements) over the
        ranks and leave this rank's contiguous 1/size of the sum in
        ``out``; returns ``out``."""
        if inp.numel() != out.numel() * self.size:
            raise ValueError(f"reduce_scatter_ of {inp.numel()} elements "
                             f"into {out.numel()} over {self.size} ranks")
        self._pair(out, inp, self._reduce_scatter)
        return out

    def all_gather_(self, out: torch.Tensor,
                    inp: torch.Tensor) -> torch.Tensor:
        """Concatenate the ranks' ``inp`` (flat) in rank order into ``out``;
        returns ``out``."""
        if out.numel() != inp.numel() * self.size:
            raise ValueError(f"all_gather_ of {inp.numel()} elements into "
                             f"{out.numel()} over {self.size} ranks")
        self._pair(out, inp, self._all_gather)
        return out

    @staticmethod
    def _reduce_scatter(out, inp):
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", ".*is deprecated")
            dist.reduce_scatter_tensor(out, inp)

    @staticmethod
    def _all_gather(out, inp):
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", ".*is deprecated")
            dist.all_gather_into_tensor(out, inp)

    def close(self):
        """Destroy the process group if ``make_data_mesh`` created it."""
        if self.owns_group and dist.is_initialized():
            dist.destroy_process_group()
        self.owns_group = False


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return default if v is None else int(v)


def make_data_mesh(n_devices: Optional[int] = None,
                   device=None) -> DataMesh:
    """1-D "data" mesh over this process's world.

    n_devices: the data-axis size the caller expects (``--mesh data=N``);
    ValueError unless it equals the world size. device: the device type
    the ranks compute on (default: the CUDA card; "cpu" for host ranks).
    Rank 0 prints the backend it took."""
    want = resolve_device(device)
    if dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
        local_rank = _env_int("LOCAL_RANK", rank)
        local_world = _env_int("LOCAL_WORLD_SIZE", world)
        owns = False
    else:
        torchrun = "RANK" in os.environ and "WORLD_SIZE" in os.environ
        rank = _env_int("RANK", 0) if torchrun else 0
        world = _env_int("WORLD_SIZE", 1) if torchrun else 1
        local_rank = _env_int("LOCAL_RANK", rank)
        local_world = _env_int("LOCAL_WORLD_SIZE", world)
        owns = True
    if n_devices is not None and int(n_devices) != world:
        raise ValueError(
            f"a data mesh of {n_devices} needs a world of {n_devices} "
            f"processes, this one has {world}")
    if want.type == "cuda":
        n_cards = torch.cuda.device_count()
        dev = torch.device("cuda", local_rank % n_cards)
        torch.cuda.set_device(dev)
        backend = "nccl" if local_world <= n_cards and \
            dist.is_nccl_available() else "gloo"
    else:
        dev, n_cards, backend = torch.device("cpu"), 0, "gloo"
    if owns:
        if torchrun:
            dist.init_process_group(backend, init_method="env://",
                                    rank=rank, world_size=world)
        else:
            dist.init_process_group(backend, store=dist.HashStore(),
                                    rank=0, world_size=1)
    else:
        backend = dist.get_backend()
    mesh = DataMesh(rank=rank, size=world, device=dev, backend=backend,
                    owns_group=owns)
    if rank == 0:
        share = f", {local_world} ranks share {n_cards} card(s): " \
            "collectives staged through pinned host memory" \
            if mesh.staged else ""
        print(f"data mesh: backend {backend}, world {world}, device "
              f"{dev}{share}", flush=True)
    return mesh
