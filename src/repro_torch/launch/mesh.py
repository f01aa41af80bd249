"""The meshes of the distributed D2FT step (port of
``repro/launch/mesh.py::make_data_mesh`` and of ``MeshSpec.build``).

The JAX package runs one program over a ``jax.sharding.Mesh``; the port
runs one process per rank on ``torch.distributed``. A ``DataMesh`` is one
axis of ranks: its process group, this process's rank in it, its size and
the device the rank computes on, with the collectives the steps need (a
summing ``all_reduce_``, a ``broadcast_``, the ZeRO modes' summing
``reduce_scatter_`` and ``all_gather_``, and the pipeline's ``send_`` /
``recv_``) and the ``CollectiveCounter`` of the gradient sync.

``make_mesh`` returns a ``Mesh`` of ``MeshSpec(data, stage, tensor)``:
global rank r sits at (d, s, t) = r in row-major order over (data, stage,
tensor), as ``MeshSpec.build`` reshapes its devices, and each axis is a
``DataMesh`` over the process sub-group of the ranks that share the other
two coordinates (``dist.new_group``: every rank creates every group, its
own or not, in one fixed order, or the ranks hang). An axis that spans
the world is the default group; an axis of one rank in a larger world
has no group (``trivial``): its collectives are the identity and call
nothing, where a staged 4 GB all-reduce over one rank would cost seconds.
``make_data_mesh`` is ``make_mesh`` of a data axis over the whole world,
and returns that axis: a world of one still calls its backend. The
axes share one counter, which counts each collective under its own kind:
``stage`` (the pipeline's loss and gradient reassembly), ``tp_grad``
(``sharding.sync.apply_tensor_grad_sync``), ``tp_act`` (the tensor
axis's f and g operators), ``p2p`` (the pipeline's sends), besides the
data-axis sync's kinds. The counter also records every call the mesh
makes, one ``CollectiveRecord`` each (its kind, the operation class of
``COLLECTIVE_OPS``, the bytes counted, the axis's size and name), the
calls it does not count among them: the loop's metric all-reduces
(``metrics``), broadcasts (``broadcast``) and the elastic loop's barrier
after a checkpoint save (``barrier``). ``launch.collectives`` prices the
records as ``repro/launch/hlo.py`` prices a compiled step's collectives.

The group comes from the ``torchrun`` environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``) where it is set, from an already initialised default group
(the CPU tests spawn their ranks and initialise it themselves), and
otherwise is a world of one in an in-memory store.

Backend: NCCL where every rank of the host has a card of its own; gloo on
the CPU, and where more ranks than cards share a card. gloo's collectives
run on host memory, so with CUDA tensors the mesh stages each collective's
buffers (input and output) through pinned host memory itself (``staged``
is True), and a caller's timings show that copy. The axes of one mesh
share one pinned buffer.

``reduce_scatter_`` and ``all_gather_`` call ``reduce_scatter_tensor`` and
``all_gather_into_tensor``, which torch 2.11 (NCCL and gloo) and 2.13
(gloo) both run; 2.13 marks them deprecated, and the warning is
silenced.

A ``torch.distributed.DeviceMesh`` is not used for either mesh: it binds
rank r to the device of index r, which is wrong when ranks share the one
card, and its sub-meshes are process groups all the same; the axes here
are plain groups, so one code path serves ranks with a card each and
ranks that share one.
"""
from __future__ import annotations

import os
import time
import warnings
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch import resolve_device


# The operation class of each kind of collective the mesh makes: the class
# of HLO instruction JAX's parser (``repro/launch/hlo.py``) prices such a
# call under. None: the class of the call the kind wraps (a re-layout
# gathers). ``broadcast`` has no HLO class: JAX's replicated inputs need
# none. The kinds of ``RECORDED_ONLY`` are recorded but kept out of the
# counter's per-kind totals, which price a step's sync and re-layouts.
COLLECTIVE_OPS = {
    "all_reduce": "all-reduce", "guard": "all-reduce",
    "tp_grad": "all-reduce", "tp_act": "all-reduce", "stage": "all-reduce",
    "merge": "all-reduce", "reduce_scatter": "reduce-scatter",
    "all_gather": "all-gather", "ckpt": "all-gather",
    "p2p": "collective-permute", "reshard": None,
    "metrics": "all-reduce", "barrier": "all-reduce",
    "broadcast": "broadcast",
}
RECORDED_ONLY = frozenset({"metrics", "barrier", "broadcast"})


def collective_op(kind: str) -> Optional[str]:
    """The operation class of ``kind`` (``COLLECTIVE_OPS``); ValueError for
    a kind the table lacks."""
    try:
        return COLLECTIVE_OPS[kind]
    except KeyError:
        raise ValueError(f"unknown collective kind {kind!r}: the mesh's "
                         f"kinds are {sorted(COLLECTIVE_OPS)}") from None


def _check_counted(kind: str):
    """ValueError unless ``kind`` is one the per-kind totals count."""
    collective_op(kind)
    if kind in RECORDED_ONLY:
        raise ValueError(f"{kind!r} calls are recorded, not counted")


@dataclass(frozen=True)
class CollectiveRecord:
    """One collective call: its kind, its operation class, the bytes the
    counter counts for it, the size k of the axis that made it (1 on a
    trivial axis or a world of one: no byte leaves the rank) and the
    axis's name."""
    kind: str
    op: str
    nbytes: int
    k: int
    axis: str


@dataclass
class CollectiveCounter:
    """Bytes handed to each collective and the number of calls, counted
    from the tensors sent, and the host-clock seconds of the syncs that
    sent them (``sharding.sync``'s sync and re-layout functions add to
    it). A reduce-scatter counts its input and an all-gather its output:
    the full-size side, what ``sync_byte_report``'s ``rs_bytes`` and
    ``ag_bytes`` price. ``records`` holds every call in order, the
    ``RECORDED_ONLY`` kinds too (callers clear it)."""
    bytes: Dict[str, int] = field(default_factory=dict)
    calls: Dict[str, int] = field(default_factory=dict)
    seconds: float = 0.0
    # host-clock seconds of the collective calls alone, by kind
    kind_seconds: Dict[str, float] = field(default_factory=dict)
    records: List[CollectiveRecord] = field(default_factory=list)
    # (kind, bytes) of the ``DataMesh.counted`` block in progress
    pending: Optional[Tuple[str, int]] = None

    def add(self, kind: str, nbytes: int, seconds: float = 0.0):
        _check_counted(kind)
        self.bytes[kind] = self.bytes.get(kind, 0) + int(nbytes)
        self.calls[kind] = self.calls.get(kind, 0) + 1
        self.kind_seconds[kind] = self.kind_seconds.get(kind, 0.0) + seconds

    def record(self, kind: str, op: str, nbytes: int, k: int, axis: str):
        """Record one call; ValueError where ``kind`` is not in
        ``COLLECTIVE_OPS`` or its class is not ``op``."""
        want = collective_op(kind)
        if want is not None and want != op:
            raise ValueError(f"a {kind!r} call made a {op}, not a {want}")
        self.records.append(CollectiveRecord(kind, op, int(nbytes), int(k),
                                             axis))

    def total(self) -> int:
        return sum(self.bytes.values())


class _Pinned:
    """One pinned host buffer, grown on demand and kept for the next call
    (float32 buckets of up to a parameter copy: allocating it each step
    would cost more than the copy); the axes of a mesh share it."""

    def __init__(self):
        self.buf: Optional[torch.Tensor] = None

    def get(self, n: int, dtype) -> torch.Tensor:
        nbytes = n * torch.empty((), dtype=dtype).element_size()
        if self.buf is None or self.buf.numel() < nbytes:
            self.buf = None
            self.buf = torch.empty(nbytes, dtype=torch.uint8,
                                   pin_memory=True)
        return self.buf[:nbytes].view(dtype)


def _sync_device(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class DataMesh:
    """One axis of ranks: ``rank`` and ``size`` within its group
    (``group`` None: the default group, the whole world; ``ranks``: the
    group's global ranks in group order, None for the world; ``trivial``:
    one rank of a larger world, no group, collectives that call
    nothing)."""
    rank: int
    size: int
    device: torch.device
    backend: str
    owns_group: bool
    counter: CollectiveCounter = field(default_factory=CollectiveCounter)
    _host: _Pinned = field(default_factory=_Pinned, repr=False)
    group: Optional[object] = field(default=None, repr=False)
    ranks: Optional[Tuple[int, ...]] = None
    name: str = "data"
    trivial: bool = False

    @property
    def shape(self) -> Dict[str, int]:
        return {self.name: self.size}

    @property
    def staged(self) -> bool:
        """True when collectives on this rank's device go through host
        memory (gloo with CUDA tensors)."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def _global(self, r: int) -> int:
        """The global rank of this axis's rank ``r``."""
        return r if self.ranks is None else self.ranks[r]

    def _note(self, op: str, kind: str, nbytes: int):
        """Record a call of class ``op``: under the kind and bytes of the
        ``counted`` block in progress, else under ``kind`` and
        ``nbytes``."""
        c = self.counter
        if c.pending is not None:
            (kind, nbytes), c.pending = c.pending, None
        c.record(kind, op, nbytes, self.size, self.name)

    def _collective(self, t: torch.Tensor, op):
        if self.trivial:
            return
        if not self.staged:
            op(t)
            return
        flat = t.reshape(-1)
        host = self._host.get(flat.numel(), flat.dtype)
        host.copy_(flat)
        op(host)
        flat.copy_(host)
        if flat.data_ptr() != t.data_ptr():
            t.copy_(flat.view(t.shape))

    def all_reduce_(self, t: torch.Tensor,
                    kind: str = "metrics") -> torch.Tensor:
        """Sum ``t`` over the ranks, in place; returns ``t``. Recorded
        under ``kind`` outside a ``counted`` block."""
        self._note("all-reduce", kind, t.numel() * t.element_size())
        self._collective(t, lambda x: dist.all_reduce(x, group=self.group))
        return t

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Overwrite ``t`` with rank ``src``'s, in place; returns ``t``.
        Recorded under ``broadcast``."""
        self._note("broadcast", "broadcast", t.numel() * t.element_size())
        self._collective(t, lambda x: dist.broadcast(
            x, self._global(src), group=self.group))
        return t

    def counted(self, kind: str, nbytes: int, call):
        """Run ``call`` (one collective of this mesh), adding ``nbytes`` and
        its host-clock seconds (the device synchronised at both ends) to
        the counter under ``kind``; the call is recorded under ``kind``
        with ``nbytes``. ValueError for a kind ``COLLECTIVE_OPS`` lacks or
        keeps out of the totals; RuntimeError where ``call`` made no
        collective of the mesh."""
        _check_counted(kind)
        _sync_device(self.device)
        t0 = time.perf_counter()
        self.counter.pending = (kind, int(nbytes))
        try:
            call()
            if self.counter.pending is not None:
                raise RuntimeError(f"a counted {kind!r} block made no "
                                   "collective of the mesh")
        finally:
            self.counter.pending = None
        _sync_device(self.device)
        self.counter.add(kind, nbytes, time.perf_counter() - t0)

    def sum_(self, t: torch.Tensor, kind: str) -> torch.Tensor:
        """``all_reduce_`` counted under ``kind``; returns ``t``."""
        self.counted(kind, t.numel() * t.element_size(),
                     lambda: self.all_reduce_(t))
        return t

    def send_(self, t: torch.Tensor, dst: int):
        """Send ``t`` to this axis's rank ``dst`` (blocking), counted under
        ``p2p``."""
        nbytes = t.numel() * t.element_size()

        def call():
            self._note("collective-permute", "p2p", nbytes)
            flat = t.detach().reshape(-1)
            if self.staged:
                host = self._host.get(flat.numel(), flat.dtype)
                host.copy_(flat)
                flat = host
            dist.send(flat.contiguous(), self._global(dst), group=self.group)
        self.counted("p2p", nbytes, call)

    def recv_(self, t: torch.Tensor, src: int) -> torch.Tensor:
        """Fill ``t`` (contiguous) with what this axis's rank ``src`` sends
        (blocking); returns ``t``. Not recorded: a receive is the other
        half of its sender's ``p2p`` record."""
        flat = t.view(-1)
        if self.staged:
            host = self._host.get(flat.numel(), flat.dtype)
            dist.recv(host, self._global(src), group=self.group)
            flat.copy_(host)
        else:
            dist.recv(flat, self._global(src), group=self.group)
        return t

    def _pair(self, out: torch.Tensor, inp: torch.Tensor, op):
        """``op(out, inp)`` on flat contiguous 1-D tensors, staged through
        one pinned host buffer holding both where the mesh is staged."""
        if self.trivial:
            out.copy_(inp)
            return
        if not self.staged:
            op(out, inp)
            return
        host = self._host.get(inp.numel() + out.numel(), inp.dtype)
        h_in, h_out = host[:inp.numel()], host[inp.numel():]
        h_in.copy_(inp)
        op(h_out, h_in)
        out.copy_(h_out)

    def reduce_scatter_(self, out: torch.Tensor,
                        inp: torch.Tensor) -> torch.Tensor:
        """Sum ``inp`` (flat, ``size`` x ``out.numel()`` elements) over the
        ranks and leave this rank's contiguous 1/size of the sum in
        ``out``; returns ``out``. Recorded under ``reduce_scatter`` outside
        a ``counted`` block."""
        if inp.numel() != out.numel() * self.size:
            raise ValueError(f"reduce_scatter_ of {inp.numel()} elements "
                             f"into {out.numel()} over {self.size} ranks")
        self._note("reduce-scatter", "reduce_scatter",
                   inp.numel() * inp.element_size())
        self._pair(out, inp, self._reduce_scatter)
        return out

    def all_gather_(self, out: torch.Tensor,
                    inp: torch.Tensor) -> torch.Tensor:
        """Concatenate the ranks' ``inp`` (flat) in rank order into ``out``;
        returns ``out``. Recorded under ``all_gather`` outside a
        ``counted`` block."""
        if out.numel() != inp.numel() * self.size:
            raise ValueError(f"all_gather_ of {inp.numel()} elements into "
                             f"{out.numel()} over {self.size} ranks")
        self._note("all-gather", "all_gather",
                   out.numel() * out.element_size())
        self._pair(out, inp, self._all_gather)
        return out

    def _reduce_scatter(self, out, inp):
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", ".*is deprecated")
            dist.reduce_scatter_tensor(out, inp, group=self.group)

    def _all_gather(self, out, inp):
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", ".*is deprecated")
            dist.all_gather_into_tensor(out, inp, group=self.group)

    def close(self):
        """Destroy the default group if the mesh created it (an axis that
        spans the world owns it with the world)."""
        if self.owns_group and dist.is_initialized():
            dist.destroy_process_group()
        self.owns_group = False


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return default if v is None else int(v)


def _world_size() -> int:
    """The world this process is in, or will make: the default group's,
    else torchrun's ``WORLD_SIZE``, else 1."""
    if dist.is_initialized():
        return dist.get_world_size()
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        return _env_int("WORLD_SIZE", 1)
    return 1


def _world(device) -> Tuple[DataMesh, int, int]:
    """This process's world as a ``DataMesh`` (joining or making the
    default group); also the local world size and the number of cards."""
    want = resolve_device(device)
    world = _world_size()
    if dist.is_initialized():
        rank = dist.get_rank()
        owns = torchrun = False
    else:
        torchrun = "RANK" in os.environ and "WORLD_SIZE" in os.environ
        rank = _env_int("RANK", 0) if torchrun else 0
        owns = True
    local_rank = _env_int("LOCAL_RANK", rank)
    local_world = _env_int("LOCAL_WORLD_SIZE", world)
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
    return (DataMesh(rank=rank, size=world, device=dev, backend=backend,
                     owns_group=owns, name="world"), local_world, n_cards)


def _backend_line(mesh: DataMesh, local_world: int, n_cards: int) -> str:
    share = f", {local_world} ranks share {n_cards} card(s): " \
        "collectives staged through pinned host memory" \
        if mesh.staged else ""
    return (f"backend {mesh.backend}, world {mesh.size}, device "
            f"{mesh.device}{share}")


def make_data_mesh(n_devices: Optional[int] = None,
                   device=None) -> DataMesh:
    """1-D "data" mesh over this process's world: the data axis of
    ``make_mesh(MeshSpec(data=world))``.

    n_devices: the data-axis size the caller expects (``--mesh data=N``);
    ValueError unless it equals the world size. device: the device type
    the ranks compute on (default: the CUDA card; "cpu" for host ranks)."""
    from repro_torch.launch.parallel import MeshSpec

    world = _world_size()
    if n_devices is not None and int(n_devices) != world:
        raise ValueError(
            f"a data mesh of {n_devices} needs a world of {n_devices} "
            f"processes, this one has {world}")
    return make_mesh(MeshSpec(data=world), device).data


@dataclass
class Mesh:
    """A (data, stage, tensor) mesh of processes: this rank's coordinates
    and one ``DataMesh`` an axis (``world`` spans every rank of the
    mesh). The axes share the world's counter and pinned buffer."""
    spec: "MeshSpec"
    coords: Tuple[int, int, int]
    world: DataMesh
    data: DataMesh
    stage: DataMesh
    tensor: DataMesh

    @property
    def rank(self) -> int:
        return self.world.rank

    @property
    def size(self) -> int:
        return self.world.size

    @property
    def device(self) -> torch.device:
        return self.world.device

    @property
    def counter(self) -> CollectiveCounter:
        return self.world.counter

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.spec.axis_names, self.spec.shape))

    def close(self):
        self.world.close()


def make_mesh(spec, device=None) -> Optional[Mesh]:
    """The ``MeshSpec`` mesh over the first ``spec.size`` ranks of this
    process's world (one process a rank; rank r at (d, s, t) row-major over
    (data, stage, tensor)). Every rank of the world must call it: each
    takes part in creating every axis group. ValueError where the world is
    smaller than the mesh, or larger and not made by the caller; ranks past
    ``spec.size`` get None, as the devices past a JAX mesh's size are left
    out of it. Rank 0 prints the mesh and its backend."""
    import numpy as np

    n, world = spec.size, _world_size()
    if n > world or (n < world and not dist.is_initialized()):
        raise ValueError(
            f"requested a {spec.describe()} mesh ({n} ranks) but the world "
            f"has {world} processes"
            + ("" if n > world else
               " (a smaller mesh needs a default group made by the caller)"))
    full, local_world, n_cards = _world(device)
    grid = np.arange(n).reshape(spec.shape)
    member = full.rank < n

    def axis(name, ranks):
        # a group over every rank of the world is the default group (and
        # owned with it); an axis of one rank in a larger world needs none
        spans = len(ranks) == world
        group = dist.new_group(list(ranks)) \
            if 1 < len(ranks) < world else None
        if not (member and full.rank in ranks):
            return None
        return DataMesh(rank=ranks.index(full.rank), size=len(ranks),
                        device=full.device, backend=full.backend,
                        owns_group=spans and full.owns_group,
                        counter=full.counter, _host=full._host, group=group,
                        ranks=None if spans else ranks, name=name,
                        trivial=len(ranks) == 1 and not spans)

    # one group for each combination of the other two coordinates, in
    # row-major order: the same calls, in the same order, on every rank
    mine = {}
    for a, name in enumerate(spec.axis_names):
        for line in np.moveaxis(grid, a, -1).reshape(-1, spec.shape[a]):
            got = axis(name, tuple(int(r) for r in line))
            if got is not None:
                mine[name] = got
    world_axis = axis("world", tuple(range(n))) if n < world else full
    if not member:
        return None
    coords = tuple(int(c) for c in np.unravel_index(full.rank, spec.shape))
    if full.rank == 0:
        print(f"mesh {spec.describe()}: "
              f"{_backend_line(full, local_world, n_cards)}", flush=True)
    return Mesh(spec=spec, coords=coords, world=world_axis,
                data=mine["data"], stage=mine["stage"],
                tensor=mine["tensor"])


def sub_mesh(mesh: DataMesh, members) -> Optional[DataMesh]:
    """The data mesh of ``members`` (ranks of ``mesh``, in the order
    given), sharing ``mesh``'s counter and pinned buffer: the survivors of
    the elastic loop's dropout. A group of two or more ranks is a
    ``dist.new_group``, which is collective over the world: every rank of
    the world calls this, and ``mesh`` must then span the world
    (ValueError otherwise). One member takes no group (``trivial``: its
    collectives call nothing); all of ``mesh``'s ranks give ``mesh``
    itself. Returns None on a rank outside ``members``."""
    members = [int(r) for r in members]
    if members == list(range(mesh.size)):
        return mesh
    glob = tuple(mesh._global(r) for r in members)
    group = None
    if len(members) > 1:
        if mesh.size != dist.get_world_size():
            raise ValueError(
                f"a sub-mesh of {len(members)} ranks needs a new process "
                f"group, which every rank of the world must create: the "
                f"mesh spans {mesh.size} of {dist.get_world_size()}")
        group = dist.new_group(list(glob))
    if mesh.rank not in members:
        return None
    return DataMesh(rank=members.index(mesh.rank), size=len(members),
                    device=mesh.device, backend=mesh.backend,
                    owns_group=False, counter=mesh.counter, _host=mesh._host,
                    group=group, ranks=glob, name=mesh.name,
                    trivial=len(members) == 1)


def axes(mesh) -> Tuple[DataMesh, DataMesh, Optional[DataMesh],
                        Optional[DataMesh]]:
    """(world, data, stage, tensor) of a mesh; a ``DataMesh`` (what
    ``make_data_mesh`` returns) is its own world and data axis and has no
    stage or tensor axis."""
    if isinstance(mesh, Mesh):
        return mesh.world, mesh.data, mesh.stage, mesh.tensor
    return mesh, mesh, None, None
