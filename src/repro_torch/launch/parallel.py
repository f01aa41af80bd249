"""Multi-axis parallelism config: ``MeshSpec`` + ``ParallelConfig`` (port of
``repro/launch/parallel.py``).

``MeshSpec(data, stage, tensor)`` names the three parallel axes of the
distributed D2FT paths:

* ``data``   — batch sharding; the gradient sync runs over this axis.
* ``stage``  — pipeline stages over contiguous layer ranges.
* ``tensor`` — sharding of attention heads / FFN columns at the schedule's
  (layer, head-group) granularity.

The port runs one process per rank: ``launch.mesh.make_data_mesh`` builds
the data-only mesh and ``launch.mesh.make_mesh`` the (data, stage, tensor)
one, a process sub-group an axis, where the JAX package builds a
``jax.sharding.Mesh`` with ``MeshSpec.build``. ``ParallelConfig`` makes
every check the JAX package makes, with its error types and messages, and
no other. Every sync mode runs (masked, ZeRO-1, ZeRO-3, streamed with
``opt_chunk``, local), the stage and tensor axes with the unstreamed
ones, and the pre-sync guard on a pure data mesh (not streamed).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

SYNC_MODES = ("masked", "zero", "zero3", "local")

# canonical axis names, in mesh order
DATA_AXIS, STAGE_AXIS, TENSOR_AXIS = "data", "stage", "tensor"


@dataclass(frozen=True)
class MeshSpec:
    """Logical (data, stage, tensor) mesh shape."""
    data: int = 1
    stage: int = 1
    tensor: int = 1

    @classmethod
    def parse(cls, text: str) -> "MeshSpec":
        """Parse ``"data=4,stage=2,tensor=1"`` (unlisted axes default 1)."""
        sizes = {}
        for part in filter(None, (p.strip() for p in text.split(","))):
            if "=" not in part:
                raise ValueError(
                    f"bad --mesh entry {part!r}: expected axis=size "
                    "(e.g. data=4,stage=2,tensor=1)")
            k, v = part.split("=", 1)
            k = k.strip()
            if k not in (DATA_AXIS, STAGE_AXIS, TENSOR_AXIS):
                raise ValueError(
                    f"unknown mesh axis {k!r}: valid axes are "
                    f"{DATA_AXIS}/{STAGE_AXIS}/{TENSOR_AXIS}")
            if k in sizes:
                raise ValueError(f"mesh axis {k!r} given twice")
            sizes[k] = int(v)
        return cls(**sizes)

    @property
    def shape(self) -> Tuple[int, int, int]:
        return (self.data, self.stage, self.tensor)

    @property
    def axis_names(self) -> Tuple[str, str, str]:
        return (DATA_AXIS, STAGE_AXIS, TENSOR_AXIS)

    @property
    def size(self) -> int:
        return self.data * self.stage * self.tensor

    def validate(self):
        for name, n in zip(self.axis_names, self.shape):
            if not isinstance(n, int) or n < 1:
                raise ValueError(
                    f"mesh axis {name!r} must be a positive int, got {n!r}")

    def __post_init__(self):
        self.validate()

    def describe(self) -> str:
        return ",".join(f"{k}={v}"
                        for k, v in zip(self.axis_names, self.shape))


@dataclass(frozen=True)
class ParallelConfig:
    """Frozen execution config for the distributed D2FT train step: mesh
    spec, sync_mode, streamed, opt_chunk, guard, use_kernel and pipeline
    microbatches (required > 0 when ``mesh.stage > 1``, 0 otherwise). All
    cross-option validation happens at construction."""
    mesh: MeshSpec = field(default_factory=MeshSpec)
    sync_mode: str = "masked"
    streamed: bool = False
    opt_chunk: Optional[int] = None
    guard: bool = False
    use_kernel: bool = False
    microbatches: int = 0

    @property
    def data_axis(self) -> str:
        return DATA_AXIS

    @property
    def stage_axis(self) -> Optional[str]:
        return STAGE_AXIS if self.mesh.stage > 1 else None

    @property
    def tensor_axis(self) -> Optional[str]:
        return TENSOR_AXIS if self.mesh.tensor > 1 else None

    def __post_init__(self):
        self.validate()

    def validate(self):
        """The JAX package's cross-option checks, with its error types and
        messages."""
        self.mesh.validate()
        if self.sync_mode not in SYNC_MODES:
            raise ValueError(f"unknown sync_mode {self.sync_mode!r}: "
                             f"valid modes are {SYNC_MODES}")
        if self.streamed or self.opt_chunk:
            if self.sync_mode != "zero3":
                raise AssertionError(
                    "streamed/opt_chunk require sync_mode='zero3'")
        if self.streamed and self.guard:
            raise ValueError(
                "streamed ZeRO-3 cannot guard: the guard zeroes anomalous "
                "local grads before any collective, but the streamed "
                "reduce-scatters live inside the vjp")
        S, T = self.mesh.stage, self.mesh.tensor
        if self.sync_mode == "local" and (S > 1 or T > 1):
            raise ValueError("sync_mode='local' is communication-free and "
                             "incompatible with stage/tensor axes")
        if self.streamed and (S > 1 or T > 1):
            raise ValueError(
                "streamed ZeRO-3 fuses reduce-scatters into the vjp and "
                "does not compose with stage/tensor axes yet — use "
                "streamed=False")
        if self.guard and (S > 1 or T > 1):
            raise ValueError(
                "guard zeroes whole-device local grads, which are partial "
                "contributions under stage/tensor parallelism — guard "
                "requires a pure data mesh")
        if self.use_kernel and (S > 1 or T > 1):
            raise ValueError(
                "use_kernel has no stage/tensor route yet (the pipeline "
                "and tensor-parallel paths run the masked reference)")
        if S > 1:
            if self.microbatches < 1:
                raise ValueError(
                    f"stage={S} pipeline needs microbatches >= 1, got "
                    f"{self.microbatches}")
        elif self.microbatches:
            raise ValueError(
                "microbatches is a pipeline option: set mesh.stage > 1")

    def validate_model(self, cfg):
        """Model-dependent divisibility checks (tensor axis tiling)."""
        T = self.mesh.tensor
        if T > 1:
            if cfg.n_heads % T or cfg.n_kv_heads % T:
                raise ValueError(
                    f"tensor={T} must divide n_heads={cfg.n_heads} and "
                    f"n_kv_heads={cfg.n_kv_heads}")
        if self.mesh.stage > 1 and cfg.n_layers < self.mesh.stage:
            raise ValueError(
                f"stage={self.mesh.stage} needs at least that many layers "
                f"(n_layers={cfg.n_layers})")

    def validate_mesh(self, mesh):
        """Check a mesh (``launch.mesh.DataMesh``, the data axis alone, or
        ``launch.mesh.Mesh``) carries the axes this config needs."""
        shape = dict(mesh.shape)
        if shape.get(DATA_AXIS, 1) != self.mesh.data:
            raise ValueError(
                f"mesh data axis is {shape.get(DATA_AXIS, 1)}, "
                f"ParallelConfig says {self.mesh.data}")
        for name, want in ((STAGE_AXIS, self.mesh.stage),
                           (TENSOR_AXIS, self.mesh.tensor)):
            if want > 1 and shape.get(name, 1) != want:
                raise ValueError(
                    f"ParallelConfig wants {name}={want} but the mesh has "
                    f"{name}={shape.get(name, 1)} "
                    f"(mesh axes: {dict(mesh.shape)})")
