"""Logical-axis sharding rules.

The counterpart of ``repro/sharding/rules.py``, pure Python: :meth:`MeshRules.spec`
returns a plain tuple of mesh-axis names (``None`` for a replicated dim),
which is what the reference's ``PartitionSpec`` holds, so
``tuple(reference.spec(...)) == port.spec(...)``.  The port uses the
``nodes`` axis (``train/step.py::node_step_specs``) to say which dim of
the node-sharded step's inputs each rank of the node group splits.

Models annotate every parameter/activation dimension with a *logical* axis
name; this module resolves logical names to physical mesh axes with
divisibility checking (uneven shardings are rejected),
falling back to replication and *recording* every fallback so the roofline
report can explain replicated-attention archs (minitron 24H, whisper 20H,
hymba 25H on a 16-way model axis).

Logical axes:
  batch      — global batch dim                -> ("pod","data") / ("data",)
  heads      — attention query heads           -> "model" (TP)
  kv_heads   — GQA key/value heads             -> "model" if divisible else None
  embed      — d_model dim of weight matrices  -> fsdp axis if cfg.fsdp else None
  ff         — feed-forward hidden             -> "model"
  vocab      — vocabulary dim                  -> "model"
  experts    — MoE expert dim                  -> None (experts 2D-sharded via embed/ff)
  cache_seq  — KV-cache sequence dim in decode -> "model" (+ "data" for B=1 long ctx)
  seq        — activation sequence dim         -> None (no sequence parallelism v0)
  nodes      — heterogeneous-cluster node dim  -> node_axis (the node-sharded RealBackend)
  None       — replicated
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

__all__ = ["MeshRules", "Fallback"]

AxisAssignment = Union[None, str, Tuple[str, ...]]
Spec = Tuple[AxisAssignment, ...]


@dataclasses.dataclass(frozen=True)
class Fallback:
    """Record of a logical axis we could not shard as requested."""

    path: str
    dim: int
    logical: str
    wanted: AxisAssignment
    size: int
    reason: str


@dataclasses.dataclass
class MeshRules:
    """Resolves logical axis names to mesh axes for one (mesh, arch) pair."""

    mesh_axes: Dict[str, int]                 # physical axis name -> size
    batch_axes: Tuple[str, ...] = ("data",)   # ("pod","data") on multi-pod
    model_axis: str = "model"
    fsdp_axis: Optional[str] = None           # "data" to enable FSDP/ZeRO-3
    cache_seq_axes: Tuple[str, ...] = ("model",)
    experts_axis: Optional[str] = None        # "model" for expert parallelism
    node_axis: Optional[str] = None           # "nodes" on the RealBackend node mesh
    fallbacks: List[Fallback] = dataclasses.field(default_factory=list)

    def _assignment(self, logical: Optional[str]) -> AxisAssignment:
        if logical is None:
            return None
        table: Dict[str, AxisAssignment] = {
            "batch": self.batch_axes,
            "heads": self.model_axis,
            "kv_heads": self.model_axis,
            "embed": self.fsdp_axis,
            "ff": self.model_axis,
            "vocab": self.model_axis,
            "experts": self.experts_axis,
            "cache_seq": self.cache_seq_axes,
            "seq": None,
            "ssm_inner": self.model_axis,
            "nodes": self.node_axis,
        }
        if logical not in table:
            raise KeyError(f"unknown logical axis {logical!r}")
        return table[logical]

    def _axes_size(self, assignment: AxisAssignment) -> int:
        if assignment is None:
            return 1
        if isinstance(assignment, str):
            return self.mesh_axes[assignment]
        return int(np.prod([self.mesh_axes[a] for a in assignment]))

    def spec(
        self,
        logical_axes: Sequence[Optional[str]],
        shape: Optional[Sequence[int]] = None,
        *,
        path: str = "",
    ) -> Spec:
        """The spec (one mesh-axis assignment per dim) for a tensor with
        given logical axes and shape.

        If ``shape`` is provided, every dim must be divisible by its mapped
        mesh extent or the dim falls back to replication (recorded).
        """
        parts: List[AxisAssignment] = []
        used: set = set()
        for i, logical in enumerate(logical_axes):
            assignment = self._assignment(logical)
            if assignment is not None:
                axes = (assignment,) if isinstance(assignment, str) else tuple(assignment)
                if used & set(axes):
                    # A mesh axis may appear once per spec; earlier dims win
                    # (e.g. decode caches: cache_seq takes "model", so a
                    # 16-divisible kv_heads dim falls back to replication).
                    self.fallbacks.append(
                        Fallback(
                            path=path, dim=i, logical=logical or "",
                            wanted=assignment, size=-1 if shape is None else shape[i],
                            reason="mesh axis already used by an earlier dim",
                        )
                    )
                    assignment = None
                elif shape is not None:
                    extent = self._axes_size(assignment)
                    if shape[i] % extent != 0:
                        self.fallbacks.append(
                            Fallback(
                                path=path,
                                dim=i,
                                logical=logical or "",
                                wanted=assignment,
                                size=shape[i],
                                reason=f"{shape[i]} % {extent} != 0",
                            )
                        )
                        assignment = None
                if assignment is not None:
                    used |= set(axes)
                    # Collapse singleton tuples to the bare axis name so
                    # configured tuple forms like ("data",) produce the same
                    # spec as "data".
                    assignment = axes[0] if len(axes) == 1 else tuple(axes)
            parts.append(assignment)
        # Trim trailing Nones for tidier specs.
        while parts and parts[-1] is None:
            parts.pop()
        return tuple(parts)

    def batch_spec(self, extra_dims: int = 1) -> Spec:
        """Spec for (batch, seq, ...) activations.  Single-axis batch meshes
        collapse to the bare axis name, matching what :meth:`spec` emits."""
        axes = self.batch_axes[0] if len(self.batch_axes) == 1 else tuple(self.batch_axes)
        return (axes, *([None] * extra_dims))

    def fallback_report(self) -> str:
        if not self.fallbacks:
            return "no sharding fallbacks"
        lines = []
        seen = set()
        for f in self.fallbacks:
            key = (f.path, f.dim)
            if key in seen:
                continue
            seen.add(key)
            lines.append(
                f"{f.path} dim{f.dim} ({f.logical}={f.size}) -> replicated ({f.reason})"
            )
        return "\n".join(lines)
