"""The node mesh: how the node-sharded RealBackend splits its node axis.

The counterpart of ``repro/launch/mesh.py``'s node-mesh helpers.  Where the
reference lays a 1-D ``("nodes",)`` device mesh over the local devices and
``shard_map``s the node axis over it, the port splits the node axis over
the ranks of a ``torch.distributed`` process group: one process per card
under NCCL, or CPU processes under gloo.  Each of the first d ranks (d =
:func:`node_shard_count`) owns n/d consecutive nodes; the rest own none
and join every collective with zeros, so parameters stay replicated on
every rank.

Without an initialised default group, :func:`make_node_mesh` builds a
world of one over a ``HashStore``: gloo for the CPU, NCCL for a card (the
counterpart of the reference's one-device mesh).  It lives until
:func:`release_world_of_one` shuts it down.  Nothing here moves work to
the CPU: a card that is not there raises.

The TPU production layouts (``make_production_mesh``, ``make_rules``) wait
for the dry run.
"""
from __future__ import annotations

import dataclasses
import datetime
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch import resolve_device

__all__ = [
    "NodeMesh",
    "make_node_mesh",
    "release_world_of_one",
    "mesh_axis_sizes",
    "node_shard_count",
    "train_microbatches",
    "TRAIN_MICROBATCHES",
]

# Gradient-accumulation microbatches for train_4k (global batch 256).
TRAIN_MICROBATCHES = {
    "default": 8,
    "llama3-8b": 4,
    "deepseek-v2-236b": 16,
    "chameleon-34b": 16,
    "internlm2-20b": 8,
}

_TIMEOUT = datetime.timedelta(minutes=10)
# device -> the world-of-one group.  One per process, as the default group
# is: every backend of the process shares it rather than opening another
# NCCL communicator, until release_world_of_one.
_SOLO: Dict[str, Any] = {}


def train_microbatches(arch_id: str, *, global_batch: int = 256,
                       batch_extent: int = 1) -> int:
    """Per-arch microbatch count, capped so each microbatch still fills the
    batch mesh axes (B/mb >= batch_extent) — otherwise the microbatch loses
    its batch sharding and activations replicate."""
    mb = TRAIN_MICROBATCHES.get(arch_id, TRAIN_MICROBATCHES["default"])
    max_mb = max(global_batch // max(batch_extent, 1), 1)
    return min(mb, max_mb)


def _default_world_size() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def node_shard_count(n_nodes: int, device_count: Optional[int] = None) -> int:
    """Shard count for the RealBackend node axis: the largest divisor of
    ``n_nodes`` that fits ``device_count`` (default: the default process
    group's world size, 1 without one).

    Divisibility (rather than padding to the device count) is deliberate:
    padded zero-mask node rows would drag the nanmedian inside
    ``guard_weights`` toward zero and flag every real node as an outlier,
    so the node axis is never padded — shards just get n/D nodes each.
    """
    if n_nodes <= 0:
        raise ValueError("n_nodes must be positive")
    if device_count is None:
        device_count = _default_world_size()
    d = max(1, min(n_nodes, device_count))
    while n_nodes % d:
        d -= 1
    return d


@dataclasses.dataclass(frozen=True)
class NodeMesh:
    """The node axis of an ``n_nodes`` sharded step over a process group:
    ``shards`` (d) ranks own ``n_nodes / d`` nodes each; ``shard`` is this
    rank's index among them (``None`` for ranks >= d, which own no node),
    ``nodes`` the indices it owns, ``device`` where its tensors live."""

    n_nodes: int
    shards: int
    shard: Optional[int]
    device: torch.device
    group: Any
    rank: int
    world: int

    def node_range(self) -> Tuple[int, int]:
        """``[lo, hi)``: the nodes this rank owns, the ``n_nodes`` split in
        ``shards`` equal blocks."""
        if self.shard is None:
            return 0, 0
        per = self.n_nodes // self.shards
        return self.shard * per, (self.shard + 1) * per

    @property
    def nodes(self) -> Tuple[int, ...]:
        return tuple(range(*self.node_range()))

    def all_reduce_(self, tensor: torch.Tensor) -> torch.Tensor:
        """Sum ``tensor`` over every rank of the group, in place.  On NCCL
        the sum is queued on the stream: the host does not wait."""
        opts = dist.AllreduceOptions()
        opts.reduceOp = dist.ReduceOp.SUM
        self.group.allreduce([tensor], opts).wait()
        return tensor

    def barrier(self) -> None:
        """Every rank waits here until all have arrived (a one-element sum
        read back to the host)."""
        flag = torch.zeros(1, dtype=torch.float32, device=self.device)
        float(self.all_reduce_(flag)[0])


def mesh_axis_sizes(mesh: NodeMesh) -> dict:
    return {"nodes": mesh.shards}


def _world_of_one(device: torch.device):
    """A one-rank process group of this process alone, on ``device``'s
    backend (gloo for the CPU, NCCL for a card), over a ``HashStore``;
    built once per device."""
    group = _SOLO.get(str(device))
    if group is None:
        store = dist.HashStore()
        if device.type == "cuda":
            group = dist.ProcessGroupNCCL(store, 0, 1)
        elif device.type == "cpu":
            group = dist.ProcessGroupGloo(store, 0, 1, _TIMEOUT)
        else:
            raise ValueError(f"no process-group backend for device {device}")
        _SOLO[str(device)] = group
    return group


def release_world_of_one() -> int:
    """Shut down and forget every world-of-one group of this process (a
    NCCL communicator and its watchdog, or a gloo context); the next
    :func:`make_node_mesh` without a group builds a new one.  Drop the
    backends and meshes that hold one first.  Returns how many it shut
    down."""
    released = 0
    while _SOLO:
        _, group = _SOLO.popitem()
        group.shutdown()
        released += 1
    return released


def make_node_mesh(n_nodes: int, group: Any = None, *, device: Any = None) -> NodeMesh:
    """The node mesh of an ``n_nodes`` sharded step over ``group`` (default:
    the default process group if one is initialised, else a world of one
    on ``device``, the card by default).

    Under the default group the rank's device is ``device`` when given,
    else the current card for NCCL and the CPU for gloo."""
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    if group is None:
        dev = resolve_device(device)
        group = _world_of_one(dev)
    else:
        backend = str(dist.get_backend(group)) if isinstance(group, dist.ProcessGroup) else None
        if device is not None:
            dev = resolve_device(device)
        else:
            dev = resolve_device(None if backend == "nccl" else "cpu")
        if backend == "nccl" and dev.type != "cuda":
            raise ValueError(f"an NCCL group needs CUDA tensors, not {dev}")
    rank, world = group.rank(), group.size()
    d = node_shard_count(n_nodes, world)
    return NodeMesh(
        n_nodes=int(n_nodes), shards=d, shard=rank if rank < d else None,
        device=dev, group=group, rank=rank, world=world,
    )
