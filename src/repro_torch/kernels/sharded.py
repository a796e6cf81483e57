"""A kernel's wrapper on DTensors: each rank computes on its local shards.

Attention, the WKV recurrence and the selective scan are independent over
the batch and over heads (the scan's channels), and each runs over the
whole sequence.  So each wrapper, handed DTensors (the dry run's
parameters and activations over a ``DeviceMesh``), runs itself under
``local_map`` on the local shards: split over batch and heads as its lead
input is, never over the sequence.  On a ``"cuda"`` mesh the local shards
take the kernel's route (its custom op, whose fake implementation serves
fake tensors); on a ``"cpu"`` mesh, the plain version.  The parameters of
the call that have no batch dim (WKV's ``u``, the scan's ``log_a``) or no
head dim (the scan's B and C) are replicated over those mesh dims, and
their gradients come back as partial sums there.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch

__all__ = ["local_over_batch_heads"]

Dims = Tuple[Optional[int], Optional[int]]  # (batch dim, head dim) of one tensor


def _roles(lead, dims: Dims) -> List[Optional[int]]:
    """Per mesh dim of ``lead``: 0 where it splits the batch, 1 where it
    splits the heads, None where the call replicates."""
    roles: List[Optional[int]] = []
    for p in lead.placements:
        role = None
        for i, dim in enumerate(dims):
            if dim is not None and p.is_shard(dim):
                role = i
        roles.append(role)
    return roles


def _placements(roles, dims: Dims, missing) -> Tuple:
    """A tensor's placements: ``Shard`` on the mesh dims that split a dim
    it has, ``missing()`` on those that split a dim it lacks, ``Replicate``
    where the call replicates."""
    from torch.distributed.tensor import Replicate, Shard

    return tuple(Replicate() if r is None else Shard(dims[r]) if dims[r] is not None
                 else missing() for r in roles)


def local_over_batch_heads(fn: Callable, tensors: Sequence[torch.Tensor],
                           in_dims: Sequence[Dims], out_dims: Sequence[Dims]):
    """``fn(*local tensors)`` on each rank's shards of the DTensors
    ``tensors``, split over batch and heads as ``tensors[0]`` is (dims
    given as (batch dim, head dim) per input in ``in_dims`` and per output
    in ``out_dims``, None where a tensor has no such dim).  Returns DTensors
    (a tuple when ``out_dims`` has more than one entry)."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    roles = _roles(tensors[0], in_dims[0])
    in_pl = tuple(_placements(roles, d, Replicate) for d in in_dims)
    grad_pl = tuple(_placements(roles, d, Partial) for d in in_dims)
    # local_map reads a tuple as one placement list per output, a list as
    # the one output's placements.
    out_pl = tuple(list(_placements(roles, d, Replicate)) for d in out_dims)
    mapped = local_map(fn, out_placements=out_pl if len(out_pl) > 1 else out_pl[0],
                       in_placements=in_pl, in_grad_placements=grad_pl,
                       device_mesh=tensors[0].device_mesh, redistribute_inputs=True)
    return mapped(*tensors)
