"""Activation-sharding constraint hook (the counterpart of
``repro/sharding/context.py``).

Model code is mesh-agnostic.  Where the reference pins an activation's
layout with ``with_sharding_constraint`` (GSPMD loses the batch or head
sharding of attention operands and MoE buffers otherwise), the port's
models call ``constrain(x, logical_axes)`` at the same points.  Inside a
``sharding_context(mesh, rules)`` (the dry run's) it redistributes a
``DTensor`` to the layout the rules give its logical axes; outside one, or
on a plain tensor, it returns ``x`` itself, so every path that runs on
plain tensors is unchanged.

Divisibility and duplicate-axis fallbacks come from ``MeshRules.spec``, so
a constraint never asks for an uneven layout (e.g. batch=1 stays
replicated).  :func:`placements` turns a spec into DTensor placements.
"""
from __future__ import annotations

import contextlib
import types
from typing import List, Optional, Sequence

import torch

from repro_torch.sharding.rules import MeshRules, Spec

__all__ = ["sharding_context", "constrain", "active_rules", "placements", "rank_block",
           "is_dtensor"]

# Process-wide, not per thread (the reference's is per thread): the
# autograd engine runs a CUDA backward, and the recomputation of a
# checkpointed layer in it, on its own device thread, where the context
# must hold too.
_state = types.SimpleNamespace(ctx=None)


@contextlib.contextmanager
def sharding_context(mesh, rules: MeshRules):
    """Activate ``rules`` over the ``DeviceMesh`` ``mesh`` for
    :func:`constrain` (and for :func:`active_rules`)."""
    prev = _state.ctx
    _state.ctx = (mesh, rules)
    try:
        yield
    finally:
        _state.ctx = prev


def active_rules() -> Optional[MeshRules]:
    """The MeshRules of the active sharding context, or None."""
    ctx = _state.ctx
    return ctx[1] if ctx else None


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def placements(mesh, spec: Spec) -> List:
    """DTensor placements over ``mesh`` (a ``DeviceMesh`` with named dims)
    for a spec tuple: tensor dim i on mesh axis a -> ``Shard(i)`` on a's
    mesh dim, every mesh dim no dim names -> ``Replicate()``.  A dim on a
    tuple of axes (``("pod", "data")``) is split major to minor, which is
    the mesh dims' order, as DTensor splits a dim sharded on several.  A
    mesh dim of one rank splits nothing: ``Replicate()`` there, so that a
    one-rank mesh lays every tensor out whole."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out: List = [Replicate() for _ in names]
    for dim, assignment in enumerate(spec):
        if assignment is None:
            continue
        axes = (assignment,) if isinstance(assignment, str) else tuple(assignment)
        mesh_dims = [names.index(a) for a in axes]
        if mesh_dims != sorted(mesh_dims):
            raise ValueError(f"dim {dim}'s axes {axes} are not in the mesh's order {names}")
        for m in mesh_dims:
            if mesh.size(m) > 1:
                out[m] = Shard(dim)
    return out


def rank_block(mesh, dims: Sequence[int]) -> int:
    """Which block of a dim split over the mesh dims ``dims`` (major to
    minor) this rank holds."""
    block = 0
    for i in dims:
        block = block * mesh.size(i) + mesh.get_local_rank(i)
    return block


def constrain(x: torch.Tensor, logical_axes: Sequence[Optional[str]], *,
              sizes: Optional[Sequence[int]] = None) -> torch.Tensor:
    """``x`` laid out (and its gradient pinned) as the rules lay out
    ``logical_axes`` under the active context; ``x`` itself outside one or
    for a plain tensor.  ``sizes`` replaces ``x.shape`` in the rules'
    divisibility check: a flattened (heads x head_dim) dim splits as its
    head count would."""
    ctx = _state.ctx
    if ctx is None:
        return x
    mesh, rules = ctx
    if len(logical_axes) != x.ndim:
        raise ValueError(f"axes rank {len(logical_axes)} != tensor rank {x.ndim}")
    if not is_dtensor(x):
        return x
    spec = rules.spec(logical_axes, x.shape if sizes is None else sizes, path="activation")
    return _Pin.apply(x, mesh, tuple(placements(mesh, spec)))


class _Pin(torch.autograd.Function):
    """Redistribute to ``placements`` and pin the gradient to the same
    layout, as a sharding constraint does to its cotangent (DTensor's own
    ``redistribute`` sends the gradient back to the input's layout, so a
    partial sum's gradient would stay partial)."""

    @staticmethod
    def forward(ctx, x, mesh, layout):
        ctx.mesh, ctx.layout = mesh, layout
        return x.redistribute(mesh, layout)

    @staticmethod
    def backward(ctx, grad):
        return grad.redistribute(ctx.mesh, ctx.layout), None, None
