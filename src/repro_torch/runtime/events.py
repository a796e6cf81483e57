"""The cluster-churn part of the runtime's event alphabet.

Every change to the cluster state is an immutable, timestamped
:class:`Event`.  The serving runtime speaks the membership events:

* :class:`NodeJoin` / :class:`NodeLeave` — cluster membership churn.  Node
  ids are stable: a leave marks the id unavailable, a join brings it back.

The job events of the reference alphabet (``JobArrival``,
``JobCompletion``, ``Preemption``, ``ModelRefit``) carry a scheduler
``JobSpec`` and arrive with the scheduler.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

__all__ = [
    "Event",
    "NodeJoin",
    "NodeLeave",
    "describe",
]


@dataclasses.dataclass(frozen=True)
class Event:
    """Base event: ``time`` is the simulated timestamp the event fires at.
    Ties are broken by post order (the runtime's queue sequence number)."""

    time: float


@dataclasses.dataclass(frozen=True)
class NodeJoin(Event):
    nodes: Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class NodeLeave(Event):
    nodes: Tuple[int, ...]


def describe(event: Event) -> str:
    """One-line human description (trace logs and reconcile records)."""
    if isinstance(event, NodeJoin):
        return f"node_join{tuple(event.nodes)}"
    if isinstance(event, NodeLeave):
        return f"node_leave{tuple(event.nodes)}"
    return type(event).__name__
