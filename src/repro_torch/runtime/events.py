"""The ClusterRuntime event alphabet.

Every change to the cluster state — jobs coming and going, nodes failing
and returning, performance-model refreshes, policy preemptions — is an
immutable, timestamped :class:`Event`.  The runtime consumes them from a
single queue in ``(time, post-order)`` order, so a trace replays
deterministically: same events in, same reconcile decisions out.

The alphabet is intentionally small (the Pollux/Sia-style cluster
simulation needs exactly these six):

* :class:`JobArrival`    — a job enters the queue (or a preempted job
  resumes: arrivals are idempotent on the handle, keyed by job name).
* :class:`JobCompletion` — a job finishes and releases its nodes.
* :class:`Preemption`    — the operator/policy pulls a job off the cluster;
  its handle survives (models retained), its execution backend's
  statistical state is checkpointed (params/opt-state/GNS for a real
  backend — to ``<checkpoint_dir>/<job>.ckpt.npz`` when the runtime has
  one), and a later arrival resumes it with that state restored bit-exactly.
* :class:`NodeJoin` / :class:`NodeLeave` — cluster membership churn.  Node
  ids are stable: a leave marks the id unavailable, a join brings it back.
* :class:`ModelRefit`    — a job's per-node performance coefficients were
  re-fitted (the per-epoch OLS path); carries either an explicit refreshed
  :class:`~repro_torch.core.scheduler.JobSpec` or a seeded drift to apply.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.core.scheduler import JobSpec

__all__ = [
    "Event",
    "JobArrival",
    "JobCompletion",
    "Preemption",
    "NodeJoin",
    "NodeLeave",
    "ModelRefit",
    "describe",
]


@dataclasses.dataclass(frozen=True)
class Event:
    """Base event: ``time`` is the simulated timestamp the event fires at.
    Ties are broken by post order (the runtime's queue sequence number)."""

    time: float


@dataclasses.dataclass(frozen=True)
class JobArrival(Event):
    spec: JobSpec

    @property
    def job(self) -> str:
        return self.spec.name


@dataclasses.dataclass(frozen=True)
class JobCompletion(Event):
    job: str


@dataclasses.dataclass(frozen=True)
class Preemption(Event):
    job: str


@dataclasses.dataclass(frozen=True)
class NodeJoin(Event):
    nodes: Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class NodeLeave(Event):
    nodes: Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class ModelRefit(Event):
    """Per-epoch OLS-refit of one job's performance models.

    If ``spec`` is given it replaces the job's spec verbatim; otherwise the
    current spec's node coefficients are drifted by the seeded lognormal
    jitter of :func:`repro_torch.core.simulator.drift_model` (``rel``/``seed``) —
    the same drift vehicle the warm-start benchmarks use, so refit traces
    are reproducible without carrying model payloads around.
    """

    job: str = ""
    rel: float = 0.1
    seed: int = 0
    spec: Optional[JobSpec] = None


def describe(event: Event) -> str:
    """One-line human description (trace logs and reconcile records)."""
    if isinstance(event, JobArrival):
        return f"arrive({event.spec.name})"
    if isinstance(event, JobCompletion):
        return f"complete({event.job})"
    if isinstance(event, Preemption):
        return f"preempt({event.job})"
    if isinstance(event, NodeJoin):
        return f"node_join{tuple(event.nodes)}"
    if isinstance(event, NodeLeave):
        return f"node_leave{tuple(event.nodes)}"
    if isinstance(event, ModelRefit):
        return f"refit({event.job}, rel={event.rel})"
    return type(event).__name__
