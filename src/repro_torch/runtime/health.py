"""Telemetry-driven failure detection: the HealthMonitor.

The runtime already collects per-node :class:`~repro_torch.core.perf_model.
NodeObservation` telemetry every epoch — the same stream the performance-
model fitters consume.  This module turns that stream into failure
detection, the second third of the fault-tolerance layer (injection:
:mod:`repro_torch.runtime.faults`; recovery: the
:class:`~repro_torch.runtime.runtime.ClusterRuntime` reconcile loop):

* **Stragglers** are flagged from the residual between each node's
  *observed* per-batch compute time (a-part + backprop, averaged over the
  epoch's steps) and the :class:`~repro_torch.core.perf_model.ClusterPerfModel`
  *prediction* for the same local batch size.  The log-residual is tracked
  per node with an EWMA + EWMA-variance filter; a breach is a z-score
  above ``z_threshold`` or a raw ratio above ``ratio_threshold`` (the hard
  trip for gross degradation), sustained for ``suspect_epochs``
  consecutive epochs so a single noisy epoch never quarantines a node.
* **Crashes** are flagged from *missing* observations: a node a running
  job holds that reports nothing for ``crash_epochs`` consecutive epochs
  is declared crashed (a silent stop produces no NodeLeave — absence of
  telemetry is the only signal).
* **Numeric anomalies** are a separate channel (:meth:`HealthMonitor.
  observe_numerics`): the real backend's gradient anomaly guard reports,
  per node, how many steps it excluded from Eq. (9) aggregation; a node
  anomalous for ``numeric_suspect_epochs`` consecutive epochs is
  quarantined through the same state machine, so a persistently poisoned
  node is contained exactly like a persistent straggler.
* **Quarantine state machine** with exponential-backoff re-admission:
  ``healthy → quarantined → probation → healthy``, where a breach during
  probation re-quarantines with a *doubled* backoff (capped at
  ``backoff_max``) so a flapping node cannot thrash the scheduler's warm
  caches.
* **Drift** — a sustained mild residual across a job's whole node set
  (``drift_ratio`` for ``drift_epochs`` epochs, below the straggler
  threshold) requests a forced :class:`~repro_torch.runtime.events.ModelRefit`
  so the controller re-learns instead of planning on stale coefficients.

The monitor is *observation-only until it fires*: it consumes telemetry
and emits :class:`HealthAction` values from :meth:`poll`; the runtime
decides how to act on them.  With no faults present it emits nothing and
the replay is bit-identical to a monitor-free run.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = [
    "HealthConfig",
    "NodeState",
    "HealthAction",
    "QuarantineNode",
    "ReadmitNode",
    "CrashDetected",
    "RefitRequested",
    "HealthMonitor",
]


class NodeState:
    """The quarantine state machine's alphabet."""

    HEALTHY = "healthy"
    QUARANTINED = "quarantined"
    PROBATION = "probation"
    CRASHED = "crashed"


@dataclasses.dataclass(frozen=True)
class HealthConfig:
    """Detection thresholds and backoff schedule (all documented in
    benchmarks/README.md §Fault tolerance)."""

    z_threshold: float = 4.0        # EWMA z-score that counts as a breach
    ratio_threshold: float = 1.5    # hard observed/predicted trip
    ewma_decay: float = 0.5         # residual EWMA decay (higher = slower)
    sigma_floor: float = 0.05       # log-residual stddev floor for the z-score
    suspect_epochs: int = 2         # consecutive breaches before quarantine
    crash_epochs: int = 2           # consecutive missing epochs before crash
    backoff_initial: int = 2        # epochs quarantined before probation
    backoff_max: int = 32           # backoff doubling cap
    probation_epochs: int = 2       # clean probation epochs before healthy
    drift_ratio: float = 1.10       # job-mean residual that counts as drift
    drift_epochs: int = 4           # sustained drift epochs before a refit
    numeric_suspect_epochs: int = 2  # consecutive anomalous-gradient epochs
                                     # before quarantine (numeric channel)


# -- actions the runtime reconciles ------------------------------------------


@dataclasses.dataclass(frozen=True)
class HealthAction:
    epoch: int


@dataclasses.dataclass(frozen=True)
class QuarantineNode(HealthAction):
    node: int
    job: str
    backoff: int


@dataclasses.dataclass(frozen=True)
class ReadmitNode(HealthAction):
    node: int


@dataclasses.dataclass(frozen=True)
class CrashDetected(HealthAction):
    node: int
    job: str


@dataclasses.dataclass(frozen=True)
class RefitRequested(HealthAction):
    job: str


class _NodeHealth:
    """Per-node filter + state machine state."""

    __slots__ = (
        "state", "ewma", "var", "count", "breaches", "missing",
        "backoff", "release_epoch", "probation_left", "quarantines",
        "transitions", "numeric_breaches",
    )

    def __init__(self) -> None:
        self.state = NodeState.HEALTHY
        self.ewma = 0.0          # EWMA of the log residual
        self.var = 0.0           # EWMA of its squared deviation
        self.count = 0
        self.breaches = 0
        self.missing = 0
        self.backoff = 0
        self.release_epoch: Optional[int] = None
        self.probation_left = 0
        self.quarantines = 0
        self.transitions: List[Tuple[int, str]] = []
        self.numeric_breaches = 0

    def transition(self, epoch: int, state: str) -> None:
        self.state = state
        self.transitions.append((epoch, state))


class HealthMonitor:
    """Consumes per-epoch node telemetry; emits recovery actions.

    Drive with one :meth:`observe_job` call per running job per epoch,
    then one :meth:`tick` per epoch (quarantine-release bookkeeping),
    then drain :meth:`poll`.  ``detections`` is the append-only log the
    fault-telemetry accounting reads (``{"kind", "node", "job", "epoch"}``).
    """

    def __init__(self, config: Optional[HealthConfig] = None) -> None:
        self.config = config or HealthConfig()
        self.nodes: Dict[int, _NodeHealth] = {}
        self.detections: List[Dict[str, object]] = []
        self._drift: Dict[str, int] = {}
        self._pending: List[HealthAction] = []

    # -- observability ---------------------------------------------------

    def node(self, node_id: int) -> _NodeHealth:
        if node_id not in self.nodes:
            self.nodes[node_id] = _NodeHealth()
        return self.nodes[node_id]

    def state(self, node_id: int) -> str:
        return self.nodes[node_id].state if node_id in self.nodes else NodeState.HEALTHY

    def states(self) -> Dict[int, str]:
        return {nid: h.state for nid, h in sorted(self.nodes.items())}

    def transitions(self, node_id: int) -> List[Tuple[int, str]]:
        return list(self.node(node_id).transitions)

    # -- ingestion -------------------------------------------------------

    def observe_job(
        self,
        job: str,
        epoch: int,
        node_ids: Sequence[int],
        observed_times: Sequence[Optional[float]],
        predicted_times: Sequence[float],
    ) -> None:
        """One job's epoch telemetry: per held node, the observed mean
        compute time (``None`` if the node reported nothing this epoch)
        and the model-predicted time for the same local batch."""
        cfg = self.config
        residuals: List[float] = []
        for nid, obs, pred in zip(node_ids, observed_times, predicted_times):
            h = self.node(int(nid))
            if h.state in (NodeState.QUARANTINED, NodeState.CRASHED):
                continue  # holds no work we trust; nothing to ingest
            if obs is None:
                h.missing += 1
                h.breaches = 0
                if h.missing >= cfg.crash_epochs:
                    h.transition(epoch, NodeState.CRASHED)
                    self.detections.append(
                        {"kind": "crash", "node": int(nid), "job": job, "epoch": epoch}
                    )
                    self._pending.append(
                        CrashDetected(epoch=epoch, node=int(nid), job=job)
                    )
                continue
            h.missing = 0
            if pred <= 0.0 or obs <= 0.0:
                continue
            x = math.log(obs / pred)
            residuals.append(x)
            sigma = max(math.sqrt(h.var), cfg.sigma_floor)
            breach = (
                (x - h.ewma) / sigma > cfg.z_threshold
                or obs / pred > cfg.ratio_threshold * math.exp(h.ewma)
            ) and h.count >= 1
            if breach:
                h.breaches += 1
                trip = (
                    1 if h.state == NodeState.PROBATION else cfg.suspect_epochs
                )  # a flap re-quarantines on the first probation breach
                if h.breaches >= trip:
                    self._quarantine(h, int(nid), job, epoch)
            else:
                h.breaches = 0
                if h.state == NodeState.PROBATION:
                    h.probation_left -= 1
                    if h.probation_left <= 0:
                        h.transition(epoch, NodeState.HEALTHY)
                # The filter only learns from non-breach epochs, so a
                # straggler cannot drag its own baseline up and escape.
                d = cfg.ewma_decay
                if h.count == 0:
                    h.ewma, h.var = x, 0.0
                else:
                    h.var = d * h.var + (1 - d) * (x - h.ewma) ** 2
                    h.ewma = d * h.ewma + (1 - d) * x
                h.count += 1
        self._observe_drift(job, epoch, residuals)

    def observe_numerics(
        self,
        job: str,
        epoch: int,
        node_ids: Sequence[int],
        anomaly_counts: Sequence[int],
    ) -> None:
        """The numerical-health channel: per held node, how many of this
        epoch's steps the gradient anomaly guard excluded the node from
        Eq. (9) aggregation (non-finite or norm-outlier contribution).

        A node anomalous for ``numeric_suspect_epochs`` consecutive epochs
        is quarantined through the same state machine timing faults use —
        and, as with timing breaches, a single anomalous epoch during
        probation re-quarantines immediately (a numerically flapping node
        doubles its backoff).  Clean epochs reset the streak.
        """
        cfg = self.config
        for nid, count in zip(node_ids, anomaly_counts):
            h = self.node(int(nid))
            if h.state in (NodeState.QUARANTINED, NodeState.CRASHED):
                continue
            if int(count) <= 0:
                h.numeric_breaches = 0
                continue
            h.numeric_breaches += 1
            if h.numeric_breaches == 1:
                self.detections.append(
                    {"kind": "numeric", "node": int(nid), "job": job, "epoch": epoch}
                )
            trip = 1 if h.state == NodeState.PROBATION else cfg.numeric_suspect_epochs
            if h.numeric_breaches >= trip:
                h.numeric_breaches = 0
                self._quarantine(h, int(nid), job, epoch)

    def _quarantine(self, h: _NodeHealth, nid: int, job: str, epoch: int) -> None:
        h.quarantines += 1
        h.backoff = (
            self.config.backoff_initial
            if h.quarantines == 1
            else min(h.backoff * 2, self.config.backoff_max)
        )
        h.release_epoch = epoch + h.backoff
        h.breaches = 0
        h.transition(epoch, NodeState.QUARANTINED)
        self.detections.append(
            {"kind": "quarantine", "node": nid, "job": job, "epoch": epoch}
        )
        self._pending.append(
            QuarantineNode(epoch=epoch, node=nid, job=job, backoff=h.backoff)
        )

    def _observe_drift(self, job: str, epoch: int, residuals: List[float]) -> None:
        """Sustained mild whole-job drift (below the straggler trip) means
        the performance model is stale, not that a node is sick."""
        cfg = self.config
        if residuals and (
            sum(residuals) / len(residuals) > math.log(cfg.drift_ratio)
        ):
            self._drift[job] = self._drift.get(job, 0) + 1
            if self._drift[job] >= cfg.drift_epochs:
                self._drift[job] = 0
                self.detections.append(
                    {"kind": "drift", "node": None, "job": job, "epoch": epoch}
                )
                self._pending.append(RefitRequested(epoch=epoch, job=job))
        else:
            self._drift[job] = 0

    def tick(self, epoch: int) -> None:
        """End-of-epoch bookkeeping: release quarantined nodes whose
        backoff expired into probation."""
        for nid, h in sorted(self.nodes.items()):
            if (
                h.state == NodeState.QUARANTINED
                and h.release_epoch is not None
                and epoch >= h.release_epoch
            ):
                h.probation_left = self.config.probation_epochs
                h.breaches = 0
                h.transition(epoch, NodeState.PROBATION)
                self._pending.append(ReadmitNode(epoch=epoch, node=nid))

    def poll(self) -> List[HealthAction]:
        """Drain pending actions (deterministic order: ingestion order)."""
        out, self._pending = self._pending, []
        return out
