"""RuntimeInvariantChecker: debug-mode structural validation of the runtime.

Chaos testing is only as strong as what it asserts.  This module is the
assertion layer: after every reconciled event the checker sweeps the
runtime's cross-object state — allocation, job handles, scheduler caches,
health state machine — for structural corruption that individual unit
tests cannot see (they each hold one object).  Violations are collected,
never raised: a chaos run completes and then reports, so one broken
invariant cannot mask the others.

Checked invariants:

* **Disjoint assignment** — no node assigned to two jobs; every assigned
  node id is in range and not currently down.
* **Conserved allocation fractions** — every per-job goodput/fraction is
  finite and non-negative, and the total number of assigned nodes never
  exceeds the nodes actually available (n_nodes minus down).
* **Bounded caches** — the incremental scheduler's per-job gain/take
  caches respect their eviction limit (``cache_limit``, default
  ``8 * n_nodes``) — the fleet-scale memory guarantee.
* **Quarantine liveness** — every quarantined node has a pending
  re-admission (``release_epoch``), and every crashed node has a crash
  detection record: no node can be silently lost forever.
* **Handle/state coherence** — RUNNING handles hold >= 1 node; DONE and
  PREEMPTED handles hold none.

Enable with ``ClusterRuntime(..., invariants=True)`` (the chaos CI lanes
do); ``runtime.invariant_violations`` and the fault-telemetry block
surface the findings.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, List

from repro_torch.runtime.health import NodeState

__all__ = ["InvariantViolation", "RuntimeInvariantChecker"]


@dataclasses.dataclass(frozen=True)
class InvariantViolation:
    """One broken invariant at one reconcile point."""

    invariant: str
    detail: str
    event: str
    epoch: int

    def __str__(self) -> str:  # pragma: no cover - debugging aid
        return f"[{self.invariant}] {self.detail} (after {self.event}, epoch {self.epoch})"


class RuntimeInvariantChecker:
    """Sweeps a :class:`~repro_torch.runtime.runtime.ClusterRuntime` for
    structural corruption.  ``check`` is called by the runtime after every
    reconciled event (trace-driven and recovery-synthesized alike);
    ``violations`` accumulates across the run."""

    def __init__(self, runtime: Any) -> None:
        self.runtime = runtime
        self.violations: List[InvariantViolation] = []
        self.checks_run = 0

    def check(self, event_label: str = "?") -> List[InvariantViolation]:
        rt = self.runtime
        found: List[InvariantViolation] = []

        def violate(invariant: str, detail: str) -> None:
            found.append(
                InvariantViolation(
                    invariant=invariant,
                    detail=detail,
                    event=event_label,
                    epoch=int(rt.epoch_index),
                )
            )

        alloc = rt.allocation
        # -- disjoint assignment ------------------------------------------
        owner: dict = {}
        assigned_total = 0
        for job, ids in alloc.assignment.items():
            for nid in ids:
                nid = int(nid)
                assigned_total += 1
                if nid in owner:
                    violate(
                        "disjoint-assignment",
                        f"node {nid} assigned to both {owner[nid]!r} and {job!r}",
                    )
                owner[nid] = job
                if not 0 <= nid < rt.n_nodes:
                    violate(
                        "node-range", f"assigned node {nid} outside [0, {rt.n_nodes})"
                    )
                if nid in rt.down_nodes:
                    violate(
                        "down-node-assigned",
                        f"node {nid} assigned to {job!r} while down",
                    )

        # -- conserved fractions / finite scores --------------------------
        available = rt.n_nodes - len(rt.down_nodes)
        if assigned_total > available:
            violate(
                "capacity",
                f"{assigned_total} nodes assigned but only {available} available",
            )
        for job, g in alloc.goodputs.items():
            if not math.isfinite(g) or g < 0.0:
                violate("finite-goodput", f"job {job!r} goodput {g!r}")
        for job, frac in alloc.fractions.items():
            if not math.isfinite(frac) or frac < -1e-9:
                violate("finite-fraction", f"job {job!r} fraction {frac!r}")

        # -- bounded scheduler caches -------------------------------------
        sched = getattr(rt.policy, "scheduler", None)
        if sched is not None:
            limit = sched.cache_limit
            if limit is None:
                limit = 8 * max(sched.n_nodes, 1)
            for label, cache in (
                ("gain", getattr(sched, "_gain_cache", {})),
                ("take", getattr(sched, "_take_cache", {})),
            ):
                for job, per_job in cache.items():
                    if len(per_job) > limit:
                        violate(
                            "cache-bound",
                            f"{label} cache for {job!r} holds {len(per_job)} "
                            f"entries > limit {limit}",
                        )

        # -- quarantine liveness ------------------------------------------
        if rt.health is not None:
            crash_nodes = {
                d["node"] for d in rt.health.detections if d["kind"] == "crash"
            }
            for nid, h in rt.health.nodes.items():
                if h.state == NodeState.QUARANTINED and h.release_epoch is None:
                    violate(
                        "quarantine-liveness",
                        f"node {nid} quarantined with no pending re-admission",
                    )
                if h.state == NodeState.CRASHED and nid not in crash_nodes:
                    violate(
                        "crash-record",
                        f"node {nid} CRASHED with no crash detection record",
                    )
                if h.backoff > rt.health.config.backoff_max:
                    violate(
                        "backoff-cap",
                        f"node {nid} backoff {h.backoff} exceeds cap "
                        f"{rt.health.config.backoff_max}",
                    )

        # -- handle/state coherence ---------------------------------------
        from repro_torch.runtime.runtime import JobState

        for name, handle in rt.handles.items():
            if handle.state == JobState.RUNNING and not handle.nodes:
                violate("handle-state", f"RUNNING job {name!r} holds no nodes")
            if handle.state in (JobState.DONE, JobState.PREEMPTED) and handle.nodes:
                violate(
                    "handle-state",
                    f"{handle.state} job {name!r} still holds nodes {handle.nodes}",
                )

        self.checks_run += 1
        self.violations.extend(found)
        return found

    def assert_clean(self) -> None:
        """Raise AssertionError listing every violation (CI convenience)."""
        if self.violations:
            lines = "\n".join(f"  {v}" for v in self.violations)
            raise AssertionError(
                f"{len(self.violations)} runtime invariant violation(s):\n{lines}"
            )
