"""repro_torch.runtime — the event-driven cluster runtime: one front door over
controller, scheduler, simulator, and trainer.

The paper's Cannikin system is a *runtime* loop: observe steps, refit the
performance model, re-plan batch sizes, reallocate nodes as jobs and
hardware come and go.  This package exposes that loop as one API:

* :class:`ClusterRuntime` — deterministic reconcile loop over an event
  queue (:class:`JobArrival`, :class:`JobCompletion`, :class:`NodeJoin`/
  :class:`NodeLeave`, :class:`ModelRefit`, :class:`Preemption`), wrapping
  the incremental :class:`~repro_torch.core.scheduler.Scheduler` so allocations
  are recomputed incrementally per event, never cold.
* :class:`JobHandle` — per-job lifecycle (pending → running ⇄ preempted →
  done) owning a :class:`~repro_torch.core.controller.CannikinController`;
  surfaces :class:`~repro_torch.core.controller.EpochPlan`s and
  :class:`~repro_torch.core.controller.ControllerStats`.
* :class:`ExecutionBackend` — the plan → execute → observe engine behind
  ``JobHandle.advance``: :class:`SimBackend` (timing simulator) and
  :class:`RealBackend` (real gradients + Theorem-4.1 GNS tracking,
  preemption checkpoint/restore) are swappable per :class:`JobSpec`;
  :class:`EpochLoop`/:func:`run_backend_epoch` are the same loop
  standalone, surfacing unified :class:`EpochRecord` telemetry.
* :class:`Policy` — pluggable allocation policies: ``cannikin`` (the
  paper-derived allocator), ``static``, and ``fair-share`` baselines, all
  scored on the same goodput scale.
* :class:`Trace` / :func:`replay` / :func:`compare_policies` — synthetic
  multi-job churn workloads over :class:`~repro_torch.core.simulator.
  SimulatedCluster` (the Pollux/Sia-style cluster simulation).
* :class:`FaultPlan` / :class:`FaultInjector` / :class:`HealthMonitor` —
  the fault-tolerance layer: seeded deterministic fault injection
  (crashes, stragglers, noise spikes, flaky checkpoint I/O — plus the
  real-path integrity faults :class:`GradientPoison`,
  :class:`CheckpointCorruption`, :class:`SolverStall`), telemetry-
  driven detection (EWMA residuals, the gradient anomaly guard's
  numerical-health channel, quarantine with exponential-backoff
  re-admission), and self-healing recovery through the reconcile loop
  (``replay(..., faults=FaultPlan.chaos(n))``).
* :class:`Watchdog` / :class:`RuntimeInvariantChecker` — integrity
  hardening: deadline guards on OptPerf solves (timeouts enter the
  engine-degradation chain) and backend epochs, and a debug-mode
  structural validator run after every reconciled event
  (``ClusterRuntime(..., invariants=True)``).  Checksummed checkpoint
  generations with rollback live in :mod:`repro_torch.train.checkpoint`.
* :func:`make_partition_policy` / :func:`drive_partition_policy` — the
  single-job batch-partition factory + epoch-driving loop shared by the
  launch CLI, examples, and benchmarks.

The counterpart of ``repro/runtime``, module for module; the port-only
argument is the ``device`` the Cannikin policy's ``"jax"`` engine solves
on (``ClusterRuntime``/``replay``/``compare_policies``), and a real job's
model trains on its :class:`RealBackendConfig`'s ``device``.  The card is
the default for both; ``device="cpu"`` must be asked for.

Quick start::

    from repro_torch.core.scheduler import random_jobs
    from repro_torch.runtime import ClusterRuntime

    rt = ClusterRuntime(n_nodes=8, policy="cannikin")
    for i, job in enumerate(random_jobs(2, 8, seed=0)):
        rt.submit(job, at=float(i))
    rt.run()                 # reconcile queued events
    rt.advance(epochs=3)     # step the running jobs' training loops
    print(rt.allocation.aggregate_goodput, rt.counters())
"""
from repro_torch.runtime.backend import (
    BACKENDS,
    EpochLoop,
    EpochRecord,
    ExecutionBackend,
    ExecutionResult,
    GradObservation,
    RealBackend,
    RealBackendConfig,
    SimBackend,
    make_backend,
    run_backend_epoch,
)
from repro_torch.runtime.events import (
    Event,
    JobArrival,
    JobCompletion,
    ModelRefit,
    NodeJoin,
    NodeLeave,
    Preemption,
    describe,
)
from repro_torch.runtime.faults import (
    FAULT_PLANS,
    CheckpointCorruption,
    FaultInjector,
    FaultPlan,
    FlakyCheckpointIO,
    FlakyCheckpoints,
    GradientPoison,
    NodeCrash,
    NoiseSpike,
    SolverStall,
    Straggler,
    make_fault_plan,
)
from repro_torch.runtime.health import (
    CrashDetected,
    HealthAction,
    HealthConfig,
    HealthMonitor,
    NodeState,
    QuarantineNode,
    ReadmitNode,
    RefitRequested,
)
from repro_torch.runtime.invariants import InvariantViolation, RuntimeInvariantChecker
from repro_torch.runtime.policy import (
    POLICIES,
    CannikinPolicy,
    FairSharePolicy,
    Policy,
    StaticPolicy,
    drive_partition_policy,
    make_partition_policy,
    make_policy,
)
from repro_torch.runtime.runtime import (
    ClusterRuntime,
    JobHandle,
    JobState,
    ReconcileRecord,
    drift_spec,
)
from repro_torch.runtime.trace import (
    Trace,
    TraceReport,
    compare_policies,
    format_batch_policy_summary,
    format_summary,
    rank_batch_policies,
    replay,
    synthetic_trace,
)
from repro_torch.runtime.watchdog import DeadlineExceeded, Watchdog

__all__ = [
    "BACKENDS",
    "EpochLoop",
    "EpochRecord",
    "ExecutionBackend",
    "ExecutionResult",
    "GradObservation",
    "RealBackend",
    "RealBackendConfig",
    "SimBackend",
    "make_backend",
    "run_backend_epoch",
    "Event",
    "JobArrival",
    "JobCompletion",
    "ModelRefit",
    "NodeJoin",
    "NodeLeave",
    "Preemption",
    "describe",
    "Policy",
    "POLICIES",
    "CannikinPolicy",
    "StaticPolicy",
    "FairSharePolicy",
    "make_policy",
    "make_partition_policy",
    "drive_partition_policy",
    "ClusterRuntime",
    "JobHandle",
    "JobState",
    "ReconcileRecord",
    "drift_spec",
    "Trace",
    "TraceReport",
    "replay",
    "compare_policies",
    "synthetic_trace",
    "format_summary",
    "rank_batch_policies",
    "format_batch_policy_summary",
    "FAULT_PLANS",
    "FaultPlan",
    "FaultInjector",
    "FlakyCheckpointIO",
    "FlakyCheckpoints",
    "NodeCrash",
    "NoiseSpike",
    "Straggler",
    "GradientPoison",
    "CheckpointCorruption",
    "SolverStall",
    "make_fault_plan",
    "Watchdog",
    "DeadlineExceeded",
    "RuntimeInvariantChecker",
    "InvariantViolation",
    "HealthAction",
    "HealthConfig",
    "HealthMonitor",
    "NodeState",
    "CrashDetected",
    "QuarantineNode",
    "ReadmitNode",
    "RefitRequested",
]
