"""ClusterRuntime: the event-driven reconcile loop over scheduler,
controller, and simulator.

The paper's Cannikin system is a *runtime*: it observes steps, refits the
performance model, re-plans batch sizes, and reallocates nodes as jobs and
hardware come and go.  :class:`ClusterRuntime` is that loop as one object:

* events (:mod:`repro_torch.runtime.events`) enter a single queue and are
  reconciled deterministically in ``(time, post-order)`` order;
* each event maps onto exactly one incremental entry point of the active
  allocation :class:`~repro_torch.runtime.policy.Policy` (for ``cannikin``, the
  incremental :class:`~repro_torch.core.scheduler.Scheduler` — cached rows and
  warm bracket seeds make every event an incremental re-allocation, never
  a cold solve);
* the resulting :class:`~repro_torch.core.scheduler.Allocation` is pushed down
  to per-job :class:`JobHandle` lifecycle objects, each owning its own
  :class:`~repro_torch.core.controller.CannikinController` (the paper's elastic
  ``add_nodes``/``remove_nodes`` reconfiguration runs on every node-set
  change) and a per-job
  :class:`~repro_torch.runtime.backend.ExecutionBackend` — the timing simulator
  (``backend="sim"``, built from the job's own ground-truth node models)
  or real gradients (``backend="real"``), whichever the
  :class:`JobSpec` names;
* :meth:`ClusterRuntime.advance` steps every running job's epoch loop
  (plan → execute → observe over its backend), so a replayed trace yields
  both allocation decisions *and* training behaviour (bootstrap → optperf,
  unified :class:`~repro_torch.runtime.backend.EpochRecord` telemetry,
  ControllerStats);
* :class:`Preemption` is checkpointed for real backends: params/opt-state/
  GNS state are snapshotted (and written via :mod:`repro_torch.train.checkpoint`
  when the runtime has a ``checkpoint_dir``) on preempt and restored
  bit-exactly on re-admission.

The counterpart of ``repro/runtime/runtime.py``, copied verbatim but for
the ``device`` that :class:`ClusterRuntime` hands its allocation policy
(where the Cannikin policy's ``"jax"`` engine solves).  Where a real job's
model trains is its :class:`~repro_torch.runtime.backend.RealBackendConfig`'s
``device``: the card unless ``"cpu"`` is asked for.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import os
from typing import Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.core.batch_policy import policy_requirements
from repro_torch.core.controller import CannikinController, ControllerStats, EpochPlan
from repro_torch.core.scheduler import Allocation, JobSpec
from repro_torch.core.simulator import drift_model
from repro_torch.runtime.backend import (
    EpochRecord,
    ExecutionBackend,
    RealBackendConfig,
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
from repro_torch.runtime.faults import FaultInjector, FaultPlan
from repro_torch.runtime.health import (
    CrashDetected,
    HealthConfig,
    HealthMonitor,
    QuarantineNode,
    ReadmitNode,
    RefitRequested,
)
from repro_torch.runtime.invariants import RuntimeInvariantChecker
from repro_torch.runtime.policy import Policy, make_policy
from repro_torch.runtime.watchdog import Watchdog

__all__ = [
    "JobState",
    "JobHandle",
    "ReconcileRecord",
    "ClusterRuntime",
    "drift_spec",
]


class JobState:
    """Job lifecycle: submit → PENDING → RUNNING ⇄ PREEMPTED → DONE."""

    PENDING = "pending"       # submitted, currently holds no nodes
    RUNNING = "running"       # holds >= 1 node
    PREEMPTED = "preempted"   # pulled off the cluster; resumable
    DONE = "done"             # completed; terminal


def drift_spec(spec: JobSpec, rel: float, seed: int) -> JobSpec:
    """A job spec whose node coefficients drifted by ~``rel`` (the seeded
    lognormal jitter of :func:`repro_torch.core.simulator.drift_model`) — the
    deterministic payload behind :class:`ModelRefit` events."""
    drifted = drift_model(spec.full_model, rel, seed)
    return dataclasses.replace(spec, node_models=drifted.nodes)


class JobHandle:
    """Lifecycle object for one submitted job.

    Owns the job's :class:`CannikinController` (created when the job first
    receives nodes; *kept* across preemption and node churn so learned
    models survive, exactly the paper's §6 elastic semantics) and the
    job's :class:`~repro_torch.runtime.backend.ExecutionBackend` — whichever
    engine ``spec.backend`` names (``"sim"``: the job's own ground-truth
    node models as a timing simulator; ``"real"``: real gradients).
    ``advance`` is one plan → execute → observe loop over that backend.
    Surfaces unified :class:`~repro_torch.runtime.backend.EpochRecord` telemetry
    (``records``), :class:`EpochPlan`s, and :class:`ControllerStats`.

    Preemption checkpoints the backend's statistical state (params,
    opt-state, GNS state, stream counters for a real backend; nothing for
    the sim): in memory always, and to ``<checkpoint_dir>/<job>.ckpt.npz``
    when the runtime has a checkpoint directory.  Re-admission restores it
    — from the file when one exists (the cross-process semantics), else
    from the in-memory snapshot — before the first post-resume epoch.
    """

    def __init__(
        self,
        spec: JobSpec,
        *,
        submitted_at: float = 0.0,
        noise: float = 0.0,
        seed: int = 0,
        real_config: Optional[RealBackendConfig] = None,
        checkpoint_dir: Optional[str] = None,
        injector: Optional[FaultInjector] = None,
    ) -> None:
        self.spec = spec
        self.state = JobState.PENDING
        self.nodes: Tuple[int, ...] = ()
        self.controller: Optional[CannikinController] = None
        self.backend: Optional[ExecutionBackend] = None
        self.submitted_at = submitted_at
        self.started_at: Optional[float] = None
        self.finished_at: Optional[float] = None
        self.epochs_run = 0
        self.sim_time = 0.0
        self.reallocations = 0
        self.preemptions = 0
        self.ckpt_write_failures = 0
        self.ckpt_fallbacks = 0
        self.ckpt_rollbacks = 0
        self.restores = 0
        self.records: List[EpochRecord] = []
        self.last_result = None  # the most recent epoch's ExecutionResult
        self.checkpoint_path: Optional[str] = None
        self._ctl_nodes: Tuple[int, ...] = ()  # node ids behind controller idx 0..n-1
        self._noise = noise
        self._seed = seed
        self._real_config = real_config
        self._ckpt_dir = checkpoint_dir
        self._injector = injector
        self._ckpt_manager = None  # lazy CheckpointManager (needs _ckpt_dir)
        self._snapshot: Optional[dict] = None
        self._resume_pending = False

    # -- observability ---------------------------------------------------

    @property
    def name(self) -> str:
        return self.spec.name

    @property
    def stats(self) -> Optional[ControllerStats]:
        return self.controller.stats if self.controller is not None else None

    @property
    def last_plan(self) -> Optional[EpochPlan]:
        return self.controller.last_plan if self.controller is not None else None

    @property
    def last_record(self) -> Optional[EpochRecord]:
        return self.records[-1] if self.records else None

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (
            f"JobHandle({self.name!r}, state={self.state}, nodes={self.nodes}, "
            f"epochs={self.epochs_run})"
        )

    # -- reconcile surface (driven by ClusterRuntime) --------------------

    def _new_controller(self, n: int) -> CannikinController:
        policy_name = getattr(self.spec, "batch_policy", None)
        if policy_name is not None:
            return self._policy_controller(n, policy_name)
        if self.spec.backend == "real":
            # Real gradients feed the GNS tracker, so total-batch adaptivity
            # is live: the controller sweeps {B, 2B} against the measured
            # gradient noise scale (§4.4).
            total = self.spec.total_batch
            return CannikinController(
                n,
                batch_candidates=sorted({total, 2 * total}),
                ref_batch=self.spec.ref_batch,
                adaptive=True,
            )
        # Sim-backend trace jobs train at the spec's fixed total batch: no
        # gradients exist, so the runtime optimizes the *split* (OptPerf
        # partition) and the allocation only.
        return CannikinController(
            n,
            batch_candidates=[self.spec.total_batch],
            ref_batch=self.spec.total_batch,
            adaptive=False,
        )

    def _policy_controller(self, n: int, name: str) -> CannikinController:
        """Build the controller for an explicit ``JobSpec.batch_policy``.

        GNS-driven policies need gradient telemetry, so on a gradient-free
        backend they collapse to the fixed-batch controller (b_noise would
        sit at inf and every proposal would degenerate to the reference
        batch anyway — this is the runtime-level mirror of the launch-layer
        guard).  Schedule-driven policies (empty ``requires``) run
        adaptively on *any* backend — the point of the damper family."""
        total = self.spec.total_batch
        needs_gns = "gns" in policy_requirements(name)
        if name == "fixed" or (needs_gns and self.spec.backend != "real"):
            return CannikinController(
                n,
                batch_candidates=[total],
                ref_batch=total,
                adaptive=False,
            )
        if needs_gns:
            return CannikinController(
                n,
                batch_candidates=sorted({total, 2 * total}),
                ref_batch=self.spec.ref_batch,
                adaptive=True,
                batch_policy=name,
            )
        # Gradient-free damper: candidates span the schedule's range so the
        # controller's bounds let the ramp actually move.
        return CannikinController(
            n,
            batch_candidates=sorted({self.spec.ref_batch, total, 2 * total}),
            ref_batch=self.spec.ref_batch,
            adaptive=True,
            batch_policy=name,
        )

    def set_nodes(self, nodes: Sequence[int], *, now: float = 0.0) -> None:
        """Apply a new node assignment, resizing the controller elastically.

        Node ids kept across the change keep their fitted models
        (``remove_nodes`` semantics); new ids bootstrap for two epochs
        (``add_nodes``).  Controller index ``i`` always corresponds to
        ``self._ctl_nodes[i]``; the per-job simulator follows that order.
        """
        nodes = tuple(int(n) for n in nodes)
        if nodes == self.nodes:
            return
        self.reallocations += 1
        self.nodes = nodes
        if not nodes:
            if self.state == JobState.RUNNING:
                self.state = JobState.PENDING
            return
        new_set = set(nodes)
        if self.controller is None:
            self.controller = self._new_controller(len(nodes))
            self._ctl_nodes = nodes
        else:
            old = self._ctl_nodes
            dropped_idx = [i for i, nid in enumerate(old) if nid not in new_set]
            if old and len(dropped_idx) == len(old):
                # Total replacement: nothing learned carries over.
                self.controller = self._new_controller(len(nodes))
                self._ctl_nodes = nodes
            else:
                if dropped_idx:
                    self.controller.remove_nodes(dropped_idx)
                kept = tuple(nid for nid in old if nid in new_set)
                added = tuple(nid for nid in nodes if nid not in set(old))
                if added:
                    self.controller.add_nodes(len(added))
                self._ctl_nodes = kept + added
        self._bind_backend()
        if self._resume_pending:
            self._restore_backend()
            self._resume_pending = False
        if self.state in (JobState.PENDING, JobState.PREEMPTED):
            self.state = JobState.RUNNING
            if self.started_at is None:
                self.started_at = now

    def _bind_backend(self) -> None:
        """(Build and) bind the spec's execution backend to the currently
        held nodes.  The backend object itself persists across node churn
        and preemption — only its timing cluster follows the node set — so
        learned statistical state (params, opt-state, GNS) survives.  A
        re-arrival whose spec names a *different* backend kind gets a fresh
        engine (its statistical state necessarily starts over)."""
        if self.backend is None or self.backend.kind != self.spec.backend:
            self.backend = make_backend(
                self.spec.backend,
                noise=self._noise,
                seed=self._seed,
                real_config=self._real_config,
                injector=self._injector,
            )
        self.backend.configure(
            self.spec, self._ctl_nodes, seed=self._seed + self.reallocations
        )

    def _checkpoint_manager(self):
        """The job's :class:`~repro_torch.train.checkpoint.CheckpointManager`
        (generation files ``<dir>/<job>.genNNNNNN.ckpt.npz``); None when the
        runtime has no checkpoint directory."""
        if self._ckpt_dir is None:
            return None
        if self._ckpt_manager is None:
            from repro_torch.train.checkpoint import CheckpointManager

            self._ckpt_manager = CheckpointManager(self._ckpt_dir, self.name)
        return self._ckpt_manager

    def _policy_state(self) -> dict:
        """The controller's batch-policy checkpoint payload ({} when there
        is no controller or the policy is stateless — e.g. the fixed policy
        of legacy sim jobs, whose snapshots must stay byte-identical)."""
        if self.controller is None:
            return {}
        return dict(self.controller.policy.state())

    def _snapshot_template(self) -> dict:
        """The restore template: the backend's snapshot shape, plus the
        batch-policy subtree exactly when the live policy would write one —
        so template and written-checkpoint structure always agree."""
        template = dict(self.backend.snapshot())
        pol = self._policy_state()
        if pol:
            template["batch_policy"] = pol
        return template

    def _load_state(self, state: dict) -> None:
        """Split a restored snapshot between its owners: the batch-policy
        subtree goes to the controller's policy, everything else to the
        execution backend."""
        state = dict(state)
        pol = state.pop("batch_policy", None)
        if pol is not None and self.controller is not None:
            self.controller.policy.load_state(pol)
        self.backend.load_snapshot(state)

    def _restore_backend(self) -> None:
        """Restore the preemption checkpoint into the backend (and the
        batch policy, whose adaptation state rides the same snapshot): from
        the newest *valid* checkpoint generation when any were written (the
        file is the source of truth — in a real cluster the preempted
        process died; a corrupt head generation rolls back to the newest
        one whose sha256 verifies, counted in ``ckpt_rollbacks``), else
        from the in-memory snapshot."""
        if self.backend is None:
            return
        manager = self._checkpoint_manager()
        if (
            manager is not None
            and self.checkpoint_path is not None
            and manager.generations()
        ):
            from repro_torch.train.checkpoint import CheckpointCorruptError

            before = manager.rollbacks
            try:
                state, _gen, path = manager.restore(self._snapshot_template())
            except CheckpointCorruptError:
                # Every generation corrupt: fall back to the in-memory
                # snapshot (the in-process resume path) if there is one.
                self.ckpt_rollbacks += manager.rollbacks - before
                if self._snapshot is not None:
                    self._load_state(self._snapshot)
                    self.ckpt_fallbacks += 1
                    self.restores += 1
                return
            self.ckpt_rollbacks += manager.rollbacks - before
            self.checkpoint_path = path
            self._load_state(state)
            self.restores += 1
        elif self.checkpoint_path is not None and os.path.exists(self.checkpoint_path):
            from repro_torch.train import checkpoint as ckpt

            self._load_state(
                ckpt.restore(self.checkpoint_path, self._snapshot_template())
            )
            self.restores += 1
        elif self._snapshot is not None:
            self._load_state(self._snapshot)
            self.restores += 1

    def apply_refit(self, spec: JobSpec) -> None:
        """Swap in a refreshed spec (ModelRefit): the ground truth drifts;
        the controller keeps its fitters and re-learns from the next
        epoch's measurements — the per-epoch OLS loop of §4.5."""
        if spec.name != self.name:
            raise ValueError(f"refit spec {spec.name!r} does not match {self.name!r}")
        self.spec = spec
        if self.nodes:
            self._bind_backend()

    def preempt(self) -> None:
        # Snapshot only on the RUNNING->PREEMPTED edge: a duplicate
        # Preemption event must not re-serialize post-preemption live state
        # over the only good checkpoint (the file models a process that
        # already died).  The preemptions counter still counts every event,
        # matching the reconcile loop's idempotent-event semantics.
        if self.backend is not None and self.state != JobState.PREEMPTED:
            snap = dict(self.backend.snapshot())
            pol = self._policy_state()
            if pol:
                # Batch-policy adaptation state (damper counters, loss
                # anchors, tracked b_noise) rides the same checkpoint as the
                # backend's statistical state; stateless policies add
                # nothing, keeping legacy snapshots byte-identical.
                snap["batch_policy"] = pol
            if snap:
                self._snapshot = snap
                manager = self._checkpoint_manager()
                if manager is not None:
                    io = self._injector.checkpoint_io if self._injector else None
                    # Flaky checkpoint I/O gets bounded retries (a failed
                    # attempt leaves no file, so the generation counter
                    # does not advance); if all attempts fail, resume falls
                    # back to the in-memory snapshot (checkpoint_path stays
                    # unset so restore never reads a file this preemption
                    # failed to write).
                    for _attempt in range(3):
                        try:
                            path = manager.save(snap, io=io)
                            self.checkpoint_path = path
                            if self._injector is not None:
                                # Disk-corruption fault seam: flips bytes in
                                # the just-written generation *after* the
                                # atomic rename — exactly the failure the
                                # checksummed rollback must absorb.
                                self._injector.corrupt_checkpoint(path)
                            break
                        except OSError:
                            self.ckpt_write_failures += 1
                    else:
                        self.checkpoint_path = None
                        self.ckpt_fallbacks += 1
                self._resume_pending = True
        self.state = JobState.PREEMPTED
        self.preemptions += 1
        self.nodes = ()

    def finish(self, now: float) -> None:
        self.state = JobState.DONE
        self.finished_at = now
        self.nodes = ()
        self._snapshot = None
        self._resume_pending = False

    # -- epoch loop ------------------------------------------------------

    def advance(self, epochs: int = 1, *, steps: int = 4) -> List[EpochRecord]:
        """Run ``epochs`` plan → execute → observe cycles over the job's
        backend on the held nodes.  No-op unless RUNNING."""
        if self.state != JobState.RUNNING or self.backend is None:
            return []
        assert self.controller is not None
        out: List[EpochRecord] = []
        for _ in range(epochs):
            record, result = run_backend_epoch(self.controller, self.backend, steps=steps)
            self.last_result = result
            self.sim_time += record.epoch_seconds
            self.epochs_run += 1
            self.records.append(record)
            out.append(record)
        return out


@dataclasses.dataclass(frozen=True)
class ReconcileRecord:
    """One reconcile step: the event, what the policy decided, and the
    aggregate score — the trace log's unit entry."""

    time: float
    event: Event
    allocation: Allocation

    @property
    def aggregate_goodput(self) -> float:
        return self.allocation.aggregate_goodput

    @property
    def aggregate_fraction(self) -> float:
        return self.allocation.aggregate_fraction

    @property
    def label(self) -> str:
        return describe(self.event)


class ClusterRuntime:
    """The single front door: an event-driven cluster runtime.

    >>> rt = ClusterRuntime(8, policy="cannikin")
    >>> handle = rt.submit(spec)            # JobArrival at rt.clock
    >>> rt.run()                            # reconcile queued events
    >>> rt.advance(epochs=2)                # step running jobs' epoch loops
    >>> rt.allocation.aggregate_goodput

    ``policy`` is an allocation-policy name (``cannikin`` / ``static`` /
    ``fair-share``) or a :class:`Policy` instance; ``engine`` selects the
    stacked-solver engine for the Cannikin policy.  ``noise``/``seed``
    configure the per-job measurement simulators.  ``real_backend`` is the
    :class:`~repro_torch.runtime.backend.RealBackendConfig` recipe used for jobs
    whose spec names ``backend="real"``; ``checkpoint_dir`` enables on-disk
    preemption checkpoints (``<dir>/<job>.ckpt.npz``).  ``device`` is where
    a policy named here solves on the ``"jax"`` engine (the card when None).
    """

    def __init__(
        self,
        n_nodes: int,
        *,
        policy: Union[str, Policy] = "cannikin",
        engine: str = "batched",
        noise: float = 0.0,
        seed: int = 0,
        real_backend: Optional[RealBackendConfig] = None,
        checkpoint_dir: Optional[str] = None,
        faults: Optional[FaultPlan] = None,
        health: Union[None, bool, HealthConfig, HealthMonitor] = None,
        watchdog: Union[None, bool, "Watchdog"] = None,
        invariants: bool = False,
        device=None,
    ) -> None:
        self.n_nodes = n_nodes
        self.policy: Policy = (
            make_policy(policy, n_nodes, engine=engine, device=device)
            if isinstance(policy, str)
            else policy
        )
        self.handles: Dict[str, JobHandle] = {}
        self.clock = 0.0
        self.allocation = Allocation({}, {}, {})
        self.records: List[ReconcileRecord] = []
        self.down_nodes: set = set()
        self._noise = noise
        self._seed = seed
        self._real_backend = real_backend
        self._checkpoint_dir = checkpoint_dir
        self._queue: List[Tuple[float, int, Event]] = []
        self._seq = itertools.count()
        # -- fault tolerance: injection + detection + recovery --------------
        self.injector: Optional[FaultInjector] = (
            FaultInjector(faults) if faults is not None else None
        )
        if health is None:
            health = faults is not None  # faults imply the monitor
        if isinstance(health, HealthMonitor):
            self.health: Optional[HealthMonitor] = health
        elif isinstance(health, HealthConfig):
            self.health = HealthMonitor(health)
        elif health:
            self.health = HealthMonitor()
        else:
            self.health = None
        self.epoch_index = 0           # global epoch counter (fault clock)
        self.sim_clock = 0.0           # simulated wall-clock across epochs
        self.noop_events = 0           # idempotent NodeLeave/NodeJoin no-ops
        self.recovery_log: List[Dict[str, object]] = []
        self._epoch_sim: List[float] = []  # per-epoch sim seconds (MTTR accounting)
        # -- integrity hardening: watchdog + invariant checker --------------
        self.watchdog: Optional[Watchdog] = self._build_watchdog(watchdog)
        if self.watchdog is not None and hasattr(self.policy, "watchdog"):
            self.policy.watchdog = self.watchdog
        self.invariant_checker: Optional[RuntimeInvariantChecker] = (
            RuntimeInvariantChecker(self) if invariants else None
        )

    def _build_watchdog(self, watchdog) -> "Optional[Watchdog]":
        """Resolve the watchdog argument.  ``True`` (or None while the fault
        plan schedules solver stalls) builds one wired to the injector's
        stall seam, with a solve deadline of half the shortest injected
        stall — tight enough that every stall trips the deadline, loose
        enough that real solves never do."""
        if isinstance(watchdog, Watchdog):
            if watchdog.stall_hook is None and self.injector is not None:
                watchdog.stall_hook = self.injector.solver_stall
            return watchdog
        stalls = (
            self.injector.plan.solver_stalls if self.injector is not None else ()
        )
        if watchdog is None:
            watchdog = bool(stalls)
        if not watchdog:
            return None
        deadline = min((s.delay for s in stalls), default=None)
        return Watchdog(
            solve_deadline=deadline / 2.0 if deadline else None,
            stall_hook=self.injector.solver_stall if self.injector else None,
        )

    @property
    def invariant_violations(self) -> List[object]:
        return self.invariant_checker.violations if self.invariant_checker else []

    def _check_invariants(self, event: Event) -> None:
        if self.invariant_checker is not None:
            self.invariant_checker.check(describe(event))

    # -- event intake ----------------------------------------------------

    def post(self, event: Event) -> None:
        """Enqueue an event; reconciled by :meth:`step`/:meth:`run` in
        ``(time, post-order)`` order."""
        heapq.heappush(self._queue, (event.time, next(self._seq), event))

    def _get_or_create_handle(self, spec: JobSpec, submitted_at: float) -> JobHandle:
        handle = self.handles.get(spec.name)
        if handle is None:
            handle = JobHandle(
                spec,
                submitted_at=submitted_at,
                noise=self._noise,
                seed=self._seed + len(self.handles),
                real_config=self._real_backend,
                checkpoint_dir=self._checkpoint_dir,
                injector=self.injector,
            )
            self.handles[spec.name] = handle
        return handle

    def submit(self, spec: JobSpec, *, at: Optional[float] = None) -> JobHandle:
        """Create (or fetch) the job's handle and post its arrival."""
        when = self.clock if at is None else at
        handle = self._get_or_create_handle(spec, when)
        self.post(JobArrival(time=when, spec=spec))
        return handle

    def complete(self, name: str, *, at: Optional[float] = None) -> None:
        self.post(JobCompletion(time=self.clock if at is None else at, job=name))

    def preempt(self, name: str, *, at: Optional[float] = None) -> None:
        self.post(Preemption(time=self.clock if at is None else at, job=name))

    def refit(
        self, name: str, *, rel: float = 0.1, seed: int = 0, at: Optional[float] = None
    ) -> None:
        self.post(
            ModelRefit(time=self.clock if at is None else at, job=name, rel=rel, seed=seed)
        )

    def node_leave(self, nodes: Sequence[int], *, at: Optional[float] = None) -> None:
        self.post(NodeLeave(time=self.clock if at is None else at, nodes=tuple(nodes)))

    def node_join(self, nodes: Sequence[int], *, at: Optional[float] = None) -> None:
        self.post(NodeJoin(time=self.clock if at is None else at, nodes=tuple(nodes)))

    @property
    def pending_events(self) -> int:
        return len(self._queue)

    # -- reconcile loop --------------------------------------------------

    def step(self) -> Optional[ReconcileRecord]:
        """Reconcile the earliest queued event; returns its record (None if
        the queue is empty)."""
        if not self._queue:
            return None
        t, _, event = heapq.heappop(self._queue)
        self.clock = max(self.clock, t)
        self.allocation = self._apply(event)
        self._apply_allocation(self.allocation)
        record = ReconcileRecord(time=self.clock, event=event, allocation=self.allocation)
        self.records.append(record)
        self._check_invariants(event)
        return record

    def run(self) -> List[ReconcileRecord]:
        """Drain the event queue; returns the records appended."""
        start = len(self.records)
        while self._queue:
            self.step()
        return self.records[start:]

    def advance(self, epochs: int = 1, *, steps: int = 4) -> None:
        """Step every RUNNING job's epoch loop ``epochs`` times.

        With no fault injector and no health monitor each job advances
        its epochs in turn (bit-identical replays).  With either present, epochs
        advance in lockstep across jobs — the injector's fault clock and
        the monitor's detection windows are global epoch indices — and
        each epoch ends with detection + self-healing recovery.
        """
        if self.injector is None and self.health is None:
            for handle in self.handles.values():
                handle.advance(epochs, steps=steps)
            return
        for _ in range(epochs):
            self._advance_epoch(steps=steps)

    def _advance_epoch(self, *, steps: int) -> None:
        """One global epoch: inject → execute every running job → observe
        health → reconcile recovery actions as synthesized events."""
        e = self.epoch_index
        if self.injector is not None:
            self.injector.begin_epoch(e)
        epoch_sim = 0.0
        ran: List[JobHandle] = []
        for handle in list(self.handles.values()):
            if self.watchdog is not None:
                # Soft deadline: a slow epoch is counted, never discarded.
                recs = self.watchdog.guard_execute(
                    lambda h=handle: h.advance(1, steps=steps)
                )
            else:
                recs = handle.advance(1, steps=steps)
            if recs:
                ran.append(handle)
                epoch_sim = max(epoch_sim, recs[-1].epoch_seconds)
        self.sim_clock += epoch_sim
        self._epoch_sim.append(epoch_sim)
        if self.health is not None:
            for handle in ran:
                self._observe_health(handle, e)
            self.health.tick(e)
            self._apply_health_actions()
        self.epoch_index += 1

    def _observe_health(self, handle: JobHandle, epoch: int) -> None:
        """Feed one job's epoch telemetry to the monitor: per held node,
        observed mean compute time (a-part + backprop over the epoch's
        steps; ``None`` for a node that reported nothing) against the
        :class:`~repro_torch.core.perf_model.NodePerfModel` prediction for the
        same local batch.

        The reference is the job spec's own coefficients — the exact model
        the scheduler scores goodput with — not the controller's learned
        fit: a freshly-reallocated controller's fit is biased while new
        nodes bootstrap, and detection against it flaps.  The premise of
        the whole system is that these coefficients faithfully describe
        healthy hardware (Eqs. 2–6); a fault is precisely a sustained
        deviation from them, and a ModelRefit updates the reference."""
        assert self.health is not None
        result = handle.last_result
        if result is None or not result.measurements:
            return
        node_ids = handle._ctl_nodes
        observed: List[Optional[float]] = []
        predicted: List[float] = []
        for i, nid in enumerate(node_ids):
            obs = [
                m.observations[i]
                for m in result.measurements
                if i < len(m.observations) and m.observations[i] is not None
            ]
            if not obs:
                observed.append(None)
                predicted.append(0.0)
                continue
            observed.append(
                sum(o.a_time + o.backprop_time for o in obs) / len(obs)
            )
            b = obs[0].batch_size
            nd = handle.spec.node_models[nid]
            predicted.append(max((nd.q + nd.k) * b + (nd.s + nd.m), 1e-9))
        self.health.observe_job(handle.name, epoch, node_ids, observed, predicted)
        # Numerical-health channel: per-node anomalous-gradient step counts
        # from the real backend's guard (empty for unguarded backends).  A
        # zero count is an explicit healthy signal (it resets the streak),
        # so the whole vector is fed, not just the breaches.
        anomalies = getattr(result, "grad_anomalies", ()) or ()
        if len(anomalies) == len(node_ids):
            self.health.observe_numerics(handle.name, epoch, node_ids, anomalies)

    def _reconcile_now(self, event: Event) -> ReconcileRecord:
        """Apply a synthesized (detection-driven) event immediately.  The
        shared heapq holds *future* trace events — draining it here would
        fast-forward the trace, so recovery bypasses the queue."""
        self.allocation = self._apply(event)
        self._apply_allocation(self.allocation)
        record = ReconcileRecord(
            time=self.clock, event=event, allocation=self.allocation
        )
        self.records.append(record)
        self._check_invariants(event)
        return record

    def _log_recovery(self, action: str, node: Optional[int], jobs, epoch: int) -> None:
        self.recovery_log.append(
            {
                "action": action,
                "node": node,
                "jobs": tuple(jobs),
                "epoch": epoch,
                "sim_time": self.sim_clock,
            }
        )

    def _apply_health_actions(self) -> None:
        """Self-healing: map drained monitor actions onto the existing
        event alphabet.  Crash → drain victims through the Preemption
        checkpoint path, mask the node, resubmit; quarantine/re-admission
        → the NodeLeave/NodeJoin availability masking (warm caches
        survive); sustained drift → a forced ModelRefit."""
        assert self.health is not None
        for action in self.health.poll():
            if isinstance(action, CrashDetected):
                victims = [
                    h.name
                    for h in self.handles.values()
                    if h.state == JobState.RUNNING and action.node in h.nodes
                ]
                for name in victims:
                    self._reconcile_now(Preemption(time=self.clock, job=name))
                self._reconcile_now(
                    NodeLeave(time=self.clock, nodes=(action.node,))
                )
                for name in victims:
                    self._reconcile_now(
                        JobArrival(time=self.clock, spec=self.handles[name].spec)
                    )
                self._log_recovery("crash_recover", action.node, victims, action.epoch)
            elif isinstance(action, QuarantineNode):
                self._reconcile_now(
                    NodeLeave(time=self.clock, nodes=(action.node,))
                )
                self._log_recovery("quarantine", action.node, (action.job,), action.epoch)
            elif isinstance(action, ReadmitNode):
                self._reconcile_now(
                    NodeJoin(time=self.clock, nodes=(action.node,))
                )
                self._log_recovery("readmit", action.node, (), action.epoch)
            elif isinstance(action, RefitRequested):
                handle = self.handles.get(action.job)
                if handle is not None and self._scheduled(handle):
                    self._reconcile_now(
                        ModelRefit(
                            time=self.clock, job=action.job, spec=handle.spec
                        )
                    )
                    self._log_recovery("refit", None, (action.job,), action.epoch)

    # -- event dispatch --------------------------------------------------

    def _handle(self, name: str) -> JobHandle:
        try:
            return self.handles[name]
        except KeyError:
            raise KeyError(f"unknown job {name!r}") from None

    @staticmethod
    def _scheduled(handle: JobHandle) -> bool:
        """Whether the handle's job is currently known to the allocation
        policy (arrival adds it; preemption/completion remove it)."""
        return handle.state in (JobState.PENDING, JobState.RUNNING)

    def _apply(self, event: Event) -> Allocation:
        if isinstance(event, JobArrival):
            spec = event.spec
            handle = self._get_or_create_handle(spec, self.clock)
            if handle.state == JobState.DONE:
                raise ValueError(f"job {spec.name!r} already completed")
            if handle.state == JobState.PREEMPTED:
                handle.state = JobState.PENDING  # resume
            handle.spec = spec
            return self.policy.add_job(spec)
        if isinstance(event, JobCompletion):
            handle = self._handle(event.job)
            # A preempted job holds no nodes and is unknown to the policy:
            # completing (cancelling) it only closes the handle.
            alloc = (
                self.policy.remove_job(event.job)
                if self._scheduled(handle)
                else self.allocation
            )
            handle.finish(self.clock)
            return alloc
        if isinstance(event, Preemption):
            handle = self._handle(event.job)
            alloc = (
                self.policy.remove_job(event.job)
                if self._scheduled(handle)
                else self.allocation  # idempotent: already off the cluster
            )
            handle.preempt()
            return alloc
        if isinstance(event, NodeLeave):
            # Idempotency guard: a duplicate leave for an already-down node
            # or a leave naming an unknown node must be a counted no-op —
            # the policy's availability mask only ever sees fresh, known
            # ids, so it can never be corrupted by event replay.
            fresh = tuple(
                int(n)
                for n in event.nodes
                if 0 <= int(n) < self.n_nodes and int(n) not in self.down_nodes
            )
            if len(fresh) < len(event.nodes):
                self.noop_events += 1
            if not fresh:
                return self.allocation
            self.down_nodes |= set(fresh)
            return self.policy.node_leave(fresh)
        if isinstance(event, NodeJoin):
            fresh = tuple(
                int(n)
                for n in event.nodes
                if 0 <= int(n) < self.n_nodes and int(n) in self.down_nodes
            )
            if len(fresh) < len(event.nodes):
                self.noop_events += 1
            if not fresh:
                return self.allocation
            self.down_nodes -= set(fresh)
            return self.policy.node_join(fresh)
        if isinstance(event, ModelRefit):
            handle = self._handle(event.job)
            new_spec = event.spec or drift_spec(handle.spec, event.rel, event.seed)
            # Policy first: if it rejects (e.g. unknown job), the handle
            # must not be left half-mutated.  A preempted job refits its
            # handle only — the refreshed spec takes effect on resume.
            alloc = (
                self.policy.update_job(new_spec)
                if self._scheduled(handle)
                else self.allocation
            )
            handle.apply_refit(new_spec)
            return alloc
        raise TypeError(f"unknown event type {type(event).__name__}")

    def _apply_allocation(self, alloc: Allocation) -> None:
        for name, handle in self.handles.items():
            if handle.state in (JobState.PENDING, JobState.RUNNING):
                handle.set_nodes(alloc.assignment.get(name, ()), now=self.clock)

    # -- observability ---------------------------------------------------

    def jobs(self, *states: str) -> List[JobHandle]:
        """Handles, optionally filtered by state(s)."""
        if not states:
            return list(self.handles.values())
        return [h for h in self.handles.values() if h.state in states]

    def counters(self) -> Dict[str, int]:
        """The allocation policy's solve/reuse counters ({} for policies
        without them)."""
        fn = getattr(self.policy, "counters", None)
        return fn() if callable(fn) else {}

    def fault_telemetry(self) -> Optional[Dict[str, object]]:
        """Fault-tolerance telemetry for the trace report: what was
        injected, what detection caught (and how fast), and what recovery
        did about it.  ``None`` when the runtime has neither an injector
        nor a monitor (so golden-path summaries are unchanged)."""
        if self.injector is None and self.health is None:
            return None
        detections = self.health.detections if self.health is not None else []
        crash_lat: List[int] = []
        quar_lat: List[int] = []
        mttr_ep: List[int] = []
        mttr_sim: List[float] = []
        if self.injector is not None:
            for c in self.injector.plan.crashes:
                det = next(
                    (
                        d
                        for d in detections
                        if d["kind"] == "crash" and d["node"] == c.node
                    ),
                    None,
                )
                if det is None:
                    continue
                crash_lat.append(int(det["epoch"]) - c.at_epoch)
                rec = next(
                    (
                        r
                        for r in self.recovery_log
                        if r["action"] == "crash_recover" and r["node"] == c.node
                    ),
                    None,
                )
                if rec is not None:
                    e0, e1 = c.at_epoch, int(rec["epoch"])
                    mttr_ep.append(e1 - e0)
                    mttr_sim.append(sum(self._epoch_sim[e0 : e1 + 1]))
            for s in self.injector.plan.stragglers:
                det = next(
                    (
                        d
                        for d in detections
                        if d["kind"] == "quarantine"
                        and d["node"] == s.node
                        and int(d["epoch"]) >= s.at_epoch
                    ),
                    None,
                )
                if det is not None:
                    quar_lat.append(int(det["epoch"]) - s.at_epoch)
            for p in self.injector.plan.poisons:
                det = next(
                    (
                        d
                        for d in detections
                        if d["kind"] == "numeric"
                        and d["node"] == p.node
                        and int(d["epoch"]) >= p.at_epoch
                    ),
                    None,
                )
                if det is not None:
                    quar_lat.append(int(det["epoch"]) - p.at_epoch)
        det_lat = crash_lat + quar_lat

        def _mean(xs):
            return (sum(xs) / len(xs)) if xs else None

        out: Dict[str, object] = {
            "injected": dict(self.injector.counts()) if self.injector else {},
            "detected": {
                kind: sum(1 for d in detections if d["kind"] == kind)
                for kind in ("crash", "quarantine", "drift", "numeric")
            },
            "recoveries": {
                act: sum(1 for r in self.recovery_log if r["action"] == act)
                for act in ("crash_recover", "quarantine", "readmit", "refit")
            },
            "noop_events": self.noop_events,
            "checkpoint_write_failures": sum(
                h.ckpt_write_failures for h in self.handles.values()
            ),
            "checkpoint_fallbacks": sum(
                h.ckpt_fallbacks for h in self.handles.values()
            ),
            "checkpoint_rollbacks": sum(
                h.ckpt_rollbacks for h in self.handles.values()
            ),
            "restores": sum(h.restores for h in self.handles.values()),
            "detection_latency_epochs": _mean(det_lat),
            "mttr_epochs": _mean(mttr_ep),
            "mttr_sim_seconds": _mean(mttr_sim),
            "epochs": self.epoch_index,
            "sim_time": self.sim_clock,
        }
        if self.watchdog is not None:
            out["watchdog"] = self.watchdog.counters()
        if self.invariant_checker is not None:
            out["invariants"] = {
                "checks": self.invariant_checker.checks_run,
                "violations": len(self.invariant_checker.violations),
            }
        return out
