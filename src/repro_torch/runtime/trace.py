"""Trace building + replay: synthetic multi-job workloads over the runtime.

A :class:`Trace` is an ordered bag of events (built fluently or passed
in), replayable through a fresh :class:`ClusterRuntime` per policy — the
Pollux/Sia-style cluster simulation: job arrivals and departures, node
churn, model refits, preemptions, with simulated training epochs between
events.  :func:`compare_policies` replays one trace under every
allocation policy and returns comparable :class:`TraceReport`s.

The counterpart of ``repro/runtime/trace.py``, copied verbatim but for
the ``device`` that :func:`replay` and :func:`compare_policies` hand each
runtime (where the Cannikin policy's ``"jax"`` engine solves).
"""
from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.batch_policy import BATCH_POLICIES
from repro_torch.core.goodput import statistical_efficiency
from repro_torch.core.scheduler import JobSpec, random_jobs
from repro_torch.runtime.backend import RealBackendConfig
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
from repro_torch.runtime.runtime import ClusterRuntime, ReconcileRecord

__all__ = [
    "Trace",
    "TraceReport",
    "replay",
    "compare_policies",
    "synthetic_trace",
    "format_summary",
    "rank_batch_policies",
    "format_batch_policy_summary",
]


class Trace:
    """Fluent builder over the event alphabet.

    >>> trace = (Trace()
    ...          .arrive(spec_a, at=0.0)
    ...          .arrive(spec_b, at=1.0)
    ...          .complete("a", at=3.0)
    ...          .node_leave([7], at=4.0))

    Events are immutable and the builder holds no runtime state, so one
    trace replays under any number of runtimes/policies.
    """

    def __init__(self, events: Sequence[Event] = ()) -> None:
        self.events: List[Event] = list(events)

    def post(self, event: Event) -> "Trace":
        self.events.append(event)
        return self

    def arrive(self, spec: JobSpec, at: float = 0.0) -> "Trace":
        return self.post(JobArrival(time=at, spec=spec))

    def complete(self, job: str, at: float) -> "Trace":
        return self.post(JobCompletion(time=at, job=job))

    def preempt(self, job: str, at: float) -> "Trace":
        return self.post(Preemption(time=at, job=job))

    def refit(self, job: str, at: float, *, rel: float = 0.1, seed: int = 0) -> "Trace":
        return self.post(ModelRefit(time=at, job=job, rel=rel, seed=seed))

    def node_leave(self, nodes: Sequence[int], at: float) -> "Trace":
        return self.post(NodeLeave(time=at, nodes=tuple(nodes)))

    def node_join(self, nodes: Sequence[int], at: float) -> "Trace":
        return self.post(NodeJoin(time=at, nodes=tuple(nodes)))

    def __len__(self) -> int:
        return len(self.events)

    def __iter__(self):
        return iter(self.events)


@dataclasses.dataclass
class TraceReport:
    """What one policy did with one trace — the comparable unit.

    ``baseline`` (set only by fault-injecting replays) is the fault-free
    twin of the same trace, enabling :attr:`goodput_retention` — the
    cost of the faults plus recovery in retained training throughput.

    ``batch_policy`` (set by batch-policy-stamped replays) names the
    :mod:`repro_torch.core.batch_policy` law every job ran under; it unlocks the
    cross-policy metrics — :attr:`sample_throughput`,
    :attr:`statistical_efficiency` and their product
    :attr:`policy_goodput` — that :func:`rank_batch_policies` sorts on.
    """

    policy: str
    records: List[ReconcileRecord]
    runtime: ClusterRuntime
    baseline: Optional["TraceReport"] = None
    batch_policy: Optional[str] = None

    @property
    def aggregate_goodput(self) -> float:
        return self.runtime.allocation.aggregate_goodput

    @property
    def aggregate_fraction(self) -> float:
        return self.runtime.allocation.aggregate_fraction

    @property
    def job_states(self) -> Dict[str, str]:
        return {name: h.state for name, h in self.runtime.handles.items()}

    @property
    def epochs(self) -> Dict[str, int]:
        return {name: h.epochs_run for name, h in self.runtime.handles.items()}

    @property
    def total_sim_time(self) -> float:
        """Simulated seconds of training across all jobs."""
        return sum(h.sim_time for h in self.runtime.handles.values())

    # -- batch-policy comparison metrics --------------------------------

    def _epoch_records(self):
        for handle in self.runtime.handles.values():
            for rec in handle.records:
                yield handle, rec

    @property
    def mean_total_batch(self) -> float:
        """Mean planned total batch over every executed epoch — shows
        whether (and how far) an adaptive policy actually moved the batch."""
        totals = [rec.total_batch for _, rec in self._epoch_records()]
        return float(np.mean(totals)) if totals else 0.0

    @property
    def sample_throughput(self) -> float:
        """Training samples processed per simulated second, across jobs:
        Σ (total_batch × steps_in_epoch) / total sim time."""
        samples = 0.0
        for _, rec in self._epoch_records():
            if rec.measured_batch_time > 0:
                steps = round(rec.epoch_seconds / rec.measured_batch_time)
                samples += rec.total_batch * steps
        sim_time = self.total_sim_time
        return float(samples / sim_time) if sim_time > 0 else 0.0

    @property
    def statistical_efficiency(self) -> float:
        """Mean per-epoch statistical efficiency E(B) (Pollux/§2 — how much
        of each sample's gradient signal the batch size preserves), using
        the epoch's measured gradient-noise scale when the backend tracked
        one and the spec's prior ``b_noise`` otherwise (sim traces), so the
        metric ranks policies on both backends."""
        effs = []
        for handle, rec in self._epoch_records():
            b_noise = rec.b_noise if math.isfinite(rec.b_noise) else handle.spec.b_noise
            effs.append(
                float(
                    statistical_efficiency(
                        b_noise, rec.total_batch, handle.spec.ref_batch
                    )
                )
            )
        return float(np.mean(effs)) if effs else 0.0

    @property
    def policy_goodput(self) -> float:
        """The paper's goodput decomposition applied to the whole replay:
        sample throughput × statistical efficiency — the scalar
        :func:`rank_batch_policies` orders policies by."""
        return self.sample_throughput * self.statistical_efficiency

    @property
    def goodput_retention(self) -> Optional[float]:
        """Fault-free sim-time over faulted sim-time for the same trace:
        1.0 means the faults cost nothing; 0.5 means epochs took twice as
        long end-to-end (stalls + slowdowns + recovery overhead).

        NaN-safe by construction: a degenerate twin (zero sim-time on
        either side — e.g. a trace whose jobs never advanced an epoch)
        yields a defined value with a warning instead of 0/0 = NaN
        poisoning downstream sweep aggregation."""
        if self.baseline is None:
            return None
        faulted = self.total_sim_time
        fault_free = self.baseline.total_sim_time
        if faulted <= 0.0:
            if fault_free <= 0.0:
                warnings.warn(
                    "goodput_retention: both faulted and fault-free replays "
                    "accumulated zero sim-time (no epochs advanced?); "
                    "reporting 1.0 instead of 0/0",
                    RuntimeWarning,
                    stacklevel=2,
                )
                return 1.0
            warnings.warn(
                "goodput_retention: faulted replay accumulated zero sim-time "
                "while the fault-free twin trained; reporting 0.0",
                RuntimeWarning,
                stacklevel=2,
            )
            return 0.0
        if fault_free <= 0.0:
            warnings.warn(
                "goodput_retention: fault-free twin accumulated zero sim-time "
                "while the faulted replay trained; reporting 0.0",
                RuntimeWarning,
                stacklevel=2,
            )
            return 0.0
        return fault_free / faulted

    def summary(self) -> Dict[str, object]:
        """JSON-able one-policy summary (assignment, scores, counters).
        Grows a ``faults`` block only for fault-tolerant runtimes, so
        golden-path summaries are byte-identical to earlier releases."""
        out: Dict[str, object] = {
            "policy": self.policy,
            "events": [describe(r.event) for r in self.records],
            "aggregate_goodput": self.aggregate_goodput,
            "aggregate_fraction": self.aggregate_fraction,
            "assignment": {
                k: list(v) for k, v in self.runtime.allocation.assignment.items()
            },
            "job_states": self.job_states,
            "epochs": self.epochs,
            "counters": self.runtime.counters(),
        }
        telemetry = self.runtime.fault_telemetry()
        if telemetry is not None:
            telemetry = dict(telemetry)
            telemetry["goodput_retention"] = self.goodput_retention
            telemetry["total_sim_time"] = self.total_sim_time
            telemetry["recovery_log"] = [dict(r) for r in self.runtime.recovery_log]
            out["faults"] = telemetry
        if self.batch_policy is not None:
            # Batch-policy metrics appear only on stamped replays, so
            # golden-path summaries stay byte-identical to earlier releases.
            out["batch_policy"] = self.batch_policy
            out["sample_throughput"] = self.sample_throughput
            out["statistical_efficiency"] = self.statistical_efficiency
            out["policy_goodput"] = self.policy_goodput
            out["mean_total_batch"] = self.mean_total_batch
        return out


def _stamp_batch_policy(trace: Trace, name: str) -> Trace:
    """A copy of ``trace`` whose every arriving job runs under the named
    batch policy (the same stamping idiom :func:`synthetic_trace` uses for
    backends — events are immutable, so the original trace is untouched)."""
    events: List[Event] = []
    for event in trace:
        spec = getattr(event, "spec", None)
        if spec is not None:
            event = dataclasses.replace(
                event, spec=dataclasses.replace(spec, batch_policy=name)
            )
        events.append(event)
    return Trace(events)


def replay(
    trace: Trace,
    n_nodes: int,
    *,
    policy: str = "cannikin",
    engine: str = "batched",
    epochs_per_event: int = 0,
    steps: int = 4,
    noise: float = 0.0,
    seed: int = 0,
    real_backend: Optional[RealBackendConfig] = None,
    checkpoint_dir: Optional[str] = None,
    faults=None,
    health=None,
    invariants: bool = False,
    batch_policy: Optional[str] = None,
    device=None,
) -> TraceReport:
    """Replay ``trace`` through a fresh :class:`ClusterRuntime`.

    Events reconcile in time order; with ``epochs_per_event > 0`` every
    running job additionally advances that many training epochs after each
    event (plan → execute → observe over each job's execution backend — so
    controllers learn, bootstrap, and reach the optperf phase mid-trace).
    ``real_backend``/``checkpoint_dir`` plumb through to the runtime for
    traces whose specs name ``backend="real"``.

    ``faults`` (a :class:`~repro_torch.runtime.faults.FaultPlan`) injects the
    plan's schedule into the replay; the report then carries a fault-free
    twin of the same replay as ``report.baseline`` so goodput retention is
    measurable.  ``health`` enables/configures the
    :class:`~repro_torch.runtime.health.HealthMonitor` (on by default whenever
    faults are injected).  ``invariants`` enables the debug-mode
    :class:`~repro_torch.runtime.invariants.RuntimeInvariantChecker` after every
    reconciled event (chaos CI runs with it on).

    ``batch_policy`` stamps a :mod:`repro_torch.core.batch_policy` law onto every
    arriving job (and the fault-free twin) before replaying, and marks the
    report so its cross-policy metrics activate.  ``device`` is where the
    ``"jax"`` engine solves (the card when None)."""
    if batch_policy is not None:
        trace = _stamp_batch_policy(trace, batch_policy)
    if faults is not None:
        baseline = replay(
            trace, n_nodes, policy=policy, engine=engine,
            epochs_per_event=epochs_per_event, steps=steps, noise=noise,
            seed=seed, real_backend=real_backend, checkpoint_dir=None,
            batch_policy=batch_policy, device=device,
        )
    else:
        baseline = None
    rt = ClusterRuntime(
        n_nodes, policy=policy, engine=engine, noise=noise, seed=seed,
        real_backend=real_backend, checkpoint_dir=checkpoint_dir,
        faults=faults, health=health, invariants=invariants, device=device,
    )
    for event in trace:
        rt.post(event)
    records: List[ReconcileRecord] = []
    while rt.pending_events:
        record = rt.step()
        assert record is not None
        if epochs_per_event:
            rt.advance(epochs_per_event, steps=steps)
        records.append(record)
    return TraceReport(
        policy=policy,
        records=records,
        runtime=rt,
        baseline=baseline,
        batch_policy=batch_policy,
    )


def compare_policies(
    trace: Trace,
    n_nodes: int,
    *,
    policies: Sequence[str] = ("cannikin", "static", "fair-share"),
    engine: str = "batched",
    epochs_per_event: int = 0,
    steps: int = 4,
    noise: float = 0.0,
    seed: int = 0,
    real_backend: Optional[RealBackendConfig] = None,
    checkpoint_dir: Optional[str] = None,
    faults=None,
    health=None,
    invariants: bool = False,
    batch_policies: Optional[Sequence[str]] = None,
    device=None,
) -> Dict[str, TraceReport]:
    """Replay one trace under several policies (fresh runtime each) and
    return the per-policy reports.

    Two comparison axes share this entry point:

    * default — one replay per *allocation* policy in ``policies``
      (baselines and Cannikin become comparable in one run);
    * ``batch_policies`` given — one replay per *batch-size* policy, all
      under the first allocation policy in ``policies``; the returned dict
      is keyed by batch-policy name and each report carries the
      cross-policy metrics (:func:`rank_batch_policies` consumes it).
      ``batch_policies=()`` means every registered policy.
    """
    if batch_policies is not None:
        names = tuple(batch_policies) or tuple(sorted(BATCH_POLICIES))
        return {
            name: replay(
                trace,
                n_nodes,
                policy=policies[0],
                engine=engine,
                epochs_per_event=epochs_per_event,
                steps=steps,
                noise=noise,
                seed=seed,
                real_backend=real_backend,
                checkpoint_dir=checkpoint_dir,
                faults=faults,
                health=health,
                invariants=invariants,
                batch_policy=name,
                device=device,
            )
            for name in names
        }
    return {
        name: replay(
            trace,
            n_nodes,
            policy=name,
            engine=engine,
            epochs_per_event=epochs_per_event,
            steps=steps,
            noise=noise,
            seed=seed,
            real_backend=real_backend,
            checkpoint_dir=checkpoint_dir,
            faults=faults,
            health=health,
            invariants=invariants,
            device=device,
        )
        for name in policies
    }


def synthetic_trace(
    n_jobs: int = 3,
    n_nodes: int = 12,
    seed: int = 0,
    *,
    arrival_spacing: float = 1.0,
    departure: bool = True,
    node_leave: bool = True,
    refit: bool = False,
    arrival: str = "fixed",
    size_dist: str = "fixed",
    size_sigma: float = 1.0,
    backend: Optional[str] = None,
    total_batch: Optional[int] = None,
) -> Tuple[Trace, List[JobSpec]]:
    """The canonical churn scenario over the seeded random job mix.

    Jobs arrive one after another; optionally the first job departs after
    the last arrival, one node fails after that, and the last job's model
    is refit at the end — i.e. the acceptance scenario (arrivals, one
    departure, one node leave) in one call.  Returns ``(trace, jobs)`` so
    callers can also drive the same jobs by hand.

    ``arrival`` selects the arrival process: ``"fixed"`` (the default —
    exactly ``arrival_spacing`` apart, unchanged from earlier releases) or
    ``"poisson"`` (exponential inter-arrival times with mean
    ``arrival_spacing``, i.e. a Poisson process of rate
    ``1/arrival_spacing``).  ``size_dist`` selects the job-size law:
    ``"fixed"`` keeps :func:`random_jobs`'s categorical total batches;
    ``"lognormal"`` multiplies each job's total batch by a heavy-tailed
    ``exp(N(0, size_sigma))`` draw (the log-normal job-size skew real
    cluster traces show), floored at the job's reference batch.  Both draws
    come from one RNG seeded by ``seed``, so traces stay reproducible.

    ``backend`` (``"sim"``/``"real"``) stamps every job's execution
    backend; ``total_batch`` overrides every job's total batch (useful to
    shrink real-backend traces to CPU-sized batches).
    """
    if arrival not in ("fixed", "poisson"):
        raise ValueError(f"unknown arrival process {arrival!r}")
    if size_dist not in ("fixed", "lognormal"):
        raise ValueError(f"unknown job-size distribution {size_dist!r}")
    jobs = random_jobs(n_jobs, n_nodes, seed)
    rng = np.random.default_rng(seed)
    stamped = []
    for job in jobs:
        changes: Dict[str, object] = {}
        if total_batch is not None:
            changes["total_batch"] = int(total_batch)
        elif size_dist == "lognormal":
            factor = float(rng.lognormal(mean=0.0, sigma=size_sigma))
            changes["total_batch"] = max(
                job.ref_batch, int(round(job.total_batch * factor))
            )
        if backend is not None:
            changes["backend"] = backend
        stamped.append(dataclasses.replace(job, **changes) if changes else job)
    jobs = stamped
    trace = Trace()
    t = 0.0

    def gap() -> float:
        if arrival == "poisson":
            return float(rng.exponential(arrival_spacing))
        return arrival_spacing

    for job in jobs:
        trace.arrive(job, at=t)
        t += gap()
    if departure and n_jobs > 1:
        trace.complete(jobs[0].name, at=t)
        t += gap()
    if node_leave and n_nodes > 1:
        trace.node_leave([n_nodes - 1], at=t)
        t += gap()
    if refit:
        trace.refit(jobs[-1].name, at=t, rel=0.2, seed=seed + 1)
    return trace, jobs


def rank_batch_policies(reports: Dict[str, TraceReport]) -> List[Dict[str, object]]:
    """Order :func:`compare_policies(..., batch_policies=...)` output by
    :attr:`TraceReport.policy_goodput` (descending) into one ranking —
    goodput *and* its throughput/efficiency decomposition per policy."""
    rows = []
    for name, rep in reports.items():
        rows.append(
            {
                "batch_policy": rep.batch_policy or name,
                "policy_goodput": rep.policy_goodput,
                "sample_throughput": rep.sample_throughput,
                "statistical_efficiency": rep.statistical_efficiency,
                "mean_total_batch": rep.mean_total_batch,
                "aggregate_goodput": rep.aggregate_goodput,
                "epochs": int(sum(rep.epochs.values())),
                "total_sim_time": rep.total_sim_time,
            }
        )
    rows.sort(key=lambda r: r["policy_goodput"], reverse=True)
    return rows


def format_batch_policy_summary(reports: Dict[str, TraceReport]) -> str:
    """Fixed-width ranking table over the batch-policy comparison axis."""
    lines = [
        f"{'batch policy':<14} {'goodput':>10} {'samples/s':>10} "
        f"{'stat eff':>9} {'mean B':>8} {'epochs':>7}"
    ]
    for row in rank_batch_policies(reports):
        lines.append(
            f"{row['batch_policy']:<14} {row['policy_goodput']:>10.1f} "
            f"{row['sample_throughput']:>10.1f} "
            f"{row['statistical_efficiency']:>9.3f} "
            f"{row['mean_total_batch']:>8.1f} {row['epochs']:>7}"
        )
    return "\n".join(lines)


def format_summary(reports: Dict[str, TraceReport]) -> str:
    """Fixed-width comparison table over :func:`compare_policies` output."""
    lines = [
        f"{'policy':<11} {'agg goodput':>12} {'agg fraction':>13} "
        f"{'jobs':>5}  states"
    ]
    for name, rep in reports.items():
        states = ",".join(
            f"{job}:{state}" for job, state in sorted(rep.job_states.items())
        )
        lines.append(
            f"{name:<11} {rep.aggregate_goodput:>12.1f} "
            f"{rep.aggregate_fraction:>13.3f} {len(rep.job_states):>5}  {states}"
        )
    return "\n".join(lines)
