"""Allocation policies for the ClusterRuntime, plus the partition-policy
factory shared by the launch CLI, examples, and benchmarks.

The counterpart of ``repro/runtime/policy.py``, copied verbatim but for
the ``device`` the Cannikin policy's ``"jax"`` engine solves on.

Two distinct policy kinds live here:

* **Allocation policies** (the :class:`Policy` protocol) decide *which
  nodes each job gets*.  They see every cluster event and return a full
  :class:`~repro_torch.core.scheduler.Allocation`, so all policies are
  comparable in one trace run:

  - ``cannikin``   — the paper-derived heterogeneity-aware greedy
    allocator, wrapped around the incremental
    :class:`~repro_torch.core.scheduler.Scheduler` so every event is an
    incremental re-allocation (cached rows + warm bracket seeds), never a
    cold solve.
  - ``static``     — contiguous equal-size node blocks in arrival order
    (the classic static-partition cluster baseline).
  - ``fair-share`` — nodes dealt round-robin across jobs in arrival
    order, so every job gets an even slice of every speed tier (the
    quota-style fair share of heterogeneous capacity).

  The baselines still *score* their assignments with each job's OptPerf
  goodput (via :meth:`JobSpec.goodput`), so aggregate goodput/fraction
  numbers are apples-to-apples across policies.

* **Partition policies** (:func:`make_partition_policy`) decide *how one
  job splits its batch across its nodes* — CannikinController vs the
  even/LB-BSP baselines of ``core/baselines.py``.  This is the factory
  ``launch/train.py`` and ``benchmarks/bench_adaptation.py`` share.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Protocol, Sequence, Set, Tuple, runtime_checkable

from repro_torch.core.scheduler import Allocation, JobSpec, Scheduler

__all__ = [
    "Policy",
    "CannikinPolicy",
    "StaticPolicy",
    "FairSharePolicy",
    "POLICIES",
    "make_policy",
    "make_partition_policy",
    "drive_partition_policy",
]


@runtime_checkable
class Policy(Protocol):
    """What the ClusterRuntime needs from an allocation policy.

    Every mutator returns the resulting :class:`Allocation` so the
    runtime's reconcile loop is one call per event.  Implementations must
    be deterministic: replaying the same event sequence must reproduce the
    same allocations.
    """

    name: str
    n_nodes: int

    def add_job(self, spec: JobSpec) -> Allocation: ...

    def remove_job(self, name: str) -> Allocation: ...

    def update_job(self, spec: JobSpec) -> Allocation: ...

    def node_leave(self, node_ids: Sequence[int]) -> Allocation: ...

    def node_join(self, node_ids: Sequence[int]) -> Allocation: ...

    def reallocate(self) -> Allocation: ...

    @property
    def jobs(self) -> Tuple[JobSpec, ...]: ...


class CannikinPolicy:
    """The heterogeneity-aware allocator as a runtime policy.

    A thin veneer over the incremental :class:`Scheduler`: arrivals,
    departures, refits, and node churn all map onto its incremental
    entry points, so per-event cost is bounded by what actually changed
    (see the scheduler's ``warm_rounds``/``cached_rows`` counters, which
    this class surfaces via :meth:`counters`).
    """

    name = "cannikin"

    # Graceful degradation: when an engine's solver errors out mid-event
    # (a device failure on the "jax" path, say), the scheduler drops one tier
    # and retries — never letting one solver failure kill a job.
    _ENGINE_FALLBACK = {"jax": "batched", "batched": "scalar"}

    def __init__(
        self, n_nodes: int, *, engine: str = "batched", watchdog=None, device=None
    ) -> None:
        self.n_nodes = n_nodes
        self.scheduler = Scheduler(n_nodes, engine=engine, device=device)
        self.engine_degradations = 0
        self.last_known_good_served = 0
        # Optional repro_torch.runtime.watchdog.Watchdog: deadline-guards every
        # solve; a DeadlineExceeded (a RuntimeError) enters the same
        # degradation chain as a solver error, so a stalled solve costs one
        # engine tier, never a hung reconcile.
        self.watchdog = watchdog

    def _solve(self, op):
        """Run one scheduler entry point under the degradation chain.

        Validation errors (unknown job, duplicate arrival, bad node id:
        ``KeyError``/``ValueError``) propagate — those are caller bugs,
        not solver failures.  Anything else — including a watchdog
        ``DeadlineExceeded`` on a stalled solve — walks ``_ENGINE_FALLBACK``
        (jax → batched → scalar), re-solving from the scheduler's intact
        job/mask state; with every tier exhausted, the last-known-good
        allocation is served rather than raising mid-reconcile.
        """
        try:
            if self.watchdog is not None:
                return self.watchdog.guard_solve(op)
            return op()
        except (KeyError, ValueError):
            raise
        except Exception:
            while self.scheduler.engine in self._ENGINE_FALLBACK:
                self.scheduler.engine = self._ENGINE_FALLBACK[self.scheduler.engine]
                self.engine_degradations += 1
                try:
                    return self.scheduler.reallocate()
                except (KeyError, ValueError):
                    raise
                except Exception:
                    continue
            last_good = self.scheduler.allocation
            if last_good is not None:
                self.last_known_good_served += 1
                return last_good
            raise

    def add_job(self, spec: JobSpec) -> Allocation:
        return self._solve(lambda: self.scheduler.add_job(spec))

    def remove_job(self, name: str) -> Allocation:
        return self._solve(lambda: self.scheduler.remove_job(name))

    def update_job(self, spec: JobSpec) -> Allocation:
        return self._solve(lambda: self.scheduler.update_job(spec))

    def node_leave(self, node_ids: Sequence[int]) -> Allocation:
        return self._solve(lambda: self.scheduler.node_leave(node_ids))

    def node_join(self, node_ids: Sequence[int]) -> Allocation:
        return self._solve(lambda: self.scheduler.node_join(node_ids))

    def reallocate(self) -> Allocation:
        return self._solve(self.scheduler.reallocate)

    @property
    def jobs(self) -> Tuple[JobSpec, ...]:
        return self.scheduler.jobs

    def counters(self) -> Dict[str, int]:
        s = self.scheduler
        out = {
            "allocations": s.allocations,
            "warm_rounds": s.warm_rounds,
            "cold_rounds": s.cold_rounds,
            "solved_rows": s.solved_rows,
            "cached_rows": s.cached_rows,
        }
        # Degradation counters appear only once the chain actually fired,
        # keeping fault-free golden counter dicts unchanged.
        if self.engine_degradations:
            out["engine_degradations"] = self.engine_degradations
        if self.last_known_good_served:
            out["last_known_good_served"] = self.last_known_good_served
        if self.watchdog is not None and self.watchdog.solver_timeouts:
            out["solver_timeouts"] = self.watchdog.solver_timeouts
        return out


class _BaselinePolicy:
    """Shared bookkeeping for the non-adaptive allocation baselines.

    Subclasses implement :meth:`_assign` (names x available nodes ->
    assignment).  Goodputs/fractions come from each job's own OptPerf
    solve over its assigned set, so baseline allocations score on the
    same scale as Cannikin's.
    """

    name = "baseline"

    def __init__(self, n_nodes: int, **_: object) -> None:
        self.n_nodes = n_nodes
        self._jobs: Dict[str, JobSpec] = {}   # insertion order == arrival order
        self._down: Set[int] = set()
        self._solo: Dict[str, float] = {}

    # -- event surface ---------------------------------------------------

    def add_job(self, spec: JobSpec) -> Allocation:
        if spec.name in self._jobs:
            raise ValueError(f"job {spec.name!r} already scheduled")
        self._jobs[spec.name] = spec
        return self.reallocate()

    def remove_job(self, name: str) -> Allocation:
        if name not in self._jobs:
            raise KeyError(name)
        del self._jobs[name]
        self._solo.pop(name, None)
        return self.reallocate()

    def update_job(self, spec: JobSpec) -> Allocation:
        if spec.name not in self._jobs:
            raise KeyError(spec.name)
        self._jobs[spec.name] = spec
        self._solo.pop(spec.name, None)
        return self.reallocate()

    def node_leave(self, node_ids: Sequence[int]) -> Allocation:
        ids = {int(i) for i in node_ids}
        bad = [i for i in ids if not 0 <= i < self.n_nodes]
        if bad:
            raise ValueError(f"node ids out of range: {sorted(bad)}")
        self._down |= ids
        return self.reallocate()

    def node_join(self, node_ids: Sequence[int]) -> Allocation:
        self._down -= {int(i) for i in node_ids}
        return self.reallocate()

    @property
    def jobs(self) -> Tuple[JobSpec, ...]:
        return tuple(self._jobs.values())

    # -- allocation ------------------------------------------------------

    def _assign(
        self, names: List[str], avail: List[int]
    ) -> Dict[str, Tuple[int, ...]]:
        raise NotImplementedError

    def reallocate(self) -> Allocation:
        if not self._jobs:
            return Allocation({}, {}, {})
        avail = [n for n in range(self.n_nodes) if n not in self._down]
        assignment = self._assign(list(self._jobs), avail)
        goodputs, fractions = {}, {}
        for name, spec in self._jobs.items():
            ids = tuple(sorted(assignment.get(name, ())))
            assignment[name] = ids
            if name not in self._solo:
                self._solo[name] = max(spec.solo_goodput(), 1e-12)
            goodputs[name] = spec.goodput(ids) if ids else 0.0
            fractions[name] = goodputs[name] / self._solo[name]
        return Allocation(assignment=assignment, goodputs=goodputs, fractions=fractions)


class StaticPolicy(_BaselinePolicy):
    """Contiguous equal node blocks in arrival order.

    The classic statically-partitioned cluster: job i gets the i-th block
    of the available node list, block sizes as even as possible (earlier
    arrivals absorb the remainder).  Blind to heterogeneity — a block can
    land entirely on the slow tier.
    """

    name = "static"

    def _assign(self, names, avail):
        j = len(names)
        base, extra = divmod(len(avail), j)
        out: Dict[str, Tuple[int, ...]] = {}
        start = 0
        for i, name in enumerate(names):
            size = base + (1 if i < extra else 0)
            out[name] = tuple(avail[start : start + size])
            start += size
        return out


class FairSharePolicy(_BaselinePolicy):
    """Round-robin deal: node ``avail[i]`` goes to job ``i % J``.

    Every job gets an even *count* and — because consecutive node ids in
    the catalog clusters run fastest-to-slowest — an even slice of every
    speed tier: the quota-style fair share of heterogeneous capacity.
    Still blind to job-specific needs (batch size, comm sensitivity).
    """

    name = "fair-share"

    def _assign(self, names, avail):
        out: Dict[str, List[int]] = {name: [] for name in names}
        for i, nid in enumerate(avail):
            out[names[i % len(names)]].append(nid)
        return {name: tuple(ids) for name, ids in out.items()}


POLICIES = {
    "cannikin": CannikinPolicy,
    "static": StaticPolicy,
    "fair-share": FairSharePolicy,
}


def make_policy(
    name: str, n_nodes: int, *, engine: str = "batched", device=None
) -> Policy:
    """Build an allocation policy by name (``cannikin``/``static``/
    ``fair-share``); ``engine`` selects the stacked-solver engine for the
    Cannikin policy and ``device`` where its ``"jax"`` engine solves (the
    card when None); baselines score via the scalar path regardless."""
    try:
        cls = POLICIES[name]
    except KeyError:
        raise ValueError(
            f"unknown allocation policy {name!r}; choose from {sorted(POLICIES)}"
        ) from None
    return cls(n_nodes, engine=engine, device=device)


# ---------------------------------------------------------------------------
# Per-job batch-partition policies (single-job training loop)
# ---------------------------------------------------------------------------


def make_partition_policy(
    name: str,
    n_nodes: int,
    *,
    candidates: Sequence[int],
    ref_batch: int,
    adaptive: bool = True,
    sweep_engine: str = "batched",
    batch_policy: Optional[str] = None,
):
    """Build a batch-*partition* policy: how one job splits its global batch
    across its nodes each epoch.

    ``cannikin`` returns a :class:`~repro_torch.core.controller.CannikinController`
    (OptPerf partition + optional adaptive total batch); ``even``/``ddp``/
    ``adaptdl`` the uniform split; ``lb-bsp`` the iterative Δ=5 tuner.
    ``batch_policy`` selects the controller's total-batch adaptation law
    from the :mod:`repro_torch.core.batch_policy` registry (cannikin only).
    This is the single factory behind ``launch/train.py`` and the
    convergence/adaptation benchmarks.
    """
    from repro_torch.core.baselines import EvenPartition, LBBSPPartition
    from repro_torch.core.controller import CannikinController

    if name == "cannikin":
        return CannikinController(
            n_nodes,
            batch_candidates=candidates,
            ref_batch=ref_batch,
            adaptive=adaptive,
            sweep_engine=sweep_engine,
            batch_policy=batch_policy,
        )
    if name in ("even", "ddp", "adaptdl"):
        # AdaptDL's per-node split in heterogeneous clusters equals DDP's
        # (paper §5.2.2); its total-batch adaptivity is modeled by pairing
        # this partition with the Cannikin GNS engine in the convergence
        # benchmark.
        return EvenPartition(n_nodes)
    if name == "lb-bsp":
        return LBBSPPartition(n_nodes, delta=5)
    raise ValueError(f"unknown partition policy {name!r}")


def drive_partition_policy(policy, sim, total: int, epochs: int, *, steps: int = 8) -> List[float]:
    """Drive one partition policy against a :class:`SimulatedCluster` for
    ``epochs`` epochs; returns the per-epoch mean batch time.

    The canonical plan → measure → observe loop (shared by
    ``bench_adaptation`` and the examples so every driver exercises the
    identical protocol): Cannikin controllers plan and ingest epoch
    measurements; baselines just repartition from the last measurement.
    """
    from repro_torch.core.controller import CannikinController

    times: List[float] = []
    last = None
    for epoch in range(epochs):
        if isinstance(policy, CannikinController):
            plan = policy.plan_epoch()
            batches = list(plan.batches)
        else:
            batches = policy.partition(total, epoch, last)
        t, ms = sim.run_epoch(batches, steps)
        last = ms[-1]
        if isinstance(policy, CannikinController):
            policy.observe_epoch(ms)
        times.append(t / steps)
    return times
