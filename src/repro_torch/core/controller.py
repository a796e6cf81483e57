"""The Cannikin epoch controller (§4.1 workflow, §4.5 implementation).

Per-epoch loop:

  1. *Bootstrap* (epochs 0–1): no performance model exists yet; assign local
     batches inversely proportional to per-sample time (Eq. 8) — this both
     balances load roughly and guarantees each node sees >= 2 distinct local
     batch sizes so the linear fits become possible.
  2. *Model learning*: each node's fitter ingests NodeObservations; cluster
     gamma via inverse-variance weighting (Eq. 12), T_comm via min-aggregation,
     T_u from gamma-weighted split of the comm time.
  3. *Batch-size selection*: the adaptive engine enumerates total-batch
     candidates; goodput(B) = throughput(B) * efficiency(B) with throughput
     from OptPerf(B); the OptPerf_init cache avoids re-sweeping (§4.5).
  4. *Partition*: round Eq.-(9)-compatible optimal real batches to integers.

The controller is runtime-agnostic: it consumes measurements (from the
simulator or from wall-clock timing of real steps) and produces the next
epoch's partition + learning-rate scale.

The port carries the reference's two-program path (plan on the host,
execute, observe).  The fused on-device planning of the reference
(``fused_context``/``stage_fused_proposal`` and the ``optperf_jax``
coefficient export) waits for the fused epoch (ROADMAP §1.5):
:meth:`CannikinController.fused_context` returns None, as the reference's
does when ``optperf_jax`` is missing.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.batch_policy import (
    BatchBounds,
    BatchSizePolicy,
    PolicyTelemetry,
    make_batch_policy,
)
from repro_torch.core.gns import GNSState, estimate_gns, gns_update, gns_weights
from repro_torch.core.goodput import (
    BatchSizeSelector,
    adascale_gain,
    sqrt_lr_scale,
)
from repro_torch.core.optperf import (
    OptPerfSolution,
    round_batches,
    solve_optperf,
)
from repro_torch.core.perf_model import (
    ClusterPerfModel,
    CommModel,
    GammaAggregator,
    NodeObservation,
    OnlineNodeFitter,
    bootstrap_partition,
)
from repro_torch.core.simulator import StepMeasurement

__all__ = [
    "CannikinController",
    "EpochPlan",
    "ControllerStats",
]

@dataclasses.dataclass(frozen=True)
class EpochPlan:
    """What the controller tells the runtime to do next epoch."""

    epoch: int
    total_batch: int
    batches: Tuple[int, ...]
    lr_scale: float
    predicted_batch_time: Optional[float]  # None during bootstrap
    phase: str                             # "bootstrap" | "optperf"
    solution: Optional[OptPerfSolution] = None
    # Provenance: which BatchSizePolicy proposed this total batch (None for
    # bootstrap plans — no policy is consulted before a model exists).
    batch_policy: Optional[str] = None


@dataclasses.dataclass
class ControllerStats:
    overhead_seconds: float = 0.0
    epochs_planned: int = 0
    full_sweeps: int = 0
    incremental_updates: int = 0
    # Incremental re-bracketing observability: how many full sweeps were
    # warm-started from the previous epoch's t_star vector vs solved cold
    # (cold = first sweep, membership change, or coefficient-regime change).
    warm_sweeps: int = 0
    cold_sweeps: int = 0
    def overhead_fraction(self, training_seconds: float) -> float:
        if training_seconds <= 0:
            return 0.0
        return self.overhead_seconds / training_seconds


class CannikinController:
    """Drives heterogeneous adaptive-batch-size training.

    Args:
      n_nodes: number of DP node groups.
      batch_candidates: total-batch-size candidates (adaptive engine range).
      ref_batch: user's initial/reference batch size B0.
      lr_rule: "adascale" (SGD workloads) or "sqrt" (Adam workloads).
      adaptive: if False, keeps total batch fixed at ``ref_batch`` (the
        fixed-batch evaluation mode of §5.2.2) but still optimizes the split.
      sweep_engine: "batched" (default) runs the candidate goodput sweep as
        one vectorized ``solve_optperf_batch`` pass; "jax" (the reference's
        on-device sweep) raises until it is ported (ROADMAP §1.5); "scalar"
        keeps the per-candidate
        Algorithm-1 loop (cross-check oracle).  Plans are identical in every
        case — the winner is always re-solved scalar.  The array engines
        warm-start each epoch's brackets from the previous epoch's t_star
        vector (see BatchSizeSelector).
      warm_drift_limit: maximum relative coefficient drift under which the
        previous epoch's brackets are still trusted as warm seeds; larger
        drift (a regime change) falls back to cold brackets.
      min_local / max_local: per-node local batch bounds (memory limits, §6).
      batch_policy: name of a registered :mod:`repro_torch.core.batch_policy`
        law (or a ready :class:`BatchSizePolicy` instance) deciding the
        total batch each epoch.  ``None`` keeps the historical behaviour:
        ``cannikin-gns`` when ``adaptive``, else ``fixed`` — both
        bit-identical to the pre-protocol controller.  ``adaptive=False``
        always forces ``fixed`` (the §5.2.2 evaluation mode wins).
      policy_kwargs: extra keyword arguments for the named policy's
        constructor (e.g. ``{"factor": 2.0, "delay": 4}`` for geodamp).
    """

    name = "cannikin"

    def __init__(
        self,
        n_nodes: int,
        *,
        batch_candidates: Sequence[int],
        ref_batch: int,
        lr_rule: str = "adascale",
        adaptive: bool = True,
        solver: str = "algorithm1",
        sweep_engine: str = "batched",
        warm_drift_limit: float = 0.25,
        gns_decay: float = 0.9,
        min_local: int = 1,
        max_local: Optional[int] = None,
        batch_policy: Union[str, BatchSizePolicy, None] = None,
        policy_kwargs: Optional[Dict] = None,
    ) -> None:
        self.n = n_nodes
        self.ref_batch = int(ref_batch)
        self.adaptive = adaptive
        self.lr_rule = lr_rule
        self.solver = solver
        self.min_local = min_local
        self.max_local = max_local
        self.fitters: Dict[int, OnlineNodeFitter] = {
            i: OnlineNodeFitter() for i in range(n_nodes)
        }
        self.selector = BatchSizeSelector(
            candidates=tuple(sorted(set(int(b) for b in batch_candidates))),
            ref_batch=int(ref_batch),
            solver=solver,
            engine=sweep_engine,
            warm_drift_limit=warm_drift_limit,
        )
        self.gns = GNSState()
        self.gns_decay = gns_decay
        self.stats = ControllerStats()
        self._epoch = 0
        self._last_plan: Optional[EpochPlan] = None
        self._model: Optional[ClusterPerfModel] = None
        self._last_loss = float("nan")
        if batch_policy is None or isinstance(batch_policy, str):
            if not adaptive:
                chosen = "fixed"
            elif batch_policy is None:
                chosen = "cannikin-gns"
            else:
                chosen = batch_policy
            kwargs = dict(policy_kwargs or {})
            if chosen in ("cannikin-gns", "fixed"):
                # These two reproduce the historical controller paths, where
                # the LR rule was the controller's own knob; dampers pin
                # their own rule unless policy_kwargs overrides it.
                kwargs.setdefault("lr_rule", lr_rule)
            self.policy: BatchSizePolicy = make_batch_policy(
                chosen,
                candidates=self.selector.candidates,
                ref_batch=self.ref_batch,
                selector=self.selector,
                **kwargs,
            )
        else:
            self.policy = batch_policy

    # ------------------------------------------------------------------
    # measurement ingestion
    # ------------------------------------------------------------------

    def observe_epoch(self, measurements: Sequence[StepMeasurement]) -> None:
        """Feed the epoch's step measurements (averaged per node)."""
        if not measurements:
            return
        n_steps = len(measurements)
        for i in range(self.n):
            # A crashed node reports nothing: its slot holds None and the
            # fitter simply sees no sample this epoch.
            obs = [m.observations[i] for m in measurements if m.observations[i] is not None]
            if not obs:
                continue
            self.fitters[i].add(
                NodeObservation(
                    batch_size=obs[0].batch_size,
                    a_time=float(np.mean([o.a_time for o in obs])),
                    backprop_time=float(np.mean([o.backprop_time for o in obs])),
                    gamma=float(np.mean([o.gamma for o in obs])),
                    comm_time=float(np.min([o.comm_time for o in obs])),
                )
            )
        self._model = None  # stale

    def observe_gradients(
        self,
        local_sqnorms: Sequence[float],
        global_sqnorm: float,
        batches: Sequence[float],
    ) -> None:
        """Feed per-node gradient square-norms for GNS tracking (§4.4)."""
        try:
            _, g, s = estimate_gns(local_sqnorms, global_sqnorm, batches)
        except (ValueError, np.linalg.LinAlgError):
            return
        self.gns = gns_update(self.gns, g, s, decay=self.gns_decay)

    def observe_execution(self, result) -> None:
        """Ingest one backend epoch's telemetry in the canonical order:
        per-step gradient square-norms (GNS tracking) first, then the
        epoch's timing measurements (performance-model fitting).

        ``result`` is duck-typed (any object with ``grad_observations`` —
        each carrying ``local_sqnorms``/``global_sqnorm``/``batches`` — and
        ``measurements``), so the controller stays runtime-agnostic: the
        :class:`~repro.runtime.backend.ExecutionResult` of either backend
        and hand-built test doubles all plumb through the same way.

        Steps where the backend's anomaly guard excluded a node
        (``obs.valid`` not all-true) are skipped for GNS tracking: their
        square-norms are poisoned and would corrupt the Theorem-4.1
        estimate."""
        for obs in getattr(result, "grad_observations", ()) or ():
            valid = getattr(obs, "valid", ())
            if valid and not all(valid):
                continue
            self.observe_gradients(obs.local_sqnorms, obs.global_sqnorm, obs.batches)
        loss = getattr(result, "mean_loss", None)
        self._last_loss = float(loss) if loss is not None else float("nan")
        self.observe_epoch(result.measurements)

    # ------------------------------------------------------------------
    # model assembly
    # ------------------------------------------------------------------

    def can_model(self) -> bool:
        return all(f.can_fit() for f in self.fitters.values())

    def cluster_model(self) -> ClusterPerfModel:
        if self._model is not None:
            return self._model
        if not self.can_model():
            raise RuntimeError("performance models not yet learnable")
        nodes = tuple(self.fitters[i].fit() for i in range(self.n))
        agg = GammaAggregator(self.fitters)
        gamma = agg.gamma()
        t_comm = agg.t_comm()
        # Split T_comm into overlappable T_o and last-bucket T_u.  The paper
        # measures buckets directly; behind XLA we apportion by bucket count
        # heuristic: T_u = T_comm / n_buckets with n_buckets ~ 1/(1-gamma)
        # clamped — tests cover robustness of OptPerf to this split.
        t_u = t_comm * min(0.2, max(0.02, 1.0 - gamma) * 0.2)
        t_o = t_comm - t_u
        self._model = ClusterPerfModel(
            nodes=nodes, comm=CommModel(t_o=t_o, t_u=t_u, gamma=gamma)
        )
        return self._model

    def set_comm_split(self, t_o: float, t_u: float, gamma: float) -> None:
        """Override the comm model with directly measured values (used when the
        runtime can observe bucket boundaries, e.g. the simulator's oracle or
        a profiler hook)."""
        if not self.can_model():
            raise RuntimeError("performance models not yet learnable")
        nodes = tuple(self.fitters[i].fit() for i in range(self.n))
        self._model = ClusterPerfModel(
            nodes=nodes, comm=CommModel(t_o=t_o, t_u=t_u, gamma=gamma)
        )

    # ------------------------------------------------------------------
    # planning
    # ------------------------------------------------------------------

    @property
    def batch_bounds(self) -> BatchBounds:
        """Total-batch bounds the policy must stay within: the span of the
        candidate grid, always widened to include the reference batch."""
        grid = set(self.selector.candidates) | {self.ref_batch}
        return BatchBounds(min_total=min(grid), max_total=max(grid))

    def _apply_bounds(self, batches: List[int], total: int) -> List[int]:
        """Clamp local batches to [min_local, max_local] preserving the sum."""
        lo = self.min_local
        hi = self.max_local if self.max_local is not None else total
        b = np.clip(np.asarray(batches, dtype=np.int64), lo, hi)
        diff = total - int(b.sum())
        # Redistribute the clamping residue greedily to unclamped nodes.
        order = np.argsort(b) if diff > 0 else np.argsort(-b)
        idx = 0
        while diff != 0 and idx < 10 * self.n:
            i = int(order[idx % self.n])
            step = 1 if diff > 0 else -1
            if lo <= b[i] + step <= hi:
                b[i] += step
                diff -= step
            idx += 1
        return [int(x) for x in b]

    def plan_epoch(self) -> EpochPlan:
        """Produce the next epoch's configuration.

        The total-batch decision is delegated to ``self.policy`` (the
        :class:`BatchSizePolicy` seam): every planning round first feeds
        the policy one :class:`PolicyTelemetry` observation (previous
        epoch's plan, latest mean loss, current GNS estimate), then — once
        a performance model exists — asks it to ``propose`` the next total
        batch and LR scale.  Splitting the total across nodes stays the
        controller's job: OptPerf solve (reusing the policy's solution if
        it already ran the sweep), Eq.-(9) rounding, local-bound clamping.
        """
        t0 = time.perf_counter()
        epoch = self._epoch
        self._epoch += 1
        self.stats.epochs_planned += 1

        last = self._last_plan
        self.policy.observe(
            PolicyTelemetry(
                epoch=epoch,
                total_batch=last.total_batch if last is not None else 0,
                mean_loss=self._last_loss,
                b_noise=self.gns.b_noise,
                phase=last.phase if last is not None else "",
            )
        )

        model = None
        if self.can_model():
            try:
                model = self.cluster_model()
            except ValueError:
                # A non-physical fit (negative slope) means the window is
                # polluted — e.g. a straggler window straddling the fit.
                # Plan the bootstrap split and re-learn from the next
                # epochs' measurements instead of killing the job.
                model = None
        if model is None:
            plan = self._bootstrap_plan(epoch)
            self._finish_plan(plan, t0)
            return plan
        proposal = self.policy.propose(model, self.batch_bounds)
        best_b = int(proposal.total_batch)
        sol = proposal.solution
        if sol is None:
            sol = solve_optperf(model, best_b, method=self.solver)
        batches = self._apply_bounds(
            round_batches(list(sol.batches), best_b), best_b
        )
        plan = EpochPlan(
            epoch=epoch,
            total_batch=best_b,
            batches=tuple(batches),
            lr_scale=float(proposal.lr_scale),
            predicted_batch_time=sol.opt_perf,
            phase="optperf",
            solution=sol,
            batch_policy=self.policy.name,
        )
        self._finish_plan(plan, t0)
        return plan

    def _finish_plan(self, plan: EpochPlan, t0: float) -> None:
        self.stats.overhead_seconds += time.perf_counter() - t0
        self.stats.full_sweeps = self.selector.full_sweeps
        self.stats.incremental_updates = self.selector.incremental_updates
        self.stats.warm_sweeps = self.selector.warm_sweeps
        self.stats.cold_sweeps = self.selector.cold_sweeps
        self._last_plan = plan

    # ------------------------------------------------------------------
    # fused on-device planning (ROADMAP §1.5)
    # ------------------------------------------------------------------

    def fused_context(self) -> None:
        """Always None: the fused epoch's on-device sweep is not ported, so
        callers take the two-program path, as the reference's callers do
        when ``optperf_jax`` is missing."""
        return None

    def _bootstrap_plan(self, epoch: int) -> EpochPlan:
        total = self.ref_batch
        if epoch == 0 or not all(f.num_observations for f in self.fitters.values()):
            # Even split, first contact.
            batches = round_batches([total / self.n] * self.n, total)
        else:
            # Eq. (8): inverse per-sample-time proportional assignment.  If
            # this lands on the same batch a node already saw, nudge by one
            # sample so the fitter gets two distinct sizes.
            ts = [self.fitters[i].per_sample_time() for i in range(self.n)]
            raw = bootstrap_partition(ts, total)
            batches = self._nudge_distinct(round_batches(raw, total), total)
        batches = self._apply_bounds(batches, total)
        return EpochPlan(
            epoch=epoch,
            total_batch=total,
            batches=tuple(batches),
            lr_scale=1.0,
            predicted_batch_time=None,
            phase="bootstrap",
        )

    def _nudge_distinct(self, batches: List[int], total: int) -> List[int]:
        """Ensure each node's new batch differs from every one it has seen."""
        out = list(batches)
        for i in range(self.n):
            fitter = self.fitters[i]
            seen = {o.batch_size for o in fitter._obs}  # noqa: SLF001 (intra-package)
            if float(out[i]) in seen:
                j = max(range(self.n), key=lambda x: out[x])
                if j != i and out[j] > 1:
                    out[i] += 1
                    out[j] -= 1
                elif out[i] > 1:
                    out[i] -= 1
                    out[(i + 1) % self.n] += 1
        return out

    # ------------------------------------------------------------------
    # elastic reconfiguration (paper §6: dynamic resource allocation)
    # ------------------------------------------------------------------

    def remove_nodes(self, node_ids: Sequence[int]) -> None:
        """Drop nodes mid-training.  Learned models of the remaining nodes
        are kept (the paper: "easily use the learned computing models of
        remaining nodes"); the OptPerf cache is invalidated."""
        drop = set(node_ids)
        keep = [i for i in range(self.n) if i not in drop]
        if not keep:
            raise ValueError("cannot remove every node")
        self.fitters = {new: self.fitters[old] for new, old in enumerate(keep)}
        self.n = len(keep)
        self._model = None
        # Cluster membership changed: cached solutions AND the warm-start
        # bracket state are both stale.
        self.selector.invalidate()
        self._invalidate_policy()

    def add_nodes(self, count: int = 1) -> None:
        """Add fresh nodes: their models are unknown, so the controller
        drops back to the bootstrap phase for two epochs (paper §6:
        "re-initialize the cluster for job J with two epochs")."""
        if count < 1:
            raise ValueError("count must be >= 1")
        for i in range(self.n, self.n + count):
            self.fitters[i] = OnlineNodeFitter()
        self.n += count
        self._model = None
        self.selector.invalidate()
        self._invalidate_policy()

    def _invalidate_policy(self) -> None:
        """Tell the policy its cached cluster view is stale (cannikin-gns
        shares the controller's selector, whose caches were just dropped;
        a policy with its own caches hooks ``invalidate``)."""
        invalidate = getattr(self.policy, "invalidate", None)
        if invalidate is not None:
            invalidate()

    @property
    def last_plan(self) -> Optional[EpochPlan]:
        return self._last_plan
