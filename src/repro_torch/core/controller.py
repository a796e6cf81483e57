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

The port carries both of the reference's program shapes: the two-program
path (plan on the host, execute, observe) and the fused path, where the
backend's epoch runs the goodput sweep on the device
(:mod:`repro_torch.core.optperf_torch`) and the controller certifies each
proposal against the float64 host oracle before it plans from it
(``fused_context``/``stage_fused_proposal``).  Unlike the reference, which
drops to the two-program path when JAX is missing, there is nothing to drop
from: torch is always there.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.batch_policy import (
    BatchBounds,
    BatchSizePolicy,
    PolicyTelemetry,
    lr_scale_for,
    make_batch_policy,
)
from repro_torch.core.gns import GNSState, estimate_gns, gns_update, gns_weights
from repro_torch.core.goodput import (
    BatchSizeSelector,
    adascale_gain,
    sqrt_lr_scale,
    statistical_efficiency,
)
from repro_torch.core.optperf import (
    OptPerfSolution,
    _problem_from_model,
    round_batches,
    solve_optperf,
    solve_optperf_batch,
)
from repro_torch.core import optperf_torch
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
    "FusedSweepContext",
    "FusedProposal",
    "FUSED_CERT_TOL",
]

# Relative tolerance for certifying an on-device (float32) fused-epoch plan
# against the host float64 two-program oracle — same bar the device sweep
# engine's own certification uses.
FUSED_CERT_TOL = 1e-5


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
    # bootstrap plans — no policy is consulted before a model exists;
    # "<policy>+fused" when the plan consumed an on-device fused proposal).
    batch_policy: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class FusedSweepContext:
    """Everything a fused backend epoch needs to run the goodput sweep on
    device: the refit model's prefetched device coefficients, the candidate
    grid (device + host views), the water-fill lower bracket, and the
    reference batch for Eq. (6) efficiency.  ``model`` pins the exact host
    model the certification oracle must re-solve against."""

    model: ClusterPerfModel
    coeffs: Any                 # optperf_torch.DeviceCoeffs
    candidates: Any             # (C,) device tensor, coeffs dtype
    candidates_np: np.ndarray   # (C,) float64 host view
    lo0: float
    ref_batch: float


@dataclasses.dataclass(frozen=True)
class FusedProposal:
    """What the fused device program proposed for the next epoch: the
    goodput-argmax candidate, its water-filled partition, and the full
    sweep telemetry the host certification checks against the float64
    oracle."""

    best_index: int
    total_batch: float
    batches: np.ndarray         # (n,) real-valued water-fill partition
    t_star: float               # winner's cluster time
    t_stars: np.ndarray         # (C,) per-candidate cluster times
    goodputs: np.ndarray        # (C,) device goodput landscape
    b_noise: float              # epoch-final on-device GNS estimate
    sweep_iters: int


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
    # Fused-mode observability: plans consumed from on-device proposals,
    # host-float64 certifications run (off the critical path), certification
    # failures (any failure permanently falls back to the two-program path),
    # and the worst relative deviation a certification ever measured.
    fused_plans: int = 0
    fused_certifications: int = 0
    fused_cert_failures: int = 0
    fused_max_rel_err: float = 0.0

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
        one vectorized ``solve_optperf_batch`` pass; "jax" runs the same
        sweep on ``device`` (the on-device sweep); "scalar" keeps the
        per-candidate Algorithm-1 loop (cross-check oracle).  Plans are
        identical in every case — the winner is always re-solved scalar.
        The array engines warm-start each epoch's brackets from the
        previous epoch's t_star vector (see BatchSizeSelector).
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
      device: where the on-device sweep runs (``sweep_engine="jax"``) and
        where :meth:`fused_context` exports the coefficients when its
        caller names no device: the card unless ``"cpu"`` is asked for.
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
        device: Any = None,
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
            device=device,
        )
        self.device = device
        self.gns = GNSState()
        self.gns_decay = gns_decay
        self.stats = ControllerStats()
        self._epoch = 0
        self._last_plan: Optional[EpochPlan] = None
        self._model: Optional[ClusterPerfModel] = None
        self._last_loss = float("nan")
        self._fused_ctx: Optional[FusedSweepContext] = None
        self._fused_pending: Optional[Tuple[FusedSweepContext, FusedProposal]] = None
        self._fused_disabled = False
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
        self._prefetch_device_coeffs(self._model)
        return self._model

    def _prefetch_device_coeffs(self, model: ClusterPerfModel) -> None:
        """Fuse the device-coefficient export with the per-epoch OLS refit.

        Under ``sweep_engine="jax"`` the freshly refit model's coefficient
        arrays are shipped to the sweep's device *here*, at refit time,
        instead of lazily inside the next sweep — so the on-device re-solve
        never blocks on a host export (the refit already paid the
        transfer), and a stale pre-refit export can never be what the sweep
        reads (the cache is keyed on the frozen model instance)."""
        if self.selector.engine != "jax":
            return
        optperf_torch.device_coeffs(model, device=self.device)

    def _evict_device_export(self) -> None:
        """Drop the *current* model's cached device-coefficient export.

        Membership changes (`add_nodes`/`remove_nodes`) orphan `self._model`;
        its prefetched coefficient stack must be evicted — not merely
        dereferenced — so a stale export can never be reused (and never
        stays pinned in device memory) after the cluster changed shape."""
        if self._model is None:
            return
        optperf_torch.evict_device_coeffs(self._model)

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
        self._prefetch_device_coeffs(self._model)

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

    def plan_epoch(self, *, prefer_fused: bool = False) -> EpochPlan:
        """Produce the next epoch's configuration.

        The total-batch decision is delegated to ``self.policy`` (the
        :class:`BatchSizePolicy` seam): every planning round first feeds
        the policy one :class:`PolicyTelemetry` observation (previous
        epoch's plan, latest mean loss, current GNS estimate), then — once
        a performance model exists — asks it to ``propose`` the next total
        batch and LR scale.  Splitting the total across nodes stays the
        controller's job: OptPerf solve (reusing the policy's solution if
        it already ran the sweep), Eq.-(9) rounding, local-bound clamping.

        ``prefer_fused=True`` consumes a staged on-device fused proposal
        (see :meth:`stage_fused_proposal`) instead of asking the policy —
        identical plan structure, zero host solve on the critical path.
        With nothing staged (first fused epoch, bootstrap, certification
        fallback) the normal path runs.
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
            # Any staged fused proposal was built by a model that no longer
            # exists for planning purposes; drop it rather than serve it
            # after a bootstrap interlude.
            self._fused_pending = None
            plan = self._bootstrap_plan(epoch)
            self._finish_plan(plan, t0)
            return plan
        plan = self._fused_plan(epoch) if prefer_fused else None
        if plan is None:
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
    # fused on-device planning (the sweep beside the train steps)
    # ------------------------------------------------------------------

    def fused_context(self, device: Any = None) -> Optional[FusedSweepContext]:
        """The sweep inputs for a fused backend epoch on ``device`` (the
        controller's own device when None), or None whenever fused mode
        cannot run (bootstrap, non-adaptive, a policy other than
        cannikin-gns, or a past certification failure) — callers then take
        the two-program path unchanged.  The coefficient export and the
        candidate grid live on ``device``; a context built for another
        device is rebuilt, never copied."""
        if not self.adaptive or self._fused_disabled:
            return None
        if getattr(self.policy, "name", "") != "cannikin-gns":
            return None
        model = self._model
        if model is None:
            return None
        coeffs = optperf_torch.device_coeffs(
            model, device=self.device if device is None else device
        )
        ctx = self._fused_ctx
        if ctx is not None and ctx.model is model and ctx.coeffs is coeffs:
            return ctx
        _, lo0 = _problem_from_model(model)
        cand_np = np.asarray(self.selector.candidates, np.float64)
        ctx = FusedSweepContext(
            model=model,
            coeffs=coeffs,
            candidates=torch.as_tensor(
                cand_np, dtype=coeffs.alphas.dtype, device=coeffs.alphas.device
            ),
            candidates_np=cand_np,
            lo0=float(lo0),
            ref_batch=float(self.ref_batch),
        )
        self._fused_ctx = ctx
        return ctx

    def stage_fused_proposal(
        self, ctx: FusedSweepContext, proposal: FusedProposal
    ) -> None:
        """Certify an on-device proposal against the host float64 oracle
        and stage it for the next ``plan_epoch(prefer_fused=True)``.

        Runs *after* the epoch that produced the proposal — never between
        plan and execute, which is the whole point of fused mode.  A
        certification failure permanently disables fused planning (the
        two-program fallback is bit-compatible, so this is safe, and a
        float32 disagreement is systemic rather than transient)."""
        if self._fused_disabled:
            return
        self._certify_fused(ctx, proposal)
        if not self._fused_disabled:
            self._fused_pending = (ctx, proposal)

    def _certify_fused(self, ctx: FusedSweepContext, prop: FusedProposal) -> None:
        """Host float64 re-solve of the exact sweep the device ran: same
        model, same candidates, same (device-estimated) noise scale."""
        t0 = time.perf_counter()
        cands = ctx.candidates_np
        sols = solve_optperf_batch(ctx.model, [float(b) for b in cands])
        opt_perfs = np.asarray(sols.opt_perfs, np.float64)
        eff = statistical_efficiency(prop.b_noise, cands, ctx.ref_batch)
        goodputs = cands / opt_perfs * eff
        host_best = int(np.argmax(goodputs))
        rel = float(
            np.max(
                np.abs(np.asarray(prop.t_stars) - opt_perfs)
                / np.maximum(opt_perfs, 1e-12)
            )
        )
        ok = rel <= FUSED_CERT_TOL
        if ok and host_best != prop.best_index:
            # A genuine goodput near-tie may flip the argmax in float32;
            # only a materially better host winner is a failure.
            gap = abs(goodputs[host_best] - goodputs[prop.best_index])
            ok = gap <= FUSED_CERT_TOL * max(goodputs[host_best], 1e-12)
        if ok:
            host_batches = np.asarray(sols.batches[prop.best_index], np.float64)
            total = float(cands[prop.best_index])
            rel_b = float(
                np.max(np.abs(np.asarray(prop.batches) - host_batches))
                / max(total, 1e-12)
            )
            ok = rel_b <= FUSED_CERT_TOL
            rel = max(rel, rel_b)
        self.stats.fused_certifications += 1
        self.stats.fused_max_rel_err = max(self.stats.fused_max_rel_err, rel)
        if not ok:
            self.stats.fused_cert_failures += 1
            self._fused_disabled = True
            self._fused_pending = None
        self.stats.overhead_seconds += time.perf_counter() - t0

    def _fused_plan(self, epoch: int) -> Optional[EpochPlan]:
        """Turn the staged (certified) device proposal into an EpochPlan:
        integer rounding, local-bound clamping, and the policy's LR rule
        evaluated at the device-estimated noise scale."""
        pending, self._fused_pending = self._fused_pending, None
        if pending is None:
            return None
        ctx, prop = pending
        total = int(round(prop.total_batch))
        batches = self._apply_bounds(
            round_batches([float(b) for b in prop.batches], total), total
        )
        lr = lr_scale_for(
            self.lr_rule,
            batch=total,
            ref_batch=self.ref_batch,
            b_noise=prop.b_noise,
        )
        states = tuple(
            "compute" if c else "comm"
            for c in ctx.model.compute_bottleneck_mask(
                np.asarray(prop.batches, np.float64)
            )
        )
        sol = OptPerfSolution(
            total_batch=float(prop.total_batch),
            opt_perf=float(prop.t_star),
            batches=tuple(float(b) for b in prop.batches),
            bottleneck=states,
            method="waterfill/fused-device",
        )
        self.stats.fused_plans += 1
        return EpochPlan(
            epoch=epoch,
            total_batch=total,
            batches=tuple(batches),
            lr_scale=float(lr),
            predicted_batch_time=float(prop.t_star),
            phase="optperf",
            solution=sol,
            batch_policy=f"{self.policy.name}+fused",
        )

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
        self._evict_device_export()
        self._drop_fused_state()
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
        self._evict_device_export()
        self._drop_fused_state()
        self._model = None
        self.selector.invalidate()
        self._invalidate_policy()

    def _drop_fused_state(self) -> None:
        """Membership changed: the staged proposal and cached context refer
        to a cluster that no longer exists.  ``_fused_disabled`` survives —
        a float32 certification failure is systemic, not shape-specific."""
        self._fused_pending = None
        self._fused_ctx = None

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
