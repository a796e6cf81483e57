"""Goodput model and total-batch-size selection (§2.2, §4.1, Pollux-style).

goodput(B) = throughput(B) * efficiency(B)

  * throughput(B) = B / OptPerf(B)   — samples/sec at the *optimal* hetero
    partition for B (this is where Cannikin differs from Pollux: Pollux's
    throughput model assumes even shards).
  * efficiency(B) = (B_noise + B0) / (B_noise + B) — statistical efficiency
    relative to the user's reference batch size B0 (McCandlish/Pollux).

The whole candidate sweep is evaluated in one array pass via
:func:`goodput_curve` / :func:`repro_torch.core.optperf.solve_optperf_batch`
(O(~200) NumPy broadcasts for any number of candidates); the scalar
:func:`goodput` remains for single-B queries and as the cross-check oracle.

Also provides the AdaScale learning-rate gain used by the SGD workloads and
the square-root scaling rule used by Adam-family workloads (Table 4).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.optperf import (
    BatchedOptPerfSolution,
    OptPerfSolution,
    solve_optperf,
    solve_optperf_algorithm1_batch,
    solve_optperf_batch,
)
from repro_torch.core.optperf_torch import solve_optperf_batch_jax
from repro_torch.core.perf_model import ClusterPerfModel

__all__ = [
    "statistical_efficiency",
    "goodput",
    "goodput_curve",
    "GoodputCurve",
    "adascale_gain",
    "sqrt_lr_scale",
    "BatchSizeSelector",
]


def statistical_efficiency(b_noise: float, batch, ref_batch: float):
    """E(B) = (B_noise + B0) / (B_noise + B); E(B0) = 1, decreasing in B.

    ``batch`` may be a scalar (returns float) or an array (returns an array
    of the same shape).
    """
    b = np.asarray(batch, dtype=np.float64)
    if np.any(b <= 0) or ref_batch <= 0:
        raise ValueError("batch sizes must be positive")
    if not np.isfinite(b_noise):
        eff = np.ones_like(b)
    else:
        b_noise = max(b_noise, 0.0)
        eff = (b_noise + ref_batch) / (b_noise + b)
    return float(eff) if np.ndim(batch) == 0 else eff


def goodput(
    model: ClusterPerfModel,
    batch: float,
    b_noise: float,
    ref_batch: float,
    *,
    solver: str = "algorithm1",
    boundary_hint: Optional[int] = None,
) -> Tuple[float, OptPerfSolution]:
    """goodput(B) and the OptPerf partition that realizes it."""
    sol = solve_optperf(model, batch, method=solver, boundary_hint=boundary_hint)
    thr = batch / sol.opt_perf
    eff = statistical_efficiency(b_noise, batch, ref_batch)
    return thr * eff, sol


def _array_sweep_solver(engine: str, device: Any = None):
    """The array-engine entry point for a full sweep: the on-device sweep
    (:func:`repro_torch.core.optperf_torch.solve_optperf_batch_jax`) on
    ``device`` (the card unless ``"cpu"`` is asked for) for ``engine ==
    "jax"``, else the NumPy batched engine.  There is no fallback: a device
    sweep that cannot run raises.  Shared gating for :func:`goodput_curve`
    and :class:`BatchSizeSelector`.
    """
    if engine == "jax":
        return functools.partial(solve_optperf_batch_jax, device=device)
    return solve_optperf_batch


@dataclasses.dataclass(frozen=True)
class GoodputCurve:
    """goodput(B) over a candidate vector, solved in one batched pass."""

    candidates: np.ndarray          # (C,) total batch sizes
    goodputs: np.ndarray            # (C,) samples/sec * efficiency
    throughputs: np.ndarray         # (C,) samples/sec at the OptPerf partition
    efficiencies: np.ndarray        # (C,) statistical efficiency
    solutions: BatchedOptPerfSolution

    def best_index(self) -> int:
        return int(np.argmax(self.goodputs))

    def best(self) -> Tuple[float, OptPerfSolution, float]:
        """(best B, its OptPerf solution, its goodput)."""
        j = self.best_index()
        return (
            float(self.candidates[j]),
            self.solutions.solution(j),
            float(self.goodputs[j]),
        )


def goodput_curve(
    model: ClusterPerfModel,
    candidates: Sequence[float],
    b_noise: float,
    ref_batch: float,
    *,
    engine: str = "batched",
    warm_start: Optional[np.ndarray] = None,
    device: Any = None,
) -> GoodputCurve:
    """Vectorized goodput(B) for every candidate total batch size.

    One :func:`solve_optperf_batch` call (a ``(C,)``-bracket bisection against
    a ``(C, n)`` feasible-batch matrix) replaces the per-candidate scalar
    sweep; cost is independent of the candidate count up to the O(C*n) array
    arithmetic inside each of the ~50 bisection steps — or a handful with a
    ``warm_start`` (the previous epoch's ``curve.solutions.t_stars``).
    ``engine="jax"`` runs the sweep on ``device`` (the on-device sweep;
    the card unless ``device="cpu"``).
    """
    cands = np.array(candidates, dtype=np.float64)  # copy: no aliasing
    cands.flags.writeable = False
    if engine not in ("batched", "jax"):
        raise ValueError(f"unknown goodput_curve engine {engine!r}")
    sols = _array_sweep_solver(engine, device)(model, cands, warm_start=warm_start)
    thr = cands / sols.opt_perfs
    eff = statistical_efficiency(b_noise, cands, ref_batch)
    return GoodputCurve(
        candidates=cands,
        goodputs=thr * eff,
        throughputs=thr,
        efficiencies=np.asarray(eff, dtype=np.float64),
        solutions=sols,
    )


def adascale_gain(b_noise: float, batch: float, ref_batch: float) -> float:
    """AdaScale gain r(B): the effective number of reference-size steps one
    big-batch step is worth;  r = (B_noise/B0 + 1) / (B_noise/B + 1) in the
    variance-dominated regime.  Clipped to [1, B/B0]."""
    if not np.isfinite(b_noise) or b_noise <= 0:
        return batch / ref_batch
    r = (b_noise / ref_batch + 1.0) / (b_noise / batch + 1.0)
    return float(np.clip(r, 1.0, batch / ref_batch))


def sqrt_lr_scale(batch: float, ref_batch: float) -> float:
    """Square-root LR scaling for Adam-family optimizers (Table 4)."""
    return float(np.sqrt(batch / ref_batch))


@dataclasses.dataclass
class BatchSizeSelector:
    """Enumerates total-batch-size candidates and picks argmax goodput.

    Implements the §4.5 "Total batch size selection" optimization: OptPerf is
    batch-size-dependent but *training-progress-independent*, so after the
    initial sweep the per-candidate OptPerf values (and their overlap
    states) are cached; subsequent epochs only recompute the candidate that
    wins under the updated GNS, unless its overlap state changed — then the
    full sweep re-runs.

    ``engine`` selects how a full sweep is executed: ``"batched"`` (default)
    solves every candidate in one :func:`solve_optperf_batch` array pass;
    ``"jax"`` runs the same sweep on ``device`` (the on-device sweep,
    :mod:`repro_torch.core.optperf_torch`; the card unless ``device="cpu"``);
    ``"scalar"`` is the original per-candidate
    loop with §4.5 boundary-hint chaining, kept as the cross-check oracle.
    Either way the winning candidate is re-solved with the scalar
    ``solver``, so the emitted plan is identical across engines.

    Incremental re-bracketing: the array engines carry the previous sweep's
    ``t_stars`` vector and seed the next sweep's brackets from it, cutting a
    full bisection to a handful of array passes when the performance models
    drifted only a little between epochs.  The warm state is dropped —
    falling back to cold brackets — whenever the cluster membership (node
    count), the candidate set, or the coefficient regime changed (any
    coefficient moved by more than ``warm_drift_limit`` relative).
    """

    candidates: Tuple[int, ...]
    ref_batch: int
    solver: str = "algorithm1"
    engine: str = "batched"
    warm_drift_limit: float = 0.25
    device: Any = None
    # epoch -> cache
    _optperf_cache: Dict[int, OptPerfSolution] = dataclasses.field(default_factory=dict)
    _state_cache: Dict[int, Tuple[str, ...]] = dataclasses.field(default_factory=dict)
    full_sweeps: int = 0
    incremental_updates: int = 0
    warm_sweeps: int = 0
    cold_sweeps: int = 0
    _warm_t_stars: Optional[np.ndarray] = dataclasses.field(default=None, repr=False)
    _warm_signature: Optional[Tuple[np.ndarray, ...]] = dataclasses.field(
        default=None, repr=False
    )

    def __post_init__(self) -> None:
        if self.engine not in ("batched", "scalar", "jax"):
            raise ValueError(f"unknown sweep engine {self.engine!r}")

    # -- warm-start state ----------------------------------------------

    @staticmethod
    def _model_signature(model: ClusterPerfModel) -> Tuple[np.ndarray, ...]:
        c = model.coeffs
        comm = np.asarray([model.comm.t_o, model.comm.t_u, model.comm.gamma])
        # ks/ms are part of the regime signature even though they do not
        # move t_star: they drive the overlap-state criterion, and a refit
        # that changes only the backprop split must still count as drift
        # (stale-regime brackets would otherwise be trusted blindly).
        return (c.alphas, c.cs, c.betas, c.ds, c.ks, c.ms, comm)

    def _warm_start_for(self, model: ClusterPerfModel) -> Optional[np.ndarray]:
        """Previous t_stars if they are still trustworthy seeds, else None."""
        if self._warm_t_stars is None or self._warm_signature is None:
            return None
        if self._warm_t_stars.shape[0] != len(self.candidates):
            return None
        sig = self._model_signature(model)
        for old, new in zip(self._warm_signature, sig):
            if old.shape != new.shape:   # cluster membership changed
                return None
            denom = np.maximum(np.abs(old), 1e-12)
            if float(np.max(np.abs(new - old) / denom)) > self.warm_drift_limit:
                return None              # coefficient regime changed
        return self._warm_t_stars

    def invalidate(self) -> None:
        """Drop every cached solution *and* the warm-start state (cluster
        membership changes route through here)."""
        self._optperf_cache.clear()
        self._state_cache.clear()
        self._warm_t_stars = None
        self._warm_signature = None

    def _sweep(self, model: ClusterPerfModel) -> None:
        self.full_sweeps += 1
        ordered = sorted(self.candidates)
        if self.engine in ("batched", "jax"):
            warm = self._warm_start_for(model)
            solver = _array_sweep_solver(self.engine, self.device)
            batch_sol = solver(
                model, np.asarray(ordered, dtype=np.float64), warm_start=warm
            )
            for j, b in enumerate(ordered):
                sol = batch_sol.solution(j)
                self._optperf_cache[b] = sol
                self._state_cache[b] = sol.bottleneck
            if warm is None:
                self.cold_sweeps += 1
            else:
                self.warm_sweeps += 1
            self._warm_t_stars = np.asarray(batch_sol.t_stars, dtype=np.float64)
            self._warm_signature = self._model_signature(model)
            return
        if self.solver == "algorithm1":
            # Batched boundary checks: Check 1/Check 2 vectorized across the
            # whole candidate vector, bit-equal per row to the scalar loop
            # below (which stays the oracle; see
            # :func:`repro_torch.core.optperf.solve_optperf_algorithm1_batch`).
            for b, sol in zip(
                ordered, solve_optperf_algorithm1_batch(model, ordered)
            ):
                self._optperf_cache[b] = sol
                self._state_cache[b] = sol.bottleneck
            return
        hint: Optional[int] = None
        for b in ordered:
            sol = solve_optperf(model, b, method=self.solver, boundary_hint=hint)
            self._optperf_cache[b] = sol
            self._state_cache[b] = sol.bottleneck
            # §4.5 "Overlap state searching": warm-start the next (larger)
            # candidate from this one's boundary (count of compute nodes).
            hint = sum(1 for s in sol.bottleneck if s == "compute")

    def select(
        self, model: ClusterPerfModel, b_noise: float
    ) -> Tuple[int, OptPerfSolution, float]:
        """Return (best total batch, its OptPerf solution, its goodput)."""
        if not self._optperf_cache:
            self._sweep(model)

        def cached_goodput(b: int) -> float:
            sol = self._optperf_cache[b]
            eff = statistical_efficiency(b_noise, b, self.ref_batch)
            return (b / sol.opt_perf) * eff

        best = max(self.candidates, key=cached_goodput)
        # Re-solve only the winner with fresh performance models.
        fresh = solve_optperf(model, best, method=self.solver)
        if fresh.bottleneck != self._state_cache.get(best):
            # Overlap pattern changed -> cached landscape is stale: resweep.
            self._sweep(model)
            best = max(self.candidates, key=cached_goodput)
            # Re-solve the (possibly new) winner with the scalar solver so
            # the emitted plan is engine-independent on this path too.
            fresh = solve_optperf(model, best, method=self.solver)
            self._optperf_cache[best] = fresh
            self._state_cache[best] = fresh.bottleneck
        else:
            self.incremental_updates += 1
            self._optperf_cache[best] = fresh
        eff = statistical_efficiency(b_noise, best, self.ref_batch)
        return best, fresh, (best / fresh.opt_perf) * eff
