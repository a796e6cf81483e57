"""OptPerf: the optimal batch-partition / batch-time solver (§3.3, §4.2, App. A).

Three solvers are provided:

``solve_optperf_algorithm1``
    Paper-faithful Algorithm 1: closed-form Check 1 (all compute-bottleneck),
    Check 2 (all communication-bottleneck), then a binary search over the
    bottleneck boundary for the mixed case.  O(n) per candidate boundary
    (the "linear system" of the paper is diagonal once the partition is
    fixed, so we solve it directly rather than with a generic O(n^3) solve).
    Kept as the independent cross-check oracle for the array engine below.

``solve_optperf_waterfill``
    Beyond-paper oracle: the node batch time
        T_i(b) = max(t_compute_i(b) + T_u, syncStart_i(b) + T_comm)
    is strictly increasing in b, so for a target cluster time T each node has
    a maximal feasible batch
        b_i(T) = min((T - T_u - c_i)/alpha_i, (T - T_comm - d_i)/beta_i)
    and Sum_i max(b_i(T), 0) is continuous and nondecreasing in T.  Bisection
    on T yields the exact optimum including b_i >= 0 clamping that
    Algorithm 1's linear solves ignore.  Implemented as the single-candidate
    special case of the batched engine.

``solve_optperf_batch``
    The batched water-fill engine: solves OptPerf for *all* candidate total
    batch sizes of a goodput sweep simultaneously.  The bisection state is a
    ``(num_candidates,)`` vector of ``[lo, hi]`` brackets refined against a
    ``(num_candidates, n)`` feasible-batch matrix, so the whole sweep costs
    O(max_iter) NumPy broadcasts — ~200 array ops total regardless of the
    candidate count — instead of ``num_candidates * max_iter * n``
    Python-level evaluations.  Complexity: O(max_iter * C * n) flops, O(C * n)
    memory, zero Python-level per-node or per-candidate work in the hot loop.

    ``warm_start`` (incremental re-bracketing): pass the previous epoch's
    ``t_stars`` vector and the solver runs a *safeguarded Newton* refinement
    from it instead of cold bracketing + full bisection.  g(T) is monotone
    piecewise-affine, so when perf-model drift is small the active set is
    unchanged and the first Newton step lands on the new optimum exactly —
    a handful of array passes replace ~50.  Every Newton iterate also tightens
    a true [lo, hi] bracket, and anything not converged falls through to
    standard bisection, so a stale or even garbage warm start still converges
    to the identical solution.

``solve_optperf_stacked``
    The same engine over a :class:`~repro_torch.core.perf_model.StackedClusterModel`
    — C *independent* problem rows (each row its own node subset + comm
    model, padded to a common width).  This is what lets the multi-job
    scheduler evaluate every (job, candidate-node) marginal goodput of a
    greedy round in one array pass.

All coefficient access goes through :attr:`ClusterPerfModel.coeffs`, the
cached array view (precomputed alphas/cs/betas/ds/backprop vectors; the model
dataclass is frozen so the cache can never go stale).  A third, jit-compiled
engine that runs the same bisection on-device lives in
:mod:`repro.core.optperf_jax`.

Scalar solvers return an :class:`OptPerfSolution`; the batched/stacked
engines return a :class:`BatchedOptPerfSolution`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.perf_model import ClusterPerfModel, StackedClusterModel

__all__ = [
    "OptPerfSolution",
    "BatchedOptPerfSolution",
    "solve_optperf_algorithm1",
    "solve_optperf_algorithm1_batch",
    "solve_optperf_waterfill",
    "solve_optperf_waterfill_subset",
    "solve_optperf_waterfill_subsets",
    "solve_optperf_batch",
    "solve_optperf_stacked",
    "solve_optperf",
    "round_batches",
]


@dataclasses.dataclass(frozen=True)
class OptPerfSolution:
    """Solution of the OptPerf problem for one total batch size."""

    total_batch: float
    opt_perf: float                    # minimized cluster batch time (seconds)
    batches: Tuple[float, ...]         # optimal (real-valued) local batches
    bottleneck: Tuple[str, ...]        # per node: "compute" | "comm"
    method: str                        # solver that produced this

    @property
    def ratios(self) -> Tuple[float, ...]:
        return tuple(b / self.total_batch for b in self.batches)

    def summary(self) -> str:
        parts = ", ".join(
            f"b{i}={b:.1f}({s[:4]})" for i, (b, s) in enumerate(zip(self.batches, self.bottleneck))
        )
        return f"OptPerf={self.opt_perf * 1e3:.3f}ms B={self.total_batch:g} [{parts}]"


@dataclasses.dataclass(frozen=True)
class BatchedOptPerfSolution:
    """OptPerf solutions for a whole vector of candidate total batch sizes.

    ``batches`` is ``(C, n)``; ``total_batches``/``opt_perfs`` are ``(C,)``;
    ``compute_mask`` is the ``(C, n)`` boolean overlap state (True = the node
    is compute-bottleneck at that candidate's optimum).

    ``t_stars`` is the bisected cluster-time bound per candidate — the warm
    start for the next epoch's solve.  ``iterations`` counts feasible-batch
    array passes spent (observability: warm-started solves should use a
    handful where cold ones use ~50).  ``node_mask`` is ``None`` for the
    single-model engines; for stacked solves it marks real (non-padding)
    slots per row and extraction respects it.
    """

    total_batches: np.ndarray
    opt_perfs: np.ndarray
    batches: np.ndarray
    compute_mask: np.ndarray
    method: str
    t_stars: Optional[np.ndarray] = None
    iterations: int = 0
    node_mask: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return int(self.total_batches.shape[0])

    def _valid(self, j: int) -> np.ndarray:
        if self.node_mask is None:
            return np.arange(self.batches.shape[1])
        return np.flatnonzero(self.node_mask[j])

    def bottleneck(self, j: int) -> Tuple[str, ...]:
        return tuple(
            "compute" if self.compute_mask[j, i] else "comm" for i in self._valid(j)
        )

    def solution(self, j: int, *, method: Optional[str] = None) -> OptPerfSolution:
        """Extract candidate/row ``j`` as a scalar :class:`OptPerfSolution`
        (padding slots of stacked solves are dropped)."""
        return OptPerfSolution(
            total_batch=float(self.total_batches[j]),
            opt_perf=float(self.opt_perfs[j]),
            batches=tuple(float(self.batches[j, i]) for i in self._valid(j)),
            bottleneck=self.bottleneck(j),
            method=method or self.method,
        )

    def solutions(self) -> List[OptPerfSolution]:
        return [self.solution(j) for j in range(len(self))]


# ---------------------------------------------------------------------------
# helpers (all pure NumPy over the cached coefficient view)
# ---------------------------------------------------------------------------


def _solve_equal_compute(model: ClusterPerfModel, total_batch: float) -> Tuple[float, np.ndarray]:
    """Check 1: equalize t_compute across all nodes.  mu is the common
    t_compute; b_i = (mu - c_i)/alpha_i."""
    c = model.coeffs
    inv = 1.0 / c.alphas
    mu = (total_batch + (c.cs * inv).sum()) / inv.sum()
    return float(mu), (mu - c.cs) * inv


def _solve_equal_syncstart(model: ClusterPerfModel, total_batch: float) -> Tuple[float, np.ndarray]:
    """Check 2: equalize syncStart across all nodes."""
    c = model.coeffs
    inv = 1.0 / c.betas
    mu = (total_batch + (c.ds * inv).sum()) / inv.sum()
    return float(mu), (mu - c.ds) * inv


def _solve_mixed(
    model: ClusterPerfModel,
    total_batch: float,
    compute_mask: np.ndarray,
) -> Tuple[float, np.ndarray]:
    """Mixed case (App. A.3): compute nodes satisfy t_compute_i = mu, comm
    nodes satisfy syncStart_i + T_o = mu; Sum b = B.  One masked reduction."""
    c = model.coeffs
    t_o = model.comm.t_o
    slope = np.where(compute_mask, c.alphas, c.betas)
    offset = np.where(compute_mask, c.cs, t_o + c.ds)
    inv = 1.0 / slope
    mu = (total_batch + (offset * inv).sum()) / inv.sum()
    return float(mu), (mu - offset) * inv


def _partition_valid(
    model: ClusterPerfModel,
    batches: np.ndarray,
    compute_mask: np.ndarray,
) -> bool:
    """The hypothesized overlap state must match the realized one, and all
    batches must be physically valid (>= 0)."""
    if batches.min() < 0:
        return False
    return bool(np.array_equal(model.compute_bottleneck_mask(batches), compute_mask))


# ---------------------------------------------------------------------------
# Algorithm 1 — paper-faithful (scalar cross-check oracle)
# ---------------------------------------------------------------------------


def solve_optperf_algorithm1(
    model: ClusterPerfModel,
    total_batch: float,
    *,
    boundary_hint: Optional[int] = None,
) -> OptPerfSolution:
    """Paper Algorithm 1: overlap-state determination + OptPerf configuration.

    ``boundary_hint`` seeds the mixed-case search with the boundary found for a
    neighbouring total batch size (§4.5 "Overlap state searching"): candidates
    are probed outward from the hint, which makes the epoch-over-epoch resolve
    O(1) boundary probes in the common case.
    """
    if total_batch <= 0:
        raise ValueError("total batch must be positive")
    model.validate()
    n = model.n
    t_u = model.comm.t_u

    # ---- Check 1: all nodes compute-bottleneck --------------------------
    # The paper's linear solves do not enforce b_i >= 0; with small total
    # batches a hopeless straggler can be assigned a negative batch.  Any
    # negative assignment invalidates the closed form and we fall through
    # to the clamped water-fill oracle (beyond-paper robustness; recorded
    # in EXPERIMENTS.md).
    mu_c, batches_c = _solve_equal_compute(model, total_batch)
    mask_c = model.compute_bottleneck_mask(batches_c)
    if batches_c.min() >= 0 and mask_c.all():
        return OptPerfSolution(
            total_batch=total_batch,
            opt_perf=mu_c + t_u,
            batches=tuple(float(b) for b in batches_c),
            bottleneck=("compute",) * n,
            method="algorithm1/check1",
        )

    # ---- Check 2: all nodes communication-bottleneck --------------------
    mu_s, batches_s = _solve_equal_syncstart(model, total_batch)
    mask_s = model.compute_bottleneck_mask(batches_s)
    if batches_s.min() >= 0 and not mask_s.any():
        return OptPerfSolution(
            total_batch=total_batch,
            opt_perf=mu_s + model.comm.t_comm,
            batches=tuple(float(b) for b in batches_s),
            bottleneck=("comm",) * n,
            method="algorithm1/check2",
        )

    # ---- Mixed bottleneck ------------------------------------------------
    # Nodes that are compute-bound under BOTH checks are certainly compute-
    # bound at the optimum; likewise for comm-bound.  The remaining
    # "outliers" are ordered and a boundary is binary-searched (§4.2).
    certain_compute = mask_c & mask_s
    certain_comm = ~mask_c & ~mask_s
    outliers = np.flatnonzero(~certain_compute & ~certain_comm)

    # Rank outliers by fixed processing time (the batch-independent part of
    # the node time); larger fixed time => more likely comm-bottleneck.
    fixed_times = model.coeffs.ds + model.comm.t_comm
    outliers = outliers[np.argsort(fixed_times[outliers], kind="stable")]

    def split_mask(split: int) -> np.ndarray:
        mask = certain_compute.copy()
        mask[outliers[:split]] = True
        return mask

    def try_boundary(split: int) -> Optional[Tuple[float, np.ndarray, np.ndarray]]:
        mask = split_mask(split)
        mu, batches = _solve_mixed(model, total_batch, mask)
        if _partition_valid(model, batches, mask):
            return mu, batches, mask
        return None

    # Probe order: hint (if any) first, then binary search, then exhaustive
    # fallback (robustness beyond the paper; n is small so this is cheap).
    candidates: List[int] = []
    if boundary_hint is not None:
        candidates.append(max(0, min(len(outliers), boundary_hint)))
    lo, hi = 0, len(outliers)
    while lo <= hi:
        mid = (lo + hi) // 2
        candidates.append(mid)
        # Direction: if solving with `mid` makes some hypothesized comm node
        # actually compute-bound, we put too few nodes on the compute side.
        mask = split_mask(mid)
        mu, batches = _solve_mixed(model, total_batch, mask)
        realized = model.compute_bottleneck_mask(batches)
        too_few_compute = bool(np.any(realized & ~mask))
        if too_few_compute:
            lo = mid + 1
        else:
            hi = mid - 1
    candidates.extend(range(len(outliers) + 1))

    seen = set()
    for split in candidates:
        if split in seen:
            continue
        seen.add(split)
        result = try_boundary(split)
        if result is None:
            continue
        mu, batches, mask = result
        return OptPerfSolution(
            total_batch=total_batch,
            opt_perf=mu + t_u,
            batches=tuple(float(b) for b in batches),
            bottleneck=tuple("compute" if c else "comm" for c in mask),
            method=f"algorithm1/mixed(split={split})",
        )

    # No consistent partition (can happen when the unconstrained solve drives
    # some b_i < 0): fall back to the clamped water-fill oracle.
    return solve_optperf_waterfill(model, total_batch)


def solve_optperf_algorithm1_batch(
    model: ClusterPerfModel,
    total_batches: Sequence[float],
    *,
    boundary_hint: Optional[int] = None,
) -> List[OptPerfSolution]:
    """Algorithm 1 over a whole candidate vector, closed forms vectorized.

    The batched ``boundary_hint`` analogue: Check 1 and Check 2 — the two
    closed-form boundary checks that resolve the overwhelming majority of a
    goodput sweep's candidates — are evaluated for *all* candidates in one
    array pass (the per-candidate scalar arithmetic is reproduced exactly:
    the reduction constants ``K = sum(offset/slope)`` and ``S = sum(1/slope)``
    are computed once and each candidate's ``mu = (B + K)/S`` and
    ``b = (mu - offset)/slope`` use the identical float operations, so every
    row is bit-equal to :func:`solve_optperf_algorithm1` on that candidate).
    Only the candidates both checks reject fall back to the scalar mixed-case
    search, chained through §4.5 boundary hints exactly like the scalar
    sweep: each candidate (closed-form or mixed) updates the hint for the
    next with its compute-node count.

    The scalar path stays the bit-exactness oracle — a seeded equivalence
    test pins ``solution_batch[i] == solution_scalar[i]`` field-for-field.
    """
    totals = [float(b) for b in total_batches]
    if any(b <= 0 for b in totals):
        raise ValueError("total batch must be positive")
    model.validate()
    n = model.n
    c = model.coeffs
    t_u = model.comm.t_u
    t_comm = model.comm.t_comm
    totals_arr = np.asarray(totals, dtype=np.float64)

    # Check 1 for every candidate: the scalar path computes
    # mu = (B + (cs*inv).sum()) / inv.sum() with inv = 1/alphas; hoisting the
    # two reductions out of the candidate loop leaves per-candidate work at
    # exactly one add, one divide, and one (mu - cs)*inv row — the same float
    # ops, now broadcast.
    inv_c = 1.0 / c.alphas
    k_c = (c.cs * inv_c).sum()
    s_c = inv_c.sum()
    mus_c = (totals_arr + k_c) / s_c
    batches_c = (mus_c[:, None] - c.cs) * inv_c
    mask_c = model.compute_bottleneck_mask(batches_c)
    ok_c = (batches_c.min(axis=1) >= 0) & mask_c.all(axis=1)

    # Check 2, identically vectorized.
    inv_s = 1.0 / c.betas
    k_s = (c.ds * inv_s).sum()
    s_s = inv_s.sum()
    mus_s = (totals_arr + k_s) / s_s
    batches_s = (mus_s[:, None] - c.ds) * inv_s
    mask_s = model.compute_bottleneck_mask(batches_s)
    ok_s = (batches_s.min(axis=1) >= 0) & (~mask_s.any(axis=1))

    solutions: List[OptPerfSolution] = []
    hint = boundary_hint
    for j, total in enumerate(totals):
        if ok_c[j]:
            sol = OptPerfSolution(
                total_batch=total,
                opt_perf=float(mus_c[j]) + t_u,
                batches=tuple(float(b) for b in batches_c[j]),
                bottleneck=("compute",) * n,
                method="algorithm1/check1",
            )
        elif ok_s[j]:
            sol = OptPerfSolution(
                total_batch=total,
                opt_perf=float(mus_s[j]) + t_comm,
                batches=tuple(float(b) for b in batches_s[j]),
                bottleneck=("comm",) * n,
                method="algorithm1/check2",
            )
        else:
            sol = solve_optperf_algorithm1(model, total, boundary_hint=hint)
        solutions.append(sol)
        # §4.5 hint chaining, identical to the scalar sweep: every candidate
        # (closed-form rows included) reseeds the next mixed search.
        hint = sum(1 for s in sol.bottleneck if s == "compute")
    return solutions


# ---------------------------------------------------------------------------
# Batched water-fill bisection — the array engine
# ---------------------------------------------------------------------------
#
# A _Problem is the engine's uniform array view of either
#   * one ClusterPerfModel shared by all C candidates (coeffs (n,), comm
#     scalars, mask None — NumPy broadcasting does the (C, n) lift), or
#   * a StackedClusterModel of C independent rows (coeffs (C, n), comm
#     (C, 1), boolean mask for padding slots).
# Every solver below (cold bisection, warm-start Newton, finalization, the
# on-device port in optperf_jax) is written against this view, so the
# single-model and stacked paths can never drift numerically.


class _Problem(NamedTuple):
    alphas: np.ndarray            # (n,) or (C, n)
    cs: np.ndarray
    betas: np.ndarray
    ds: np.ndarray
    ks: np.ndarray
    ms: np.ndarray
    t_o: Union[float, np.ndarray]     # scalar or (C, 1)
    t_u: Union[float, np.ndarray]
    t_comm: Union[float, np.ndarray]
    gamma: Union[float, np.ndarray]
    mask: Optional[np.ndarray]        # None (all valid) or (C, n) bool
    # t-independent precomputes, hoisted out of the per-iteration evals:
    safe_betas: np.ndarray            # betas with 1.0 at degenerate slots
    degenerate: np.ndarray            # betas <= 0 (syncStart flat in b)
    any_degenerate: bool
    inv_alphas: np.ndarray            # Newton slope ingredients
    inv_betas: np.ndarray             # 0 at degenerate slots


def _make_problem(alphas, cs, betas, ds, ks, ms, t_o, t_u, t_comm, gamma, mask):
    degenerate = betas <= 0.0
    safe_betas = np.where(degenerate, 1.0, betas)
    return _Problem(
        alphas=alphas, cs=cs, betas=betas, ds=ds, ks=ks, ms=ms,
        t_o=t_o, t_u=t_u, t_comm=t_comm, gamma=gamma, mask=mask,
        safe_betas=safe_betas,
        degenerate=degenerate,
        any_degenerate=bool(degenerate.any()),
        inv_alphas=1.0 / alphas,
        inv_betas=np.where(degenerate, 0.0, 1.0 / safe_betas),
    )


def _problem_from_model(model: ClusterPerfModel) -> Tuple[_Problem, float]:
    """(problem view, lo0) — memoized on the frozen model like ``coeffs``,
    so per-epoch re-solves pay the precompute once."""
    cached = model.__dict__.get("_optperf_problem")
    if cached is None:
        c = model.coeffs
        comm = model.comm
        p = _make_problem(
            c.alphas, c.cs, c.betas, c.ds, c.ks, c.ms,
            comm.t_o, comm.t_u, comm.t_comm, comm.gamma, None,
        )
        cached = (p, _p_lo0(p))
        model.__dict__["_optperf_problem"] = cached
    return cached


def _problem_from_stack(stack: StackedClusterModel) -> Tuple[_Problem, np.ndarray]:
    """(problem view, per-row lo0) — memoized on the stack instance exactly
    like :func:`_problem_from_model`.  Stacks must be treated as immutable
    once solved (mutating their arrays in place would leave the cached
    derived arrays — ``safe_betas``/``inv_alphas``/… — stale)."""
    cached = stack.__dict__.get("_optperf_problem")
    if cached is None:
        col = lambda v: v[:, None]  # noqa: E731 — broadcast against (C, n)
        p = _make_problem(
            stack.alphas, stack.cs, stack.betas, stack.ds, stack.ks, stack.ms,
            col(stack.t_o), col(stack.t_u), col(stack.t_comm), col(stack.gamma),
            stack.mask,
        )
        cached = (p, _p_lo0(p))
        stack.__dict__["_optperf_problem"] = cached
    return cached


def _p_lo0(p: _Problem) -> Union[float, np.ndarray]:
    """Per-problem lower time bound: below the smallest fixed node time no
    node can take positive batch, so assigned(lo0) == 0 < B always."""
    fixed = np.minimum(p.cs + p.t_u, p.ds + p.t_comm)
    if p.mask is not None:
        fixed = np.where(p.mask, fixed, np.inf)
    out = fixed.min(axis=-1)
    return float(out) if np.ndim(out) == 0 else out


def _p_feasible(
    p: _Problem, ts: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Shared feasible-batch kernel: (b, b_compute, b_comm).

    Every consumer (bracketing, bisection, Newton, finalization) goes through
    this single expression, so recomputing feasible batches at an emitted
    t_star is *bit-identical* to the evaluation that certified it — the
    upper-bracket invariant in :func:`_finalize_batches` depends on that.
    """
    t = np.asarray(ts, dtype=np.float64)[..., None]
    b_compute = (t - p.t_u - p.cs) / p.alphas
    slack = t - p.t_comm - p.ds
    b_comm = slack / p.safe_betas
    if p.any_degenerate:
        # A node whose syncStart does not grow with b (beta == 0, i.e.
        # q = gamma = 0) is never comm-constrained once t clears its fixed
        # comm time.
        b_comm = np.where(
            p.degenerate, np.where(slack >= 0.0, np.inf, -np.inf), b_comm
        )
    b = np.minimum(b_compute, b_comm)
    if p.mask is not None:
        b = np.where(p.mask, b, -np.inf)
    return b, b_compute, b_comm


def _p_best_single_node_time(p: _Problem, totals: np.ndarray) -> np.ndarray:
    """Upper bound on the optimum per row: the best *single* node processing
    the whole batch.  Mask-aware (padding slots are +inf, never the min), so
    the jax engines can clamp stale-high warm seeds on stacked problems too."""
    t = np.asarray(totals, dtype=np.float64)[..., None]
    nt = np.maximum(
        p.alphas * t + p.cs + p.t_u, p.betas * t + p.ds + p.t_comm
    )
    if p.mask is not None:
        nt = np.where(p.mask, nt, np.inf)
    return nt.min(axis=-1)


def _p_max_batches(p: _Problem, ts: np.ndarray) -> np.ndarray:
    """Largest feasible batch per node at cluster times ``ts``; shape
    ``(...,)`` -> ``(..., n)``.  Padding slots (mask False) are forced to
    -inf, i.e. contribute nothing."""
    return _p_feasible(p, ts)[0]


def _p_max_batches_and_slope(
    p: _Problem, ts: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """(feasible batches, d feasible/dT) — the Newton ingredients.

    The slope of min(b_compute, b_comm) is 1/alpha on the compute branch and
    1/beta on the comm branch (0 where beta is degenerate: that branch is a
    constant ±inf)."""
    b, b_compute, b_comm = _p_feasible(p, ts)
    slope = np.where(b_compute <= b_comm, p.inv_alphas, p.inv_betas)
    return b, slope


def _p_assigned(p: _Problem, ts: np.ndarray) -> np.ndarray:
    return np.maximum(_p_max_batches(p, ts), 0.0).sum(axis=-1)


def _p_rows(p: _Problem, rows: np.ndarray) -> _Problem:
    """Row-subset view of a stacked problem (single-model problems broadcast
    over candidates, so they are returned unchanged)."""
    if p.mask is None:
        return p
    take = lambda v: v[rows]  # noqa: E731
    return p._replace(
        alphas=take(p.alphas), cs=take(p.cs), betas=take(p.betas),
        ds=take(p.ds), ks=take(p.ks), ms=take(p.ms),
        t_o=take(p.t_o), t_u=take(p.t_u), t_comm=take(p.t_comm),
        gamma=take(p.gamma), mask=take(p.mask),
        safe_betas=take(p.safe_betas), degenerate=take(p.degenerate),
        inv_alphas=take(p.inv_alphas), inv_betas=take(p.inv_betas),
    )


def _p_node_times(p: _Problem, batches: np.ndarray) -> np.ndarray:
    """Per-node batch times (max form); padding slots get -inf so row maxima
    see only real nodes."""
    b = np.asarray(batches, dtype=np.float64)
    out = np.maximum(
        p.alphas * b + p.cs + p.t_u, p.betas * b + p.ds + p.t_comm
    )
    if p.mask is not None:
        out = np.where(p.mask, out, -np.inf)
    return out


def _p_compute_mask(p: _Problem, batches: np.ndarray) -> np.ndarray:
    """Overlap-state criterion (1-gamma) P_i >= T_o; padding slots False."""
    b = np.asarray(batches, dtype=np.float64)
    out = (1.0 - p.gamma) * (p.ks * b + p.ms) >= p.t_o
    if p.mask is not None:
        out = out & p.mask
    return out


def _grow_bracket(
    p: _Problem,
    totals: np.ndarray,
    lo0: Union[float, np.ndarray],
    hi: np.ndarray,
) -> Tuple[np.ndarray, int]:
    """Geometrically expand ``hi`` until assigned(hi) >= B on every row."""
    evals = 0
    for _ in range(64):
        short = _p_assigned(p, hi) < totals
        evals += 1
        if not short.any():
            return hi, evals
        hi = np.where(short, lo0 + (hi - lo0) * 2.0, hi)
    raise RuntimeError("water-fill failed to bracket optimum")


def _bisect(
    p: _Problem,
    totals: np.ndarray,
    lo: np.ndarray,
    hi: np.ndarray,
    *,
    tol: float,
    max_iter: int,
    freeze: bool = False,
) -> Tuple[np.ndarray, int]:
    """Standard simultaneous bisection; returns (t_star = hi, eval count).
    The upper-bracket invariant assigned(hi) >= B holds throughout: hi only
    ever moves to midpoints verified >= B.

    ``freeze=True`` stops updating a row once *it* has converged instead of
    halving it until every row converges.  Each frozen row then traces
    exactly the (lo, hi) sequence a solo single-row solve of that row would
    — the bit-identity contract of :func:`solve_optperf_waterfill_subsets`
    rests on this.  The default (shared halving) is kept for the engines
    whose emitted t_stars existing callers already depend on.
    """
    evals = 0
    for _ in range(max_iter):
        done = hi - lo <= tol * np.maximum(1.0, np.abs(hi))
        if done.all():
            break
        mid = 0.5 * (lo + hi)
        ge = _p_assigned(p, mid) >= totals
        evals += 1
        if freeze:
            hi = np.where(~done & ge, mid, hi)
            lo = np.where(~done & ~ge, mid, lo)
        else:
            hi = np.where(ge, mid, hi)
            lo = np.where(ge, lo, mid)
    return hi, evals


_WARM_NEWTON_ITER = 16


def _warm_refine(
    p: _Problem,
    totals: np.ndarray,
    lo0: Union[float, np.ndarray],
    warm_start: np.ndarray,
    *,
    tol: float,
) -> Tuple[np.ndarray, np.ndarray, int, np.ndarray, Optional[np.ndarray]]:
    """Safeguarded-Newton refinement from a previous t_star vector.

    g(T) = Sum_i max(b_i(T), 0) is monotone piecewise-affine, so inside one
    affine segment a single Newton step is exact — under small perf-model
    drift the active set is unchanged and the solve needs ~2-3 array passes.
    Every iterate also updates a certified [lo, hi] bracket (any evaluated t
    with g >= B is an upper bound, g < B a lower bound), and proposals
    leaving the bracket fall back to its midpoint (or geometric growth while
    no upper bound is known), so arbitrary warm starts remain correct.

    Returns (lo, hi, evals, t_last, raw_last): the brackets ready for
    :func:`_bisect` (which exits immediately on already-converged rows) plus
    the final evaluation point and its feasible-batch matrix — when
    ``t_star == t_last`` finalization reuses ``raw_last`` instead of paying
    another array pass.
    """
    w = np.asarray(warm_start, dtype=np.float64)
    if w.shape != totals.shape:
        raise ValueError("warm_start shape must match total_batches")
    lo = np.broadcast_to(np.asarray(lo0, dtype=np.float64), totals.shape).copy()
    hi = np.full(totals.shape, np.inf)
    usable = np.isfinite(w) & (w > lo)
    t = np.where(usable, w, lo + 1.0)
    close_rel = max(tol, 1e-14)
    evals = 0
    raw = None
    for _ in range(_WARM_NEWTON_ITER):
        raw, slope_elem = _p_max_batches_and_slope(p, t)
        evals += 1
        g = np.maximum(raw, 0.0).sum(axis=-1)
        ge = g >= totals
        hi = np.where(ge, np.minimum(hi, t), hi)
        lo = np.where(~ge, np.maximum(lo, t), lo)
        # Residual acceptance: an evaluated point whose residual is within
        # tolerance IS the answer (|t - t*| <= tol*B/slope <= tol*t* since g
        # passes through ~B*t/t*); collapse the bracket onto it so the
        # trailing bisection skips the row.  Acceptance works from *either*
        # side — finalization turns a tol-sized deficit into a proportional
        # inflation the same way it removes overshoot.  Width-based
        # convergence alone never fires here: Newton lands *on* the root
        # instead of squeezing a bracket around it.
        close = np.abs(g - totals) <= close_rel * totals
        lo = np.where(close, t, lo)
        hi = np.where(close, t, hi)
        done = np.isfinite(hi) & (hi - lo <= tol * np.maximum(1.0, np.abs(hi)))
        if done.all():
            break
        slope = np.where(raw > 0.0, slope_elem, 0.0).sum(axis=-1)
        ok = slope > 0.0
        t_newton = t - (g - totals) / np.where(ok, slope, 1.0)
        # A float-stuck proposal (residual below one step of representable
        # progress) gets a tol-sized upward bump: the next evaluation then
        # certifies it as an exact upper point.
        t_newton = np.where(
            (t_newton == t) & ~done, t * (1.0 + close_rel) + 1e-300, t_newton
        )
        # Safeguard: the proposal must fall strictly inside the certified
        # bracket; otherwise bisect it (or keep growing while unbounded).
        bounded = np.isfinite(hi)
        fallback = np.where(bounded, 0.5 * (lo + hi), lo0 + (lo - lo0) * 2.0 + 1.0)
        bad = ~ok | ~(t_newton > lo) | ~(t_newton < hi)
        t = np.where(done, t, np.where(bad, fallback, t_newton))
    # Rows still unbounded above (warm start far below the new optimum and
    # Newton ran out of iterations) get the cold geometric growth.
    missing = ~np.isfinite(hi)
    if missing.any():
        seed = np.where(missing, np.maximum(lo, lo0) + 1.0, hi)
        grown, grow_evals = _grow_bracket(p, totals, lo0, seed)
        evals += grow_evals
        hi = np.where(missing, grown, hi)
        raw = None  # t no longer matches the last evaluation
    return lo, hi, evals, t, raw


def _finalize_batches(
    p: _Problem,
    totals: np.ndarray,
    t_star: np.ndarray,
    *,
    tol: float,
    raw: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Turn the bisected time bounds into exact-sum batch vectors.

    Returns ``(batches, node_times)`` — the realized per-node times fall out
    of the internal bound check, so callers reuse them for ``opt_perfs``
    instead of paying another array pass.  ``raw`` may carry a feasible-batch
    matrix already evaluated *at* ``t_star`` (warm solves end on one); it
    must be the output of :func:`_p_max_batches` at exactly ``t_star``.

    Bisection leaves Sum_i max(b_i(t_star), 0) >= B (up to float residue);
    warm Newton acceptance may instead leave a deficit of at most ~tol*B.
    Either way the residual is removed *proportionally over the positive
    (binding) nodes* — shrinking keeps every touched node under its time
    bound, and the tol-sized inflation of the deficit case stays inside the
    bound tolerance below.  (A whole-vector rescale would be wrong: it could
    inflate a binding node past ``t_star`` whenever float residue left the
    sum a hair under B.)  Clamped nodes (b=0, fixed time already at/above
    ``t_star``) are never touched.
    """
    if raw is None:
        raw = _p_max_batches(p, t_star)                 # (..., n)
    batches = np.maximum(raw, 0.0)
    sums = batches.sum(axis=-1)
    # Invariant: the solvers only emit t_star values verified (by the
    # identical expression) to overshoot, or to undershoot by at most the
    # residual-acceptance tolerance.  Anything worse is a bracket-logic bug.
    if not bool(np.all(totals - sums <= 4.0 * max(tol, 1e-14) * totals)):
        raise AssertionError("water-fill bisection lost its upper-bracket invariant")
    pos_sums = np.where(sums > 0.0, sums, 1.0)
    off = sums != totals
    if np.any(off):
        # Proportional rescale over positive nodes; factor <= 1 for
        # overshoot, <= 1 + O(tol) for the warm-acceptance deficit.
        factor = np.where(off, totals / pos_sums, 1.0)
        batches = batches * factor[..., None]
    # Internal consistency: no positive node may exceed its bisected time
    # bound (clamped stragglers sit at their fixed floor, which can lie above
    # t_star and is unavoidable at any partition).
    node_times = _p_node_times(p, batches)
    positive = batches > 0.0
    bound = t_star[..., None] * (1.0 + max(tol * 16.0, 1e-8)) + 1e-12
    if not bool(np.all(np.where(positive, node_times, -np.inf) <= bound)):
        raise AssertionError("water-fill finalization exceeded the bisected time bound")
    return batches, node_times


def _solve_problem(
    p: _Problem,
    lo0: Union[float, np.ndarray],
    totals: np.ndarray,
    *,
    tol: float,
    max_iter: int,
    warm_start: Optional[np.ndarray],
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, int]:
    """Shared engine body: bracket (cold or warm), bisect, finalize.

    Returns (t_star, batches, opt_perfs, compute_mask, evals)."""
    raw_last = None
    if warm_start is None:
        lo = np.broadcast_to(np.asarray(lo0, dtype=np.float64), totals.shape).copy()
        hi, evals = _grow_bracket(p, totals, lo0, lo + 1.0)
    else:
        lo, hi, evals, t_last, raw_last = _warm_refine(
            p, totals, lo0, warm_start, tol=tol
        )
    t_star, bisect_evals = _bisect(p, totals, lo, hi, tol=tol, max_iter=max_iter)
    evals += bisect_evals
    # Warm solves typically end with (almost) every row accepted at its final
    # evaluation point — finalization then reuses that feasible-batch matrix.
    # The few rows that converged by bracket width instead (t_star = an older
    # upper point) get a cheap subset re-evaluation.
    reuse = None
    if raw_last is not None and bisect_evals == 0:
        mismatch = t_star != t_last
        n_mismatch = int(np.count_nonzero(mismatch))
        if n_mismatch == 0:
            reuse = raw_last
        elif n_mismatch <= max(4, totals.shape[0] // 8):
            reuse = raw_last.copy()
            reuse[mismatch] = _p_max_batches(
                _p_rows(p, mismatch), t_star[mismatch]
            )
    batches, node_times = _finalize_batches(p, totals, t_star, tol=tol, raw=reuse)
    opt_perfs = node_times.max(axis=-1)
    compute_mask = _p_compute_mask(p, batches)
    return t_star, batches, opt_perfs, compute_mask, evals


def _validated_totals(total_batches: Sequence[float]) -> np.ndarray:
    totals = np.array(total_batches, dtype=np.float64)  # copy: no aliasing
    if totals.ndim != 1:
        raise ValueError("total_batches must be a 1-D sequence")
    if totals.size == 0:
        raise ValueError("total_batches must be non-empty")
    if np.any(totals <= 0):
        raise ValueError("total batch must be positive")
    return totals


def solve_optperf_batch(
    model: ClusterPerfModel,
    total_batches: Sequence[float],
    *,
    tol: float = 1e-10,
    max_iter: int = 200,
    warm_start: Optional[np.ndarray] = None,
) -> BatchedOptPerfSolution:
    """Solve OptPerf for every candidate total batch size in one array pass.

    All candidates are bisected *simultaneously*: the bracket state is a
    ``(C,)`` vector and each iteration evaluates one ``(C, n)`` feasible-batch
    broadcast, so the whole sweep is ~``max_iter`` NumPy ops regardless of C.

    Monotonicity argument (per candidate, same as the scalar water-fill):
    each node's feasible batch b_i(T) is affine increasing in T, so
    g(T) = Sum_i max(b_i(T), 0) is continuous, nondecreasing, and unbounded;
    bisection on g(T) = B converges geometrically.

    ``warm_start``: previous ``t_stars`` vector (aligned with
    ``total_batches``); enables the safeguarded-Newton incremental re-solve
    (see module docstring).  The answer is identical with or without it.
    """
    totals = _validated_totals(total_batches)
    model.validate()
    p, lo0 = _problem_from_model(model)
    t_star, batches, opt_perfs, compute_mask, evals = _solve_problem(
        p, lo0, totals, tol=tol, max_iter=max_iter, warm_start=warm_start
    )
    for arr in (totals, t_star, opt_perfs, batches, compute_mask):
        arr.flags.writeable = False
    return BatchedOptPerfSolution(
        total_batches=totals,
        opt_perfs=opt_perfs,
        batches=batches,
        compute_mask=compute_mask,
        method="waterfill/batched" if warm_start is None else "waterfill/batched+warm",
        t_stars=t_star,
        iterations=evals,
    )


def solve_optperf_stacked(
    stack: StackedClusterModel,
    total_batches: Sequence[float],
    *,
    tol: float = 1e-10,
    max_iter: int = 200,
    warm_start: Optional[np.ndarray] = None,
) -> BatchedOptPerfSolution:
    """Water-fill C *independent* problem rows simultaneously.

    Each row of the :class:`StackedClusterModel` is its own cluster (node
    subset + comm model) with its own total batch ``total_batches[r]``; all
    rows share the bisection loop, so a whole scheduler round costs the same
    ~50 array passes as a single solve.  Padding slots never receive batch
    and never contribute to row times."""
    totals = _validated_totals(total_batches)
    if totals.shape[0] != stack.shape[0]:
        raise ValueError("total_batches length must match stack rows")
    stack.validate()
    p, lo0 = _problem_from_stack(stack)
    t_star, batches, opt_perfs, compute_mask, evals = _solve_problem(
        p, lo0, totals, tol=tol, max_iter=max_iter, warm_start=warm_start
    )
    for arr in (totals, t_star, opt_perfs, batches, compute_mask):
        arr.flags.writeable = False
    return BatchedOptPerfSolution(
        total_batches=totals,
        opt_perfs=opt_perfs,
        batches=batches,
        compute_mask=compute_mask,
        method="waterfill/stacked",
        t_stars=t_star,
        iterations=evals,
        node_mask=stack.mask,
    )


def solve_optperf_waterfill(
    model: ClusterPerfModel,
    total_batch: float,
    *,
    tol: float = 1e-10,
    max_iter: int = 200,
) -> OptPerfSolution:
    """Exact OptPerf via bisection on the cluster batch time T.

    Single-candidate specialization of :func:`solve_optperf_batch` (identical
    numerics, so the scalar oracle and the batched engine can never drift).
    """
    batch = solve_optperf_batch(
        model, np.asarray([total_batch], dtype=np.float64), tol=tol, max_iter=max_iter
    )
    return batch.solution(0, method="waterfill")


def solve_optperf_waterfill_subset(
    model: ClusterPerfModel,
    node_ids: Sequence[int],
    total_batch: float,
    *,
    tol: float = 1e-10,
    max_iter: int = 200,
) -> OptPerfSolution:
    """Water-fill over a *node subset* of ``model``.

    Bit-identical to building the subset :class:`ClusterPerfModel` and
    calling :func:`solve_optperf_waterfill` — the per-node coefficients are
    elementwise, so gathering rows of the full model's cached ``coeffs``
    yields the exact same floats — but without the per-call model
    construction and re-validation.  This is the multi-job scheduler's
    chosen-set re-solve in a loop (one call per greedy round), where the
    construction overhead dominated the solve.
    """
    if total_batch <= 0:
        raise ValueError("total batch must be positive")
    ids = np.asarray(node_ids, dtype=np.intp)
    if ids.size == 0:
        raise ValueError("need at least one node")
    comm = model.comm
    comm.validate()
    p = _make_problem(
        *_subset_problem_row(model, ids),
        comm.t_o, comm.t_u, comm.t_comm, comm.gamma, None,
    )
    totals = np.asarray([float(total_batch)])
    t_star, batches, opt_perfs, compute_mask, _ = _solve_problem(
        p, _p_lo0(p), totals, tol=tol, max_iter=max_iter, warm_start=None
    )
    return OptPerfSolution(
        total_batch=float(total_batch),
        opt_perf=float(opt_perfs[0]),
        batches=tuple(float(b) for b in batches[0]),
        bottleneck=tuple("compute" if m else "comm" for m in compute_mask[0]),
        method="waterfill",
    )


def _subset_problem_row(
    model: ClusterPerfModel, ids: np.ndarray
) -> Tuple[np.ndarray, ...]:
    """Gathered (alphas, cs, betas, ds, ks, ms) rows for one node subset —
    THE shared gather+validation behind the solo and stacked subset solvers
    (comm is validated by the caller, once per distinct model).

    Validation applies the same vectorized k > 0, q >= 0 semantics as
    ``ClusterPerfModel.validate`` to the subset only: a bad node outside
    the subset must not reject an otherwise valid sub-cluster — and vice
    versa."""
    c = model.coeffs
    ks = c.ks[ids]
    alphas = c.alphas[ids]
    if not (bool(np.all(ks > 0)) and bool(np.all(alphas - ks >= 0))):
        raise ValueError("ill-posed node model")
    return alphas, c.cs[ids], c.betas[ids], c.ds[ids], ks, c.ms[ids]


def solve_optperf_waterfill_subsets(
    models: Sequence[ClusterPerfModel],
    node_id_sets: Sequence[Sequence[int]],
    total_batches: Sequence[float],
    *,
    tol: float = 1e-10,
    max_iter: int = 200,
) -> List[OptPerfSolution]:
    """Batch of :func:`solve_optperf_waterfill_subset` calls as stacked
    array solves — **bit-identical** to the scalar per-subset loop.

    ``models[r]`` / ``node_id_sets[r]`` / ``total_batches[r]`` describe row
    ``r`` (models may repeat; each row carries its model's own comm model as
    a per-row column).  Rows are grouped by subset size and each group is
    solved as one stacked water-fill — *without padding*, so every row's
    feasible-batch reductions see exactly the floats the solo solve sees,
    and with per-row frozen bisection (see :func:`_bisect`), so every row
    traces the solo solve's bracket sequence exactly.  This is the
    scheduler's chosen-set re-solve path: one stacked call per distinct
    chosen-set size per ``allocate`` instead of one scalar solve per greedy
    round, with the oracle-parity contract preserved bit-for-bit.

    Raises :class:`ValueError` on any ill-posed row, exactly like the
    scalar subset solver does for that row.
    """
    rows = len(node_id_sets)
    if not (len(models) == rows == len(total_batches)):
        raise ValueError("models, node_id_sets, total_batches length mismatch")
    out: List[Optional[OptPerfSolution]] = [None] * rows
    validated = set()
    groups: dict = {}
    for r in range(rows):
        ids = np.asarray(node_id_sets[r], dtype=np.intp)
        if ids.size == 0:
            raise ValueError("need at least one node")
        if float(total_batches[r]) <= 0:
            raise ValueError("total batch must be positive")
        if id(models[r].comm) not in validated:
            models[r].comm.validate()
            validated.add(id(models[r].comm))
        groups.setdefault(int(ids.size), []).append((r, ids))
    for m, members in groups.items():
        g = len(members)
        coeff_rows = [_subset_problem_row(models[r], ids) for r, ids in members]
        stacked = [np.stack([cr[i] for cr in coeff_rows]) for i in range(6)]
        col = lambda vals: np.asarray(vals, dtype=np.float64)[:, None]  # noqa: E731
        comms = [models[r].comm for r, _ in members]
        p = _make_problem(
            *stacked,
            col([cm.t_o for cm in comms]),
            col([cm.t_u for cm in comms]),
            col([cm.t_comm for cm in comms]),
            col([cm.gamma for cm in comms]),
            None,
        )
        totals = np.asarray([float(total_batches[r]) for r, _ in members])
        lo0 = _p_lo0(p)
        lo = np.broadcast_to(np.asarray(lo0, dtype=np.float64), totals.shape).copy()
        hi, _ = _grow_bracket(p, totals, lo0, lo + 1.0)
        t_star, _ = _bisect(p, totals, lo, hi, tol=tol, max_iter=max_iter, freeze=True)
        batches, node_times = _finalize_batches(p, totals, t_star, tol=tol)
        opt_perfs = node_times.max(axis=-1)
        compute_mask = _p_compute_mask(p, batches)
        for gi, (r, _) in enumerate(members):
            out[r] = OptPerfSolution(
                total_batch=float(totals[gi]),
                opt_perf=float(opt_perfs[gi]),
                batches=tuple(float(b) for b in batches[gi]),
                bottleneck=tuple(
                    "compute" if mk else "comm" for mk in compute_mask[gi]
                ),
                method="waterfill",
            )
    assert all(s is not None for s in out)
    return out  # type: ignore[return-value]


def solve_optperf(
    model: ClusterPerfModel,
    total_batch: float,
    *,
    method: str = "algorithm1",
    boundary_hint: Optional[int] = None,
) -> OptPerfSolution:
    """Dispatch helper. ``method`` in {"algorithm1", "waterfill"}."""
    if method == "algorithm1":
        return solve_optperf_algorithm1(model, total_batch, boundary_hint=boundary_hint)
    if method == "waterfill":
        return solve_optperf_waterfill(model, total_batch)
    raise ValueError(f"unknown method {method!r}")


# ---------------------------------------------------------------------------
# Integer rounding (§4.5 "Integer batch sizes")
# ---------------------------------------------------------------------------


def round_batches(batches: Sequence[float], total_batch: int) -> List[int]:
    """Round real batches to integers summing exactly to ``total_batch``.

    The paper rounds and accepts the (insignificant) error; we use
    largest-remainder rounding so the sum constraint holds exactly and the
    rounding error per node is < 1 sample.  When float residue leaves the
    real batches summing a hair *above* ``total_batch`` (so the floors
    already overshoot), the deficit is taken from the entries with the
    smallest fractional parts instead of raising; overshoot of a sample per
    node or more still raises (that is a wrong-total caller bug).
    """
    if total_batch != int(total_batch):
        raise ValueError("total batch must be an integer")
    floors = [int(math.floor(b)) for b in batches]
    remainder = int(total_batch) - sum(floors)
    out = list(floors)
    if remainder < 0:
        if sum(batches) - total_batch >= len(batches):
            # Overshoot of a sample per node or more is a caller bug (a
            # partition computed for a different total), not float residue.
            raise ValueError("batches sum above total")
        # Decrement the smallest fractional parts (they lose the least mass),
        # skipping entries already at zero; raise only when the total is
        # unreachable even with every batch driven to zero.
        order = sorted(range(len(batches)), key=lambda i: batches[i] - floors[i])
        need = -remainder
        while need:
            progressed = False
            for i in order:
                if out[i] > 0:
                    out[i] -= 1
                    need -= 1
                    progressed = True
                    if need == 0:
                        break
            if not progressed:
                raise ValueError("batches sum above total")
        return out
    # Assign leftover samples to the largest fractional parts.
    fracs = sorted(
        range(len(batches)), key=lambda i: batches[i] - floors[i], reverse=True
    )
    for i in fracs[:remainder]:
        out[i] += 1
    return out
