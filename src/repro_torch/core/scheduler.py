"""Heterogeneity-aware multi-job scheduler (beyond-paper; the paper's §6
"Adapt to schedulers for heterogeneous clusters" future-work item).

Existing schedulers (Pollux, Optimus) allocate homogeneous slices per job;
Sia is heterogeneity-aware across jobs but keeps each job's allocation
homogeneous.  With Cannikin, a job runs *optimally on any heterogeneous
subset* — its goodput for an arbitrary node set is computable from the
per-node performance models.  That turns scheduling into: partition the
cluster's (heterogeneous) nodes among jobs to maximize aggregate
goodput-fraction.

`allocate` uses greedy marginal-gain assignment (submodular-style):
repeatedly give the next node to the job whose *relative* goodput gains the
most from it.  Each job's goodput for a candidate node set comes from the
OptPerf solver over that subset — the same machinery the controller uses,
so scheduler decisions and runtime behaviour cannot diverge.

The array engines (``engine="batched"`` NumPy, ``engine="jax"`` on-device)
keep one *fixed-layout* stacked problem per allocation run: row
``ji * N + c`` is job ``ji``'s current node set plus candidate node ``c``,
padded to a power-of-two width.  Between greedy rounds only the winning
job's rows change (one appended node), so each round

  * re-solves exactly those N rows — one :func:`solve_optperf_stacked` /
    :func:`~repro_torch.core.optperf_torch.solve_optperf_stacked_jax` call —
  * **warm-started** from the same rows' previous ``t_stars`` (the problems
    differ by one appended node, so the safeguarded-Newton refinement
    certifies in a handful of array passes instead of ~50 cold bisections),
  * and reuses every other job's marginal goodputs unchanged (their sets
    and candidates did not move — the values are exact, not approximate).

``engine="scalar"`` keeps the original per-(job, node) loop as the
cross-check oracle; the final chosen sets are re-solved through the
*bit-identical* stacked subset solver (one
:func:`~repro_torch.core.optperf.solve_optperf_waterfill_subsets` call per
distinct set size per allocation run, replacing the old one-scalar-solve-
per-greedy-round serial tail), so emitted allocations carry
engine-identical numbers.

:class:`Scheduler` wraps the greedy core with *incremental re-allocation*:
``add_job``/``remove_job``/``update_job`` re-run the greedy loop but reuse
everything the arrival/departure did not touch — cached solo goodputs,
cached per-(job, node-set) marginal rows from the previous run (exact
hits while the greedy trajectory replays), and warm bracket seeds once it
diverges — so only the affected rows pay full solves.  ``update_job`` (the
per-epoch OLS refit path) invalidates that job's cached rows and the stack
device caches; see :meth:`~repro_torch.core.perf_model.StackedClusterModel.invalidate_device_cache`.

This is intentionally a library (allocation policy + simulation harness),
not a daemon: launch integration would wrap `allocate`/`Scheduler` in a
reconcile loop.

The counterpart of ``repro/core/scheduler.py``, copied verbatim but for the
``"jax"`` engine: here it is the stacked sweep of
:mod:`repro_torch.core.optperf_torch` on ``device`` (the card unless
``"cpu"`` is asked for), and where the reference falls back to NumPy when
JAX is missing, the port has nothing to fall back from: a failing device
solve raises.  The engine keeps the reference's name so that telemetry and
solution ``method`` strings compare equal.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch import resolve_device
from repro_torch.core import optperf_torch
from repro_torch.core.goodput import statistical_efficiency
from repro_torch.core.optperf import (
    solve_optperf_stacked,
    solve_optperf_waterfill_subset,
    solve_optperf_waterfill_subsets,
)
from repro_torch.core.perf_model import (
    ClusterPerfModel,
    CommModel,
    NodePerfModel,
    StackedClusterModel,
)

__all__ = [
    "JobSpec",
    "Allocation",
    "Scheduler",
    "allocate",
    "aggregate_goodput",
    "random_jobs",
]


@dataclasses.dataclass(frozen=True)
class JobSpec:
    """A job's statistical state + per-node performance models.

    ``node_models[i]`` is THIS job's fitted model for cluster node i (compute
    coefficients are job-dependent; §4.2).  ``comm`` is the job's fitted
    communication model.  ``backend`` names the execution engine the runtime
    drives the job's epochs through (``"sim"`` — timing simulator only, or
    ``"real"`` — real gradients via
    :class:`~repro_torch.runtime.backend.RealBackend`).  ``batch_policy`` names a
    registered :mod:`repro_torch.core.batch_policy` adaptation law for the job's
    controller (``None`` keeps the historical per-backend default: GNS-driven
    adaptive on ``"real"``, fixed-batch on ``"sim"``).
    """

    name: str
    node_models: Tuple[NodePerfModel, ...]   # indexed by cluster node id
    comm: CommModel
    total_batch: int
    b_noise: float
    ref_batch: int
    min_nodes: int = 1
    backend: str = "sim"
    batch_policy: Optional[str] = None

    @functools.cached_property
    def full_model(self) -> ClusterPerfModel:
        """This job's model over the whole cluster; its cached ``coeffs`` are
        the gather source for the batched scheduler rows."""
        return ClusterPerfModel(nodes=self.node_models, comm=self.comm)

    @functools.cached_property
    def efficiency(self) -> float:
        return statistical_efficiency(self.b_noise, self.total_batch, self.ref_batch)

    def goodput(self, node_ids: Sequence[int]) -> float:
        if len(node_ids) < self.min_nodes:
            return 0.0
        try:
            sol = solve_optperf_waterfill_subset(
                self.full_model, node_ids, self.total_batch
            )
        except (ValueError, RuntimeError):
            return 0.0
        thr = self.total_batch / sol.opt_perf
        return thr * self.efficiency

    def solo_goodput(self) -> float:
        """Goodput with the whole cluster — the normalizer for fairness."""
        return self.goodput(tuple(range(len(self.node_models))))


def _finite_sum(values: Iterable[float]) -> float:
    """Sum treating non-finite entries as 0.0 — an empty or zero-node
    allocation (or a garbage-fit job whose solo normalizer degenerated to
    NaN) must aggregate to 0.0, never poison the total with NaN."""
    return float(sum(v for v in values if math.isfinite(v)))


@dataclasses.dataclass(frozen=True)
class Allocation:
    assignment: Dict[str, Tuple[int, ...]]   # job -> node ids
    goodputs: Dict[str, float]
    fractions: Dict[str, float]              # goodput / solo goodput

    @property
    def aggregate_fraction(self) -> float:
        return _finite_sum(self.fractions.values())

    @property
    def aggregate_goodput(self) -> float:
        return _finite_sum(self.goodputs.values())


def _chosen_goodput_batch(
    pairs: Sequence[Tuple[JobSpec, Tuple[int, ...]]]
) -> List[float]:
    """:meth:`JobSpec.goodput` for many (job, chosen node set) pairs, solved
    as stacked subset water-fills — one
    :func:`~repro_torch.core.optperf.solve_optperf_waterfill_subsets` call per
    distinct set size instead of one scalar solve per pair.  Values are
    bit-identical to ``job.goodput(ids)`` (the stacked path freezes each
    row's bisection at its solo convergence point), so the oracle-parity
    contract on emitted goodputs is preserved exactly.  A degenerate row
    falls the whole batch back to the per-pair scalar path, which carries
    the graceful-0.0 semantics row by row."""
    values = [0.0] * len(pairs)
    models, sets, totals, idx = [], [], [], []
    for i, (job, ids) in enumerate(pairs):
        if len(ids) < job.min_nodes:
            continue
        models.append(job.full_model)
        sets.append(ids)
        totals.append(job.total_batch)
        idx.append(i)
    if not idx:
        return values
    try:
        sols = solve_optperf_waterfill_subsets(models, sets, totals)
    except (ValueError, RuntimeError):
        for i in idx:
            job, ids = pairs[i]
            values[i] = job.goodput(ids)
        return values
    for i, sol in zip(idx, sols):
        job = pairs[i][0]
        thr = job.total_batch / sol.opt_perf
        values[i] = thr * job.efficiency
    return values


def _stacked_solver(engine: str, device=None):
    """The stacked-row solver for an array engine: the on-device sweep on
    ``device`` (the card when None; raises without one) for
    ``engine == "jax"``, else the NumPy stacked engine."""
    if engine == "jax":
        return functools.partial(
            optperf_torch.solve_optperf_stacked_jax, device=resolve_device(device)
        )
    return solve_optperf_stacked


def _model_ok(job: JobSpec) -> bool:
    try:
        job.full_model.validate()
        return True
    except ValueError:
        return False


_INERT_FILL = (
    ("alphas", 1.0), ("cs", 0.0), ("betas", 1.0),
    ("ds", 0.0), ("ks", 1.0), ("ms", 0.0),
)


class _GreedyState:
    """Fixed-layout stacked-problem state for one array-engine run.

    Row ``ji * N + c`` is job ``ji``'s current node set (columns ``0..m-1``)
    plus candidate node ``c`` (column ``m``), padded to a power-of-two
    column capacity so the device engine sees a handful of shapes
    instead of one per round.  ``take`` updates exactly the winner's N rows
    in place (chosen node written into column ``m``, the candidate column
    moves to ``m+1``) and invalidates the cached device/solver views of the
    mutated block — the warm seeds (`t_stars`) and marginal goodputs of
    every other job carry over unchanged.
    """

    def __init__(self, jobs: Sequence[JobSpec], n_nodes: int, healthy: Sequence[bool]):
        self.jobs = list(jobs)
        self.healthy = list(healthy)
        self.n = n_nodes
        self.j = len(jobs)
        self.rows = self.j * n_nodes
        self.width = 1
        self.m = [0] * self.j
        self.assign: List[List[int]] = [[] for _ in jobs]
        self.goodputs = np.zeros((self.j, n_nodes))
        self.t_stars = np.full((self.j, n_nodes), np.nan)
        self.dirty = set(range(self.j))
        self.t_o = np.zeros(self.rows)
        self.t_u = np.zeros(self.rows)
        self.gamma = np.zeros(self.rows)
        self.totals = np.empty(self.rows)
        self._alloc_arrays()
        cand = np.arange(n_nodes, dtype=np.intp)
        for ji, job in enumerate(jobs):
            sl = self._block(ji)
            self.totals[sl] = job.total_batch
            if not self.healthy[ji]:
                # Garbage-fit job (bad node fit or bad comm model): inert
                # unit rows — mask True and zeroed comm keep the stack valid
                # — with goodput forced to 0, same as JobSpec.goodput's
                # graceful degradation.
                self.mask[sl, 0] = True
                continue
            self.t_o[sl] = job.comm.t_o
            self.t_u[sl] = job.comm.t_u
            self.gamma[sl] = job.comm.gamma
            co = job.full_model.coeffs
            for name, _ in _INERT_FILL:
                self.arrays[name][sl, 0] = getattr(co, name)[cand]
            self.mask[sl, 0] = True

    def _alloc_arrays(self) -> None:
        """(Re)allocate the width-dependent coefficient arrays (the row
        vectors — comm/totals — are width-independent and allocated once)."""
        self.arrays = {
            name: np.full((self.rows, self.width), fill) for name, fill in _INERT_FILL
        }
        self.mask = np.zeros((self.rows, self.width), dtype=bool)
        self._stacks: Dict[int, StackedClusterModel] = {}

    def _block(self, ji: int) -> slice:
        return slice(ji * self.n, (ji + 1) * self.n)

    def _grow(self) -> None:
        old, old_mask, w = self.arrays, self.mask, self.width
        self.width = w * 2
        self._alloc_arrays()
        for name in old:
            self.arrays[name][:, :w] = old[name]
        self.mask[:, :w] = old_mask

    def _stack_for(self, ji: int) -> StackedClusterModel:
        """Stacked view of one job block, cached per block so repeated
        solves of unchanged rows reuse the memoized `_Problem` view and the
        device export (``take`` invalidates the mutated block's)."""
        stack = self._stacks.get(ji)
        if stack is None:
            sl = self._block(ji)
            stack = StackedClusterModel(
                t_o=self.t_o[sl], t_u=self.t_u[sl], gamma=self.gamma[sl],
                mask=self.mask[sl],
                **{name: arr[sl] for name, arr in self.arrays.items()},
            )
            self._stacks[ji] = stack
        return stack

    def take(self, ji: int, node: int) -> None:
        """Append ``node`` to job ``ji``'s set, updating its rows in place."""
        m = self.m[ji]
        if m + 2 > self.width:
            self._grow()
        self.assign[ji].append(node)
        self.m[ji] = m + 1
        self.dirty.add(ji)
        if self.healthy[ji]:
            sl = self._block(ji)
            co = self.jobs[ji].full_model.coeffs
            cand = np.arange(self.n, dtype=np.intp)
            for name, _ in _INERT_FILL:
                arr = self.arrays[name]
                arr[sl, m] = getattr(co, name)[node]
                arr[sl, m + 1] = getattr(co, name)[cand]
            self.mask[sl, m + 1] = True
            # The block's arrays changed under any cached views: the memoized
            # `_Problem` derived arrays and the device export are stale.
            stack = self._stacks.get(ji)
            if stack is not None:
                stack.invalidate_device_cache()
                # The new columns are gathers from this job's already-
                # validated full model, so the validity memo may be kept —
                # re-validating every round is pure overhead.
                stack.__dict__["_validated"] = True

    def _viable(self, ji: int) -> bool:
        return self.healthy[ji] and (self.m[ji] + 1) >= self.jobs[ji].min_nodes

    def _solve_rows(
        self, ji: int, solver, warm: Optional[np.ndarray]
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(goodput row incl. efficiency, t_star row) for one job block."""
        stack = self._stack_for(ji)
        sol = solver(stack, self.totals[self._block(ji)], warm_start=warm)
        good = np.zeros(self.n)
        if self._viable(ji):
            good = self.jobs[ji].total_batch / sol.opt_perfs * self.jobs[ji].efficiency
        return good, np.asarray(sol.t_stars)

    def _scalar_rows(self, ji: int) -> np.ndarray:
        job = self.jobs[ji]
        base = self.assign[ji]
        return np.asarray(
            [job.goodput(tuple(base + [c])) for c in range(self.n)]
        )


def _allocate_arrays(
    jobs: Sequence[JobSpec],
    n_nodes: int,
    engine: str,
    *,
    solo: Dict[str, float],
    round_scalar: bool = False,
    gain_cache: Optional[Dict[str, Dict[Tuple[int, ...], Tuple[np.ndarray, np.ndarray]]]] = None,
    take_cache: Optional[Dict[str, Dict[Tuple[int, ...], float]]] = None,
    counters: Optional["Scheduler"] = None,
    unavailable: Sequence[int] = (),
    cache_limit: Optional[int] = None,
    device=None,
) -> Allocation:
    """Greedy marginal-gain assignment on the fixed-layout stacked state.

    ``round_scalar=False`` (the default mode: plain :func:`allocate` and the
    incremental :class:`Scheduler`) reads the chosen row's certified stacked
    value during the rounds — within solver tolerance (~1e-10 relative) of a
    scalar re-solve — and re-solves only the *final* chosen sets, batched
    through the bit-identical stacked subset solver (one
    :func:`~repro_torch.core.optperf.solve_optperf_waterfill_subsets` call per
    distinct set size per run), so emitted goodputs match the scalar
    oracle's bit-for-bit while the rounds themselves stay array-only.
    ``round_scalar=True`` is the debug/cross-check mode that re-solves the
    chosen set with the scalar path after *every* round, making the
    intermediate ``current`` values oracle-bit-identical too.  The two modes
    pick identical assignments unless some round has two competing gains
    closer than the round solver's resolution without being exactly tied
    (exact ties — e.g. identical node models — break identically in both):
    ~1e-10 relative for the NumPy engine, ~1e-7 for the float32 device
    engine.  Real clusters sit far from that degeneracy.
    """
    solver = _stacked_solver(engine, device)
    healthy = [_model_ok(j) for j in jobs]
    state = _GreedyState(jobs, n_nodes, healthy)
    current = [0.0] * len(jobs)
    # Down nodes are pre-marked taken: the fixed row layout (and with it
    # every cached marginal row and warm bracket seed) is preserved across
    # node churn — the greedy loop simply never assigns a masked node.
    taken = np.zeros(n_nodes, dtype=bool)
    for nid in unavailable:
        taken[int(nid)] = True
    remaining = n_nodes - int(taken.sum())

    # Long-lived Schedulers reconcile indefinitely; every distinct greedy
    # trajectory adds cache keys, so each per-job cache is bounded (oldest
    # entries evicted first — dicts preserve insertion order) instead of
    # growing with the number of reallocations.
    if cache_limit is None:
        cache_limit = 8 * max(n_nodes, 1)

    def bounded_insert(cache: Dict, key, value) -> None:
        cache.pop(key, None)
        cache[key] = value
        while len(cache) > cache_limit:
            cache.pop(next(iter(cache)))

    def job_cache(ji: int):
        if gain_cache is None:
            return None
        return gain_cache.setdefault(jobs[ji].name, {})

    def solve_dirty() -> None:
        """Refresh the marginal rows of every dirty job: cached exact rows
        when the (job, node-set) was solved before, one warm-seeded stacked
        call per block otherwise."""
        pending = sorted(state.dirty)
        state.dirty.clear()
        for ji in pending:
            cache = job_cache(ji)
            key = tuple(state.assign[ji])
            if cache is not None and key in cache:
                state.goodputs[ji], state.t_stars[ji] = cache[key]
                if counters is not None:
                    counters.cached_rows += state.n
                continue
            seeds = state.t_stars[ji]
            warm = seeds.copy() if np.isfinite(seeds).all() else None
            try:
                good, t_star = state._solve_rows(ji, solver, warm)
                state.goodputs[ji], state.t_stars[ji] = good, t_star
            except (ValueError, RuntimeError):
                # Degenerate block: fall back to the scalar oracle for these
                # rows (graceful 0.0 semantics included); no warm seeds.
                state.goodputs[ji] = state._scalar_rows(ji)
                state.t_stars[ji] = np.nan
                if counters is not None:
                    counters.fallback_blocks += 1
            if counters is not None:
                counters.solved_rows += state.n
                if warm is None:
                    counters.cold_rounds += 1
                else:
                    counters.warm_rounds += 1
            if cache is not None:
                bounded_insert(
                    cache, key, (state.goodputs[ji].copy(), state.t_stars[ji].copy())
                )

    def gains() -> np.ndarray:
        cur = np.asarray(current)[:, None]
        solo_v = np.asarray([solo[j.name] for j in jobs])[:, None]
        g = (state.goodputs - cur) / solo_v
        return np.where(taken[None, :], -np.inf, g)

    def chosen_goodput(ji: int) -> float:
        # Chosen sets are always re-solved by the scalar path so emitted
        # goodputs are engine-identical (cached across incremental runs —
        # the set, not the order, determines the value).
        ids = tuple(sorted(state.assign[ji]))
        if take_cache is None:
            return jobs[ji].goodput(ids)
        cache = take_cache.setdefault(jobs[ji].name, {})
        if ids not in cache:
            bounded_insert(cache, ids, jobs[ji].goodput(ids))
        return cache[ids]

    def take(ji: int, node: int) -> None:
        nonlocal remaining
        value = float(state.goodputs[ji, node])
        state.take(ji, node)
        taken[node] = True
        remaining -= 1
        current[ji] = chosen_goodput(ji) if round_scalar else value

    if remaining > 0 and jobs:
        solve_dirty()
        # Seed round: each job (in order of scarcity) takes its best node.
        for ji in sorted(range(len(jobs)), key=lambda x: -jobs[x].min_nodes):
            if remaining == 0:
                break
            solve_dirty()
            take(ji, int(np.argmax(gains()[ji])))
        # Greedy rounds: only the previous winner's rows are re-solved.
        while remaining:
            solve_dirty()
            g = gains()
            flat = int(np.argmax(g))
            ji, node = divmod(flat, n_nodes)
            if g[ji, node] <= 0:
                break  # nobody benefits (comm-bound saturation)
            take(ji, node)

    if not round_scalar:
        # Emit oracle-path values for the final sets (cached across runs):
        # the same sets re-solved through the bit-identical stacked subset
        # solver — one call per distinct set size per allocate, instead of
        # one scalar solve per greedy round — so the emitted numbers are
        # engine- and mode-identical to the scalar oracle's.
        pending: List[Tuple[int, Tuple[int, ...]]] = []
        for ji in range(len(jobs)):
            if not state.assign[ji]:
                continue
            ids = tuple(sorted(state.assign[ji]))
            if take_cache is not None:
                cache = take_cache.setdefault(jobs[ji].name, {})
                if ids in cache:
                    current[ji] = cache[ids]
                    continue
            pending.append((ji, ids))
        if pending:
            values = _chosen_goodput_batch(
                [(jobs[ji], ids) for ji, ids in pending]
            )
            for (ji, ids), value in zip(pending, values):
                if take_cache is not None:
                    bounded_insert(
                        take_cache.setdefault(jobs[ji].name, {}), ids, value
                    )
                current[ji] = value
    goodputs = {j.name: current[ji] for ji, j in enumerate(jobs)}
    fractions = {j.name: goodputs[j.name] / solo[j.name] for j in jobs}
    return Allocation(
        assignment={
            j.name: tuple(sorted(state.assign[ji])) for ji, j in enumerate(jobs)
        },
        goodputs=goodputs,
        fractions=fractions,
    )


def _allocate_scalar(
    jobs: Sequence[JobSpec],
    n_nodes: int,
    solo: Dict[str, float],
    unavailable: Sequence[int] = (),
) -> Allocation:
    """The per-(job, candidate-node) scalar loop — the cross-check oracle.
    Candidates iterate in ascending node id and jobs in caller order, so
    tie-breaking matches the array engines' fixed row layout."""
    remaining = set(range(n_nodes)) - {int(i) for i in unavailable}
    assign: Dict[str, List[int]] = {j.name: [] for j in jobs}
    current = {j.name: 0.0 for j in jobs}

    def scalar_gain(job: JobSpec, node: int) -> float:
        g = job.goodput(tuple(assign[job.name] + [node]))
        return (g - current[job.name]) / solo[job.name]

    def take(job: JobSpec, nid: int) -> None:
        assign[job.name].append(nid)
        current[job.name] = job.goodput(tuple(assign[job.name]))
        remaining.discard(nid)

    for job in sorted(jobs, key=lambda j: -j.min_nodes):
        if not remaining:
            break
        candidates = sorted(remaining)
        gains = [scalar_gain(job, nid) for nid in candidates]
        take(job, candidates[int(np.argmax(gains))])

    while remaining:
        candidates = sorted(remaining)
        gains = np.array(
            [[scalar_gain(j, nid) for nid in candidates] for j in jobs]
        )
        flat = int(np.argmax(gains))
        ji, r = divmod(flat, len(candidates))
        if gains[ji, r] <= 0:
            break
        take(jobs[ji], candidates[r])

    goodputs = {name: current[name] for name in assign}
    fractions = {name: goodputs[name] / solo[name] for name in assign}
    return Allocation(
        assignment={k: tuple(sorted(v)) for k, v in assign.items()},
        goodputs=goodputs,
        fractions=fractions,
    )


_ENGINES = ("batched", "jax", "scalar")


def allocate(
    jobs: Sequence[JobSpec],
    n_nodes: int,
    *,
    engine: str = "batched",
    unavailable: Sequence[int] = (),
    device=None,
) -> Allocation:
    """Greedy marginal-gain node assignment.

    Seeds every job with its single best node (by marginal goodput), then
    assigns remaining nodes to the job with the largest *normalized*
    marginal gain (gain / solo goodput) — normalization prevents one large
    job from starving small ones (the same normalization Pollux's fair
    goodput objective uses).

    ``engine="batched"`` (default) keeps one fixed-layout stacked problem
    and re-solves only the rows each round changed, warm-started from the
    previous round's ``t_stars``; ``engine="jax"`` runs those stacked
    solves on ``device`` (the card when None); ``engine="scalar"`` is the per-pair loop
    oracle.  All engines iterate candidates in ascending node id and jobs
    in caller order, so tie-breaking matches across engines.

    ``unavailable`` lists node ids that must not be assigned (down/drained
    nodes).  The stacked row layout is unchanged — masked nodes are simply
    pre-marked taken — so warm seeds and cached rows survive node churn.
    """
    if engine not in _ENGINES:
        raise ValueError(f"unknown allocate engine {engine!r}")
    bad = [i for i in unavailable if not 0 <= int(i) < n_nodes]
    if bad:
        # Without this check the engines would diverge: negative ids alias
        # real rows in the array engine but are ignored by the scalar one.
        raise ValueError(f"unavailable node ids out of range: {sorted(bad)}")
    if not jobs:
        return Allocation({}, {}, {})
    if len({j.name for j in jobs}) != len(jobs):
        raise ValueError("job names must be unique")
    solo = {j.name: max(j.solo_goodput(), 1e-12) for j in jobs}
    if engine == "scalar":
        return _allocate_scalar(jobs, n_nodes, solo, unavailable)
    return _allocate_arrays(
        jobs, n_nodes, engine, solo=solo, round_scalar=False,
        unavailable=unavailable, device=device,
    )


class Scheduler:
    """Stateful cluster allocator with incremental re-allocation.

    Holds the live job set and the caches that make re-allocation on job
    arrival/departure cheap: solo goodputs, per-(job, node-set) marginal
    rows from previous runs (exact reuse while the greedy trajectory
    replays), and chosen-set scalar goodputs.  ``add_job``/``remove_job``
    re-run the greedy loop against those caches so only the affected rows
    are actually solved; the emitted allocation matches a cold
    :func:`allocate` over the same job set (exactly, barring rounds whose
    competing gains differ by less than the round solver's resolution —
    see ``_allocate_arrays``).

    ``update_job`` is the per-epoch OLS-refit entry point: the refreshed
    job's cached rows (and the stacked device exports behind them) are
    invalidated before re-allocating — reusing them would solve the old
    coefficient regime (see
    :meth:`~repro_torch.core.perf_model.StackedClusterModel.invalidate_device_cache`).

    Observability: ``warm_rounds``/``cold_rounds`` count block solves by
    bracket seeding, ``solved_rows``/``cached_rows`` count marginal rows
    actually solved vs reused from cache.  ``fallback_blocks`` (the port's
    own) counts blocks whose stacked solve raised and were re-solved by the
    scalar oracle: on the device engine a failing device solve shows here.

    ``device`` is where the ``"jax"`` engine solves (the card when None);
    the host engines ignore it.
    """

    def __init__(
        self,
        n_nodes: int,
        *,
        engine: str = "batched",
        cache_limit: Optional[int] = None,
        device=None,
    ):
        if engine not in _ENGINES:
            raise ValueError(f"unknown allocate engine {engine!r}")
        if cache_limit is not None and cache_limit < 1:
            raise ValueError("cache_limit must be >= 1")
        self.n_nodes = n_nodes
        self.engine = engine
        self.device = device
        # Per-job bound on cached marginal rows / chosen-set goodputs (FIFO
        # eviction); None = the 8*n_nodes default of `_allocate_arrays`.
        self.cache_limit = cache_limit
        self.allocation: Optional[Allocation] = None
        self._jobs: Dict[str, JobSpec] = {}
        self._down: Set[int] = set()
        self._solo: Dict[str, float] = {}
        self._gain_cache: Dict[str, Dict[Tuple[int, ...], Tuple[np.ndarray, np.ndarray]]] = {}
        self._take_cache: Dict[str, Dict[Tuple[int, ...], float]] = {}
        self.warm_rounds = 0
        self.cold_rounds = 0
        self.solved_rows = 0
        self.cached_rows = 0
        self.fallback_blocks = 0
        self.allocations = 0

    @property
    def jobs(self) -> Tuple[JobSpec, ...]:
        return tuple(self._jobs.values())

    def add_job(self, job: JobSpec) -> Allocation:
        if job.name in self._jobs:
            raise ValueError(f"job {job.name!r} already scheduled")
        self._jobs[job.name] = job
        return self.reallocate()

    def remove_job(self, name: str) -> Allocation:
        if name not in self._jobs:
            raise KeyError(name)
        del self._jobs[name]
        self._drop_job_state(name)
        return self.reallocate()

    def update_job(self, job: JobSpec) -> Allocation:
        """Replace a job's spec after a coefficient refresh (OLS refit).

        The refreshed job's cached marginal rows, chosen-set goodputs, and
        solo normalizer are all stale for the new coefficient regime and
        are dropped before re-allocating; warm bracket seeds for the other
        jobs stay valid (their problems did not change)."""
        if job.name not in self._jobs:
            raise KeyError(job.name)
        self._jobs[job.name] = job
        self._drop_job_state(job.name)
        return self.reallocate()

    def node_leave(self, node_ids: Sequence[int]) -> Allocation:
        """Mark nodes unavailable (failure/drain) and re-allocate.

        The stacked row layout is indexed by the *full* cluster, so a down
        node does not shift any rows: cached marginal rows and warm bracket
        seeds (which depend only on (job, node set), never on availability)
        replay exactly — node churn costs an incremental re-run, not a cold
        one.  Down nodes are simply never assigned."""
        ids = {int(i) for i in node_ids}
        bad = [i for i in ids if not 0 <= i < self.n_nodes]
        if bad:
            raise ValueError(f"node ids out of range: {sorted(bad)}")
        self._down |= ids
        return self.reallocate()

    def node_join(self, node_ids: Sequence[int]) -> Allocation:
        """Mark previously-down nodes available again and re-allocate."""
        self._down -= {int(i) for i in node_ids}
        return self.reallocate()

    @property
    def down_nodes(self) -> Tuple[int, ...]:
        return tuple(sorted(self._down))

    @property
    def available_nodes(self) -> int:
        return self.n_nodes - len(self._down)

    def invalidate(self) -> None:
        """Drop every cache (cluster-membership or bulk-refresh changes)."""
        self._solo.clear()
        self._gain_cache.clear()
        self._take_cache.clear()

    def _drop_job_state(self, name: str) -> None:
        self._solo.pop(name, None)
        self._gain_cache.pop(name, None)
        self._take_cache.pop(name, None)

    def reallocate(self) -> Allocation:
        """Re-run the greedy loop against the incremental caches."""
        jobs = self.jobs
        self.allocations += 1
        if not jobs:
            self.allocation = Allocation({}, {}, {})
            return self.allocation
        for job in jobs:
            if job.name not in self._solo:
                self._solo[job.name] = max(job.solo_goodput(), 1e-12)
        solo = {j.name: self._solo[j.name] for j in jobs}
        down = tuple(sorted(self._down))
        if self.engine == "scalar":
            self.allocation = _allocate_scalar(jobs, self.n_nodes, solo, down)
        else:
            self.allocation = _allocate_arrays(
                jobs, self.n_nodes, self.engine, solo=solo, round_scalar=False,
                gain_cache=self._gain_cache, take_cache=self._take_cache,
                counters=self, unavailable=down, cache_limit=self.cache_limit,
                device=self.device,
            )
        return self.allocation


def aggregate_goodput(jobs: Sequence[JobSpec], allocation: Allocation) -> float:
    """Sum of per-job goodputs, with non-finite entries treated as 0.0 (a
    zero-node or garbage-fit job must not poison the aggregate with NaN)."""
    return allocation.aggregate_goodput


def random_jobs(n_jobs: int, n_nodes: int, seed: int = 42) -> List[JobSpec]:
    """Seeded random job mix over the GPU catalog — the shared scenario
    generator for the scheduler benchmark gates and the engine-parity tests
    (one source so both always exercise the same distribution)."""
    from repro_torch.core.simulator import GPU_CATALOG  # local: keep import graph lean

    rng = np.random.default_rng(seed)
    names = list(GPU_CATALOG)
    jobs = []
    for j in range(n_jobs):
        models = tuple(
            GPU_CATALOG[names[int(rng.integers(len(names)))]]
            .scaled(float(rng.uniform(0.5, 2.0)))
            .model()
            for _ in range(n_nodes)
        )
        jobs.append(
            JobSpec(
                name=f"job{j}",
                node_models=models,
                comm=CommModel(
                    t_o=float(rng.uniform(0.01, 0.08)),
                    t_u=float(rng.uniform(0.002, 0.02)),
                    gamma=float(rng.uniform(0.05, 0.4)),
                ),
                total_batch=int(rng.choice([256, 512, 1024, 2048])),
                b_noise=float(rng.uniform(100, 5000)),
                ref_batch=64,
                min_nodes=int(rng.integers(1, 3)),
            )
        )
    return jobs
