"""OptPerf water-fill adapter for serving: telemetry -> refit -> re-solve.

Serving and training share one allocation engine.  A decode tick on node
``i`` with batch ``b`` (its active slot count) costs

    t_i(b) = alpha_i * b + c_i        (seconds per generated token per slot)

— exactly the linear per-node cost law of §3.2, with no all-reduce
(``T_o = T_u = 0``), so the OptPerf water-fill
(:func:`repro_torch.core.optperf.solve_optperf_batch`) over the serving
:class:`~repro_torch.core.perf_model.ClusterPerfModel` minimizes the *max* per-node
tick time at a fixed total slot budget ``B``: every node emits tokens at the
same cadence, which is simultaneously the token-latency optimum and (for
affine costs with positive intercepts) a strictly better sustained-goodput
point than the uniform split the bench baselines against.

The linear coefficients are refitted online from observed ``(batch,
tick_time)`` pairs per node (:class:`NodeTickFitter`, the serving twin of
:class:`~repro_torch.core.perf_model.OnlineNodeFitter`), so allocations track
drifting capacity; until a node has two distinct observed batch sizes its
row falls back to the bootstrap model the allocator was constructed with.

The (alpha, c) pair maps onto :class:`~repro_torch.core.perf_model.NodePerfModel`
as ``q = k = alpha/2``, ``s = m = c/2`` — with a zero comm model the solver
sees ``t_compute = alpha*b + c`` and the ``k > 0`` well-posedness check
holds whenever the node does any work at all.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.optperf import round_batches, solve_optperf_batch
from repro_torch.core.perf_model import (
    ClusterPerfModel,
    CommModel,
    NodePerfModel,
    fit_linear,
)

__all__ = [
    "serving_node_model",
    "serving_cluster_model",
    "NodeTickFitter",
    "ServingAllocator",
    "uniform_split",
]

_SERVING_COMM = CommModel(t_o=0.0, t_u=0.0, gamma=0.0)


def serving_node_model(alpha: float, c: float) -> NodePerfModel:
    """A serving node's linear tick-cost law as a NodePerfModel."""
    if alpha <= 0:
        raise ValueError("tick-cost slope must be positive")
    return NodePerfModel(q=alpha / 2.0, s=max(c, 0.0) / 2.0,
                         k=alpha / 2.0, m=max(c, 0.0) / 2.0)


def serving_cluster_model(coeffs: Sequence[Tuple[float, float]]) -> ClusterPerfModel:
    """Cluster model over ``[(alpha_i, c_i), ...]`` with a zero comm model."""
    return ClusterPerfModel(
        nodes=tuple(serving_node_model(a, c) for a, c in coeffs),
        comm=_SERVING_COMM,
    )


def uniform_split(total_slots: int, nodes: Sequence[int]) -> Dict[int, int]:
    """The heterogeneity-blind baseline: ``B/n`` slots each (remainder to the
    lowest node ids, deterministically)."""
    if not nodes:
        raise ValueError("no nodes to split over")
    n = len(nodes)
    base, rem = divmod(int(total_slots), n)
    return {
        node: base + (1 if i < rem else 0)
        for i, node in enumerate(sorted(nodes))
    }


class NodeTickFitter:
    """Bounded-window OLS fit of one node's (batch, tick time) law."""

    def __init__(self, window: int = 64):
        self._bs: List[float] = []
        self._ts: List[float] = []
        self.window = int(window)

    def observe(self, batch: float, tick_time: float) -> None:
        if batch <= 0 or tick_time <= 0:
            return  # idle ticks carry no signal
        self._bs.append(float(batch))
        self._ts.append(float(tick_time))
        if len(self._bs) > self.window:
            del self._bs[0], self._ts[0]

    @property
    def num_observations(self) -> int:
        return len(self._bs)

    def can_fit(self) -> bool:
        return len(set(self._bs)) >= 2

    def fit(self) -> Optional[Tuple[float, float]]:
        """(alpha, c) or None when unfittable / non-physical (a node whose
        measured times say "bigger batches are faster" keeps its old row —
        measurement noise must not poison the solve)."""
        if not self.can_fit():
            return None
        alpha, c = fit_linear(self._bs, self._ts)
        if alpha <= 0:
            return None
        return alpha, max(c, 0.0)

    def throughput(self) -> Optional[float]:
        """Most recent observed tokens/sec (telemetry surface)."""
        if not self._bs:
            return None
        return self._bs[-1] / self._ts[-1]


class ServingAllocator:
    """Maps serving telemetry into ClusterPerfModel refits + OptPerf solves.

    ``mode="optperf"`` water-fills the slot budget; ``mode="uniform"`` is the
    baseline even split (the bench's comparison arm) — telemetry is ingested
    either way so the two arms differ only in the solve.
    """

    def __init__(
        self,
        coeffs: Dict[int, Tuple[float, float]],
        total_slots: int,
        *,
        mode: str = "optperf",
        fit_window: int = 64,
        min_slots: int = 0,
    ):
        if total_slots <= 0:
            raise ValueError("total_slots must be positive")
        if mode not in ("optperf", "uniform"):
            raise ValueError(f"unknown allocator mode {mode!r}")
        self.total_slots = int(total_slots)
        self.mode = mode
        self.min_slots = int(min_slots)
        self._coeffs: Dict[int, Tuple[float, float]] = {
            int(node): (float(a), float(c)) for node, (a, c) in coeffs.items()
        }
        self._fitters: Dict[int, NodeTickFitter] = {
            node: NodeTickFitter(fit_window) for node in self._coeffs
        }
        self.refits = 0
        self.solves = 0

    # -- telemetry ---------------------------------------------------------

    def observe(self, node: int, batch: float, tick_time: float) -> None:
        """One decode-tick observation (batch = active slots this tick)."""
        self._fitters.setdefault(node, NodeTickFitter()).observe(batch, tick_time)

    def refit(self) -> int:
        """Fold fitted rows over the bootstrap coefficients; returns how many
        node rows changed."""
        changed = 0
        for node, fitter in self._fitters.items():
            fit = fitter.fit()
            if fit is not None and fit != self._coeffs.get(node):
                self._coeffs[node] = fit
                changed += 1
        if changed:
            self.refits += 1
        return changed

    def coeffs(self, node: int) -> Tuple[float, float]:
        return self._coeffs[node]

    def predicted_tick(self, node: int, batch: int) -> float:
        a, c = self._coeffs[node]
        return a * batch + c

    def observed_throughput(self) -> Dict[int, float]:
        out = {}
        for node, f in self._fitters.items():
            tp = f.throughput()
            if tp is not None:
                out[node] = tp
        return out

    # -- solve -------------------------------------------------------------

    def model(self, nodes: Sequence[int]) -> ClusterPerfModel:
        missing = [n for n in nodes if n not in self._coeffs]
        if missing:
            raise KeyError(f"no coefficients for nodes {missing}")
        return serving_cluster_model([self._coeffs[n] for n in nodes])

    def solve(self, nodes: Sequence[int]) -> Dict[int, int]:
        """Per-node slot allocation over the *available* node set."""
        nodes = sorted(nodes)
        if not nodes:
            return {}
        self.solves += 1
        if self.mode == "uniform":
            return uniform_split(self.total_slots, nodes)
        model = self.model(nodes)
        sol = solve_optperf_batch(model, [float(self.total_slots)])
        slots = round_batches(list(sol.batches[0]), self.total_slots)
        alloc = {node: int(b) for node, b in zip(nodes, slots)}
        if self.min_slots > 0:
            alloc = self._apply_floor(alloc, nodes)
        return alloc

    def _apply_floor(self, alloc: Dict[int, int], nodes: Sequence[int]) -> Dict[int, int]:
        """Raise starved nodes to ``min_slots``, taking slots from the
        largest allocations (keeps the total exactly ``total_slots``)."""
        floor = min(self.min_slots, self.total_slots // max(len(nodes), 1))
        for node in nodes:
            while alloc[node] < floor:
                donor = max(alloc, key=lambda n: (alloc[n], -n))
                if alloc[donor] <= floor:
                    break
                alloc[donor] -= 1
                alloc[node] += 1
        return alloc
