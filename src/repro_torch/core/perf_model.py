"""Per-node performance models for heterogeneous data-parallel training.

Implements §3.2 of the Cannikin paper:

  * computing time of node i at local batch b:
        a_i(b) = q_i * b + s_i          (data load + forward + param update)
        P_i(b) = k_i * b + m_i          (backpropagation)
        t_compute_i(b) = a_i(b) + P_i(b)
  * communication:  T_comm = T_o + T_u  (batch-size independent constant)
  * overlap:        syncStart_i(b) = a_i(b) + gamma * P_i(b)
  * node batch time:
        T_node(b) = t_compute + T_u            if (1-gamma) P_i >= T_o
                  = syncStart + T_comm         otherwise
    which is equivalent to max(t_compute + T_u, syncStart + T_comm).

Parameter learning (§4.5):

  * (q_i, s_i) and (k_i, m_i) fitted by ordinary least squares over the
    (local batch size, measured time) observations of each node; at least
    two distinct batch sizes are required (the controller guarantees this
    via the Eq. (8) bootstrap partitioner).
  * gamma is measured per node per epoch; the cluster-level gamma uses
    inverse-variance weighting (Eq. 12).
  * T_comm uses the min over node reports (§4.5): the straggler that waits
    for nobody reports the true communication time.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "NodePerfModel",
    "CommModel",
    "ClusterCoeffs",
    "ClusterPerfModel",
    "StackedClusterModel",
    "NodeObservation",
    "OnlineNodeFitter",
    "GammaAggregator",
    "fit_linear",
    "inverse_variance_weight",
    "bootstrap_partition",
]


# ---------------------------------------------------------------------------
# Model containers
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class NodePerfModel:
    """Linear compute-time model of one node (one DP worker / node group).

    ``a(b) = q*b + s`` and ``P(b) = k*b + m``; all times in seconds, batch in
    samples.  q, k must be positive for a well-posed OptPerf problem.
    """

    q: float
    s: float
    k: float
    m: float

    def a(self, b) -> float:
        return self.q * b + self.s

    def backprop(self, b) -> float:
        return self.k * b + self.m

    def t_compute(self, b) -> float:
        return self.a(b) + self.backprop(b)

    def sync_start(self, b, gamma: float) -> float:
        return self.a(b) + gamma * self.backprop(b)

    # Coefficients used by the closed-form solvers -------------------------
    @property
    def alpha(self) -> float:
        """Slope of t_compute in b."""
        return self.q + self.k

    @property
    def c(self) -> float:
        """Intercept of t_compute."""
        return self.s + self.m

    def beta(self, gamma: float) -> float:
        """Slope of syncStart in b."""
        return self.q + gamma * self.k

    def d(self, gamma: float) -> float:
        """Intercept of syncStart."""
        return self.s + gamma * self.m

    def validate(self) -> None:
        if not (self.q >= 0 and self.k > 0):
            raise ValueError(f"ill-posed node model q={self.q} k={self.k}")


@dataclasses.dataclass(frozen=True)
class CommModel:
    """Cluster communication model: ring all-reduce split into overlapped
    part ``T_o`` and the un-overlappable last bucket ``T_u``; plus the
    overlap ratio ``gamma`` (fraction of backprop before the first bucket
    is ready)."""

    t_o: float
    t_u: float
    gamma: float

    @property
    def t_comm(self) -> float:
        return self.t_o + self.t_u

    def validate(self) -> None:
        if self.t_o < 0 or self.t_u < 0:
            raise ValueError("negative communication time")
        if not (0.0 <= self.gamma <= 1.0):
            raise ValueError(f"gamma out of range: {self.gamma}")


@dataclasses.dataclass(frozen=True)
class ClusterCoeffs:
    """Array-form coefficient view of a cluster: one entry per node.

    Everything the vectorized solvers need, precomputed once:
    ``t_compute_i(b) = alphas[i]*b + cs[i]`` and
    ``syncStart_i(b) = betas[i]*b + ds[i]`` (betas/ds already include the
    cluster gamma).  ``ks``/``ms`` are the raw backprop coefficients used by
    the overlap-state criterion ``(1-gamma)*(ks*b + ms) >= T_o``.

    All arrays are float64, read-only, shape ``(n,)``.
    """

    alphas: np.ndarray
    cs: np.ndarray
    betas: np.ndarray
    ds: np.ndarray
    ks: np.ndarray
    ms: np.ndarray

    @property
    def n(self) -> int:
        return int(self.alphas.shape[0])


@dataclasses.dataclass(frozen=True)
class ClusterPerfModel:
    """Everything the OptPerf solver needs for one cluster."""

    nodes: Tuple[NodePerfModel, ...]
    comm: CommModel

    @property
    def n(self) -> int:
        return len(self.nodes)

    @functools.cached_property
    def coeffs(self) -> ClusterCoeffs:
        """Cached array view of the per-node coefficients.

        The dataclass is frozen, so the view can never go stale; computing it
        once means no solver ever touches per-node Python attributes inside a
        loop.  (``cached_property`` writes straight to ``__dict__`` and thus
        works on frozen dataclasses.)
        """
        gamma = self.comm.gamma
        qs = np.fromiter((nd.q for nd in self.nodes), dtype=np.float64, count=self.n)
        ss = np.fromiter((nd.s for nd in self.nodes), dtype=np.float64, count=self.n)
        ks = np.fromiter((nd.k for nd in self.nodes), dtype=np.float64, count=self.n)
        ms = np.fromiter((nd.m for nd in self.nodes), dtype=np.float64, count=self.n)
        arrays = dict(
            alphas=qs + ks,
            cs=ss + ms,
            betas=qs + gamma * ks,
            ds=ss + gamma * ms,
            ks=ks,
            ms=ms,
        )
        for arr in arrays.values():
            arr.flags.writeable = False
        return ClusterCoeffs(**arrays)

    def node_time(self, i: int, b: float) -> float:
        """Batch time of node i at local batch b (max-form, §3.2.3)."""
        node = self.nodes[i]
        compute_path = node.t_compute(b) + self.comm.t_u
        comm_path = node.sync_start(b, self.comm.gamma) + self.comm.t_comm
        return max(compute_path, comm_path)

    def node_times(self, batches) -> np.ndarray:
        """Vectorized node batch times for a ``(..., n)`` batch array."""
        c = self.coeffs
        b = np.asarray(batches, dtype=np.float64)
        compute_path = c.alphas * b + c.cs + self.comm.t_u
        comm_path = c.betas * b + c.ds + self.comm.t_comm
        return np.maximum(compute_path, comm_path)

    def cluster_time(self, batches: Sequence[float]) -> float:
        """Cluster batch time = max over nodes (synchronous DP)."""
        if len(batches) != self.n:
            raise ValueError("batch vector length mismatch")
        return float(self.node_times(batches).max())

    def is_compute_bottleneck(self, i: int, b: float) -> bool:
        node = self.nodes[i]
        return (1.0 - self.comm.gamma) * node.backprop(b) >= self.comm.t_o

    def compute_bottleneck_mask(self, batches) -> np.ndarray:
        """Vectorized overlap-state criterion for a ``(..., n)`` batch array:
        True where a node is compute-bottleneck (``(1-gamma) P_i >= T_o``)."""
        c = self.coeffs
        b = np.asarray(batches, dtype=np.float64)
        return (1.0 - self.comm.gamma) * (c.ks * b + c.ms) >= self.comm.t_o

    def validate(self) -> None:
        # Hot path (every solver call revalidates): one vectorized pass over
        # the cached coefficient view, memoized — the dataclass is frozen so
        # a model that validated once can never become invalid.
        if self.__dict__.get("_validated", False):
            return
        self.comm.validate()
        c = self.coeffs
        # q = alphas - ks is float-safe: fl(q + k) >= k for q >= 0, so the
        # vectorized check matches the per-node q >= 0, k > 0 semantics.
        # Negated-all form so NaN coefficients fail validation (NaN makes
        # any comparison False) exactly like the per-node checks do.
        if not (bool(np.all(c.ks > 0)) and bool(np.all(c.alphas - c.ks >= 0))):
            for node in self.nodes:
                node.validate()  # per-node pass for a precise error message
            raise ValueError("ill-posed node model")
        self.__dict__["_validated"] = True


@dataclasses.dataclass(frozen=True)
class StackedClusterModel:
    """A batch of *independent* OptPerf problem rows padded to one width.

    Row ``r`` is its own cluster: its own node subset (coefficient row
    ``[r, :]`` with ``mask[r, :]`` marking real slots) and its own
    communication model (``t_o[r]``/``t_u[r]``/``gamma[r]``).  This is the
    input format of :func:`repro_torch.core.optperf.solve_optperf_stacked`, which
    water-fills every row simultaneously — the multi-job scheduler builds one
    stack per greedy round covering all (job, candidate-node) pairs instead
    of solving each pair with a scalar water-fill.

    Coefficient semantics match :class:`ClusterCoeffs`:
    ``t_compute = alphas*b + cs``, ``syncStart = betas*b + ds`` (betas/ds
    include the row gamma); ``ks``/``ms`` are raw backprop coefficients for
    the overlap-state criterion.  Padding slots must carry inert values
    (``alphas = betas = ks = 1``, offsets 0) so broadcast arithmetic stays
    finite; they are excluded from every reduction via ``mask``.
    """

    alphas: np.ndarray   # (C, n_max)
    cs: np.ndarray       # (C, n_max)
    betas: np.ndarray    # (C, n_max)
    ds: np.ndarray       # (C, n_max)
    ks: np.ndarray       # (C, n_max)
    ms: np.ndarray       # (C, n_max)
    t_o: np.ndarray      # (C,)
    t_u: np.ndarray      # (C,)
    gamma: np.ndarray    # (C,)
    mask: np.ndarray     # (C, n_max) bool; False = padding slot

    @property
    def shape(self) -> Tuple[int, int]:
        return tuple(self.alphas.shape)  # type: ignore[return-value]

    @property
    def t_comm(self) -> np.ndarray:
        return self.t_o + self.t_u

    # -- derived-view caches -------------------------------------------
    #
    # Two expensive exports are memoized per stack instance: the solver's
    # `_Problem` array view (repro_torch.core.optperf) and the device
    # sweep's tensor export (repro_torch.core.optperf_torch).  Both
    # key off this instance, so a stack whose coefficient arrays are
    # refreshed IN PLACE (the scheduler's per-epoch OLS refit path) must
    # call :meth:`invalidate_device_cache` — otherwise the solvers keep
    # reading the old-regime coefficients from the stale export and emit
    # brackets for a cluster that no longer exists.

    def device_cache(self) -> Dict[str, object]:
        """Per-instance slot for the device sweep's cached exports (keyed by
        dtype and device; populated by
        ``optperf_torch.stacked_device_coeffs`` so this module never imports
        torch)."""
        return self.__dict__.setdefault("_device_coeffs", {})

    def invalidate_device_cache(self) -> None:
        """Drop every derived view cached on this stack: the memoized
        `_Problem` solver view, the device-coefficient export, and the
        validation memo.  Required after any in-place coefficient refresh
        (OLS refit)."""
        self.__dict__.pop("_device_coeffs", None)
        self.__dict__.pop("_optperf_problem", None)
        self.__dict__.pop("_validated", None)

    def validate(self) -> None:
        # Hot path (the scheduler solves the same stack block every round):
        # memoized like ClusterPerfModel.validate; in-place refreshes route
        # through invalidate_device_cache which drops the memo.
        if self.__dict__.get("_validated", False):
            return
        c, n = self.alphas.shape
        for name in ("cs", "betas", "ds", "ks", "ms", "mask"):
            if getattr(self, name).shape != (c, n):
                raise ValueError(f"{name} shape mismatch")
        for name in ("t_o", "t_u", "gamma"):
            if getattr(self, name).shape != (c,):
                raise ValueError(f"{name} shape mismatch")
        # Negated-all form throughout so NaN coefficients fail validation
        # (NaN comparisons are False) — the batched scheduler relies on a
        # ValueError here to degrade a garbage-fit job to goodput 0.0 the
        # same way the scalar path does.
        if not self.mask.any(axis=1).all():
            raise ValueError("every row needs at least one valid node slot")
        if not np.all(np.where(self.mask, self.alphas, 1.0) > 0):
            raise ValueError("non-positive alpha on a valid slot")
        # Same k > 0 and q >= 0 (alpha - k >= 0) requirements as the
        # per-node NodePerfModel check: the batched scheduler must reject
        # exactly the models the scalar oracle rejects, or the engines emit
        # different allocations.
        if not np.all(np.where(self.mask, self.ks, 1.0) > 0):
            raise ValueError("non-positive backprop slope on a valid slot")
        if not np.all(np.where(self.mask, self.alphas - self.ks, 0.0) >= 0):
            raise ValueError("negative q slope on a valid slot")
        if not np.all(np.where(self.mask, self.betas, 0.0) >= 0):
            raise ValueError("negative beta on a valid slot")
        if not (np.all(self.t_o >= 0) and np.all(self.t_u >= 0)):
            raise ValueError("negative communication time")
        if not np.all((self.gamma >= 0) & (self.gamma <= 1)):
            raise ValueError("gamma out of range")
        self.__dict__["_validated"] = True

    @classmethod
    def from_models(cls, models: Sequence["ClusterPerfModel"]) -> "StackedClusterModel":
        """Pad and stack heterogeneous-width clusters into one solve batch."""
        if not models:
            raise ValueError("need at least one model")
        c = len(models)
        n_max = max(m.n for m in models)
        arrays = {
            name: np.full((c, n_max), fill, dtype=np.float64)
            for name, fill in (
                ("alphas", 1.0), ("cs", 0.0), ("betas", 1.0),
                ("ds", 0.0), ("ks", 1.0), ("ms", 0.0),
            )
        }
        mask = np.zeros((c, n_max), dtype=bool)
        t_o = np.empty(c)
        t_u = np.empty(c)
        gamma = np.empty(c)
        for r, m in enumerate(models):
            co = m.coeffs
            for name in arrays:
                arrays[name][r, : m.n] = getattr(co, name)
            mask[r, : m.n] = True
            t_o[r] = m.comm.t_o
            t_u[r] = m.comm.t_u
            gamma[r] = m.comm.gamma
        out = cls(t_o=t_o, t_u=t_u, gamma=gamma, mask=mask, **arrays)
        for arr in (*arrays.values(), t_o, t_u, gamma, mask):
            arr.flags.writeable = False
        return out

    def row_model(self, r: int) -> "ClusterPerfModel":
        """Reconstruct row ``r`` as a scalar :class:`ClusterPerfModel`
        (cross-check oracle path; q = alpha - k, s = c - m)."""
        valid = np.flatnonzero(self.mask[r])
        nodes = tuple(
            NodePerfModel(
                q=float(self.alphas[r, i] - self.ks[r, i]),
                s=float(self.cs[r, i] - self.ms[r, i]),
                k=float(self.ks[r, i]),
                m=float(self.ms[r, i]),
            )
            for i in valid
        )
        comm = CommModel(
            t_o=float(self.t_o[r]), t_u=float(self.t_u[r]), gamma=float(self.gamma[r])
        )
        return ClusterPerfModel(nodes=nodes, comm=comm)


# ---------------------------------------------------------------------------
# Online parameter learning
# ---------------------------------------------------------------------------


def fit_linear(xs: Sequence[float], ys: Sequence[float]) -> Tuple[float, float]:
    """OLS fit ``y = slope*x + intercept``. Needs >=2 distinct x values."""
    xs_arr = np.asarray(xs, dtype=np.float64)
    ys_arr = np.asarray(ys, dtype=np.float64)
    if xs_arr.size < 2 or np.ptp(xs_arr) == 0:
        raise ValueError("need at least two distinct batch sizes to fit")
    x_mean = xs_arr.mean()
    y_mean = ys_arr.mean()
    denom = float(((xs_arr - x_mean) ** 2).sum())
    slope = float(((xs_arr - x_mean) * (ys_arr - y_mean)).sum() / denom)
    intercept = float(y_mean - slope * x_mean)
    return slope, intercept


@dataclasses.dataclass
class NodeObservation:
    """One epoch-level measurement from a node."""

    batch_size: float
    a_time: float          # data load + forward + param update
    backprop_time: float
    gamma: float           # measured overlap ratio this epoch
    comm_time: float       # this node's reported T_comm (includes waiting)


class OnlineNodeFitter:
    """Accumulates observations for one node and refits (q,s,k,m).

    The paper refits after every epoch; more distinct batch sizes refine the
    model (§4.5 "Parameter learning").
    """

    def __init__(self) -> None:
        self._obs: List[NodeObservation] = []

    def add(self, obs: NodeObservation) -> None:
        if obs.batch_size <= 0:
            raise ValueError("batch size must be positive")
        self._obs.append(obs)

    @property
    def num_observations(self) -> int:
        return len(self._obs)

    @property
    def num_distinct_batches(self) -> int:
        return len({o.batch_size for o in self._obs})

    def can_fit(self) -> bool:
        return self.num_distinct_batches >= 2

    def per_sample_time(self) -> float:
        """t_sample of the most recent epoch — used by the Eq. (8) bootstrap."""
        if not self._obs:
            raise ValueError("no observations")
        last = self._obs[-1]
        return (last.a_time + last.backprop_time) / last.batch_size

    def fit(self) -> NodePerfModel:
        if not self.can_fit():
            raise ValueError("need two distinct local batch sizes (Eq. 8 bootstrap)")
        bs = [o.batch_size for o in self._obs]
        q, s = fit_linear(bs, [o.a_time for o in self._obs])
        k, m = fit_linear(bs, [o.backprop_time for o in self._obs])
        # Clamp tiny negative intercepts caused by measurement noise; a
        # negative slope would mean "bigger batches are faster" which is a
        # measurement failure we surface instead of hiding.
        if q < 0 or k <= 0:
            raise ValueError(f"non-physical fit q={q:.3g} k={k:.3g}")
        return NodePerfModel(q=q, s=max(s, 0.0), k=k, m=max(m, 0.0))

    def gamma_stats(self) -> Tuple[float, float]:
        """Mean and sample variance of this node's gamma measurements."""
        gs = np.asarray([o.gamma for o in self._obs], dtype=np.float64)
        if gs.size == 0:
            raise ValueError("no gamma observations")
        mean = float(gs.mean())
        var = float(gs.var(ddof=1)) if gs.size > 1 else float("inf")
        return mean, var

    def min_comm_time(self) -> float:
        return min(o.comm_time for o in self._obs)


def inverse_variance_weight(
    means: Sequence[float], variances: Sequence[float]
) -> float:
    """Eq. (12): inverse-variance weighted combination of per-node estimates.

    Nodes with unknown variance (single sample, var=inf) receive zero weight
    unless *all* variances are infinite, in which case we fall back to the
    plain mean (every node equally untrusted).
    """
    means_arr = np.asarray(means, dtype=np.float64)
    var_arr = np.asarray(variances, dtype=np.float64)
    if means_arr.size == 0:
        raise ValueError("no estimates")
    if means_arr.shape != var_arr.shape:
        raise ValueError("means/variances shape mismatch")
    if np.any(var_arr < 0):
        raise ValueError("negative variance")
    finite = np.isfinite(var_arr) & (var_arr > 0)
    exact = np.isfinite(var_arr) & (var_arr == 0)
    if np.any(exact):
        # Zero-variance observations dominate: average those.
        return float(means_arr[exact].mean())
    if not np.any(finite):
        return float(means_arr.mean())
    w = np.zeros_like(var_arr)
    w[finite] = 1.0 / var_arr[finite]
    w /= w.sum()
    return float((w * means_arr).sum())


class GammaAggregator:
    """Cluster-level gamma and T_comm estimation (§4.5)."""

    def __init__(self, fitters: Mapping[int, OnlineNodeFitter]):
        self._fitters = dict(fitters)

    def gamma(self) -> float:
        means, variances = [], []
        for fitter in self._fitters.values():
            mean, var = fitter.gamma_stats()
            means.append(mean)
            variances.append(var)
        g = inverse_variance_weight(means, variances)
        return min(max(g, 0.0), 1.0)

    def t_comm(self) -> float:
        """min over nodes of the node-min report (§4.5)."""
        return min(f.min_comm_time() for f in self._fitters.values())


# ---------------------------------------------------------------------------
# Eq. (8) bootstrap partition — used before performance models exist
# ---------------------------------------------------------------------------


def bootstrap_partition(
    per_sample_times: Sequence[float], total_batch: float
) -> List[float]:
    """Eq. (8): assign local batches inversely proportional to per-sample time.

    b_i = (Sum_t / t_i) / (Sum_j Sum_t / t_j) * B

    Used in the first two epochs to (a) roughly balance load and (b) make every
    node observe >=2 distinct local batch sizes so the linear models become
    fittable.
    """
    ts = np.asarray(per_sample_times, dtype=np.float64)
    if np.any(ts <= 0):
        raise ValueError("per-sample times must be positive")
    inv = 1.0 / ts
    ratios = inv / inv.sum()
    return [float(r * total_batch) for r in ratios]
