"""Heterogeneous-cluster timing simulator.

This container has one CPU device, so the heterogeneous cluster of the paper
(mixed NVIDIA SKUs / shared GPUs) is *simulated*: each node's batch timing
follows the paper's §3.2 semantics exactly —

  * linear compute time  t_compute(b) = (q + k) b + (s + m)
  * constant ring-all-reduce time T_comm = T_o + T_u
  * bucketed overlap: node batch time =
        max(t_compute + T_u, a + gamma * P + T_comm)

with optional multiplicative measurement noise, so the *learning* pipeline
(OLS fits, gamma IVW, T_comm min-aggregation) is exercised under realistic
error — this is what §5.3's prediction-error experiment needs.

The simulator returns per-node *measurements* in the same shape the real
runtime produces (``NodeObservation``), so the controller code is identical
whether driven by simulation or by wall-clock timing of real steps.

A small catalog of GPU-like node profiles (derived from the paper's Table 1/2/3
relative speeds) provides ready-made clusters A, B, and the sharing-induced
cluster C.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.perf_model import (
    ClusterPerfModel,
    CommModel,
    NodeObservation,
    NodePerfModel,
)

__all__ = [
    "NodeProfile",
    "GPU_CATALOG",
    "make_cluster",
    "cluster_A",
    "cluster_B",
    "cluster_C",
    "SimulatedCluster",
    "StepMeasurement",
    "drift_model",
]


def _lognormal_drift(rng: np.random.Generator, rel: float, x: float) -> float:
    """One multiplicative lognormal drift draw — THE per-coefficient drift
    definition shared by :func:`drift_model` and
    :meth:`SimulatedCluster.perturbed` (keep it in one place so benchmarks
    and tests can never exercise diverging drift semantics)."""
    return float(x * math.exp(rng.normal(0.0, rel))) if rel > 0 else float(x)


def drift_model(model: ClusterPerfModel, rel: float, seed: int) -> ClusterPerfModel:
    """Epoch-over-epoch performance drift applied to a fitted model.

    Independent multiplicative lognormal jitter of scale ``rel`` on every
    node coefficient — the single source of truth for the drift scenario the
    warm-started OptPerf re-solve targets (benchmarks and tests share it)."""
    if rel < 0:
        raise ValueError("rel must be >= 0")
    rng = np.random.default_rng(seed)
    nodes = tuple(
        NodePerfModel(
            q=_lognormal_drift(rng, rel, n.q),
            s=_lognormal_drift(rng, rel, n.s),
            k=_lognormal_drift(rng, rel, n.k),
            m=_lognormal_drift(rng, rel, n.m),
        )
        for n in model.nodes
    )
    return ClusterPerfModel(nodes=nodes, comm=model.comm)


@dataclasses.dataclass(frozen=True)
class NodeProfile:
    """Ground-truth node timing profile (what the simulator knows and the
    learner must discover)."""

    name: str
    q: float  # s/sample: data load + forward + update slope
    s: float  # s: fixed overhead of the a-part
    k: float  # s/sample: backprop slope
    m: float  # s: fixed backprop overhead

    def model(self) -> NodePerfModel:
        return NodePerfModel(q=self.q, s=self.s, k=self.k, m=self.m)

    def scaled(self, speed: float, name: Optional[str] = None) -> "NodeProfile":
        """A node `speed`x faster (slopes and overheads divided)."""
        return NodeProfile(
            name=name or f"{self.name}x{speed:.2f}",
            q=self.q / speed,
            s=self.s / speed,
            k=self.k / speed,
            m=self.m / speed,
        )


# Relative FP16 speeds follow the paper's Table 1 and §6 ("A100 ~3.42x
# RTX6000").  Absolute scale is per-workload; these defaults approximate
# ResNet-50/ImageNet per-sample times.  The a-part (data loading + forward +
# update) vs backprop balance differs per node type because the host CPUs
# differ (Tables 2/3: Platinum 8380 vs Gold 6126 vs W-2102) — this is what
# separates the equal-compute fixed point (LB-BSP) from the
# equal-syncStart/mixed OptPerf configuration.
GPU_CATALOG: Dict[str, NodeProfile] = {
    "a100": NodeProfile("a100", q=0.50e-3, s=5e-3, k=1.25e-3, m=8e-3),
    "v100": NodeProfile("v100", q=1.60e-3, s=8e-3, k=2.75e-3, m=9e-3),
    "rtx6000": NodeProfile("rtx6000", q=2.80e-3, s=13e-3, k=3.18e-3, m=6e-3),
    "a5000": NodeProfile("a5000", q=1.70e-3, s=7e-3, k=3.20e-3, m=9e-3),
    "a4000": NodeProfile("a4000", q=3.40e-3, s=12e-3, k=4.45e-3, m=7e-3),
    "p4000": NodeProfile("p4000", q=8.50e-3, s=16e-3, k=9.83e-3, m=8e-3),
}


def make_cluster(
    node_names: Sequence[str],
    *,
    gamma: float = 0.15,
    t_o: float = 45e-3,
    t_u: float = 9e-3,
    workload_scale: float = 1.0,
) -> Tuple[List[NodeProfile], CommModel]:
    """Build (profiles, comm model) from catalog names. ``workload_scale``
    multiplies all compute coefficients (bigger model => bigger scale)."""
    profiles = []
    for name in node_names:
        base = GPU_CATALOG[name]
        profiles.append(
            NodeProfile(
                name=base.name,
                q=base.q * workload_scale,
                s=base.s * workload_scale,
                k=base.k * workload_scale,
                m=base.m * workload_scale,
            )
        )
    return profiles, CommModel(t_o=t_o, t_u=t_u, gamma=gamma)


def cluster_A(**kw) -> Tuple[List[NodeProfile], CommModel]:
    """Paper Table 2: a5000 + a4000 + p4000 (3 nodes)."""
    return make_cluster(["a5000", "a4000", "p4000"], **kw)


def cluster_B(**kw) -> Tuple[List[NodeProfile], CommModel]:
    """Paper Table 3: 4x A100 + 4x V100 + 8x RTX6000 (16 GPUs, GPU=node)."""
    return make_cluster(["a100"] * 4 + ["v100"] * 4 + ["rtx6000"] * 8, **kw)


def cluster_C(n: int = 16, **kw) -> Tuple[List[NodeProfile], CommModel]:
    """Paper §6: sharing-induced heterogeneity — homogeneous RTX6000s whose
    effective speed is evenly spread between 1.0 (full GPU) and 0.25 (quarter
    GPU), mimicking the dummy-workload construction."""
    profiles, comm = make_cluster(["rtx6000"] * n, **kw)
    speeds = np.linspace(1.0, 0.25, n)
    profiles = [p.scaled(sp, name=f"rtx6000@{sp:.2f}") for p, sp in zip(profiles, speeds)]
    return profiles, comm


@dataclasses.dataclass(frozen=True)
class StepMeasurement:
    """What one simulated batch produces, per node."""

    batch_time: float                      # cluster batch time (max over nodes)
    node_times: Tuple[float, ...]          # per-node batch times
    observations: Tuple[NodeObservation, ...]


class SimulatedCluster:
    """Executes the paper's timing semantics with measurement noise.

    ``noise``: multiplicative stddev on every measured quantity (the paper's
    Figure 6 shows gamma measurement noise varies per GPU; we give each node a
    distinct noise level drawn once, so inverse-variance weighting has signal
    to exploit).
    """

    def __init__(
        self,
        profiles: Sequence[NodeProfile],
        comm: CommModel,
        *,
        noise: float = 0.0,
        per_node_gamma_noise: Optional[Sequence[float]] = None,
        seed: int = 0,
    ) -> None:
        self.profiles = list(profiles)
        self.comm = comm
        self.noise = noise
        self._rng = np.random.default_rng(seed)
        if per_node_gamma_noise is None:
            # Heteroscedastic gamma noise in [0.3, 2.2]x of base noise.
            per_node_gamma_noise = self._rng.uniform(0.3, 2.2, len(self.profiles)) * max(
                noise, 1e-12
            )
        self.gamma_noise = np.asarray(per_node_gamma_noise, dtype=np.float64)
        # Coefficient arrays for the vectorized timing path (profiles are
        # frozen dataclasses and the list is never mutated after init).
        self._qs = np.array([p.q for p in self.profiles], dtype=np.float64)
        self._ss = np.array([p.s for p in self.profiles], dtype=np.float64)
        self._ks = np.array([p.k for p in self.profiles], dtype=np.float64)
        self._ms = np.array([p.m for p in self.profiles], dtype=np.float64)

    @property
    def n(self) -> int:
        return len(self.profiles)

    def true_model(self) -> ClusterPerfModel:
        return ClusterPerfModel(
            nodes=tuple(p.model() for p in self.profiles), comm=self.comm
        )

    def _jitter(self, value: float, scale: Optional[float] = None) -> float:
        s = self.noise if scale is None else scale
        if s <= 0:
            return value
        return float(value * math.exp(self._rng.normal(0.0, s)))

    def run_batch(self, batches: Sequence[int]) -> StepMeasurement:
        """Simulate one synchronous batch with local batch sizes ``batches``.

        Per-node reported T_comm includes the wait-for-others term the paper
        describes (fast nodes observe inflated communication time), so the
        min-aggregation in the learner is actually exercised.
        """
        if len(batches) != self.n:
            raise ValueError("batch vector length mismatch")
        comm, gamma = self.comm, self.comm.gamma
        b = np.asarray(batches, dtype=np.float64)
        a_times = self._qs * b + self._ss
        p_times = self._ks * b + self._ms
        if self.noise > 0:
            # One vectorized draw consumes the bit stream exactly like the
            # historical per-node (a, p) interleaved scalar draws.
            eps = self._rng.normal(0.0, self.noise, size=(self.n, 2))
            a_times = a_times * np.exp(eps[:, 0])
            p_times = p_times * np.exp(eps[:, 1])
        sync_starts = a_times + gamma * p_times

        # Ring all-reduce is collective: the last bucket cannot complete
        # before every node reaches its own syncStart + remaining compute.
        # Node batch time per §3.2.3 (max form), with the *cluster-wide*
        # all-reduce gating: every node ends at the same sync-finish time for
        # the final bucket, but local compute may extend past it.
        last_sync_finish = float(
            max(
                (sync_starts + comm.t_comm).max(),
                (a_times + p_times + comm.t_u).max(),
            )
        )
        node_times = (last_sync_finish,) * self.n  # synchronous: all end together

        # Measurement jitter, preserving the historical draw order
        # [gamma_0, comm_0, gamma_1, comm_1, ...] with zero-scale draws
        # skipped (matching the scalar _jitter early-return).
        scales = np.empty((self.n, 2), dtype=np.float64)
        scales[:, 0] = self.gamma_noise
        scales[:, 1] = self.noise
        flat = scales.reshape(-1)
        factors = np.ones(2 * self.n, dtype=np.float64)
        drawn = flat > 0
        if drawn.any():
            factors[drawn] = np.exp(self._rng.normal(0.0, flat[drawn]))
        factors = factors.reshape(self.n, 2)
        measured_gammas = np.clip(gamma * factors[:, 0], 0.0, 1.0)
        # Reported comm time = true T_comm + waiting (nodes that reach
        # syncStart early observe a longer "communication" phase).
        wait = last_sync_finish - (sync_starts + comm.t_comm)
        reported_comm = (comm.t_comm + np.maximum(wait, 0.0)) * factors[:, 1]

        observations = tuple(
            NodeObservation(
                batch_size=float(bi),
                a_time=float(a_times[i]),
                backprop_time=float(p_times[i]),
                gamma=float(measured_gammas[i]),
                comm_time=float(reported_comm[i]),
            )
            for i, bi in enumerate(batches)
        )
        return StepMeasurement(
            batch_time=last_sync_finish,
            node_times=node_times,
            observations=observations,
        )

    def run_epoch(
        self, batches: Sequence[int], steps: int
    ) -> Tuple[float, List[StepMeasurement]]:
        """Simulate ``steps`` batches; returns (epoch seconds, measurements)."""
        measurements = [self.run_batch(batches) for _ in range(steps)]
        return sum(m.batch_time for m in measurements), measurements

    def perturbed(
        self,
        rel: float,
        *,
        seed: int = 0,
        perturb_comm: bool = False,
    ) -> "SimulatedCluster":
        """A cluster whose ground-truth coefficients drifted by ~``rel``.

        Models epoch-to-epoch performance drift (thermal throttling, shared
        hosts, background load) as independent multiplicative lognormal
        jitter on every node coefficient — the scenario the warm-started
        OptPerf re-solve is built for.  ``perturb_comm`` additionally drifts
        T_o/T_u.  Measurement-noise settings and the per-node gamma noise
        profile carry over; the RNG is freshly seeded so drifted clusters
        are reproducible.
        """
        if rel < 0:
            raise ValueError("rel must be >= 0")
        rng = np.random.default_rng(seed)
        profiles = [
            NodeProfile(
                name=p.name,
                q=_lognormal_drift(rng, rel, p.q),
                s=_lognormal_drift(rng, rel, p.s),
                k=_lognormal_drift(rng, rel, p.k),
                m=_lognormal_drift(rng, rel, p.m),
            )
            for p in self.profiles
        ]
        comm = self.comm
        if perturb_comm:
            comm = CommModel(
                t_o=_lognormal_drift(rng, rel, comm.t_o),
                t_u=_lognormal_drift(rng, rel, comm.t_u),
                gamma=comm.gamma,
            )
        return SimulatedCluster(
            profiles,
            comm,
            noise=self.noise,
            per_node_gamma_noise=self.gamma_noise,
            seed=seed + 1,
        )
