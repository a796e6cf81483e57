"""The scheduler's job description (:class:`JobSpec`), which the execution
backends read their timing profiles from.

The counterpart of ``repro/core/scheduler.py::JobSpec``, copied verbatim.
The multi-job scheduler itself comes with the runtime (ROADMAP §1.7).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence, Tuple

from repro_torch.core.goodput import statistical_efficiency
from repro_torch.core.optperf import solve_optperf_waterfill_subset
from repro_torch.core.perf_model import ClusterPerfModel, CommModel, NodePerfModel

__all__ = ["JobSpec"]


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
