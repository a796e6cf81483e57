"""HeteroTrainer: end-to-end Cannikin training over a (simulated) hetero cluster.

The counterpart of ``repro/train/hetero.py``: real training of a model on
this host (the card, unless ``device="cpu"``) while a ``SimulatedCluster``
supplies the wall-clock the heterogeneous cluster would have taken.  A thin
shell over :class:`repro_torch.runtime.backend.RealBackend` (the gradient
engine) and :class:`repro_torch.runtime.backend.EpochLoop` (the plan →
execute → observe loop), keeping the reference's constructor and its
:class:`EpochResult` history format.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Tuple

from repro_torch.core.simulator import SimulatedCluster
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models.registry import ModelApi
from repro_torch.optim.optimizers import Optimizer
from repro_torch.runtime.backend import EpochLoop, EpochRecord, RealBackend

__all__ = ["HeteroTrainer", "EpochResult"]


@dataclasses.dataclass
class EpochResult:
    """Per-epoch summary in the reference's historical layout."""

    epoch: int
    total_batch: int
    batches: Tuple[int, ...]
    sim_seconds: float          # simulated cluster wall-clock for the epoch
    mean_loss: float
    predicted_batch_time: Optional[float]
    measured_batch_time: float
    b_noise: float
    lr_scale: float
    phase: str

    @classmethod
    def from_record(cls, record: EpochRecord) -> "EpochResult":
        return cls(
            epoch=record.epoch,
            total_batch=record.total_batch,
            batches=record.batches,
            sim_seconds=record.epoch_seconds,
            mean_loss=record.mean_loss,
            predicted_batch_time=record.predicted_batch_time,
            measured_batch_time=record.measured_batch_time,
            b_noise=record.b_noise,
            lr_scale=record.lr_scale,
            phase=record.phase,
        )


class HeteroTrainer:
    def __init__(
        self,
        api: ModelApi,
        optimizer: Optimizer,
        cluster: SimulatedCluster,
        policy: Any,                       # CannikinController or baseline
        data: SyntheticLM,
        *,
        steps_per_epoch: int = 8,
        seed: int = 0,
        device: Any = None,
    ) -> None:
        self.api = api
        self.optimizer = optimizer
        self.cluster = cluster
        self.policy = policy
        self.data = data
        self.steps_per_epoch = steps_per_epoch
        self.backend = RealBackend(
            api,
            optimizer,
            data,
            cluster=cluster,
            seed=seed,
            gns_decay=getattr(policy, "gns_decay", 0.9),
            device=device,
        )
        self.loop = EpochLoop(
            policy, self.backend, steps_per_epoch=steps_per_epoch
        )
        self.history: List[EpochResult] = []

    # -- state passthrough (the reference's surface) ----------------------

    @property
    def params(self):
        return self.backend.params

    @params.setter
    def params(self, value) -> None:
        """Train ``value`` (a model of the same architecture) from here on:
        the backend takes it and its named parameters."""
        self.backend.params = value.requires_grad_(True)
        self.backend.named = dict(value.named_parameters())

    @property
    def opt_state(self):
        return self.backend.opt_state

    @opt_state.setter
    def opt_state(self, value) -> None:
        self.backend.opt_state = value

    @property
    def sim_time(self) -> float:
        return self.backend.sim_time

    def run_epoch(self) -> EpochResult:
        result = EpochResult.from_record(self.loop.run_epoch())
        self.history.append(result)
        return result

    def policy_total_batch(self) -> int:
        """Baselines run fixed total batch (the policy object's ref batch if
        present, else the data default)."""
        return getattr(self.policy, "total_batch", None) or getattr(
            self, "_fixed_total", 64
        )

    def set_fixed_total(self, total: int) -> None:
        """Baselines run a fixed total batch."""
        self._fixed_total = total
        self.loop.fixed_total = total

    def run(self, epochs: int, *, target_loss: Optional[float] = None) -> List[EpochResult]:
        for _ in range(epochs):
            res = self.run_epoch()
            if target_loss is not None and res.mean_loss <= target_loss:
                break
        return self.history
