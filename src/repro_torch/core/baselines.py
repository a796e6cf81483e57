"""Baseline batch-partition policies the paper compares against (§5.1).

Every policy exposes the same interface as the Cannikin controller:
``partition(total_batch, epoch, last_measurement) -> List[int]`` so the
simulator / trainer can drive any of them interchangeably.

* :class:`EvenPartition`   — PyTorch DDP / AdaptDL: equal local batches.
  (AdaptDL additionally adapts the *total* batch size; in heterogeneous
  clusters its per-node split is still even — §5.2.2 notes its batch
  processing time equals DDP's.)
* :class:`LBBSPPartition`  — LB-BSP (Chen et al., SoCC'20): semi-dynamic
  load balancing; after each epoch moves ``delta`` samples from the slowest
  node to the fastest node (step size Δ=5 per the paper's evaluation).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core.optperf import round_batches
from repro_torch.core.simulator import StepMeasurement

__all__ = ["EvenPartition", "LBBSPPartition"]


class EvenPartition:
    """DDP / AdaptDL split: b_i = B / n (largest-remainder rounded)."""

    name = "even"

    def __init__(self, n_nodes: int) -> None:
        self.n = n_nodes

    def partition(
        self,
        total_batch: int,
        epoch: int,
        last: Optional[StepMeasurement] = None,
    ) -> List[int]:
        return round_batches([total_batch / self.n] * self.n, total_batch)


class LBBSPPartition:
    """LB-BSP-style iterative tuner.

    Each epoch: compute per-node sample throughput from the last measurement,
    then shift up to ``delta`` samples from the slowest (per-sample time) node
    to the fastest.  Converges to equal compute times but needs many epochs
    (paper Fig. 9: >10 epochs vs Cannikin's 3) and re-converges from scratch
    whenever the total batch size changes.
    """

    name = "lb-bsp"

    def __init__(self, n_nodes: int, delta: int = 5) -> None:
        self.n = n_nodes
        self.delta = delta
        self._batches: Optional[List[int]] = None
        self._last_total: Optional[int] = None

    def partition(
        self,
        total_batch: int,
        epoch: int,
        last: Optional[StepMeasurement] = None,
    ) -> List[int]:
        if self._batches is None or self._last_total != total_batch:
            # Restart from even on any total-batch change (LB-BSP's weakness
            # under adaptive batch sizing, §5.2.2 "With adaptive batch size").
            self._batches = round_batches(
                [total_batch / self.n] * self.n, total_batch
            )
            self._last_total = total_batch
            return list(self._batches)
        if last is not None:
            obs = last.observations
            per_sample = np.array(
                [
                    (o.a_time + o.backprop_time) / max(o.batch_size, 1.0)
                    for o in obs
                ]
            )
            # Straggler = largest *total* compute time; recipient = node that
            # would finish soonest with extra work.
            totals = np.array([o.a_time + o.backprop_time for o in obs])
            slow = int(np.argmax(totals))
            fast = int(np.argmin(per_sample))
            if slow != fast:
                move = min(self.delta, self._batches[slow] - 1)
                if move > 0:
                    self._batches[slow] -= move
                    self._batches[fast] += move
        return list(self._batches)
