"""Host<->device transfer accounting for the runtime hot path.

The fused epoch's gain is stated in host<->device transfers per adaptive
epoch, so the counting lives at the seams where `RealBackend` ships or
fetches values, with the reference's methodology:

* every host value entering a step or an epoch counts as one h2d transfer:
  each `torch.as_tensor(..., device=)` of host data, and each host scalar
  the step takes as a launch argument (the lr scale), as the reference
  counts its shipped scalars;
* every `float(...)` / `.cpu()` pull of a device value counts as one d2h
  transfer per fetched leaf — these are the synchronization points the
  fused path exists to eliminate.

The count is deliberately conservative for the two-program baseline: the
separate OptPerf sweep's own transfers are *not* counted.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

__all__ = ["TransferCounter"]


@dataclasses.dataclass
class TransferCounter:
    """Counts host->device (h2d) and device->host (d2h) array transfers."""

    h2d: int = 0
    d2h: int = 0

    def count_h2d(self, n: int = 1) -> None:
        self.h2d += int(n)

    def count_d2h(self, n: int = 1) -> None:
        self.d2h += int(n)

    @property
    def total(self) -> int:
        return self.h2d + self.d2h

    def reset(self) -> None:
        self.h2d = 0
        self.d2h = 0

    def snapshot(self) -> Dict[str, int]:
        return {"h2d": self.h2d, "d2h": self.d2h, "total": self.total}
