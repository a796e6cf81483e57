"""Host<->device transfer accounting for the runtime hot path.

The fused-epoch perf gate (benchmarks/bench_overhead.py) is stated in
host<->device transfers per adaptive epoch, so the counting has to live at
the seams where `RealBackend` actually ships or fetches arrays — not be
inferred from jit internals.  Methodology (also in benchmarks/README.md):

* every `jnp.asarray` / `jax.device_put` of host data the backend performs
  counts as one h2d transfer (scalars included: a shipped scalar is still
  a host->device round trip in the dispatch path);
* every `float(...)` / `np.asarray(...)` / `jax.device_get` pull of a
  device value counts as one d2h transfer per fetched leaf — these are the
  synchronization points the fused path exists to eliminate.

The count is deliberately conservative for the two-program baseline: the
separate OptPerf sweep jit's own transfers are *not* counted, so the
fused/two-program ratio reported by the bench is a lower bound.
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
