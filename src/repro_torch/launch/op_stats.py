"""Per-device statistics of a step's op stream (the counterpart of
``repro/launch/hlo_stats.py``).

The reference parses the optimized, partitioned HLO of a compiled step.
The port has no compiler: the dry run runs the step eagerly on fake
tensors (``FakeTensorMode``: shapes, dtypes, no storage), with DTensor
parameters and batches over a fake ``DeviceMesh``, under
:class:`OpStatsMode`, which sees every op the step issues.  It lets
DTensor ops desugar first (it returns ``NotImplemented`` to them), so
what it counts are the ops on each rank's local shards and the
``_c10d_functional`` collectives DTensor issues to redistribute them:
per-device numbers, as the partitioned HLO's are.

  * matmul FLOPs: the ops ``torch.utils.flop_counter`` has a formula for
    (mm, bmm, addmm, baddbmm, convolutions, attention) and the kernels'
    custom ops, whose formulas count their bounds' operations; the
    selective scan's (no products) counts only toward ``flops``;
  * FLOPs: matmul FLOPs, plus 1 per output element of a pointwise op and
    1 per input element of a reduction;
  * bytes accessed: every op's tensor operands and results, views and
    allocations excluded;
  * collective bytes: each collective's result, by kind (``all-reduce``,
    ``all-gather``, ``reduce-scatter``, ``all-to-all``), the reference's
    convention;
  * ``unknown_trip_whiles``: always 0 (an eager step has no loops to
    correct);
  * memory: the live bytes of local tensors (their storages, counted
    once), whose peak over the step is the dry run's temp size.
"""
from __future__ import annotations

import dataclasses
import sys
import weakref
from typing import Dict, Iterable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

__all__ = ["OpStats", "OpStatsMode"]

_COLLECTIVES = {
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
# Custom ops whose formula counts operations off the tensor cores.
_NOT_MATMUL = {"repro_torch::ssm_scan_forward", "repro_torch::ssm_scan_backward"}
_FREE = {"aten::empty", "aten::empty_strided", "aten::empty_like", "aten::new_empty",
         "aten::new_empty_strided", "aten::detach", "aten::alias", "aten::lift_fresh",
         "_c10d_functional::wait_tensor"}


@dataclasses.dataclass
class OpStats:
    flops: float = 0.0
    matmul_flops: float = 0.0
    bytes_accessed: float = 0.0
    collective_bytes: float = 0.0
    collective_by_kind: Dict[str, float] = dataclasses.field(default_factory=dict)
    collective_counts: Dict[str, float] = dataclasses.field(default_factory=dict)
    unknown_trip_whiles: int = 0

    def as_dict(self) -> Dict:
        return {
            "flops": self.flops,
            "matmul_flops": self.matmul_flops,
            "bytes_accessed": self.bytes_accessed,
            "collective_bytes": self.collective_bytes,
            "collective_by_kind": dict(self.collective_by_kind),
            "collective_counts": dict(self.collective_counts),
            "unknown_trip_whiles": self.unknown_trip_whiles,
        }


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _in_sharding_propagation() -> bool:
    """True inside DTensor's sharding propagation, which runs ops on
    global shapes (under the active fake mode, or a new one) to learn
    output metadata: no rank runs them."""
    frame = sys._getframe(2)
    while frame is not None:
        if frame.f_code.co_filename.endswith("_sharding_prop.py"):
            return True
        frame = frame.f_back
    return False


class OpStatsMode(TorchDispatchMode):
    """Counts :class:`OpStats` and live local bytes over the ops issued
    while it is active.  ``stats`` holds the counts; ``live_bytes`` and
    ``peak_bytes`` the memory (arguments registered with
    :meth:`track` count from then on)."""

    def __init__(self):
        super().__init__()
        self.stats = OpStats()
        self.live_bytes = 0
        self.peak_bytes = 0
        self._seen: "weakref.WeakSet" = weakref.WeakSet()
        self._fake_mode = None
        self._depth = 0

    def __enter__(self):
        from torch._guards import active_fake_mode

        if self._depth == 0:
            self._fake_mode = active_fake_mode()
        self._depth += 1
        return super().__enter__()

    def __exit__(self, *exc):
        self._depth -= 1
        return super().__exit__(*exc)

    # -- memory ----------------------------------------------------------
    def _free(self, nbytes: int) -> None:
        self.live_bytes -= nbytes

    def track(self, tensors: Iterable[torch.Tensor]) -> int:
        """Count each (local) tensor's storage as live until it is freed;
        returns the bytes newly counted."""
        from torch.distributed.tensor import DTensor

        added = 0
        for t in tensors:
            if isinstance(t, DTensor):
                t = t._local_tensor
            st = t.untyped_storage()
            if st in self._seen:
                continue
            self._seen.add(st)
            n = st.nbytes()
            weakref.finalize(st, self._free, n)
            added += n
        self.live_bytes += added
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        return added

    # -- ops ---------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._guards import active_fake_mode
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # let DTensor issue its local ops and collectives
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if active_fake_mode() is not self._fake_mode or _in_sharding_propagation():
            return out  # DTensor's sharding propagation, on shapes alone
        self._count(func, args, kwargs, out)
        outs = _tensors(out)
        if outs:
            self.track(outs)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        from torch.utils.flop_counter import flop_registry

        name = func._schema.name
        s = self.stats
        namespace, _, base = name.partition("::")
        if namespace == "_c10d_functional" and base in _COLLECTIVES:
            kind = _COLLECTIVES[base]
            nbytes = sum(_nbytes(t) for t in _tensors(out))
            s.collective_bytes += nbytes
            s.collective_by_kind[kind] = s.collective_by_kind.get(kind, 0.0) + nbytes
            s.collective_counts[kind] = s.collective_counts.get(kind, 0.0) + 1
            return
        packet = func._overloadpacket
        if packet in flop_registry:
            flops = flop_registry[packet](*args, **kwargs, out_val=out)
            s.flops += flops
            if name not in _NOT_MATMUL:
                s.matmul_flops += flops
        elif torch.Tag.pointwise in func.tags:
            s.flops += sum(t.numel() for t in _tensors(out))
        elif torch.Tag.reduction in func.tags or "softmax" in base:
            s.flops += sum(t.numel() for t in _tensors((args, kwargs)))
        if func.is_view or name in _FREE:
            return
        s.bytes_accessed += sum(_nbytes(t) for t in _tensors((args, kwargs, out)))
