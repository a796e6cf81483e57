"""BatchSizePolicy: pluggable total-batch-size adaptation laws.

Cannikin's contribution is *adaptive batch size* training over heterogeneous
clusters, but GNS-driven goodput selection is only one point in the design
space the paper argues over.  This module extracts the total-batch decision
into a protocol the controller (and through it the runtime, per
:attr:`~repro_torch.core.scheduler.JobSpec.batch_policy`) can swap per job:

* ``observe(telemetry)`` ingests EpochRecord-like telemetry (duck-typed:
  anything carrying ``epoch`` / ``total_batch`` / ``mean_loss`` /
  ``b_noise`` attributes — :class:`PolicyTelemetry` is the canonical
  shape);
* ``propose(model, bounds)`` returns a :class:`BatchProposal` — the next
  total batch size *and* the learning-rate scale that goes with it (each
  policy pins its own LR-scaling rule explicitly; see :func:`lr_scale_for`);
* ``state()`` / ``load_state()`` round-trip the policy's adaptation state
  bit-exactly as a checkpointable pytree of numpy scalars, so it rides the
  runtime's existing preemption checkpoint path.

Registered implementations (``BATCH_POLICIES``):

===============  ========================================================
``cannikin-gns``  the paper's law: :class:`~repro_torch.core.goodput.
                  BatchSizeSelector` sweep + AdaScale gain, driven by the
                  Theorem-4.1 gradient-noise scale.  Bit-identical to the
                  pre-protocol controller path (golden-pinned).  Requires
                  gradient telemetry (``requires={"gns"}``).
``adadamp``       loss-ratio damper: B_k = ceil(B_0 * L_0 / L_k) — batch
                  grows as the loss falls (Sievert's AdaDamp).  Requires
                  loss telemetry (``requires={"loss"}``).
``padadamp``      practical/linear-ramp damper: B_k = B_0 + ceil(r * k).
                  Schedule-driven — no gradient or loss telemetry needed.
``geodamp``       geometric damper: B_k = B_0 * f^(k // d) (AdaBatch's
                  batch-doubling schedule).  Schedule-driven.
``fixed``         always the reference batch (the §5.2.2 fixed-batch mode
                  behind the protocol, so provenance is uniform).
===============  ========================================================

Schedule-driven dampers need no gradient telemetry, which makes adaptive
batch sizes meaningful on :class:`~repro.runtime.backend.SimBackend` — not
just the real-gradient backend.  The protocol is observation-driven on
purpose (DYNAMIX-style learned/RL policies plug in via
:func:`register_batch_policy` without another refactor).
"""
from __future__ import annotations

import dataclasses
import inspect
import math
from typing import Any, Dict, Optional, Protocol, Sequence, Tuple, runtime_checkable

import numpy as np

from repro_torch.core.goodput import BatchSizeSelector, adascale_gain, sqrt_lr_scale
from repro_torch.core.optperf import OptPerfSolution
from repro_torch.core.perf_model import ClusterPerfModel

__all__ = [
    "BatchBounds",
    "BatchProposal",
    "PolicyTelemetry",
    "BatchSizePolicy",
    "CannikinGNSPolicy",
    "FixedPolicy",
    "AdaDampPolicy",
    "PadaDampPolicy",
    "GeoDampPolicy",
    "BATCH_POLICIES",
    "LR_RULES",
    "lr_scale_for",
    "make_batch_policy",
    "register_batch_policy",
    "policy_requirements",
]


# ---------------------------------------------------------------------------
# protocol shapes
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BatchBounds:
    """Total-batch bounds the controller derives from its candidate set
    (always containing the reference batch)."""

    min_total: int
    max_total: int

    def clamp(self, total: float) -> int:
        return int(min(max(int(round(total)), self.min_total), self.max_total))


@dataclasses.dataclass(frozen=True)
class BatchProposal:
    """What a policy proposes for the next epoch.

    ``lr_scale`` is part of the proposal on purpose: the LR-scaling rule is
    each policy's explicit choice (AdaScale for GNS-driven selection, linear
    or sqrt for AdaBatch-style schedules), never an implicit controller
    default.  ``solution``/``goodput`` are set only by policies that already
    solved OptPerf for the proposed total (the controller reuses the
    solution instead of re-solving).
    """

    total_batch: int
    lr_scale: float
    solution: Optional[OptPerfSolution] = None
    goodput: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class PolicyTelemetry:
    """EpochRecord-like observation fed to ``observe`` once per planned
    epoch: the previous epoch's total batch and mean loss (NaN for
    gradient-free backends) plus the controller's current GNS estimate."""

    epoch: int
    total_batch: int
    mean_loss: float
    b_noise: float
    phase: str = ""


@runtime_checkable
class BatchSizePolicy(Protocol):
    """The total-batch-size adaptation seam.

    ``requires`` names the telemetry channels the policy cannot function
    without (``"gns"`` — gradient-noise scale, ``"loss"`` — training loss);
    an empty set marks a schedule-driven policy that adapts on any backend.
    """

    name: str
    requires: frozenset
    lr_rule: str

    def observe(self, telemetry: Any) -> None: ...

    def propose(
        self, model: ClusterPerfModel, bounds: BatchBounds
    ) -> BatchProposal: ...

    def state(self) -> Dict[str, Any]: ...

    def load_state(self, state: Dict[str, Any]) -> None: ...


# ---------------------------------------------------------------------------
# LR-scaling rules (satellite: explicit, tested coupling)
# ---------------------------------------------------------------------------

LR_RULES = ("adascale", "sqrt", "linear", "none")


def lr_scale_for(
    rule: str, *, batch: float, ref_batch: float, b_noise: float = float("inf")
) -> float:
    """The learning-rate scale a policy's rule assigns to ``batch``.

    ``adascale`` — the AdaScale gain (GNS-aware; degrades to linear B/B0
    when ``b_noise`` is unknown); ``sqrt`` — square-root scaling (Adam
    workloads, Table 4); ``linear`` — B/B0 (AdaBatch scales LR by the same
    factor as the batch at each schedule step); ``none`` — 1.0 (AdaDamp's
    position: the growing batch itself substitutes for LR decay).
    """
    if rule == "adascale":
        return adascale_gain(b_noise, batch, ref_batch)
    if rule == "sqrt":
        return sqrt_lr_scale(batch, ref_batch)
    if rule == "linear":
        return float(batch / ref_batch)
    if rule == "none":
        return 1.0
    raise ValueError(f"unknown lr rule {rule!r}; choose from {LR_RULES}")


# ---------------------------------------------------------------------------
# implementations
# ---------------------------------------------------------------------------


BATCH_POLICIES: Dict[str, type] = {}


def register_batch_policy(cls: type) -> type:
    """Class decorator: register a policy under ``cls.name`` (the RL/learned
    policy hook — new laws plug in without touching the controller)."""
    BATCH_POLICIES[cls.name] = cls
    return cls


def policy_requirements(name: str) -> frozenset:
    """The telemetry channels the named policy requires (``"gns"``,
    ``"loss"``; empty for schedule-driven policies)."""
    try:
        return BATCH_POLICIES[name].requires
    except KeyError:
        raise ValueError(
            f"unknown batch policy {name!r}; choose from {sorted(BATCH_POLICIES)}"
        ) from None


def make_batch_policy(
    name: str, *, candidates: Sequence[int], ref_batch: int, **kwargs: Any
) -> "BatchSizePolicy":
    """Build a registered policy by name.

    ``selector`` (a shared :class:`BatchSizeSelector`) is forwarded only to
    policies whose constructor accepts it; any other unexpected keyword is
    an error (typos must not silently disappear).
    """
    try:
        cls = BATCH_POLICIES[name]
    except KeyError:
        raise ValueError(
            f"unknown batch policy {name!r}; choose from {sorted(BATCH_POLICIES)}"
        ) from None
    params = inspect.signature(cls.__init__).parameters
    accepted = {k: v for k, v in kwargs.items() if k in params}
    rejected = set(kwargs) - set(accepted) - {"selector"}
    if rejected:
        raise TypeError(
            f"batch policy {name!r} does not accept {sorted(rejected)}"
        )
    return cls(
        candidates=tuple(int(b) for b in candidates),
        ref_batch=int(ref_batch),
        **accepted,
    )


class _PolicyBase:
    """Shared constructor surface: every policy takes the candidate set and
    the reference batch; ``lr_rule=None`` resolves to the class default."""

    name = "base"
    requires: frozenset = frozenset()
    default_lr_rule = "none"

    def __init__(
        self,
        *,
        candidates: Sequence[int],
        ref_batch: int,
        lr_rule: Optional[str] = None,
    ) -> None:
        self.candidates: Tuple[int, ...] = tuple(
            sorted(set(int(b) for b in candidates))
        )
        self.ref_batch = int(ref_batch)
        self.lr_rule = self.default_lr_rule if lr_rule is None else str(lr_rule)
        if self.lr_rule not in LR_RULES:
            raise ValueError(
                f"unknown lr rule {self.lr_rule!r}; choose from {LR_RULES}"
            )

    # default no-op surface; subclasses override what they use
    def observe(self, telemetry: Any) -> None:
        del telemetry

    def state(self) -> Dict[str, Any]:
        return {}

    def load_state(self, state: Dict[str, Any]) -> None:
        del state

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"{type(self).__name__}(ref_batch={self.ref_batch}, lr_rule={self.lr_rule!r})"


@register_batch_policy
class CannikinGNSPolicy(_PolicyBase):
    """The paper's law behind the protocol: the §4.5 cached candidate sweep
    (:class:`BatchSizeSelector`) picks argmax goodput under the tracked
    gradient-noise scale; LR scale is the AdaScale gain.  Plans are
    bit-identical to the pre-protocol ``CannikinController.plan_epoch``
    path (golden-pinned in tests): ``observe`` syncs the controller's live
    ``b_noise`` immediately before every ``propose``, and the selector —
    caches, warm brackets, counters — is the same object the controller
    always owned."""

    name = "cannikin-gns"
    requires = frozenset({"gns"})
    default_lr_rule = "adascale"

    def __init__(
        self,
        *,
        candidates: Sequence[int],
        ref_batch: int,
        lr_rule: Optional[str] = None,
        selector: Optional[BatchSizeSelector] = None,
        solver: str = "algorithm1",
        engine: str = "batched",
    ) -> None:
        super().__init__(candidates=candidates, ref_batch=ref_batch, lr_rule=lr_rule)
        self.selector = selector if selector is not None else BatchSizeSelector(
            candidates=self.candidates,
            ref_batch=self.ref_batch,
            solver=solver,
            engine=engine,
        )
        self.b_noise = float("inf")

    def observe(self, telemetry: Any) -> None:
        b = getattr(telemetry, "b_noise", None)
        if b is not None:
            self.b_noise = float(b)

    def propose(
        self, model: ClusterPerfModel, bounds: BatchBounds
    ) -> BatchProposal:
        del bounds  # the candidate grid already lives within the bounds
        best, sol, gp = self.selector.select(model, self.b_noise)
        return BatchProposal(
            total_batch=int(best),
            lr_scale=lr_scale_for(
                self.lr_rule,
                batch=best,
                ref_batch=self.ref_batch,
                b_noise=self.b_noise,
            ),
            solution=sol,
            goodput=gp,
        )

    def invalidate(self) -> None:
        self.selector.invalidate()

    def state(self) -> Dict[str, Any]:
        return {"b_noise": np.float64(self.b_noise)}

    def load_state(self, state: Dict[str, Any]) -> None:
        self.b_noise = float(state["b_noise"])


@register_batch_policy
class FixedPolicy(_PolicyBase):
    """Always the reference batch — the §5.2.2 fixed-batch evaluation mode
    expressed through the protocol, so non-adaptive plans carry the same
    provenance field as adaptive ones.  Stateless: its checkpoint payload
    is empty, keeping legacy sim-job preemption snapshots byte-identical."""

    name = "fixed"
    requires: frozenset = frozenset()
    default_lr_rule = "adascale"

    def __init__(
        self,
        *,
        candidates: Sequence[int],
        ref_batch: int,
        lr_rule: Optional[str] = None,
    ) -> None:
        super().__init__(candidates=candidates, ref_batch=ref_batch, lr_rule=lr_rule)
        self.b_noise = float("inf")

    def observe(self, telemetry: Any) -> None:
        b = getattr(telemetry, "b_noise", None)
        if b is not None:
            self.b_noise = float(b)

    def propose(
        self, model: ClusterPerfModel, bounds: BatchBounds
    ) -> BatchProposal:
        del model
        total = bounds.clamp(self.ref_batch)
        return BatchProposal(
            total_batch=total,
            lr_scale=lr_scale_for(
                self.lr_rule,
                batch=total,
                ref_batch=self.ref_batch,
                b_noise=self.b_noise,
            ),
        )


class _DamperBase(_PolicyBase):
    """Shared shape for the ported damper family (AdaBatch / adadamp):
    ``start`` defaults to the reference batch; state is numpy scalars so it
    round-trips bit-exactly through the npz checkpoint path."""

    def __init__(
        self,
        *,
        candidates: Sequence[int],
        ref_batch: int,
        lr_rule: Optional[str] = None,
        start: Optional[int] = None,
    ) -> None:
        super().__init__(candidates=candidates, ref_batch=ref_batch, lr_rule=lr_rule)
        self.start = int(start) if start is not None else self.ref_batch
        self.updates = 0

    def observe(self, telemetry: Any) -> None:
        del telemetry
        self.updates += 1

    def _target(self) -> int:
        raise NotImplementedError

    def propose(
        self, model: ClusterPerfModel, bounds: BatchBounds
    ) -> BatchProposal:
        del model  # schedule-driven: the split is the controller's job
        total = bounds.clamp(self._target())
        return BatchProposal(
            total_batch=total,
            lr_scale=lr_scale_for(
                self.lr_rule, batch=total, ref_batch=self.ref_batch
            ),
        )

    def state(self) -> Dict[str, Any]:
        return {"updates": np.int64(self.updates)}

    def load_state(self, state: Dict[str, Any]) -> None:
        self.updates = int(state["updates"])


@register_batch_policy
class GeoDampPolicy(_DamperBase):
    """Geometric schedule: B_k = start * factor^(k // delay) — AdaBatch's
    batch-doubling law (double every ``delay`` observed epochs).  LR scales
    linearly with the batch at each step (AdaBatch pairs each doubling with
    an equivalent LR increase).  Monotone non-decreasing by construction:
    the exponent only grows with the observation count."""

    name = "geodamp"
    requires: frozenset = frozenset()
    default_lr_rule = "linear"

    def __init__(
        self,
        *,
        candidates: Sequence[int],
        ref_batch: int,
        lr_rule: Optional[str] = None,
        start: Optional[int] = None,
        factor: float = 2.0,
        delay: int = 4,
    ) -> None:
        super().__init__(
            candidates=candidates, ref_batch=ref_batch, lr_rule=lr_rule, start=start
        )
        if factor < 1.0:
            raise ValueError("geodamp factor must be >= 1 (monotone schedule)")
        if delay < 1:
            raise ValueError("geodamp delay must be >= 1")
        self.factor = float(factor)
        self.delay = int(delay)

    def _target(self) -> int:
        return int(math.ceil(self.start * self.factor ** (self.updates // self.delay)))


@register_batch_policy
class PadaDampPolicy(_DamperBase):
    """Practical AdaDamp: the linear ramp B_k = start + ceil(rate * k)
    (adadamp's ``ceil(base + increase * updates)`` law).  ``rate`` defaults
    to ``start / 8`` per observed epoch — a doubling over eight epochs.
    Monotone non-decreasing by construction.  LR follows sqrt scaling (the
    gentle rule matching the gradual ramp)."""

    name = "padadamp"
    requires: frozenset = frozenset()
    default_lr_rule = "sqrt"

    def __init__(
        self,
        *,
        candidates: Sequence[int],
        ref_batch: int,
        lr_rule: Optional[str] = None,
        start: Optional[int] = None,
        rate: Optional[float] = None,
    ) -> None:
        super().__init__(
            candidates=candidates, ref_batch=ref_batch, lr_rule=lr_rule, start=start
        )
        self.rate = float(rate) if rate is not None else max(1.0, self.start / 8.0)
        if self.rate < 0:
            raise ValueError("padadamp rate must be >= 0 (monotone schedule)")

    def _target(self) -> int:
        return self.start + int(math.ceil(self.rate * self.updates))


@register_batch_policy
class AdaDampPolicy(_DamperBase):
    """Loss-ratio damper: B_k = ceil(start * L_0 / L_k), floored at
    ``start`` (a loss *increase* never shrinks the batch below the start).
    With no loss telemetry (NaN — e.g. the sim backend) the batch holds at
    ``start``: graceful degradation instead of blow-up.  LR rule ``none``:
    AdaDamp's position is that the growing batch substitutes for LR decay."""

    name = "adadamp"
    requires = frozenset({"loss"})
    default_lr_rule = "none"

    def __init__(
        self,
        *,
        candidates: Sequence[int],
        ref_batch: int,
        lr_rule: Optional[str] = None,
        start: Optional[int] = None,
    ) -> None:
        super().__init__(
            candidates=candidates, ref_batch=ref_batch, lr_rule=lr_rule, start=start
        )
        self.initial_loss = float("nan")
        self.last_loss = float("nan")

    def observe(self, telemetry: Any) -> None:
        super().observe(telemetry)
        loss = getattr(telemetry, "mean_loss", None)
        if loss is None:
            return
        loss = float(loss)
        if not math.isfinite(loss) or loss <= 0:
            return
        if not math.isfinite(self.initial_loss):
            self.initial_loss = loss
        self.last_loss = loss

    def _target(self) -> int:
        if (
            math.isfinite(self.initial_loss)
            and math.isfinite(self.last_loss)
            and self.last_loss > 0
        ):
            ratio = max(1.0, self.initial_loss / self.last_loss)
            return int(math.ceil(self.start * ratio))
        return self.start

    def state(self) -> Dict[str, Any]:
        return {
            "updates": np.int64(self.updates),
            "initial_loss": np.float64(self.initial_loss),
            "last_loss": np.float64(self.last_loss),
        }

    def load_state(self, state: Dict[str, Any]) -> None:
        self.updates = int(state["updates"])
        self.initial_loss = float(state["initial_loss"])
        self.last_loss = float(state["last_loss"])
