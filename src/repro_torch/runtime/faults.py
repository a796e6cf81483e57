"""Deterministic fault injection for the cluster runtime.

Real heterogeneous clusters straggle, crash, flap, and lie about their
timings — Poplar treats tolerating slow workers as inseparable from
heterogeneous efficiency, and the paper's per-node coefficients (Eqs. 2–6)
only describe hardware that is actually healthy.  This module is the
*injection* third of the fault-tolerance layer (detection lives in
:mod:`repro_torch.runtime.health`, recovery in the
:class:`~repro_torch.runtime.runtime.ClusterRuntime` reconcile loop):

* :class:`FaultPlan` — a frozen, seeded schedule of faults over global
  epoch indices.  Same seed ⇒ bit-identical schedule; composable with any
  trace (:func:`~repro_torch.runtime.trace.synthetic_trace` included) because it
  addresses nodes by global id and time by the runtime's epoch counter.
* :class:`FaultInjector` — applies the plan to ``SimBackend`` executions:
  it perturbs the :class:`~repro_torch.core.simulator.StepMeasurement` stream
  *after* the simulated cluster ran, so the cluster's own RNG stream is
  never consumed or reordered — a replay with no active fault is
  bit-identical to a run with no injector at all.
* :class:`FlakyCheckpointIO` — the injectable I/O seam of
  :func:`repro_torch.train.checkpoint.save`: fails the first N checkpoint write
  attempts with ``OSError`` so the runtime's retry/fallback path is
  exercised deterministically.

Fault kinds:

* :class:`NodeCrash` — silent stop (NOT a polite NodeLeave): from
  ``at_epoch`` the node produces no observations (``None`` in the
  measurement stream) while jobs still hold it, and every epoch that waits
  on it stalls by ``stall``x.  Detection must come from the *absence* of
  telemetry.
* :class:`Straggler` — transient throughput degradation: the node's
  observed a-part/backprop/comm times are multiplied by ``slowdown`` for
  ``duration`` epochs from ``at_epoch`` (cluster batch time follows, since
  the synchronous step waits for the slowest node).  Two windows on the
  same node model a *flapping* node.
* :class:`NoiseSpike` — a measurement-noise burst: per-step multiplicative
  lognormal jitter of scale ``scale`` on the node's observed times for the
  window.  Zero-mean in log-space, so a well-tuned detector should ride it
  out rather than quarantine.
* :class:`FlakyCheckpoints` — the first ``failures`` checkpoint writes
  raise ``OSError`` through the I/O seam.

Real-path integrity faults (the ``RealBackend`` seam):

* :class:`GradientPoison` — a node's per-node gradient contribution goes
  NaN/Inf (or is scaled by a huge factor) for a seeded epoch window.  The
  backend multiplies each node's gradient by the injector's
  :meth:`FaultInjector.poison_factors` vector inside the jitted step; the
  factor is exactly ``1.0`` outside the window, and ``g * 1.0`` is
  IEEE-exact, so no-fault replays stay bit-identical.
* :class:`CheckpointCorruption` — bytes flipped (seeded offsets) in the
  Nth successfully written checkpoint payload, after the atomic rename —
  the on-disk rot that sha256 verification and generation rollback exist
  to survive.
* :class:`SolverStall` — a seeded artificial delay on the first OptPerf
  solve of each window epoch, tripping the deadline watchdog into the
  engine-degradation / last-known-good chain.

All random factors are drawn from *stateless* generators keyed by
``(plan seed, epoch, node)``, so the schedule is bit-identical no matter
how many jobs execute, in what order, or how often a trace is replayed.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.simulator import StepMeasurement

__all__ = [
    "NodeCrash",
    "Straggler",
    "NoiseSpike",
    "FlakyCheckpoints",
    "GradientPoison",
    "CheckpointCorruption",
    "SolverStall",
    "FaultPlan",
    "FaultInjector",
    "FlakyCheckpointIO",
    "FAULT_PLANS",
    "make_fault_plan",
]


# ---------------------------------------------------------------------------
# fault kinds
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class NodeCrash:
    """Silent node death at ``at_epoch``: no observations, ``stall``x epoch
    stall for every job still holding the node.  Permanent — recovery is
    the runtime's job (detect, drain, checkpoint-restore), not the fault's."""

    node: int
    at_epoch: int
    stall: float = 2.0


@dataclasses.dataclass(frozen=True)
class Straggler:
    """Transient ``slowdown``x degradation of one node's observed times for
    ``duration`` epochs starting at ``at_epoch``."""

    node: int
    at_epoch: int
    duration: int
    slowdown: float = 3.0


@dataclasses.dataclass(frozen=True)
class NoiseSpike:
    """Measurement-noise burst: per-step lognormal jitter of scale
    ``scale`` on one node's observed times for ``duration`` epochs."""

    node: int
    at_epoch: int
    duration: int
    scale: float = 0.3


@dataclasses.dataclass(frozen=True)
class FlakyCheckpoints:
    """The first ``failures`` checkpoint write attempts raise OSError."""

    failures: int = 1


@dataclasses.dataclass(frozen=True)
class GradientPoison:
    """One node's gradient contribution is poisoned for ``duration`` epochs
    from ``at_epoch``: ``mode="nan"``/``"inf"`` makes it non-finite,
    ``mode="scale"`` multiplies it by ``factor`` (a gross norm outlier).
    The anomaly guard must exclude it before Eq. (9) aggregation."""

    node: int
    at_epoch: int
    duration: int
    mode: str = "nan"          # "nan" | "inf" | "scale"
    factor: float = 1e6        # used by mode="scale"

    def factor_value(self) -> float:
        if self.mode == "nan":
            return float("nan")
        if self.mode == "inf":
            return float("inf")
        if self.mode == "scale":
            return float(self.factor)
        raise ValueError(f"unknown GradientPoison mode {self.mode!r}")


@dataclasses.dataclass(frozen=True)
class CheckpointCorruption:
    """Flip ``n_bytes`` seeded bytes inside the ``write_index``-th (1-based)
    successfully written checkpoint file — after the atomic rename, so the
    archive exists and passes the torn-write defense but fails sha256
    verification (or outright unzipping) on load."""

    write_index: int = 1
    n_bytes: int = 24


@dataclasses.dataclass(frozen=True)
class SolverStall:
    """The first OptPerf solve of each epoch in the window stalls by
    ``delay`` real seconds — long enough to trip the deadline watchdog,
    which degrades the solver engine instead of hanging the reconcile."""

    at_epoch: int
    duration: int = 1
    delay: float = 0.05


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A seeded, immutable fault schedule (the chaos experiment's input).

    ``seed`` keys every stochastic draw (noise-spike jitter); the fault
    tuples are explicit, so the schedule is bit-identical by construction
    and printable for the trace log.
    """

    seed: int = 0
    crashes: Tuple[NodeCrash, ...] = ()
    stragglers: Tuple[Straggler, ...] = ()
    spikes: Tuple[NoiseSpike, ...] = ()
    flaky_checkpoints: Optional[FlakyCheckpoints] = None
    poisons: Tuple[GradientPoison, ...] = ()
    corruptions: Tuple[CheckpointCorruption, ...] = ()
    solver_stalls: Tuple[SolverStall, ...] = ()

    @classmethod
    def chaos(cls, n_nodes: int, seed: int = 0) -> "FaultPlan":
        """The default chaos plan over a >= 4-node cluster: one crash, one
        transient straggler, one flapping node (two straggler windows, so
        the quarantine backoff doubles), one noise spike, and one flaky
        checkpoint write.  Nodes are drawn from the seeded RNG, excluding
        the highest id (synthetic traces take that node down themselves)."""
        if n_nodes < 4:
            raise ValueError("chaos plan needs >= 4 nodes")
        rng = np.random.default_rng(seed)
        straggler, flapper, crash, spiky = (
            int(i) for i in rng.choice(n_nodes - 1, size=4, replace=False)
        )
        return cls(
            seed=seed,
            crashes=(NodeCrash(node=crash, at_epoch=10, stall=2.0),),
            stragglers=(
                Straggler(node=straggler, at_epoch=4, duration=3, slowdown=3.0),
                # The flapping node: degrades, gets quarantined, recovers,
                # then degrades again after re-admission (backoff doubles).
                Straggler(node=flapper, at_epoch=8, duration=2, slowdown=4.0),
                Straggler(node=flapper, at_epoch=14, duration=3, slowdown=4.0),
            ),
            spikes=(NoiseSpike(node=spiky, at_epoch=6, duration=3, scale=0.2),),
            flaky_checkpoints=FlakyCheckpoints(failures=1),
        )

    @classmethod
    def chaos_small(cls, n_nodes: int, seed: int = 0) -> "FaultPlan":
        """CI-sized chaos: the same fault mix compressed into fewer epochs
        (crash + straggler + flapping node inside a ~16-epoch replay)."""
        if n_nodes < 4:
            raise ValueError("chaos plan needs >= 4 nodes")
        rng = np.random.default_rng(seed)
        straggler, flapper, crash, spiky = (
            int(i) for i in rng.choice(n_nodes - 1, size=4, replace=False)
        )
        return cls(
            seed=seed,
            crashes=(NodeCrash(node=crash, at_epoch=8, stall=2.0),),
            stragglers=(
                Straggler(node=straggler, at_epoch=3, duration=3, slowdown=3.0),
                Straggler(node=flapper, at_epoch=6, duration=2, slowdown=4.0),
                Straggler(node=flapper, at_epoch=11, duration=2, slowdown=4.0),
            ),
            spikes=(NoiseSpike(node=spiky, at_epoch=5, duration=2, scale=0.2),),
            flaky_checkpoints=FlakyCheckpoints(failures=1),
        )

    @classmethod
    def chaos_real(cls, n_nodes: int, seed: int = 0) -> "FaultPlan":
        """The real-path integrity chaos plan over a >= 2-node cluster: one
        node emits NaN gradients for a window (the anomaly guard + numeric
        health channel must contain it), the second successful checkpoint
        write is corrupted on disk (generation rollback must recover), and
        one OptPerf solve stalls (the deadline watchdog must degrade the
        engine).  The poisoned node is drawn from the seeded RNG, excluding
        the highest id (synthetic traces take that node down themselves)."""
        if n_nodes < 2:
            raise ValueError("chaos-real plan needs >= 2 nodes")
        rng = np.random.default_rng(seed)
        poisoned = int(rng.integers(0, max(n_nodes - 1, 1)))
        return cls(
            seed=seed,
            poisons=(
                GradientPoison(node=poisoned, at_epoch=1, duration=2, mode="nan"),
            ),
            corruptions=(CheckpointCorruption(write_index=2, n_bytes=24),),
            solver_stalls=(SolverStall(at_epoch=0, duration=1, delay=0.05),),
        )

    def describe(self) -> List[str]:
        """One line per scheduled fault (trace logs)."""
        out = [
            f"crash(node={c.node}, epoch={c.at_epoch}, stall={c.stall}x)"
            for c in self.crashes
        ]
        out += [
            f"straggler(node={s.node}, epochs={s.at_epoch}..{s.at_epoch + s.duration - 1}, "
            f"{s.slowdown}x)"
            for s in self.stragglers
        ]
        out += [
            f"noise-spike(node={s.node}, epochs={s.at_epoch}..{s.at_epoch + s.duration - 1}, "
            f"scale={s.scale})"
            for s in self.spikes
        ]
        if self.flaky_checkpoints is not None:
            out.append(f"flaky-checkpoints(failures={self.flaky_checkpoints.failures})")
        out += [
            f"gradient-poison(node={p.node}, "
            f"epochs={p.at_epoch}..{p.at_epoch + p.duration - 1}, mode={p.mode})"
            for p in self.poisons
        ]
        out += [
            f"checkpoint-corruption(write={c.write_index}, bytes={c.n_bytes})"
            for c in self.corruptions
        ]
        out += [
            f"solver-stall(epochs={s.at_epoch}..{s.at_epoch + s.duration - 1}, "
            f"delay={s.delay}s)"
            for s in self.solver_stalls
        ]
        return out

    def counts(self) -> Dict[str, int]:
        return {
            "crashes": len(self.crashes),
            "stragglers": len(self.stragglers),
            "noise_spikes": len(self.spikes),
            "flaky_checkpoint_writes": (
                self.flaky_checkpoints.failures if self.flaky_checkpoints else 0
            ),
            "gradient_poisons": len(self.poisons),
            "checkpoint_corruptions": len(self.corruptions),
            "solver_stalls": len(self.solver_stalls),
        }


FAULT_PLANS = ("none", "chaos", "chaos-small", "chaos-real")


def make_fault_plan(name: str, n_nodes: int, seed: int = 0) -> Optional[FaultPlan]:
    """Build a named fault plan (the ``--faults`` CLI vocabulary)."""
    if name in ("none", ""):
        return None
    if name == "chaos":
        return FaultPlan.chaos(n_nodes, seed)
    if name == "chaos-small":
        return FaultPlan.chaos_small(n_nodes, seed)
    if name == "chaos-real":
        return FaultPlan.chaos_real(n_nodes, seed)
    raise ValueError(f"unknown fault plan {name!r}; choose from {FAULT_PLANS}")


# ---------------------------------------------------------------------------
# the injectable checkpoint I/O seam
# ---------------------------------------------------------------------------


class FlakyCheckpointIO:
    """Checkpoint I/O (the ``io`` seam of :func:`repro_torch.train.checkpoint.save`)
    that raises ``OSError`` on the first ``failures`` write attempts, then
    behaves normally.  ``attempts``/``failed`` counters make the retry path
    observable."""

    def __init__(self, failures: int) -> None:
        self.failures = int(failures)
        self.attempts = 0
        self.failed = 0

    def open(self, path: str, mode: str):
        self.attempts += 1
        if self.failed < self.failures:
            self.failed += 1
            raise OSError(f"injected checkpoint write failure #{self.failed}")
        return open(path, mode)

    def replace(self, src: str, dst: str) -> None:
        os.replace(src, dst)


# ---------------------------------------------------------------------------
# the injector
# ---------------------------------------------------------------------------


class FaultInjector:
    """Applies a :class:`FaultPlan` to backend executions.

    One injector is shared by every job of a runtime; the runtime advances
    its global epoch counter (``begin_epoch``) and each job's ``SimBackend``
    calls :meth:`perturb` after its simulated epoch ran.  Perturbation is a
    pure post-transform of the measurement stream — the simulated cluster's
    RNG is untouched, so a no-fault epoch is bit-identical to an
    injector-free run (the layer is invisible until it fires).

    ``injected`` records each fault instance the first epoch it actually
    affected an execution (``{"kind", "node", "epoch"}``) — the telemetry
    the detection-latency / MTTR accounting matches against.
    """

    def __init__(self, plan: FaultPlan) -> None:
        self.plan = plan
        self.epoch = 0
        self.injected: List[Dict[str, object]] = []
        self._seen: set = set()
        self.checkpoint_io: Optional[FlakyCheckpointIO] = (
            FlakyCheckpointIO(plan.flaky_checkpoints.failures)
            if plan.flaky_checkpoints is not None
            else None
        )
        self.checkpoint_writes = 0        # successful writes seen (corruption clock)
        self.corrupted_paths: List[str] = []
        self._stalls_consumed: set = set()

    # -- schedule queries ------------------------------------------------

    def begin_epoch(self, epoch: int) -> None:
        self.epoch = int(epoch)

    def crashed(self, node: int) -> bool:
        return any(c.node == node and self.epoch >= c.at_epoch for c in self.plan.crashes)

    def slowdown(self, node: int) -> float:
        s = 1.0
        for w in self.plan.stragglers:
            if w.node == node and w.at_epoch <= self.epoch < w.at_epoch + w.duration:
                s *= w.slowdown
        return s

    def spike_scale(self, node: int) -> float:
        s = 0.0
        for w in self.plan.spikes:
            if w.node == node and w.at_epoch <= self.epoch < w.at_epoch + w.duration:
                s = max(s, w.scale)
        return s

    # -- real-backend integrity seams ------------------------------------

    def poison_factors(self, node_ids: Sequence[int]) -> np.ndarray:
        """Per-node gradient multipliers for the current epoch: exactly
        ``1.0`` for healthy nodes (``g * 1.0`` is IEEE-exact, so the seam
        is bit-transparent), NaN/Inf/huge inside a poison window."""
        out = np.ones(len(node_ids), dtype=np.float32)
        for i, nid in enumerate(node_ids):
            for p in self.plan.poisons:
                if p.node == int(nid) and p.at_epoch <= self.epoch < p.at_epoch + p.duration:
                    out[i] = np.float32(p.factor_value())
                    self._record(
                        "gradient-poison", int(nid), p.at_epoch,
                        ("poison", int(nid), p.at_epoch, p.duration),
                    )
        return out

    def corrupt_checkpoint(self, path: str) -> bool:
        """Called after each *successful* checkpoint write.  Counts the
        write; when its 1-based index matches a scheduled corruption, flips
        seeded bytes inside ``path``'s payload (past the zip local header)
        and returns True."""
        self.checkpoint_writes += 1
        hits = [
            c for c in self.plan.corruptions
            if c.write_index == self.checkpoint_writes
        ]
        if not hits:
            return False
        size = os.path.getsize(path)
        with open(path, "r+b") as f:
            for c in hits:
                rng = np.random.default_rng(
                    [max(self.plan.seed, 0), 202, self.checkpoint_writes]
                )
                lo = min(256, max(size // 2, 1))
                offsets = rng.integers(low=lo, high=size, size=c.n_bytes)
                for off in offsets:
                    f.seek(int(off))
                    b = f.read(1)
                    f.seek(int(off))
                    f.write(bytes([b[0] ^ 0xFF]))
                self._record(
                    "checkpoint-corruption", None, self.epoch,
                    ("corrupt", c.write_index),
                )
        self.corrupted_paths.append(path)
        return True

    def solver_stall(self) -> float:
        """Seconds the next OptPerf solve should stall — consumed once per
        (stall window, epoch), so the watchdog-triggered degradation retry
        is not re-stalled and makes progress."""
        for s in self.plan.solver_stalls:
            if s.at_epoch <= self.epoch < s.at_epoch + s.duration:
                key = ("stall", s.at_epoch, s.duration, self.epoch)
                if key in self._stalls_consumed:
                    continue
                self._stalls_consumed.add(key)
                self._record(
                    "solver-stall", None, s.at_epoch,
                    ("solver-stall", s.at_epoch, s.duration),
                )
                return float(s.delay)
        return 0.0

    # -- telemetry -------------------------------------------------------

    def _record(self, kind: str, node: int, onset: int, key: object) -> None:
        if key in self._seen:
            return
        self._seen.add(key)
        self.injected.append({"kind": kind, "node": node, "epoch": onset})

    def counts(self) -> Dict[str, int]:
        out = self.plan.counts()
        out["fired"] = len(self.injected)
        if self.checkpoint_io is not None:
            out["checkpoint_writes_failed"] = self.checkpoint_io.failed
        if self.corrupted_paths:
            out["checkpoints_corrupted"] = len(self.corrupted_paths)
        return out

    # -- the perturbation ------------------------------------------------

    def perturb(
        self,
        job: str,
        node_ids: Sequence[int],
        epoch_seconds: float,
        measurements: List[StepMeasurement],
    ) -> Tuple[float, List[StepMeasurement]]:
        """Transform one epoch's measurement stream per the active faults.

        ``node_ids`` maps measurement index -> global node id.  Crashed
        nodes report ``None`` observations (silent stop) and stall the
        synchronous step; stragglers/spikes scale the affected node's
        observed times (cluster batch time follows the slowest node).
        Returns the stream unchanged (same objects) when no fault touches
        this job's nodes — the bit-identity guarantee.
        """
        del job
        n = len(node_ids)
        crashed = [self.crashed(nid) for nid in node_ids]
        slows = [self.slowdown(nid) for nid in node_ids]
        scales = [self.spike_scale(nid) for nid in node_ids]
        if not any(crashed) and all(s == 1.0 for s in slows) and all(
            s == 0.0 for s in scales
        ):
            return epoch_seconds, measurements

        steps = len(measurements)
        # Stateless per-(seed, epoch, node) spike factors: bit-identical no
        # matter how many jobs run or in what order.
        spike_factors = np.ones((n, steps), dtype=np.float64)
        for i, scale in enumerate(scales):
            if scale > 0.0:
                rng = np.random.default_rng(
                    [max(self.plan.seed, 0), 101, self.epoch, int(node_ids[i])]
                )
                spike_factors[i] = np.exp(rng.normal(0.0, scale, size=steps))

        stall = 1.0
        for i, nid in enumerate(node_ids):
            if crashed[i]:
                for c in self.plan.crashes:
                    if c.node == nid and self.epoch >= c.at_epoch:
                        stall = max(stall, c.stall)
                        self._record("crash", nid, c.at_epoch, ("crash", nid, c.at_epoch))
            if slows[i] != 1.0:
                for w in self.plan.stragglers:
                    if w.node == nid and w.at_epoch <= self.epoch < w.at_epoch + w.duration:
                        self._record(
                            "straggler", nid, w.at_epoch,
                            ("straggler", nid, w.at_epoch, w.duration),
                        )
            if scales[i] > 0.0:
                for w in self.plan.spikes:
                    if w.node == nid and w.at_epoch <= self.epoch < w.at_epoch + w.duration:
                        self._record(
                            "noise-spike", nid, w.at_epoch,
                            ("noise-spike", nid, w.at_epoch, w.duration),
                        )

        out: List[StepMeasurement] = []
        total = 0.0
        for s, m in enumerate(measurements):
            obs_out = []
            slowest = 0.0
            for i, obs in enumerate(m.observations):
                if crashed[i] or obs is None:
                    obs_out.append(None)
                    continue
                factor = slows[i] * float(spike_factors[i, s])
                if factor != 1.0:
                    obs = dataclasses.replace(
                        obs,
                        a_time=obs.a_time * factor,
                        backprop_time=obs.backprop_time * factor,
                        comm_time=obs.comm_time * factor,
                    )
                obs_out.append(obs)
                slowest = max(slowest, obs.a_time + obs.backprop_time)
            # The synchronous step waits for the slowest surviving node and
            # stalls on dead ones (timeout semantics, not a clean exit).
            batch_time = max(m.batch_time, slowest) * stall
            total += batch_time
            out.append(
                StepMeasurement(
                    batch_time=batch_time,
                    node_times=(batch_time,) * n,
                    observations=tuple(obs_out),
                )
            )
        return total, out
