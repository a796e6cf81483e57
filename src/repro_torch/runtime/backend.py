"""ExecutionBackend: the plan → execute → observe engine (PyTorch).

The counterpart of ``repro/runtime/backend.py``'s two-program path:

* :class:`ExecutionBackend` — the protocol: ``configure`` (follow node-set
  changes), ``execute`` (run one epoch of ``steps`` batches with a given
  partition, returning :class:`ExecutionResult`), ``snapshot`` /
  ``load_snapshot`` (the state that survives preemption).
* :class:`SimBackend` — the timing simulator behind the protocol, no
  gradients.
* :class:`RealBackend` — the gradient engine: per-node gradients over the
  padded ``(n, b_max)`` layout, the anomaly guard, the Eq. (9) aggregate,
  one optimizer update, a Theorem-4.1 GNS tracker, and a simulated cluster
  clock (statistics are real, per-node timing is simulated).
* :func:`run_backend_epoch` / :class:`EpochLoop` — the policy loop.

Where the reference takes ``jax.vmap(jax.grad)`` over the node axis, the
port loops over the n nodes: one forward and backward per node on its
padded ``(b_max, S)`` slice with its mask as per-sample weights.  The math
is the same, and each layer's attention is one explicit kernel launch per
node.  The fused epoch (``execute_fused``, ROADMAP §1.5), the node-sharded
step (§1.6) and checkpoint files (§1.7) are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Protocol, Sequence, Tuple, runtime_checkable

import numpy as np
import torch

from repro_torch.core.aggregation import ANOMALY_OUTLIER_FACTOR, guard_weights, ratios
from repro_torch.core.controller import CannikinController, EpochPlan
from repro_torch.core.gns import GNSState, estimate_gns, gns_update
from repro_torch.core.scheduler import JobSpec
from repro_torch.core.simulator import NodeProfile, SimulatedCluster, StepMeasurement
from repro_torch.data.pipeline import HeteroBatchPartitioner
from repro_torch.optim.optimizers import global_norm
from repro_torch.runtime.transfers import TransferCounter

__all__ = [
    "GradObservation",
    "ExecutionResult",
    "EpochRecord",
    "ExecutionBackend",
    "SimBackend",
    "RealBackend",
    "RealBackendConfig",
    "BACKENDS",
    "make_backend",
    "run_backend_epoch",
    "EpochLoop",
]


# ---------------------------------------------------------------------------
# telemetry records
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GradObservation:
    """One step's gradient telemetry — the Theorem-4.1 GNS ingredients:
    per-node gradient square-norms |g_i|^2, the aggregated |g|^2, and the
    local batch sizes that produced them.  ``valid`` marks which nodes the
    anomaly guard kept in the Eq. (9) aggregate (empty tuple = unguarded
    legacy observation, treated as all-valid)."""

    local_sqnorms: Tuple[float, ...]
    global_sqnorm: float
    batches: Tuple[int, ...]
    valid: Tuple[bool, ...] = ()

    @property
    def all_valid(self) -> bool:
        return all(self.valid) if self.valid else True


@dataclasses.dataclass(frozen=True)
class ExecutionResult:
    """What one backend epoch produced.

    ``measurements`` carry the per-node timing the performance-model fitters
    consume; ``losses``/``grad_observations`` are the statistical telemetry
    (empty on :class:`SimBackend`); ``b_noise`` is the backend's own GNS
    tracker estimate after the epoch (NaN when the backend computes no
    gradients); ``grad_anomalies`` counts, per node, the steps the anomaly
    guard excluded it.
    """

    epoch_seconds: float
    measurements: Tuple[StepMeasurement, ...]
    losses: Tuple[float, ...]
    grad_observations: Tuple[GradObservation, ...]
    b_noise: float
    grad_anomalies: Tuple[int, ...] = ()

    @property
    def mean_loss(self) -> float:
        return float(np.mean(self.losses)) if self.losses else float("nan")


@dataclasses.dataclass(frozen=True)
class EpochRecord:
    """Unified per-epoch telemetry: plan + execution in one record.
    ``mean_loss`` is NaN and ``b_noise`` non-finite for backends that
    compute no gradients."""

    epoch: int
    backend: str                           # ExecutionBackend.kind
    total_batch: int
    batches: Tuple[int, ...]
    lr_scale: float
    phase: str                             # "bootstrap" | "optperf" | baseline name
    predicted_batch_time: Optional[float]
    measured_batch_time: float
    epoch_seconds: float                   # simulated cluster wall-clock
    mean_loss: float
    b_noise: float
    plan: Optional[EpochPlan] = None


# ---------------------------------------------------------------------------
# the backend protocol
# ---------------------------------------------------------------------------


@runtime_checkable
class ExecutionBackend(Protocol):
    """What the epoch loop needs from an execution engine: ``configure``
    rebinds the backend to a job's node set (learned statistical state
    survives), ``execute`` runs one epoch, ``snapshot``/``load_snapshot``
    expose the state that must survive preemption."""

    kind: str

    def configure(
        self, spec: JobSpec, node_ids: Sequence[int], *, seed: int = 0
    ) -> None: ...

    def execute(
        self, batches: Sequence[int], steps: int, *, lr_scale: float = 1.0
    ) -> ExecutionResult: ...

    def snapshot(self) -> Dict[str, Any]: ...

    def load_snapshot(self, state: Dict[str, Any]) -> None: ...


def _profiles_for(spec: JobSpec, node_ids: Sequence[int]) -> List[NodeProfile]:
    """The job's own ground-truth node models over its held nodes, as timing
    profiles."""
    profiles = []
    for nid in node_ids:
        m = spec.node_models[nid]
        profiles.append(
            NodeProfile(name=f"{spec.name}:n{nid}", q=m.q, s=m.s, k=m.k, m=m.m)
        )
    return profiles


class SimBackend:
    """:class:`SimulatedCluster` behind the :class:`ExecutionBackend`
    protocol: per-node timing measurements with optional multiplicative
    noise, no gradients.  ``injector`` (duck-typed: ``perturb``) transforms
    the measurement stream after the fact, leaving the cluster's RNG
    untouched."""

    kind = "sim"

    def __init__(
        self,
        cluster: Optional[SimulatedCluster] = None,
        *,
        noise: float = 0.0,
        injector: Any = None,
    ) -> None:
        self.cluster = cluster
        self.noise = noise
        self.injector = injector
        self.sim_time = 0.0
        self.epochs_run = 0
        self._job: Optional[str] = None
        self._node_ids: Tuple[int, ...] = ()

    def configure(
        self, spec: JobSpec, node_ids: Sequence[int], *, seed: int = 0
    ) -> None:
        self.cluster = SimulatedCluster(
            _profiles_for(spec, node_ids), spec.comm, noise=self.noise, seed=seed
        )
        self._job = spec.name
        self._node_ids = tuple(int(n) for n in node_ids)

    def execute(
        self, batches: Sequence[int], steps: int, *, lr_scale: float = 1.0
    ) -> ExecutionResult:
        if self.cluster is None:
            raise RuntimeError("SimBackend not configured with a cluster")
        t, ms = self.cluster.run_epoch(list(batches), steps)
        if self.injector is not None:
            t, ms = self.injector.perturb(
                self._job or "?", self._node_ids, t, list(ms)
            )
        self.sim_time += t
        self.epochs_run += 1
        return ExecutionResult(
            epoch_seconds=t,
            measurements=tuple(ms),
            losses=(),
            grad_observations=(),
            b_noise=float("nan"),
        )

    def snapshot(self) -> Dict[str, Any]:
        return {}  # nothing statistical to persist: the sim is rebuilt on resume

    def load_snapshot(self, state: Dict[str, Any]) -> None:
        del state


def _quantize(b: int, q: int = 8) -> int:
    """The padded per-node width, rounded up to a multiple of ``q``, as the
    reference pads it (there to reuse compiled steps)."""
    return max(q, ((b + q - 1) // q) * q)


def _clone_state(state):
    """A copy of an optimizer state tuple: its tensor dicts cloned."""
    return type(state)(*(
        {k: v.clone() for k, v in field.items()} if isinstance(field, dict) else field
        for field in state
    ))


class RealBackend:
    """The real-gradient engine.

    Per step: partition the global batch by the planned local batch sizes,
    take each node's gradient of its mean loss over its padded ``(b_max,
    S)`` slice (pads weighted 0), multiply it by the node's poison factor,
    aggregate g = sum r_i g_i (Eq. 9) behind the always-on anomaly guard,
    update the parameters once, feed (|g_i|^2, |g|^2, b) to the Theorem-4.1
    GNS tracker, and advance the simulated cluster clock.

    ``api`` is a :class:`~repro_torch.models.registry.ModelApi` whose model
    has ``train_forward``; the model is drawn from ``seed`` on ``device``
    (default the card) and trains in place.  ``injector`` is duck-typed:
    ``poison_factors(node_ids)`` multiplies each node's gradient (exactly
    1.0 when healthy, so no-fault runs are unchanged) and ``perturb``
    transforms the timing measurements, as for :class:`SimBackend`.

    The guard: a node whose per-step gradient is non-finite or a gross norm
    outlier is left out of the aggregate (the others renormalized), the GNS
    tracker skips the step, and ``ExecutionResult.grad_anomalies`` counts
    it.  Per-node gradients are held until the guard has every |g_i|^2.
    """

    kind = "real"

    def __init__(
        self,
        api: Any,                        # ModelApi
        optimizer: Any,                  # repro_torch.optim Optimizer
        data: Any,                       # SyntheticLM-compatible stream
        *,
        cluster: Optional[SimulatedCluster] = None,
        noise: float = 0.0,
        seed: int = 0,
        gns_decay: float = 0.9,
        injector: Any = None,
        outlier_factor: Optional[float] = None,
        device: Any = None,
    ) -> None:
        self.api = api
        self.optimizer = optimizer
        self.data = data
        self.cluster = cluster
        self.noise = noise
        self.injector = injector
        self.outlier_factor = (
            float(outlier_factor) if outlier_factor is not None
            else ANOMALY_OUTLIER_FACTOR
        )
        self.params = api.init(seed, device=device).requires_grad_(True)
        self.device = self.params.device
        self.named = dict(self.params.named_parameters())
        self.opt_state = optimizer.init(self.named)
        self.gns = GNSState()
        self.gns_decay = gns_decay
        self.sim_time = 0.0
        self.steps_done = 0
        self.anomalous_steps = 0       # steps with >= 1 excluded node (lifetime)
        self.transfers = TransferCounter()
        self._job: Optional[str] = None
        self._node_ids: Tuple[int, ...] = ()

    # -- node-set binding ------------------------------------------------

    def configure(
        self, spec: JobSpec, node_ids: Sequence[int], *, seed: int = 0
    ) -> None:
        self.cluster = SimulatedCluster(
            _profiles_for(spec, node_ids), spec.comm, noise=self.noise, seed=seed
        )
        self._job = spec.name
        self._node_ids = tuple(int(n) for n in node_ids)

    # -- gradient engine -------------------------------------------------

    def node_grads(self, tokens, labels, mask) -> List[torch.Tensor]:
        """One node's gradient (one tensor per parameter, in ``named``
        order) of its mean loss over the padded slice ``tokens``/``labels``
        (b_max, S) with per-sample weights ``mask`` (b_max,)."""
        loss, _ = self.api.loss(
            self.params, {"tokens": tokens, "labels": labels, "weights": mask}
        )
        return list(torch.autograd.grad(loss, list(self.named.values())))

    def _step(self, tok, lab, msk, r, lr_scale, poison):
        """One train step, line for line the reference's
        ``_build_step_body``: per-node grads (x poison), sq-norms,
        anomaly-guarded Eq. (9) aggregate in float32 (invalid nodes zeroed
        before the sum, the result cast back to the parameter dtype),
        |g|^2, the whole-batch loss, the update."""
        n = tok.shape[0]
        grads = []
        for i in range(n):
            g = self.node_grads(tok[i], lab[i], msk[i])
            for leaf in g:
                leaf.mul_(poison[i].to(leaf.dtype))
            grads.append(g)
        sq_i = torch.stack([global_norm(g) ** 2 for g in grads])
        w, valid = guard_weights(sq_i, r, outlier_factor=self.outlier_factor)
        w = w.float()
        agg = {}
        for j, (name, p) in enumerate(self.named.items()):
            acc = None
            for i in range(n):
                g, grads[i][j] = grads[i][j], None  # free each node's leaf once summed
                term = w[i] * torch.where(valid[i], g, torch.zeros((), dtype=g.dtype,
                                                                   device=g.device)).float()
                acc = term if acc is None else acc + term
            agg[name] = acc.to(p.dtype)
        del grads
        sq_g = global_norm(agg) ** 2
        with torch.no_grad():
            loss, _ = self.api.loss(
                self.params,
                {
                    "tokens": tok.reshape((-1,) + tuple(tok.shape[2:])),
                    "labels": lab.reshape((-1,) + tuple(lab.shape[2:])),
                    "weights": msk.reshape(-1),
                },
            )
        _, self.opt_state = self.optimizer.update(agg, self.opt_state, self.named, lr_scale)
        return loss, sq_i, sq_g, valid

    def execute(
        self, batches: Sequence[int], steps: int, *, lr_scale: float = 1.0
    ) -> ExecutionResult:
        if self.cluster is None:
            raise RuntimeError("RealBackend not configured with a cluster")
        batches = [int(b) for b in batches]
        b_arr = np.asarray(batches, np.int64)
        b_max = _quantize(int(b_arr.max()))
        n = len(batches)
        dev = self.device
        r = torch.as_tensor(ratios(batches), dtype=torch.float32, device=dev)
        self.transfers.count_h2d(2)  # r + poison, shipped once per epoch

        node_ids = self._node_ids if len(self._node_ids) == n else tuple(range(n))
        if self.injector is not None:
            poison_np = self.injector.poison_factors(node_ids)
        else:
            poison_np = np.ones(n, np.float32)
        poison = torch.as_tensor(np.asarray(poison_np, np.float32), device=dev)
        anomaly_counts = np.zeros(n, np.int64)

        losses: List[float] = []
        grad_obs: List[GradObservation] = []
        for _ in range(steps):
            raw = self.data.batch(self.steps_done, int(b_arr.sum()))
            self.steps_done += 1
            padded, _ = HeteroBatchPartitioner.padded(raw, batches)
            seq = padded["tokens"].shape[-1]
            tok = np.zeros((n, b_max, seq), np.int32)
            lab = np.zeros((n, b_max, seq), np.int32)
            msk = np.zeros((n, b_max), np.float32)
            w = padded["tokens"].shape[1]
            tok[:, :w], lab[:, :w] = padded["tokens"], padded["labels"]
            for i, b in enumerate(batches):
                msk[i, :b] = 1.0
            # 4 h2d per step (tok/lab/msk + lr scalar), 4 d2h pulls below —
            # the per-step host round-trips the fused path collapses.
            self.transfers.count_h2d(4)
            self.transfers.count_d2h(4)
            loss, sq_i, sq_g, valid = self._step(
                torch.as_tensor(tok, device=dev),
                torch.as_tensor(lab, device=dev),
                torch.as_tensor(msk, device=dev),
                r,
                float(lr_scale),
                poison,
            )
            valid_np = valid.cpu().numpy().astype(bool)
            anomaly_counts += ~valid_np
            self.anomalous_steps += int(not valid_np.all())
            losses.append(float(loss))
            obs = GradObservation(
                local_sqnorms=tuple(float(x) for x in sq_i.cpu().numpy()),
                global_sqnorm=float(sq_g),
                batches=tuple(batches),
                valid=tuple(bool(v) for v in valid_np),
            )
            grad_obs.append(obs)
            if obs.all_valid:
                # Poisoned steps carry non-finite/outlier sq-norms: feeding
                # them to the Theorem-4.1 tracker would corrupt b_noise.
                self._track_gns(obs)

        epoch_seconds, measurements = self.cluster.run_epoch(batches, steps)
        measurements = list(measurements)
        if self.injector is not None:
            epoch_seconds, measurements = self.injector.perturb(
                self._job or "?", node_ids, epoch_seconds, measurements
            )
        self.sim_time += epoch_seconds
        return ExecutionResult(
            epoch_seconds=epoch_seconds,
            measurements=tuple(measurements),
            losses=tuple(losses),
            grad_observations=tuple(grad_obs),
            b_noise=self.gns.b_noise,
            grad_anomalies=tuple(int(c) for c in anomaly_counts),
        )

    def _track_gns(self, obs: GradObservation) -> None:
        """Theorem-4.1 tracker (same guarded update the controller uses),
        independent of any controller's own tracker."""
        try:
            _, g, s = estimate_gns(obs.local_sqnorms, obs.global_sqnorm, obs.batches)
        except (ValueError, np.linalg.LinAlgError):
            return
        self.gns = gns_update(self.gns, g, s, decay=self.gns_decay)

    # -- preemption state ------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """Everything that must survive preemption, copied: parameters,
        optimizer state, GNS state, stream counters."""
        return {
            "params": {k: v.detach().clone() for k, v in self.named.items()},
            "opt_state": _clone_state(self.opt_state),
            "gns": {
                "ema_g": np.float64(self.gns.ema_g),
                "ema_s": np.float64(self.gns.ema_s),
                "count": np.int64(self.gns.count),
            },
            "counters": {
                "steps_done": np.int64(self.steps_done),
                "sim_time": np.float64(self.sim_time),
            },
        }

    def load_snapshot(self, state: Dict[str, Any]) -> None:
        with torch.no_grad():
            for name, value in state["params"].items():
                self.named[name].copy_(value)
        self.opt_state = _clone_state(state["opt_state"])
        g = state["gns"]
        self.gns = GNSState(
            ema_g=float(g["ema_g"]), ema_s=float(g["ema_s"]), count=int(g["count"])
        )
        c = state["counters"]
        self.steps_done = int(c["steps_done"])
        self.sim_time = float(c["sim_time"])

    def checkpoint(self, path: str) -> None:
        raise NotImplementedError("checkpoint files wait for train/checkpoint.py (ROADMAP §1.7)")

    def restore(self, path: str) -> None:
        raise NotImplementedError("checkpoint files wait for train/checkpoint.py (ROADMAP §1.7)")


# ---------------------------------------------------------------------------
# backend factory
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RealBackendConfig:
    """Recipe for a :class:`RealBackend` per job whose :class:`JobSpec` names
    ``backend="real"``: the reduced ``arch`` (float32, head dim 32, so on
    the CPU only: the CUDA flash kernel takes head dims 64 and 128),
    ``SyntheticLM`` data and constant-LR SGD."""

    arch: str = "olmo-1b"
    seq_len: int = 32
    lr: float = 0.3
    gns_decay: float = 0.9
    device: Optional[str] = None

    def build(
        self, *, noise: float = 0.0, seed: int = 0, injector: Any = None
    ) -> RealBackend:
        from repro_torch.configs import get_api
        from repro_torch.data.pipeline import SyntheticLM
        from repro_torch.optim.optimizers import constant_schedule, sgd

        api = get_api(self.arch, reduced=True)
        data = SyntheticLM(vocab=api.cfg.vocab, seq_len=self.seq_len, seed=seed)
        return RealBackend(
            api,
            sgd(constant_schedule(self.lr)),
            data,
            noise=noise,
            seed=seed,
            gns_decay=self.gns_decay,
            injector=injector,
            device=self.device,
        )


BACKENDS = ("sim", "real")


def make_backend(
    kind: str,
    *,
    noise: float = 0.0,
    seed: int = 0,
    real_config: Optional[RealBackendConfig] = None,
    injector: Any = None,
) -> "ExecutionBackend":
    """Build an execution backend by the name a :class:`JobSpec` carries."""
    if kind == "sim":
        return SimBackend(noise=noise, injector=injector)
    if kind == "real":
        return (real_config or RealBackendConfig()).build(
            noise=noise, seed=seed, injector=injector
        )
    raise ValueError(f"unknown execution backend {kind!r}; choose from {BACKENDS}")


# ---------------------------------------------------------------------------
# the policy loop
# ---------------------------------------------------------------------------


def run_backend_epoch(
    policy: Any,
    backend: "ExecutionBackend",
    *,
    steps: int,
    epoch_index: int = 0,
    last_measurement: Optional[StepMeasurement] = None,
    fixed_total: Optional[int] = None,
) -> Tuple[EpochRecord, ExecutionResult]:
    """One plan → execute → observe cycle over any backend.

    ``policy`` is a :class:`CannikinController` (plans epochs, ingests
    measurement + gradient telemetry) or a baseline partition policy
    (``partition(total, epoch, last_measurement)``).  Returns the unified
    :class:`EpochRecord` plus the raw :class:`ExecutionResult`.
    """
    if isinstance(policy, CannikinController):
        plan = policy.plan_epoch()
        epoch = plan.epoch
        batches = list(plan.batches)
        total = plan.total_batch
        lr_scale = plan.lr_scale
        predicted = plan.predicted_batch_time
        phase = plan.phase
    else:
        plan = None
        epoch = epoch_index
        total = getattr(policy, "total_batch", None) or fixed_total or 64
        batches = policy.partition(total, epoch, last_measurement)
        lr_scale, predicted, phase = 1.0, None, policy.name
    result = backend.execute(batches, steps, lr_scale=lr_scale)
    if isinstance(policy, CannikinController):
        policy.observe_execution(result)
        b_noise = policy.gns.b_noise
    else:
        b_noise = result.b_noise
    record = EpochRecord(
        epoch=epoch,
        backend=getattr(backend, "kind", "?"),
        total_batch=int(total),
        batches=tuple(int(b) for b in batches),
        lr_scale=float(lr_scale),
        phase=phase,
        predicted_batch_time=predicted,
        measured_batch_time=result.epoch_seconds / max(steps, 1),
        epoch_seconds=result.epoch_seconds,
        mean_loss=result.mean_loss,
        b_noise=b_noise,
        plan=plan,
    )
    return record, result


class EpochLoop:
    """The standalone policy loop: drive one (policy, backend) pair epoch by
    epoch, accumulating :class:`EpochRecord` history; ``last_result`` is the
    latest epoch's :class:`ExecutionResult` (per-step gradient telemetry)."""

    def __init__(
        self,
        policy: Any,
        backend: "ExecutionBackend",
        *,
        steps_per_epoch: int = 8,
        fixed_total: Optional[int] = None,
    ) -> None:
        self.policy = policy
        self.backend = backend
        self.steps_per_epoch = steps_per_epoch
        self.fixed_total = fixed_total
        self.epoch = 0
        self.history: List[EpochRecord] = []
        self.last_result: Optional[ExecutionResult] = None
        self._last_measurement: Optional[StepMeasurement] = None

    @property
    def sim_time(self) -> float:
        return self.backend.sim_time  # type: ignore[attr-defined]

    def run_epoch(self) -> EpochRecord:
        record, result = run_backend_epoch(
            self.policy,
            self.backend,
            steps=self.steps_per_epoch,
            epoch_index=self.epoch,
            last_measurement=self._last_measurement,
            fixed_total=self.fixed_total,
        )
        self.epoch += 1
        self.last_result = result
        if result.measurements:
            self._last_measurement = result.measurements[-1]
        self.history.append(record)
        return record

    def run(
        self, epochs: int, *, target_loss: Optional[float] = None
    ) -> List[EpochRecord]:
        for _ in range(epochs):
            record = self.run_epoch()
            if target_loss is not None and record.mean_loss <= target_loss:
                break
        return self.history
