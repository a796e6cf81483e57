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
  clock (statistics are real, per-node timing is simulated).  Two program
  shapes: :meth:`RealBackend.execute` reads each step's telemetry back
  (the two-program path), :meth:`RealBackend.execute_fused` ships the
  epoch's batches once, runs every step, a float32 GNS EMA and the goodput
  sweep on the device with no host read in between, and pulls one
  telemetry bundle (the fused epoch).  ``checkpoint``/``restore`` write and
  read the backend's snapshot through :mod:`repro_torch.train.checkpoint`.
* :func:`run_backend_epoch` / :class:`EpochLoop` — the policy loop.

Where the reference takes ``jax.vmap(jax.grad)`` over the node axis, the
port loops over the n nodes: one forward and backward per node on its
padded ``(b_max, S)`` slice with its mask as per-sample weights.  The math
is the same, and each layer's attention is one explicit kernel launch per
node.

``RealBackend(sharded=True)`` is the reference's ``shard_map`` step: the
node axis is split over the ranks of a ``torch.distributed`` group
(:mod:`repro_torch.launch.mesh`; NCCL on cards, gloo on the CPU, a world
of one without a default group).  Each rank backprops its n/d nodes, one
all-reduce gathers every |g_i|^2 so that each rank runs the same global
guard, and another sums the ranks' float32 Eq. (9) partials; every rank
then applies the same update to its replica of the parameters.  Every
rank draws the same global batch from the same stream and takes the same
host decisions.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import (
    Any,
    Callable,
    Dict,
    List,
    Optional,
    Protocol,
    Sequence,
    Tuple,
    runtime_checkable,
)

import numpy as np
import torch

from repro_torch.core.aggregation import ANOMALY_OUTLIER_FACTOR, guard_weights, ratios
from repro_torch.core import optperf_torch
from repro_torch.core.controller import (
    CannikinController,
    EpochPlan,
    FusedProposal,
    FusedSweepContext,
)
from repro_torch.core.gns import GNSState, estimate_gns, gns_update, local_estimates
from repro_torch.core.scheduler import JobSpec
from repro_torch.core.simulator import NodeProfile, SimulatedCluster, StepMeasurement
from repro_torch.data.pipeline import HeteroBatchPartitioner
from repro_torch.launch.mesh import NodeMesh, make_node_mesh
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
    "fused_goodput_sweep",
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


def _clone_state(state, device=None):
    """A copy of an optimizer state tuple: its tensor dicts cloned (onto
    ``device`` when given)."""
    return type(state)(*(
        {k: v.to(device, copy=True) if device is not None else v.clone()
         for k, v in field.items()} if isinstance(field, dict) else field
        for field in state
    ))


@contextlib.contextmanager
def _host_syncs_raise(device: torch.device):
    """On a card, make any host synchronization inside the block raise
    (``torch.cuda.set_sync_debug_mode("error")``); the caller's mode is
    restored after."""
    if device.type != "cuda":
        yield
        return
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(mode)


def fused_goodput_sweep(dc, cand, lo0, b0, b_noise):
    """The fused epoch's last stage, on the device: the OptPerf sweep over
    the candidates ``cand``, each candidate's realized OptPerf (the max
    node time of its partition: a clamped node's fixed floor can sit above
    the bisected water level at small totals), Eq. (6) goodput at the noise
    scale ``b_noise`` and reference batch ``b0``, and the argmax.  Returns
    ``(opt_perfs, goodputs, best, best_partition, sweep_iters)`` as device
    tensors, with no host read."""
    t_stars, sweep_iters = optperf_torch.solve_optperf_sweep_device(dc, cand, lo0)
    parts = optperf_torch.device_partition(dc, t_stars[:, None], cand)
    opt_perfs = optperf_torch.device_node_times(dc, parts).amax(dim=-1)
    bn = torch.clamp_min(b_noise, 0.0)
    eff = torch.where(torch.isfinite(b_noise), (bn + b0) / (bn + cand), 1.0)
    goodputs = (cand / opt_perfs) * eff
    best = torch.argmax(goodputs)
    return (
        opt_perfs, goodputs, best, parts.index_select(0, best.reshape(1))[0],
        torch.full((), sweep_iters, dtype=torch.int32, device=cand.device),
    )


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

    ``sharded=True`` splits the node axis over the ranks of the default
    process group (a world of one without one): see the module docstring.
    Each rank builds its own backend with the same arguments.
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
        sharded: bool = False,
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
        self.sharded = bool(sharded)
        self._fused_cache: Dict[Tuple[int, int], Callable] = {}
        self._meshes: Dict[int, NodeMesh] = {}   # node count -> NodeMesh
        self._mesh: Optional[NodeMesh] = None    # the latest node set's mesh
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
        if self.sharded and self._node_ids:
            self._mesh_for(len(self._node_ids))

    def _mesh_for(self, n: int) -> NodeMesh:
        """The node mesh of an n-node sharded step (its shard count is the
        largest divisor of n that fits the group's ranks), built once per
        n over the one group of the process; the latest is ``_mesh``."""
        mesh = self._meshes.get(n)
        if mesh is None:
            mesh = self._meshes[n] = make_node_mesh(n, device=self.device)
        self._mesh = mesh
        return mesh

    def _node_placer(self, n: int, *, stacked: bool = False) -> Callable:
        """Host ``(n, ...)`` arrays (``(steps, n, ...)`` when ``stacked``)
        -> this rank's node rows on its device: the explicit h2d seam of
        sharded execution.  Every rank holds the whole global batch; none
        is scattered."""
        lo, hi = self._mesh_for(n).node_range()
        dev = self.device

        def place(arr: np.ndarray) -> torch.Tensor:
            part = arr[:, lo:hi] if stacked else arr[lo:hi]
            return torch.as_tensor(np.ascontiguousarray(part), device=dev)

        return place

    # -- gradient engine -------------------------------------------------

    def node_loss_and_grads(self, tokens, labels, mask) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """One node's mean loss over the padded slice ``tokens``/``labels``
        (b_max, S) with per-sample weights ``mask`` (b_max,), and its
        gradient (one tensor per parameter, in ``named`` order)."""
        loss, _ = self.api.loss(
            self.params, {"tokens": tokens, "labels": labels, "weights": mask}
        )
        return loss.detach(), list(torch.autograd.grad(loss, list(self.named.values())))

    def node_grads(self, tokens, labels, mask) -> List[torch.Tensor]:
        """One node's gradient (:meth:`node_loss_and_grads`)."""
        return self.node_loss_and_grads(tokens, labels, mask)[1]

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

    def _sharded_step(self, tok, lab, msk, r, lr_scale, poison):
        """One train step with the node axis split over the mesh, line for
        line the reference's ``_build_sharded_step_body``: ``tok``/``lab``
        (n/d, b_max, S) and ``msk`` (n/d, b_max) are this rank's nodes,
        ``r``/``poison`` (n,) every node's.  The local gradients (x poison)
        and |g_i|^2; one all-reduce of an (n + 2,) float32 vector into which
        each rank writes its own nodes' |g_i|^2 (x + 0 is exact) and its
        partial loss numerator and denominator; the global guard on the
        reduced vector, the same on every rank; the rank's weighted float32
        partial of each leaf, summed over the group, cast to the parameter
        dtype after the sum; |g|^2, the global loss from the per-node means
        weighted by their token sums, the update.  At a world of one the
        local sum runs in :meth:`_step`'s order, so the aggregate is the
        same bits."""
        n = r.shape[0]
        mesh = self._mesh_for(n)
        lo, hi = mesh.node_range()
        dev = self.device
        stats = torch.zeros(n + 2, dtype=torch.float32, device=dev)
        grads = []
        if hi > lo:
            losses = []
            for j, i in enumerate(range(lo, hi)):
                loss_i, g = self.node_loss_and_grads(tok[j], lab[j], msk[j])
                for leaf in g:
                    leaf.mul_(poison[i].to(leaf.dtype))
                grads.append(g)
                losses.append(loss_i)
            stats[lo:hi] = torch.stack([global_norm(g) ** 2 for g in grads])
            # Node i's token-weight sum is mask_i.sum() * S (the loss
            # broadcasts the per-sample mask over the sequence); loss_i x
            # w_sum_i is its loss summand, 0 for an all-padding node.
            w_sum = msk.sum(dim=1) * float(tok.shape[-1])
            stats[n] = (torch.stack(losses).float() * w_sum).sum()
            stats[n + 1] = w_sum.sum()
        mesh.all_reduce_(stats)
        sq_i = stats[:n]
        w, valid = guard_weights(sq_i, r, outlier_factor=self.outlier_factor)
        w = w.float()
        agg = {}
        for j, (name, p) in enumerate(self.named.items()):
            acc = None
            for k, i in enumerate(range(lo, hi)):
                g, grads[k][j] = grads[k][j], None  # free each node's leaf once summed
                term = w[i] * torch.where(valid[i], g, torch.zeros((), dtype=g.dtype,
                                                                   device=g.device)).float()
                acc = term if acc is None else acc + term
            if acc is None:  # a rank past the last shard joins with zeros
                acc = torch.zeros(p.shape, dtype=torch.float32, device=dev)
            agg[name] = mesh.all_reduce_(acc).to(p.dtype)
        del grads
        sq_g = global_norm(agg) ** 2
        loss = stats[n] / torch.clamp(stats[n + 1], min=1e-9)
        _, self.opt_state = self.optimizer.update(agg, self.opt_state, self.named, lr_scale)
        return loss, sq_i, sq_g, valid

    def _step_for(self, n: int, *, stacked: bool = False) -> Tuple[Callable, Callable]:
        """(step, place): the train step for n nodes and the function that
        ships a host ``(n, ...)`` array (``(steps, n, ...)`` when
        ``stacked``) to the device for it."""
        if self.sharded and n > 0:
            return self._sharded_step, self._node_placer(n, stacked=stacked)
        dev = self.device
        return self._step, lambda arr: torch.as_tensor(arr, device=dev)

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
        poison = torch.as_tensor(self._poison(node_ids), device=dev)
        anomaly_counts = np.zeros(n, np.int64)
        step, place = self._step_for(n)

        losses: List[float] = []
        grad_obs: List[GradObservation] = []
        for _ in range(steps):
            tok, lab, msk = self._next_padded(batches, b_max)
            # 4 h2d per step (tok/lab/msk + lr scalar), 4 d2h pulls below —
            # the per-step host round-trips the fused path collapses.
            self.transfers.count_h2d(4)
            self.transfers.count_d2h(4)
            loss, sq_i, sq_g, valid = step(
                place(tok),
                place(lab),
                place(msk),
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

        return self._finish_epoch(batches, steps, node_ids, losses, grad_obs, anomaly_counts)

    def _next_padded(self, batches: List[int], b_max: int):
        """The next step's global batch in the padded layout: tokens and
        labels (n, b_max, S) int32, masks (n, b_max) float32."""
        n = len(batches)
        raw = self.data.batch(self.steps_done, int(sum(batches)))
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
        return tok, lab, msk

    def _poison(self, node_ids: Sequence[int]) -> np.ndarray:
        if self.injector is not None:
            return np.asarray(self.injector.poison_factors(node_ids), np.float32)
        return np.ones(len(node_ids), np.float32)

    def _finish_epoch(self, batches, steps, node_ids, losses, grad_obs, anomaly_counts):
        """Advance the simulated cluster clock over the epoch (timing faults
        through the injector's ``perturb``) and bundle the telemetry."""
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

    # -- fused on-device epoch -------------------------------------------

    def _fused_epoch_fn(self, n: int) -> Callable:
        """The device part of one fused adaptive epoch for ``n`` nodes,
        built once per ``n`` and shard count (the reference's
        ``_fused_epoch_fn``, whose jitted program is cached on the same
        key): every train step (the two-program path's ``_step`` or
        ``_sharded_step``), a float32 Theorem-4.1 GNS EMA, and the OptPerf
        goodput sweep, Eq. (6) argmax and water-fill partition on the final
        state.  It only issues device work: no value is read back to the
        host until the caller pulls the telemetry."""
        sharded = self.sharded and n > 0
        key = (n, self._mesh_for(n).shards if sharded else 0)
        fn = self._fused_cache.get(key)
        if fn is not None:
            return fn
        step, decay = self._step_for(n)[0], float(self.gns_decay)

        def epoch_fn(toks, labs, msks, r, lr_scale, poison, b_vec, gns0, dc, cand, lo0, b0):
            total = b_vec.sum()
            eg, es, cnt = gns0
            losses, sq_is, sq_gs, valids = [], [], [], []
            for s in range(toks.shape[0]):
                loss, sq_i, sq_g, valid = step(toks[s], labs[s], msks[s], r, lr_scale, poison)
                if n >= 2:
                    g_i, s_i = local_estimates(sq_i, sq_g, b_vec, total)
                    # Theorem 4.1 minimum-variance weights in closed form (as
                    # gns.estimate_gns); the EMA skips guarded or degenerate
                    # steps, as the host tracker does.
                    w = (total - b_vec) / ((n - 1) * total)
                    g_est = (w * g_i).sum()
                    s_est = (w * s_i).sum()
                    ok = valid.all() & torch.isfinite(g_est) & torch.isfinite(s_est)
                    eg = torch.where(ok, decay * eg + (1.0 - decay) * g_est, eg)
                    es = torch.where(ok, decay * es + (1.0 - decay) * s_est, es)
                    cnt = torch.where(ok, cnt + 1, cnt)
                losses.append(loss)
                sq_is.append(sq_i)
                sq_gs.append(sq_g)
                valids.append(valid)
            pos = eg > 0.0
            b_noise = torch.where(
                (cnt > 0) & pos,
                torch.clamp_min(es / torch.where(pos, eg, torch.ones_like(eg)), 0.0),
                torch.full_like(eg, math.inf),
            )
            return (
                torch.stack(losses), torch.stack(sq_is), torch.stack(sq_gs),
                torch.stack(valids), eg, es, cnt, b_noise,
            ) + fused_goodput_sweep(dc, cand, lo0, b0, b_noise)

        self._fused_cache[key] = epoch_fn
        return epoch_fn

    def execute_fused(
        self,
        batches: Sequence[int],
        steps: int,
        *,
        lr_scale: float = 1.0,
        ctx: FusedSweepContext,
    ) -> Tuple[ExecutionResult, FusedProposal]:
        """Run one adaptive epoch as a fused device program and return the
        on-device batch proposal for the *next* epoch with the usual
        :class:`ExecutionResult` (the reference's ``execute_fused``).

        The host touches the device twice: one shipment of the whole
        epoch's ``(steps, n, b_max, S)`` tokens and labels, ``(steps, n,
        b_max)`` masks and the epoch's scalars, then one pull of the
        13-leaf telemetry.  In between run the same ``_step`` as
        :meth:`execute` (``steps`` times), a float32 GNS EMA, and the
        goodput sweep over ``ctx.candidates`` at the epoch-final noise
        scale; on a card this runs under
        ``torch.cuda.set_sync_debug_mode("error")``, so a host sync there
        raises.  The caller certifies the proposal afterwards
        (:meth:`CannikinController.stage_fused_proposal`).
        """
        if self.cluster is None:
            raise RuntimeError("RealBackend not configured with a cluster")
        dev = self.device
        if ctx.coeffs.alphas.device != dev or ctx.candidates.device != dev:
            raise ValueError(
                f"fused sweep context on {ctx.coeffs.alphas.device}, backend on {dev}: "
                "build it with fused_context(device=backend.device)"
            )
        batches = [int(b) for b in batches]
        b_max = _quantize(max(batches))
        n = len(batches)
        node_ids = self._node_ids if len(self._node_ids) == n else tuple(range(n))

        # Stage the whole epoch on the host, ship it once.
        staged = [self._next_padded(batches, b_max) for _ in range(steps)]
        toks, labs, msks = (np.stack(parts) for parts in zip(*staged))
        dt = ctx.coeffs.alphas.dtype

        def put(x, dtype=None):
            return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

        place = self._step_for(n, stacked=True)[1]
        args = (
            place(toks), place(labs), place(msks),
            put(ratios(batches), torch.float32),
            float(lr_scale),  # a launch argument, as in execute
            put(self._poison(node_ids)),
            put(batches, torch.float32),
            (put(self.gns.ema_g, torch.float32), put(self.gns.ema_s, torch.float32),
             put(self.gns.count, torch.int32)),
            ctx.coeffs,
            ctx.candidates,
            put(ctx.lo0, dt),
            put(ctx.ref_batch, dt),
        )
        # 3 stacked arrays + r/lr/poison/b_vec + 3 GNS carry scalars +
        # lo0/b0 — every host value entering the epoch, as the reference
        # counts them.
        self.transfers.count_h2d(12)

        with _host_syncs_raise(dev):
            telemetry = self._fused_epoch_fn(n)(*args)
        pulled = [t.cpu().numpy() for t in telemetry]
        self.transfers.count_d2h(len(telemetry))
        (
            losses_a, sq_is, sq_gs, valids, eg, es, cnt, b_noise_dev,
            opt_perfs, goodputs, best, best_batches, sweep_iters,
        ) = pulled

        self.gns = GNSState(ema_g=float(eg), ema_s=float(es), count=int(cnt))
        valids = np.asarray(valids, bool)
        anomaly_counts = (~valids).sum(axis=0)
        self.anomalous_steps += int((~valids.all(axis=1)).sum())
        grad_obs = [
            GradObservation(
                local_sqnorms=tuple(float(x) for x in sq_is[s]),
                global_sqnorm=float(sq_gs[s]),
                batches=tuple(batches),
                valid=tuple(bool(v) for v in valids[s]),
            )
            for s in range(steps)
        ]
        result = self._finish_epoch(
            batches, steps, node_ids, [float(x) for x in losses_a], grad_obs, anomaly_counts
        )
        best_i = int(best)
        cand_np = np.asarray(ctx.candidates_np, np.float64)
        proposal = FusedProposal(
            best_index=best_i,
            total_batch=float(cand_np[best_i]),
            batches=np.asarray(best_batches, np.float64),
            t_star=float(opt_perfs[best_i]),
            t_stars=np.asarray(opt_perfs, np.float64),
            goodputs=np.asarray(goodputs, np.float64),
            b_noise=float(b_noise_dev),
            sweep_iters=int(sweep_iters),
        )
        return result, proposal

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
        optimizer state, GNS state, stream counters.

        Sharded, the parameters and optimizer state are copied to the host
        (CPU tensors: numpy has no bfloat16), as the reference gathers
        them, so the snapshot and the checkpoint files made from it are
        the unsharded layout, byte for byte, and restore onto any later
        mesh."""
        host = torch.device("cpu") if self.sharded else None
        return {
            "params": {k: v.detach().to(host, copy=True) if host is not None
                       else v.detach().clone() for k, v in self.named.items()},
            "opt_state": _clone_state(self.opt_state, host),
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
        self.opt_state = _clone_state(state["opt_state"], self.device)
        g = state["gns"]
        self.gns = GNSState(
            ema_g=float(g["ema_g"]), ema_s=float(g["ema_s"]), count=int(g["count"])
        )
        c = state["counters"]
        self.steps_done = int(c["steps_done"])
        self.sim_time = float(c["sim_time"])

    def checkpoint(self, path: str) -> None:
        """Write :meth:`snapshot` to ``path`` (atomic, checksummed).
        Sharded over more than one rank, rank 0 writes the file and every
        rank waits at a barrier until it is there."""
        from repro_torch.train import checkpoint as ckpt  # lazy: avoids an import cycle

        mesh = (self._mesh or self._mesh_for(1)) if self.sharded else None
        if mesh is None or mesh.rank == 0:
            ckpt.save(path, self.snapshot())
        if mesh is not None and mesh.world > 1:
            mesh.barrier()

    def restore(self, path: str) -> None:
        """Load the snapshot a :meth:`checkpoint` call wrote to ``path``
        (every rank reads the file)."""
        from repro_torch.train import checkpoint as ckpt  # lazy: avoids an import cycle

        self.load_snapshot(ckpt.restore(path, self.snapshot()))


# ---------------------------------------------------------------------------
# backend factory
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RealBackendConfig:
    """Recipe the runtime uses to build a :class:`RealBackend` for each job
    whose :class:`JobSpec` names ``backend="real"``: ``arch``,
    ``SyntheticLM`` data and constant-LR SGD, on ``device`` (the card when
    None).

    ``reduced=True`` (the reference's recipe) builds the reduced config
    (olmo-1b's: float32 with head dim 32), which trains on the CPU and on
    the card, where the flash kernel's float32 instance at (32, 32) takes
    it.  ``reduced=False`` builds the published config in its own dtype
    (bf16 for olmo-1b, head dim 128).  ``sharded=True`` splits each step's node axis
    over the default process group's ranks (a world of one without
    one).  ``n_layers`` cuts the config's depth and keeps its widths (None:
    the config's own depth)."""

    arch: str = "olmo-1b"
    seq_len: int = 32
    lr: float = 0.3
    gns_decay: float = 0.9
    device: Optional[str] = None
    reduced: bool = True
    sharded: bool = False
    n_layers: Optional[int] = None

    def build(
        self, *, noise: float = 0.0, seed: int = 0, injector: Any = None
    ) -> RealBackend:
        from repro_torch.configs import get_api
        from repro_torch.data.pipeline import SyntheticLM
        from repro_torch.models.registry import build_api
        from repro_torch.optim.optimizers import constant_schedule, sgd

        api = get_api(self.arch, reduced=self.reduced)
        if self.n_layers is not None:
            api = build_api(self.arch, dataclasses.replace(api.cfg, n_layers=self.n_layers))
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
            sharded=self.sharded,
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
    fused: bool = False,
) -> Tuple[EpochRecord, ExecutionResult]:
    """One plan → execute → observe cycle over any backend.

    ``policy`` is a :class:`CannikinController` (plans epochs, ingests
    measurement + gradient telemetry) or a baseline partition policy
    (``partition(total, epoch, last_measurement)``).  Returns the unified
    :class:`EpochRecord` plus the raw :class:`ExecutionResult`.

    ``fused=True`` (a CannikinController and a backend with
    ``execute_fused``) runs the epoch as one fused device program: the plan
    consumes the proposal the *previous* fused epoch staged, and this
    epoch's program stages the next one.  Whenever the controller supplies
    no fused context (bootstrap, a policy other than cannikin-gns, a
    certification failure) the cycle is the two-program path.  The context
    is built on the backend's device.
    """
    if isinstance(policy, CannikinController):
        plan = policy.plan_epoch(prefer_fused=fused)
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
    fused_ctx = None
    if (
        fused
        and isinstance(policy, CannikinController)
        and hasattr(backend, "execute_fused")
    ):
        fused_ctx = policy.fused_context(device=backend.device)
    if fused_ctx is not None:
        result, proposal = backend.execute_fused(
            batches, steps, lr_scale=lr_scale, ctx=fused_ctx
        )
    else:
        result, proposal = backend.execute(batches, steps, lr_scale=lr_scale), None
    if isinstance(policy, CannikinController):
        policy.observe_execution(result)
        if proposal is not None:
            policy.stage_fused_proposal(fused_ctx, proposal)
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
    latest epoch's :class:`ExecutionResult` (per-step gradient telemetry).
    ``fused`` runs each adaptive epoch through :func:`run_backend_epoch`'s
    fused path."""

    def __init__(
        self,
        policy: Any,
        backend: "ExecutionBackend",
        *,
        steps_per_epoch: int = 8,
        fixed_total: Optional[int] = None,
        fused: bool = False,
    ) -> None:
        self.policy = policy
        self.backend = backend
        self.steps_per_epoch = steps_per_epoch
        self.fixed_total = fixed_total
        self.fused = fused
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
            fused=self.fused,
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
