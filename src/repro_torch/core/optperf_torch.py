"""On-device OptPerf: the batched water-fill sweep on torch tensors.

The counterpart of ``repro/core/optperf_jax.py``.  The whole goodput sweep —
a ``(C,)`` bracket vector bisected against the ``(C, n)`` feasible-batch
matrix — runs as plain tensor ops on one device:

  * :func:`device_coeffs`: :attr:`ClusterPerfModel.coeffs` exported once as
    stacked device tensors, cached per (model, dtype, device) in an LRU of
    128 entries whose content stamp is re-checked on every lookup;
  * geometric bracket growth as a fixed 64-trip loop (the reference's
    ``lax.while_loop`` exits once every row is satisfied; past that point
    the masked update leaves the state unchanged, so the fixed loop gives
    the same brackets with no host read of an ``any(...)``);
  * a fixed-trip-count bisection (the reference's ``lax.fori_loop``).

So a cold sweep issues its launches and never reads a device value back:
:class:`RealBackend.execute_fused <repro_torch.runtime.backend.RealBackend>`
runs it after the epoch's train steps with no host sync between them.

:func:`solve_optperf_stacked_jax` is the cluster-scale variant: C
independent stacked rows (each its own node subset and comm model, padded
to one width and masked) bisected together — the multi-job scheduler's
per-round solve.  Its export is cached on the
:class:`~repro_torch.core.perf_model.StackedClusterModel` instance.  Every
cached export carries a content stamp (a checksum of the live coefficient
arrays) re-checked at solve time: an in-place refresh that forgot
``invalidate_device_cache()`` drops the stale export and every derived
cache, and a fresh one is shipped.

Warm starts (host-called solves only) seed the brackets from the previous
epoch's ``t_stars`` (±``warm_delta`` relative), reset a seeded lower edge
that already over-assigns to the cold bound, and stop bisecting once every
bracket has converged; that test reads one flag from the device per trip,
as the NumPy engine's loop does on the host.

Precision: float32 unless ``dtype`` is given (the reference's default with
x64 off).  The host-called solves certify and finalize ``t_stars`` in
float64 through the same :func:`repro_torch.core.optperf._finalize_batches`
as the NumPy engine, so the engines agree to the device dtype's resolution
(<= 1e-5 relative in float32).

The names keep the reference's (``solve_optperf_batch_jax``,
``solve_optperf_stacked_jax``): they are the values of the public engine
name ``"jax"``, "the on-device sweep".  Entry points run on the card unless
``device="cpu"`` is passed.
"""
from __future__ import annotations

import collections
import math
import zlib
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.optperf import (
    BatchedOptPerfSolution,
    _finalize_batches,
    _p_assigned,
    _p_best_single_node_time,
    _p_compute_mask,
    _problem_from_model,
    _problem_from_stack,
    _validated_totals,
)
from repro_torch.core.perf_model import ClusterPerfModel, StackedClusterModel

__all__ = [
    "DeviceCoeffs",
    "StackedDeviceCoeffs",
    "device_coeffs",
    "evict_device_coeffs",
    "model_stamp",
    "stack_stamp",
    "stacked_device_coeffs",
    "device_partition",
    "device_node_times",
    "solve_optperf_sweep_device",
    "solve_optperf_batch_jax",
    "solve_optperf_stacked_jax",
]

_GROWTH_ITERS = 64


def _device(device) -> torch.device:
    """``device`` as a concrete torch device; None means the card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _dtype(dtype) -> torch.dtype:
    if dtype is None:
        return torch.float32
    if isinstance(dtype, torch.dtype):
        return dtype
    return {"float32": torch.float32, "float64": torch.float64}[np.dtype(dtype).name]


def _eps(dt: torch.dtype) -> float:
    return float(torch.finfo(dt).eps)


def _on(x, dt: torch.dtype, dev: torch.device) -> torch.Tensor:
    """``x`` as a ``dt`` tensor on ``dev``.  A tensor must already live on
    ``dev``: a CPU value is never copied into a device program silently."""
    if isinstance(x, torch.Tensor):
        if x.device != dev:
            raise ValueError(f"sweep input on {x.device}, coefficients on {dev}")
        return x.to(dt)
    return torch.as_tensor(np.array(x, np.float64), dtype=dt, device=dev)


def model_stamp(model: ClusterPerfModel) -> int:
    """Content checksum of the coefficient numbers a solve would consume
    (``optperf_jax.model_stamp``): the memoized ``coeffs`` view plus the
    comm model, so a model refreshed in place stamps differently than at
    export time."""
    acc = 0
    c = model.coeffs
    for arr in (c.alphas, c.cs, c.betas, c.ds, c.ks, c.ms):
        acc = zlib.crc32(np.ascontiguousarray(arr).tobytes(), acc)
    comm = np.array([model.comm.t_o, model.comm.t_u, model.comm.gamma], np.float64)
    return zlib.crc32(comm.tobytes(), acc)


def stack_stamp(stack: StackedClusterModel) -> int:
    """Content checksum of a stack's live coefficient arrays
    (``optperf_jax.stack_stamp``), re-checked on every solve."""
    acc = 0
    for arr in (stack.alphas, stack.cs, stack.betas, stack.ds, stack.ks,
                stack.ms, stack.t_o, stack.t_u, stack.gamma, stack.mask):
        acc = zlib.crc32(np.ascontiguousarray(arr).tobytes(), acc)
    return acc


class DeviceCoeffs(NamedTuple):
    """Stacked device-tensor view of one cluster's OptPerf coefficients
    (``optperf_jax.DeviceCoeffs``)."""

    alphas: torch.Tensor       # (n,)
    cs: torch.Tensor           # (n,)
    safe_betas: torch.Tensor   # (n,) betas with 1.0 at degenerate slots
    degenerate: torch.Tensor   # (n,) bool: beta <= 0 (syncStart flat in b)
    ds: torch.Tensor           # (n,)
    t_u: torch.Tensor          # 0-dim
    t_comm: torch.Tensor       # 0-dim


# LRU-bounded single-model export cache, a plain dict so that membership
# changes can evict a model's entries (CannikinController.add_nodes /
# remove_nodes).  Entries are (content_stamp, DeviceCoeffs), keyed on
# (model, dtype name, device).
_DEVICE_COEFFS_LIMIT = 128
_DEVICE_COEFFS: "collections.OrderedDict[Tuple[ClusterPerfModel, str, str], Tuple[int, DeviceCoeffs]]" = (
    collections.OrderedDict()
)


def _device_coeffs_cached(
    model: ClusterPerfModel, dt: torch.dtype, dev: torch.device
) -> DeviceCoeffs:
    key = (model, str(dt).replace("torch.", ""), str(dev))
    stamp = model_stamp(model)
    hit = _DEVICE_COEFFS.get(key)
    if hit is not None:
        if hit[0] == stamp:
            _DEVICE_COEFFS.move_to_end(key)
            return hit[1]
        # The model's numbers changed under a cached export: drop every
        # export of this model and the host views memoized from the old
        # numbers, then rebuild and re-stamp from the clean views.
        evict_device_coeffs(model)
        for slot in ("coeffs", "_optperf_problem", "_validated"):
            model.__dict__.pop(slot, None)
        stamp = model_stamp(model)
    c = model.coeffs
    degenerate = c.betas <= 0.0
    dc = DeviceCoeffs(
        alphas=_on(c.alphas, dt, dev),
        cs=_on(c.cs, dt, dev),
        safe_betas=_on(np.where(degenerate, 1.0, c.betas), dt, dev),
        degenerate=torch.as_tensor(degenerate, device=dev),
        ds=_on(c.ds, dt, dev),
        t_u=_on(model.comm.t_u, dt, dev),
        t_comm=_on(model.comm.t_comm, dt, dev),
    )
    _DEVICE_COEFFS[key] = (stamp, dc)
    while len(_DEVICE_COEFFS) > _DEVICE_COEFFS_LIMIT:
        _DEVICE_COEFFS.popitem(last=False)
    return dc


def evict_device_coeffs(model: ClusterPerfModel) -> int:
    """Drop every cached export of ``model`` (all dtypes and devices);
    returns the number of entries evicted (``optperf_jax.evict_device_coeffs``)."""
    stale = [key for key in _DEVICE_COEFFS if key[0] == model]
    for key in stale:
        del _DEVICE_COEFFS[key]
    return len(stale)


def device_coeffs(model: ClusterPerfModel, dtype=None, device=None) -> DeviceCoeffs:
    """Export (and cache) a model's coefficient arrays on ``device`` (the
    card unless given) in ``dtype`` (float32 unless given)
    (``optperf_jax.device_coeffs``)."""
    return _device_coeffs_cached(model, _dtype(dtype), _device(device))


def _device_feasible(tt, alphas, cs, safe_betas, degenerate, ds, t_u, t_comm):
    """Clamped per-node feasible batch at cluster time(s) ``tt``
    (``optperf_jax._device_feasible``); ``tt`` must already broadcast
    against the ``(..., n)`` coefficient tensors."""
    b_compute = (tt - t_u - cs) / alphas
    slack = tt - t_comm - ds
    inf = torch.full_like(slack, math.inf)
    b_comm = torch.where(
        degenerate, torch.where(slack >= 0.0, inf, -inf), slack / safe_betas
    )
    return torch.clamp_min(torch.minimum(b_compute, b_comm), 0.0)


def _sweep_body(
    lo, hi, lo0, totals, tol,
    alphas, cs, safe_betas, degenerate, ds, t_u, t_comm, mask,
    *, max_iter: int, warm: bool,
):
    """The bracket-growth and bisection loops shared by every device sweep
    (``optperf_jax._sweep_body``).  ``mask`` is None for one model and the
    ``(C, n)`` padding mask for stacked rows; ``lo0`` is a 0-dim tensor
    (one model) or a per-row vector (stacked).

    Growth and the cold bisection run fixed trip counts and read nothing
    back.  The warm bisection (``warm=True``, host-called solves only) first
    resets seeded lower edges that already over-assign to ``lo0``, then
    stops once every bracket is within ``tol``: one flag read per trip.
    Returns ``(lo, hi, iters)``; ``iters`` is a host int.
    """

    def assigned(t):
        b = _device_feasible(
            t[:, None], alphas, cs, safe_betas, degenerate, ds, t_u, t_comm
        )
        if mask is not None:
            b = torch.where(mask, b, 0.0)
        return b.sum(dim=-1)

    if warm:
        lo = torch.where(assigned(lo) >= totals, lo0, lo)

    for _ in range(_GROWTH_ITERS):
        hi = torch.where(assigned(hi) < totals, lo0 + (hi - lo0) * 2.0, hi)

    def bisect_step(lo, hi):
        mid = 0.5 * (lo + hi)
        ge = assigned(mid) >= totals
        return torch.where(ge, lo, mid), torch.where(ge, mid, hi)

    if warm:
        iters = 0
        while iters < max_iter and bool(
            (hi - lo > tol * torch.clamp_min(hi.abs(), 1.0)).any()
        ):
            lo, hi = bisect_step(lo, hi)
            iters += 1
    else:
        for _ in range(max_iter):
            lo, hi = bisect_step(lo, hi)
        iters = max_iter
    return lo, hi, iters


def solve_optperf_sweep_device(
    coeffs: DeviceCoeffs,
    total_batches,
    lo0,
    *,
    tol=None,
    max_iter: int = 64,
    lo=None,
    hi=None,
    warm: bool = False,
):
    """The candidate sweep as device ops: ``(t_stars, iters)``
    (``optperf_jax.solve_optperf_sweep_device``).

    With tensor inputs on the coefficients' device and ``warm=False`` it
    reads nothing back, so it runs inside the fused epoch with no host
    sync; the float64 certification of :func:`solve_optperf_batch_jax` is
    the caller's (``CannikinController.stage_fused_proposal``).  Returns
    the ``(C,)`` refined upper bracket edge and the bisection trip count.
    """
    dt, dev = coeffs.alphas.dtype, coeffs.alphas.device
    totals = _on(total_batches, dt, dev)
    lo0_dev = _on(lo0, dt, dev)
    if tol is None:
        tol = 8.0 * _eps(dt)
    if lo is None:
        lo = lo0_dev.expand(totals.shape).clone()
    if hi is None:
        hi = lo + 1.0
    _, hi_out, iters = _sweep_body(
        lo, hi, lo0_dev, totals, tol,
        coeffs.alphas, coeffs.cs, coeffs.safe_betas, coeffs.degenerate,
        coeffs.ds, coeffs.t_u, coeffs.t_comm, None,
        max_iter=int(max_iter), warm=warm,
    )
    return hi_out, iters


def device_partition(coeffs: DeviceCoeffs, t_star, total):
    """On-device batch partition at cluster time ``t_star``: clamp, then
    rescale to sum to ``total`` (``optperf_jax.device_partition``).  No
    float64 certification: callers certify on the host."""
    b = _device_feasible(
        t_star, coeffs.alphas, coeffs.cs, coeffs.safe_betas,
        coeffs.degenerate, coeffs.ds, coeffs.t_u, coeffs.t_comm,
    )
    s = b.sum(dim=-1, keepdim=True)
    total = _on(total, b.dtype, b.device)
    scale = torch.where(s > 0.0, total[..., None] / s, 0.0)
    return b * scale


def device_node_times(coeffs: DeviceCoeffs, batches):
    """Per-node batch times ``max(alpha b + c + t_u, beta b + d + t_comm)``
    (``optperf_jax.device_node_times``); the row maximum over a finalized
    partition is the candidate's realized OptPerf."""
    betas = torch.where(coeffs.degenerate, 0.0, coeffs.safe_betas)
    return torch.maximum(
        coeffs.alphas * batches + coeffs.cs + coeffs.t_u,
        betas * batches + coeffs.ds + coeffs.t_comm,
    )


def _certify(p, totals_np: np.ndarray, hi_out: torch.Tensor, dt: torch.dtype, what: str):
    """Host float64 certification (the reference's loop, verbatim): nudge
    each device ``t_star`` up by dtype-epsilon steps until the float64
    upper invariant holds.  Returns ``(t_star, polish)``."""
    t_star = hi_out.detach().cpu().numpy().astype(np.float64)
    nudge = 8.0 * _eps(dt)
    polish = 0
    for _ in range(64):
        deficit = _p_assigned(p, t_star) < totals_np
        polish += 1
        if not deficit.any():
            break
        t_star = np.where(deficit, t_star * (1.0 + nudge) + 1e-300, t_star)
    else:
        raise RuntimeError(f"{what} t_star failed float64 certification")
    return t_star, polish


def _warm_brackets(p, lo0, totals_np, warm_start, warm_delta, lo0_dev, dt, dev):
    """Seeded ``(lo, hi)`` from the previous ``t_stars``: seeds clamped to
    the best single node's time, unusable ones reset above ``lo0``."""
    w = np.asarray(warm_start, dtype=np.float64)
    if w.shape != totals_np.shape:
        raise ValueError("warm_start shape must match total_batches")
    t_ub = _p_best_single_node_time(p, totals_np)
    w = np.where(np.isfinite(w) & (w > lo0), np.minimum(w, t_ub), lo0 + 1.0)
    lo = torch.maximum(_on(w * (1.0 - warm_delta), dt, dev), lo0_dev)
    hi = torch.maximum(_on(w * (1.0 + warm_delta), dt, dev), lo0_dev)
    return lo, hi


def solve_optperf_batch_jax(
    model: ClusterPerfModel,
    total_batches: Sequence[float],
    *,
    tol: float = 1e-10,
    max_iter: int = 64,
    warm_start: Optional[np.ndarray] = None,
    warm_delta: float = 1e-3,
    dtype=None,
    device=None,
) -> BatchedOptPerfSolution:
    """Solve the whole candidate sweep on ``device``; finalize on the host
    in float64 (``optperf_jax.solve_optperf_batch_jax``).

    Contract-compatible with :func:`repro_torch.core.optperf.solve_optperf_batch`:
    the same solution type, exact-sum partitions, ``t_stars`` usable as the
    next epoch's ``warm_start``.  The cold sweep runs ``max_iter`` trips;
    the warm sweep stops once every bracket has converged.
    """
    totals_np = _validated_totals(total_batches)
    model.validate()
    dc = device_coeffs(model, dtype, device)
    dt, dev = dc.alphas.dtype, dc.alphas.device
    p, lo0 = _problem_from_model(model)

    totals_dev = _on(totals_np, dt, dev)
    lo0_dev = _on(lo0, dt, dev)
    tol_eff = max(tol, 8.0 * _eps(dt))
    if warm_start is None:
        lo = torch.full(totals_np.shape, lo0, dtype=dt, device=dev)
        hi = lo + 1.0
    else:
        lo, hi = _warm_brackets(p, lo0, totals_np, warm_start, warm_delta, lo0_dev, dt, dev)
    _, hi_out, sweep_iters = _sweep_body(
        lo, hi, lo0_dev, totals_dev, tol_eff,
        dc.alphas, dc.cs, dc.safe_betas, dc.degenerate, dc.ds, dc.t_u, dc.t_comm, None,
        max_iter=int(max_iter), warm=warm_start is not None,
    )
    t_star, polish = _certify(p, totals_np, hi_out, dt, "device sweep")

    batches, node_times = _finalize_batches(p, totals_np, t_star, tol=tol)
    opt_perfs = node_times.max(axis=-1)
    compute_mask = _p_compute_mask(p, batches)
    for arr in (totals_np, t_star, opt_perfs, batches, compute_mask):
        arr.flags.writeable = False
    return BatchedOptPerfSolution(
        total_batches=totals_np,
        opt_perfs=opt_perfs,
        batches=batches,
        compute_mask=compute_mask,
        method="waterfill/jax" if warm_start is None else "waterfill/jax+warm",
        t_stars=t_star,
        iterations=int(sweep_iters) + polish,
    )


# ---------------------------------------------------------------------------
# Stacked rows on the device — the cluster-scale scheduler solve
# ---------------------------------------------------------------------------


class StackedDeviceCoeffs(NamedTuple):
    """Device view of a :class:`StackedClusterModel`
    (``optperf_jax.StackedDeviceCoeffs``): C padded problem rows, each with
    its own node subset (``mask``) and comm model (``(C, 1)`` columns)."""

    alphas: torch.Tensor       # (C, n)
    cs: torch.Tensor           # (C, n)
    safe_betas: torch.Tensor   # (C, n) betas with 1.0 at degenerate slots
    degenerate: torch.Tensor   # (C, n) bool: beta <= 0
    ds: torch.Tensor           # (C, n)
    t_u: torch.Tensor          # (C, 1)
    t_comm: torch.Tensor       # (C, 1)
    mask: torch.Tensor         # (C, n) bool; False = padding slot


def stacked_device_coeffs(
    stack: StackedClusterModel, dtype=None, device=None
) -> StackedDeviceCoeffs:
    """Export (and cache) a stack's coefficient arrays on ``device``
    (``optperf_jax.stacked_device_coeffs``), in the stack's
    :meth:`~StackedClusterModel.device_cache` slot keyed by (dtype,
    device).  The content stamp is re-checked on every call: a stack
    refreshed in place without ``invalidate_device_cache()`` drops every
    derived cache and ships a fresh export."""
    dt, dev = _dtype(dtype), _device(device)
    key = (str(dt).replace("torch.", ""), str(dev))
    stamp = stack_stamp(stack)
    cache = stack.device_cache()
    hit = cache.get(key)
    if hit is not None and hit[0] != stamp:
        stack.invalidate_device_cache()
        cache = stack.device_cache()
        hit = None
    if hit is not None:
        return hit[1]

    degenerate = stack.betas <= 0.0
    sdc = StackedDeviceCoeffs(
        alphas=_on(stack.alphas, dt, dev),
        cs=_on(stack.cs, dt, dev),
        safe_betas=_on(np.where(degenerate, 1.0, stack.betas), dt, dev),
        degenerate=torch.as_tensor(degenerate, device=dev),
        ds=_on(stack.ds, dt, dev),
        t_u=_on(stack.t_u[:, None], dt, dev),
        t_comm=_on(stack.t_comm[:, None], dt, dev),
        mask=torch.as_tensor(np.array(stack.mask, bool), device=dev),
    )
    cache[key] = (stamp, sdc)
    return sdc


def solve_optperf_stacked_jax(
    stack: StackedClusterModel,
    total_batches: Sequence[float],
    *,
    tol: float = 1e-10,
    max_iter: int = 64,
    warm_start: Optional[np.ndarray] = None,
    warm_delta: float = 1e-3,
    dtype=None,
    device=None,
) -> BatchedOptPerfSolution:
    """Water-fill C independent stacked rows on ``device``; finalize on the
    host (``optperf_jax.solve_optperf_stacked_jax``).

    Contract-compatible with :func:`repro_torch.core.optperf.solve_optperf_stacked`:
    the same solution type, exact-sum partitions, padding-aware extraction,
    ``t_stars`` usable as the next round's ``warm_start``.
    """
    totals_np = _validated_totals(total_batches)
    if totals_np.shape[0] != stack.shape[0]:
        raise ValueError("total_batches length must match stack rows")
    stack.validate()
    sdc = stacked_device_coeffs(stack, dtype, device)
    dt, dev = sdc.alphas.dtype, sdc.alphas.device
    p, lo0 = _problem_from_stack(stack)

    totals_dev = _on(totals_np, dt, dev)
    lo0_dev = _on(lo0, dt, dev)
    tol_eff = max(tol, 8.0 * _eps(dt))
    if warm_start is None:
        lo = lo0_dev.clone()
        hi = lo + 1.0
    else:
        lo, hi = _warm_brackets(p, lo0, totals_np, warm_start, warm_delta, lo0_dev, dt, dev)
    _, hi_out, sweep_iters = _sweep_body(
        lo, hi, lo0_dev, totals_dev, tol_eff,
        sdc.alphas, sdc.cs, sdc.safe_betas, sdc.degenerate, sdc.ds,
        sdc.t_u, sdc.t_comm, sdc.mask,
        max_iter=int(max_iter), warm=warm_start is not None,
    )
    t_star, polish = _certify(p, totals_np, hi_out, dt, "stacked device sweep")

    batches, node_times = _finalize_batches(p, totals_np, t_star, tol=tol)
    opt_perfs = node_times.max(axis=-1)
    compute_mask = _p_compute_mask(p, batches)
    node_mask = np.array(stack.mask, dtype=bool)  # copy: stacks may be reused
    for arr in (totals_np, t_star, opt_perfs, batches, compute_mask, node_mask):
        arr.flags.writeable = False
    return BatchedOptPerfSolution(
        total_batches=totals_np,
        opt_perfs=opt_perfs,
        batches=batches,
        compute_mask=compute_mask,
        method=(
            "waterfill/stacked-jax"
            if warm_start is None
            else "waterfill/stacked-jax+warm"
        ),
        t_stars=t_star,
        iterations=int(sweep_iters) + polish,
        node_mask=node_mask,
    )
