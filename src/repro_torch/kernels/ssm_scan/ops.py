"""Public entry for the selective-scan kernel: u/dt (B, T, D), b_t/c_t
(B, T, N), log_a (D, N), all float32.

The signature of ``repro/kernels/ssm_scan/ops.py::ssm_scan`` without
``d_block`` and ``interpret``.  CUDA tensors go to the hand-written Hopper
kernel in ``csrc/ssm_scan.cu`` (time split into segments whose carries
follow ``ref.selective_scan_segments``), which reads u/dt/b_t/c_t in place
through their strides, takes any D and any T, and masks the ragged edges
itself;
CPU tensors go to the plain version :func:`selective_scan_ref`.  A CUDA
call that the kernel does not take raises: there is no fallback.

A CUDA call whose inputs require grad (with grad mode on) runs the same
forward under :class:`_SSMScan`, which also keeps the state entering every
``BACKWARD_TILE`` steps; its backward launches the hand-written kernel in
``csrc/ssm_scan_backward.cu`` (segments side by side, as
``ref.ssm_scan_backward_segments`` decomposes it) through
:func:`ssm_scan_backward`, starting from those states; CPU tensors
differentiate through the plain version.

``ssm_scan.launches`` counts calls that launch the kernel, one per call,
and ``ssm_scan_backward.launches`` calls that launch the backward kernel.

Each launch is a ``torch.library`` custom op
(``repro_torch::ssm_scan_forward``, ``repro_torch::ssm_scan_backward``)
with a fake implementation for fake and meta tensors (the dry run's
kernel route) and a FLOP formula, the operations the kernel's bound
counts.  DTensors run the call on each rank's shards, split over batch and
channels (:mod:`repro_torch.kernels.sharded`).
"""
from __future__ import annotations

import ctypes
import functools
import pathlib
import struct
from typing import Optional, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build
from repro_torch.kernels.sharded import local_over_batch_heads
from repro_torch.sharding.context import is_dtensor
from repro_torch.kernels.ssm_scan.ref import selective_scan_ref, ssm_scan_backward_ref

__all__ = [
    "ssm_scan", "ssm_scan_backward", "ssm_scan_tile_states", "SOURCE", "BACKWARD_SOURCE",
    "STATE_SIZE", "MAX_CHUNK", "BACKWARD_TILE",
]

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "ssm_scan.cu"
BACKWARD_SOURCE = SOURCE.with_name("ssm_scan_backward.cu")
STATE_SIZE = 16
MAX_CHUNK = 128
# Steps per tile of the backward kernel (kTile in ssm_scan_backward.cu,
# kBwdTile in ssm_scan.cu): it starts each tile from the state entering it.
BACKWARD_TILE = 64

# The C entry's argument block (``EntryArgs`` in the source): u, dt, b_t,
# c_t, log_a, y, state and tile-state (0: none) pointers; the (batch, time)
# strides of u, dt, b_t and c_t; the stream; B, T, D, N, chunk; one unused
# int.
_ENTRY_ARGS = struct.Struct("=8Q8qQ6i")
# The backward entry's block (``EntryArgs`` in ssm_scan_backward.cu): u, dt,
# b_t, c_t, dy, log_a, dh (0: none) and tile-state (0: none) pointers; du,
# ddt, db_t, dc_t, dlog_a and scratch pointers; the (batch, time) strides
# of u, dt, b_t, c_t and dy; the stream; B, T, D, N, chunk; one unused int.
_BACKWARD_ARGS = struct.Struct("=14Q10qQ6i")


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = build.load(SOURCE).ssm_scan_forward
    fn.argtypes = [ctypes.c_char_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _backward_kernel():
    """(entry, scratch floats for (B, T, D)) of the backward library."""
    lib = build.load(BACKWARD_SOURCE)
    fn, scratch = lib.ssm_scan_backward, lib.ssm_scan_backward_scratch
    fn.argtypes = [ctypes.c_char_p]
    fn.restype = ctypes.c_int
    scratch.argtypes = [ctypes.c_int] * 3
    scratch.restype = ctypes.c_longlong
    return fn, scratch


def _stream(dev: torch.device) -> int:
    return torch._C._cuda_getCurrentRawStream(dev.index)


def _check(u, dt, b_t, c_t, log_a, chunk) -> None:
    if u.dim() != 3:
        raise ValueError(f"u must be (B, T, D), got {tuple(u.shape)}")
    bsz, t, d = u.shape
    if dt.shape != u.shape:
        raise ValueError(f"dt {tuple(dt.shape)} != u {tuple(u.shape)}")
    if b_t.dim() != 3 or b_t.shape[:2] != (bsz, t) or c_t.shape != b_t.shape:
        raise ValueError(f"b_t {tuple(b_t.shape)} and c_t {tuple(c_t.shape)} must be "
                         f"(B, T, N) with (B, T) = {(bsz, t)}")
    if log_a.shape != (d, b_t.shape[2]):
        raise ValueError(f"log_a {tuple(log_a.shape)} must be (D, N) = {(d, b_t.shape[2])}")
    if t < 1:
        raise ValueError("T must be at least 1")
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    tensors = (u, dt, b_t, c_t, log_a)
    if any(x.dtype != torch.float32 for x in tensors):
        raise ValueError(f"ssm_scan takes float32, got {sorted({str(x.dtype) for x in tensors})}")
    if len({x.device for x in tensors}) != 1:
        raise ValueError("u, dt, b_t, c_t and log_a must be on one device")


def ssm_scan(
    u: torch.Tensor, dt: torch.Tensor, b_t: torch.Tensor, c_t: torch.Tensor,
    log_a: torch.Tensor, *, chunk: int = 64,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B, T, D), final state (B, D, N)), both float32.  ``chunk``
    is the reference's time tile; the CUDA kernel takes chunks of at most
    ``MAX_CHUNK`` and picks its own tiles, which do not change the result.
    DTensors compute on each rank's shards (over batch and channels)."""
    _check(u, dt, b_t, c_t, log_a, chunk)
    if is_dtensor(u):
        return local_over_batch_heads(
            functools.partial(ssm_scan, chunk=chunk), [u, dt, b_t, c_t, log_a],
            [(0, 2), (0, 2), (0, None), (0, None), (None, 0)], [(0, 2), (0, 1)])
    if u.device.type == "cpu":
        return selective_scan_ref(u, dt, log_a, b_t, c_t)
    if u.device.type != "cuda":
        raise ValueError(f"ssm_scan runs on cuda or cpu, not {u.device.type}")
    _cuda_checks(u, dt, b_t, c_t, chunk)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (u, dt, b_t, c_t, log_a)):
        return _SSMScan.apply(u, dt, b_t, c_t, log_a, chunk)
    return _launch(u, dt, b_t, c_t, log_a, chunk, False)[:2]


def _cuda_checks(u, dt, b_t, c_t, chunk) -> None:
    n = b_t.shape[2]
    if n != STATE_SIZE:
        raise ValueError(f"the CUDA kernel takes state size {STATE_SIZE}, got {n}")
    c = min(chunk, u.shape[1])
    if c > MAX_CHUNK:
        raise ValueError(f"the CUDA kernel takes chunks of at most {MAX_CHUNK}, got {c}")
    if any(x.stride(-1) != 1 for x in (u, dt, b_t, c_t)):
        raise ValueError("the last dim of u, dt, b_t and c_t must be contiguous")


def _tile_shape(u, n):
    bsz, t, d = u.shape
    return bsz, -(-t // BACKWARD_TILE), d, n


@torch.library.custom_op("repro_torch::ssm_scan_forward", mutates_args=(), device_types="cuda")
def _launch(u: torch.Tensor, dt: torch.Tensor, b_t: torch.Tensor, c_t: torch.Tensor,
            log_a: torch.Tensor, chunk: int, with_tiles: bool
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The forward kernel on ``u``'s device: (y, final state, tiles); with
    ``with_tiles`` it also writes the state entering every
    ``BACKWARD_TILE`` steps into tiles (B, ceil(T / 64), D, N), which is
    empty without."""
    bsz, t, d = u.shape
    n = b_t.shape[2]
    c = min(chunk, t)
    log_a = log_a.contiguous()
    y = torch.empty((bsz, t, d), dtype=torch.float32, device=u.device)
    h = torch.empty((bsz, d, n), dtype=torch.float32, device=u.device)
    tiles = torch.empty(_tile_shape(u, n) if with_tiles else (0,), dtype=torch.float32,
                        device=u.device)
    dev = u.device
    args = _ENTRY_ARGS.pack(
        u.data_ptr(), dt.data_ptr(), b_t.data_ptr(), c_t.data_ptr(), log_a.data_ptr(),
        y.data_ptr(), h.data_ptr(), tiles.data_ptr() if with_tiles else 0,
        *u.stride()[:2], *dt.stride()[:2], *b_t.stride()[:2], *c_t.stride()[:2],
        _stream(dev),
        bsz, t, d, n, c, 0,
    )
    if dev.index == torch.cuda.current_device():
        rc = _kernel()(args)
    else:
        with torch.cuda.device(dev):
            rc = _kernel()(args)
    if rc != 0:
        raise RuntimeError(f"ssm_scan kernel launch failed: cudaError {rc}")
    ssm_scan.launches += 1
    return y, h, tiles


@_launch.register_fake
def _(u, dt, b_t, c_t, log_a, chunk, with_tiles):
    bsz, t, d = u.shape
    n = b_t.shape[2]
    return (u.new_empty((bsz, t, d)), u.new_empty((bsz, d, n)),
            u.new_empty(_tile_shape(u, n) if with_tiles else (0,)))


@register_flop_formula(torch.ops.repro_torch.ssm_scan_forward)
def _launch_flops(u_shape, dt_shape, b_shape, *args, **kwargs) -> int:
    """7 per (token, channel, state): the forward bound's operations."""
    bsz, t, d = u_shape
    return 7 * bsz * t * d * b_shape[2]


class _SSMScan(torch.autograd.Function):
    """The CUDA forward and the CUDA backward: what a CUDA call that
    carries gradients runs.  The forward keeps the state entering every
    ``BACKWARD_TILE`` steps (B x ceil(T / 64) x D x N float32, which the
    backward would otherwise form in a pass of its own); a final-state
    gradient of None is taken as zero."""

    @staticmethod
    def forward(ctx, u, dt, b_t, c_t, log_a, chunk):
        y, h, tiles = _launch(u, dt, b_t, c_t, log_a, chunk, True)
        ctx.save_for_backward(u, dt, b_t, c_t, log_a, tiles)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        u, dt, b_t, c_t, log_a, tiles = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(u)
        du, ddt, db, dc, dlog_a = ssm_scan_backward(
            u, dt, b_t, c_t, log_a, dy, dh, chunk=ctx.chunk, tiles=tiles)
        return du, ddt, db, dc, dlog_a, None


def ssm_scan_tile_states(
    u: torch.Tensor, dt: torch.Tensor, b_t: torch.Tensor, c_t: torch.Tensor,
    log_a: torch.Tensor, *, chunk: int = 64,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`ssm_scan` on the card as a call that carries gradients runs
    it: (y, final state, the state entering every ``BACKWARD_TILE`` steps
    (B, ceil(T / 64), D, N)), for :func:`ssm_scan_backward`'s ``tiles``.
    CUDA tensors only."""
    _check(u, dt, b_t, c_t, log_a, chunk)
    if u.device.type != "cuda":
        raise ValueError(f"ssm_scan_tile_states runs on cuda only, not {u.device.type}")
    _cuda_checks(u, dt, b_t, c_t, chunk)
    return _launch(u, dt, b_t, c_t, log_a, chunk, True)


@torch.library.custom_op("repro_torch::ssm_scan_backward", mutates_args=(),
                         device_types="cuda")
def _launch_backward(u: torch.Tensor, dt: torch.Tensor, b_t: torch.Tensor, c_t: torch.Tensor,
                     log_a: torch.Tensor, dy: torch.Tensor, dh: Optional[torch.Tensor],
                     chunk: int, tiles: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                                torch.Tensor]:
    """The backward kernel on ``u``'s device, from the forward's ``tiles``:
    (du, ddt, db_t, dc_t, dlog_a)."""
    bsz, t, d = u.shape
    n = b_t.shape[2]
    dev = u.device
    if dy.stride(-1) != 1:
        dy = dy.contiguous()
    log_a = log_a.contiguous()
    if dh is not None:
        dh = dh.float().contiguous()
    fn, scratch_floats = _backward_kernel()
    outs = [torch.empty((bsz, t, d), dtype=torch.float32, device=dev) for _ in range(2)]
    outs += [torch.empty((bsz, t, n), dtype=torch.float32, device=dev) for _ in range(2)]
    outs.append(torch.empty((d, n), dtype=torch.float32, device=dev))
    scratch = torch.empty(scratch_floats(bsz, t, d), dtype=torch.float32, device=dev)
    inputs = (u, dt, b_t, c_t, dy)
    args = _BACKWARD_ARGS.pack(
        *(x.data_ptr() for x in inputs), log_a.data_ptr(), 0 if dh is None else dh.data_ptr(),
        tiles.data_ptr(),
        *(o.data_ptr() for o in outs), scratch.data_ptr(),
        *(st for x in inputs for st in x.stride()[:2]),
        _stream(dev),
        bsz, t, d, n, int(chunk), 0,
    )
    with torch.cuda.device(dev):
        rc = fn(args)
    if rc != 0:
        raise RuntimeError(f"ssm_scan backward kernel launch failed: cudaError {rc}")
    ssm_scan_backward.launches += 1
    return tuple(outs)


@_launch_backward.register_fake
def _(u, dt, b_t, c_t, log_a, dy, dh, chunk, tiles):
    bsz, t, d = u.shape
    n = b_t.shape[2]
    return (u.new_empty((bsz, t, d)), u.new_empty((bsz, t, d)), u.new_empty((bsz, t, n)),
            u.new_empty((bsz, t, n)), u.new_empty((d, n)))


@register_flop_formula(torch.ops.repro_torch.ssm_scan_backward)
def _launch_backward_flops(u_shape, dt_shape, b_shape, *args, **kwargs) -> int:
    """16 per (token, channel, state): the backward bound's operations."""
    bsz, t, d = u_shape
    return 16 * bsz * t * d * b_shape[2]


def ssm_scan_backward(
    u: torch.Tensor, dt: torch.Tensor, b_t: torch.Tensor, c_t: torch.Tensor,
    log_a: torch.Tensor, dy: torch.Tensor, dh: Optional[torch.Tensor] = None,
    *, chunk: int = 64, tiles: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, ...]:
    """The gradient of :func:`ssm_scan` (from h = 0) given the output's
    gradient ``dy`` (B, T, D) and the final state's ``dh`` (B, D, N; None
    is zero): (du, ddt (B, T, D), db_t, dc_t (B, T, N), dlog_a (D, N)),
    float32.  CUDA tensors go to the kernel in ``csrc/ssm_scan_backward.cu``
    (the forward's limits: N = 16, chunk <= 128, float32, last dims
    contiguous), which starts from ``tiles`` (the forward's states entering
    every ``BACKWARD_TILE`` steps, :func:`ssm_scan_tile_states`; when None
    the forward kernel forms them first); CPU tensors go to
    :func:`ssm_scan_backward_ref`."""
    _check(u, dt, b_t, c_t, log_a, chunk)
    if dy.shape != u.shape:
        raise ValueError(f"dy {tuple(dy.shape)} != u {tuple(u.shape)}")
    if u.device.type == "cpu":
        return ssm_scan_backward_ref(u, dt, b_t, c_t, log_a, dy, dh)
    if u.device.type != "cuda":
        raise ValueError(f"ssm_scan_backward runs on cuda or cpu, not {u.device.type}")
    _cuda_checks(u, dt, b_t, c_t, chunk)
    n = b_t.shape[2]
    if tiles is None:
        _, _, tiles = ssm_scan_tile_states(u, dt, b_t, c_t, log_a, chunk=chunk)
    elif tiles.shape != _tile_shape(u, n) or tiles.dtype != torch.float32 or not (
            tiles.is_contiguous() and tiles.device == u.device):
        raise ValueError(f"tiles must be float32 {_tile_shape(u, n)}, contiguous on {u.device}")
    return _launch_backward(u, dt, b_t, c_t, log_a, dy.float(), dh, chunk, tiles)


ssm_scan.launches = 0
ssm_scan_backward.launches = 0
