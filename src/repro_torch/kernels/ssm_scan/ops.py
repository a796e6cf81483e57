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
forward under :class:`_SSMScan`, whose backward launches the hand-written
kernel in ``csrc/ssm_scan_backward.cu`` through :func:`ssm_scan_backward`;
CPU tensors differentiate through the plain version.

``ssm_scan.launches`` counts calls that launch the kernel, one per call,
and ``ssm_scan_backward.launches`` calls that launch the backward kernel.
"""
from __future__ import annotations

import ctypes
import functools
import pathlib
import struct
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ssm_scan.ref import selective_scan_ref, ssm_scan_backward_ref

__all__ = [
    "ssm_scan", "ssm_scan_backward", "SOURCE", "BACKWARD_SOURCE", "STATE_SIZE", "MAX_CHUNK",
]

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "ssm_scan.cu"
BACKWARD_SOURCE = SOURCE.with_name("ssm_scan_backward.cu")
STATE_SIZE = 16
MAX_CHUNK = 128

# The C entry's argument block (``EntryArgs`` in the source): u, dt, b_t,
# c_t, log_a, y and state pointers; the (batch, time) strides of u, dt,
# b_t and c_t; the stream; B, T, D, N, chunk; one unused int.
_ENTRY_ARGS = struct.Struct("=7Q8qQ6i")
# The backward entry's block (``EntryArgs`` in ssm_scan_backward.cu): u, dt,
# b_t, c_t, dy, log_a and dh (0: none) pointers; du, ddt, db_t, dc_t,
# dlog_a and scratch pointers; the (batch, time) strides of u, dt, b_t, c_t
# and dy; the stream; B, T, D, N, chunk; one unused int.
_BACKWARD_ARGS = struct.Struct("=13Q10qQ6i")


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
    ``MAX_CHUNK`` and picks its own tiles, which do not change the result."""
    _check(u, dt, b_t, c_t, log_a, chunk)
    if u.device.type == "cpu":
        return selective_scan_ref(u, dt, log_a, b_t, c_t)
    if u.device.type != "cuda":
        raise ValueError(f"ssm_scan runs on cuda or cpu, not {u.device.type}")
    _cuda_checks(u, dt, b_t, c_t, chunk)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (u, dt, b_t, c_t, log_a)):
        return _SSMScan.apply(u, dt, b_t, c_t, log_a, chunk)
    return _launch(u, dt, b_t, c_t, log_a, chunk)


def _cuda_checks(u, dt, b_t, c_t, chunk) -> None:
    n = b_t.shape[2]
    if n != STATE_SIZE:
        raise ValueError(f"the CUDA kernel takes state size {STATE_SIZE}, got {n}")
    c = min(chunk, u.shape[1])
    if c > MAX_CHUNK:
        raise ValueError(f"the CUDA kernel takes chunks of at most {MAX_CHUNK}, got {c}")
    if any(x.stride(-1) != 1 for x in (u, dt, b_t, c_t)):
        raise ValueError("the last dim of u, dt, b_t and c_t must be contiguous")


def _launch(u, dt, b_t, c_t, log_a, chunk):
    """The forward kernel on ``u``'s device: (y, final state)."""
    bsz, t, d = u.shape
    n = b_t.shape[2]
    c = min(chunk, t)
    log_a = log_a.contiguous()
    y = torch.empty((bsz, t, d), dtype=torch.float32, device=u.device)
    h = torch.empty((bsz, d, n), dtype=torch.float32, device=u.device)
    dev = u.device
    args = _ENTRY_ARGS.pack(
        u.data_ptr(), dt.data_ptr(), b_t.data_ptr(), c_t.data_ptr(), log_a.data_ptr(),
        y.data_ptr(), h.data_ptr(),
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
    return y, h


class _SSMScan(torch.autograd.Function):
    """The CUDA forward and the CUDA backward: what a CUDA call that
    carries gradients runs.  A final-state gradient of None is taken as
    zero."""

    @staticmethod
    def forward(ctx, u, dt, b_t, c_t, log_a, chunk):
        y, h = _launch(u, dt, b_t, c_t, log_a, chunk)
        ctx.save_for_backward(u, dt, b_t, c_t, log_a)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        u, dt, b_t, c_t, log_a = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(u)
        du, ddt, db, dc, dlog_a = ssm_scan_backward(
            u, dt, b_t, c_t, log_a, dy, dh, chunk=ctx.chunk)
        return du, ddt, db, dc, dlog_a, None


def _launch_backward(u, dt, b_t, c_t, log_a, dy, dh, chunk):
    """The backward kernel on ``u``'s device: (du, ddt, db_t, dc_t, dlog_a)."""
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


def ssm_scan_backward(
    u: torch.Tensor, dt: torch.Tensor, b_t: torch.Tensor, c_t: torch.Tensor,
    log_a: torch.Tensor, dy: torch.Tensor, dh: Optional[torch.Tensor] = None,
    *, chunk: int = 64,
) -> Tuple[torch.Tensor, ...]:
    """The gradient of :func:`ssm_scan` (from h = 0) given the output's
    gradient ``dy`` (B, T, D) and the final state's ``dh`` (B, D, N; None
    is zero): (du, ddt (B, T, D), db_t, dc_t (B, T, N), dlog_a (D, N)),
    float32.  CUDA tensors go to the kernel in ``csrc/ssm_scan_backward.cu``
    (the forward's limits: N = 16, chunk <= 128, float32, last dims
    contiguous), CPU tensors to :func:`ssm_scan_backward_ref`."""
    _check(u, dt, b_t, c_t, log_a, chunk)
    if dy.shape != u.shape:
        raise ValueError(f"dy {tuple(dy.shape)} != u {tuple(u.shape)}")
    if u.device.type == "cpu":
        return ssm_scan_backward_ref(u, dt, b_t, c_t, log_a, dy, dh)
    if u.device.type != "cuda":
        raise ValueError(f"ssm_scan_backward runs on cuda or cpu, not {u.device.type}")
    _cuda_checks(u, dt, b_t, c_t, chunk)
    return _launch_backward(u, dt, b_t, c_t, log_a, dy.float(), dh, chunk)


ssm_scan.launches = 0
ssm_scan_backward.launches = 0
