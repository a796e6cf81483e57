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

``ssm_scan.launches`` counts calls that launch the kernel, one per call.
"""
from __future__ import annotations

import ctypes
import functools
import pathlib
import struct
from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ssm_scan.ref import selective_scan_ref

__all__ = ["ssm_scan", "SOURCE", "STATE_SIZE", "MAX_CHUNK"]

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "ssm_scan.cu"
STATE_SIZE = 16
MAX_CHUNK = 128

# The C entry's argument block (``EntryArgs`` in the source): u, dt, b_t,
# c_t, log_a, y and state pointers; the (batch, time) strides of u, dt,
# b_t and c_t; the stream; B, T, D, N, chunk; one unused int.
_ENTRY_ARGS = struct.Struct("=7Q8qQ6i")


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = build.load(SOURCE).ssm_scan_forward
    fn.argtypes = [ctypes.c_char_p]
    fn.restype = ctypes.c_int
    return fn


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
    bsz, t, d = u.shape
    n = b_t.shape[2]
    if n != STATE_SIZE:
        raise ValueError(f"the CUDA kernel takes state size {STATE_SIZE}, got {n}")
    c = min(chunk, t)
    if c > MAX_CHUNK:
        raise ValueError(f"the CUDA kernel takes chunks of at most {MAX_CHUNK}, got {c}")
    if any(x.stride(-1) != 1 for x in (u, dt, b_t, c_t)):
        raise ValueError("the last dim of u, dt, b_t and c_t must be contiguous")
    log_a = log_a.contiguous()
    y = torch.empty((bsz, t, d), dtype=torch.float32, device=u.device)
    h = torch.empty((bsz, d, n), dtype=torch.float32, device=u.device)
    dev = u.device
    args = _ENTRY_ARGS.pack(
        u.data_ptr(), dt.data_ptr(), b_t.data_ptr(), c_t.data_ptr(), log_a.data_ptr(),
        y.data_ptr(), h.data_ptr(),
        *u.stride()[:2], *dt.stride()[:2], *b_t.stride()[:2], *c_t.stride()[:2],
        torch._C._cuda_getCurrentRawStream(dev.index),
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


ssm_scan.launches = 0
