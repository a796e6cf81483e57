"""Public entry for the WKV kernel: model layout (B, T, H, K) + u (H, K).

The signature of ``repro/kernels/rwkv6_wkv/ops.py::wkv``.  CUDA tensors go
to the hand-written Hopper kernel in ``csrc/wkv.cu``, which reads r/k/v/
log_w in place through their strides and masks the ragged last chunk
itself; CPU tensors go to the plain version :func:`wkv_chunked`.  A CUDA
call that the kernel does not take raises: there is no fallback.

``wkv.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
import pathlib
from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.rwkv6_wkv.ref import wkv_chunked

__all__ = ["wkv", "SOURCE", "HEAD_SIZE", "MAX_CHUNK"]

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "wkv.cu"
HEAD_SIZE = 64
MAX_CHUNK = 64


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = build.load(SOURCE).wkv_forward
    fn.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 15
        + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


def _check(r, k, v, log_w, u, chunk) -> None:
    if r.dim() != 4:
        raise ValueError(f"r must be (B, T, H, K), got {tuple(r.shape)}")
    for name, x in (("k", k), ("v", v), ("log_w", log_w)):
        if x.shape != r.shape:
            raise ValueError(f"{name} {tuple(x.shape)} != r {tuple(r.shape)}")
    if u.shape != r.shape[2:]:
        raise ValueError(f"u {tuple(u.shape)} must be (H, K) = {tuple(r.shape[2:])}")
    if r.shape[1] < 1:
        raise ValueError("T must be at least 1")
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    tensors = (r, k, v, log_w, u)
    if any(x.dtype != torch.float32 for x in tensors):
        raise ValueError(f"wkv takes float32, got {sorted({str(x.dtype) for x in tensors})}")
    if len({x.device for x in tensors}) != 1:
        raise ValueError("r, k, v, log_w and u must be on one device")


def wkv(
    r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, log_w: torch.Tensor, u: torch.Tensor,
    *, chunk: int = 64,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """r/k/v/log_w: (B, T, H, K) float32; u: (H, K) float32.
    Returns (out (B, T, H, K), final state (B, H, K, K) float32)."""
    _check(r, k, v, log_w, u, chunk)
    if r.device.type == "cpu":
        return wkv_chunked(r, k, v, log_w, u, chunk=chunk)
    if r.device.type != "cuda":
        raise ValueError(f"wkv runs on cuda or cpu, not {r.device.type}")
    b, t, h, kk = r.shape
    if kk != HEAD_SIZE:
        raise ValueError(f"the CUDA kernel takes head size {HEAD_SIZE}, got {kk}")
    c = min(chunk, t)
    if c > MAX_CHUNK:
        raise ValueError(f"the CUDA kernel takes chunks of at most {MAX_CHUNK}, got {c}")
    if any(x.stride(-1) != 1 for x in (r, k, v, log_w)):
        raise ValueError("the channel dim of r, k, v and log_w must be contiguous")
    if any(x.data_ptr() % 16 or any(st % 4 for st in x.stride()[:3]) for x in (r, k, v, log_w)):
        raise ValueError("the CUDA kernel copies rows as 16-byte vectors: r, k, v and log_w "
                         "must be 16-byte aligned with strides that are multiples of 4")
    u = u.contiguous()
    out = torch.empty((b, t, h, kk), dtype=torch.float32, device=r.device)
    state = torch.empty((b, h, kk, kk), dtype=torch.float32, device=r.device)
    fn = _kernel()
    stream = torch.cuda.current_stream(r.device).cuda_stream
    with torch.cuda.device(r.device):
        rc = fn(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), log_w.data_ptr(), u.data_ptr(),
            out.data_ptr(), state.data_ptr(),
            b, t, h, kk, c,
            *(r.stride()[:3]), *(k.stride()[:3]), *(v.stride()[:3]),
            *(log_w.stride()[:3]), *(out.stride()[:3]),
            stream,
        )
    if rc != 0:
        raise RuntimeError(f"wkv kernel launch failed: cudaError {rc}")
    wkv.launches += 1
    return out, state


wkv.launches = 0
