"""Public entry for the flash-attention kernel.

Takes model-layout tensors, q ``(B, S, H, D)`` and k/v ``(B, T, KV, D)``
with GQA, like ``repro/kernels/flash_attention/ops.py``.  CUDA tensors go
to the hand-written Hopper kernel in ``csrc/flash_attention.cu``; CPU
tensors go to the plain version :func:`attention_ref`.  A CUDA call that
the kernel does not take raises: there is no fallback.

``flash_attention.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
import math
import pathlib
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import attention_ref

__all__ = ["flash_attention", "SOURCE", "HEAD_DIMS"]

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
HEAD_DIMS = (64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = build.load(SOURCE).flash_attention_forward
    fn.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
        + [ctypes.c_longlong] * 12
        + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_len, window) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, S, H, D), (B, T, KV, D), (B, T, KV, D)")
    b, _, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if h % k.shape[2]:
        raise ValueError("q heads must be a multiple of kv heads")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("q, k, v must share a dtype")
    if kv_len is not None and not 0 <= kv_len <= k.shape[1]:
        raise ValueError(f"kv_len {kv_len} outside [0, {k.shape[1]}]")
    if window is not None and window < 1:
        raise ValueError("window must be a positive int or None")


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softmax_scale: Optional[float] = None,
    kv_len: Optional[int] = None,
) -> torch.Tensor:
    """Blockwise online-softmax attention; output (B, S, H, D) in q's dtype."""
    _check(q, k, v, kv_len, window)
    if q.device.type == "cpu":
        return attention_ref(
            q, k, v, causal=causal, window=window, softmax_scale=softmax_scale, kv_len=kv_len
        )
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device.type}")
    b, s, h, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"the CUDA kernel takes head dims {HEAD_DIMS}, got {d}")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"the CUDA kernel takes float32 or bfloat16, got {q.dtype}")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("the head dim of q, k and v must be contiguous")
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)
    fn = _kernel()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = fn(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, s, t, h, kv, d,
            *(q.stride()[:3]), *(k.stride()[:3]), *(v.stride()[:3]), *(out.stride()[:3]),
            int(causal), 0 if window is None else int(window),
            t if kv_len is None else int(kv_len), float(scale), stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError {rc}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
