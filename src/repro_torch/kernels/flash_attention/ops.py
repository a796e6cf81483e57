"""Public entry for the flash-attention kernel.

Takes model-layout tensors, q ``(B, S, H, D)`` and k/v ``(B, T, KV, D)``
with GQA, like ``repro/kernels/flash_attention/ops.py``.  CUDA tensors go
to the hand-written Hopper kernel in ``csrc/flash_attention.cu``; CPU
tensors go to the plain version :func:`attention_ref`.  A CUDA call that
the kernel does not take raises: there is no fallback.  bfloat16 tensors
are read through TMA tensor maps; the C entry point refuses a layout TMA
cannot read, and :func:`tma_layout_error` (the same rule, in Python) then
says why.

``flash_attention.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
import math
import pathlib
import struct
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import attention_ref

__all__ = ["flash_attention", "tma_layout_error", "SOURCE", "HEAD_DIMS"]

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
HEAD_DIMS = (64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_TENSOR_MAP_REJECTED = -1  # the C entry's code for a bf16 layout TMA cannot read


# The C entry's argument block (``EntryArgs`` in the source): q, k, v, o
# pointers; their (batch, sequence, head) strides; the stream; dtype code,
# B, S, T, H, KV, D, causal, window, kv_len; scale; one unused int.
_ENTRY_ARGS = struct.Struct("=4Q12qQ10ifi")


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = build.load(SOURCE).flash_attention_forward
    fn.argtypes = [ctypes.c_char_p]
    fn.restype = ctypes.c_int
    return fn


def tma_layout_error(shape, strides, dtype: torch.dtype, ptr_mod_16: int) -> Optional[str]:
    """Why a bf16 ``(B, L, heads, D)`` tensor cannot be read through a TMA
    tensor map, or None if it can.  TMA needs a 16-byte aligned base, a
    contiguous last dim and every other stride a multiple of 16 bytes; a
    dim of size 1 is never stepped, so its stride does not matter."""
    if strides[-1] != 1:
        return "the head dim must be contiguous"
    if ptr_mod_16:
        return f"the base address is {ptr_mod_16} bytes off a 16-byte boundary"
    for dim in range(len(shape) - 1):
        nbytes = strides[dim] * dtype.itemsize
        if shape[dim] > 1 and nbytes % 16:
            return f"dim {dim}'s stride ({nbytes} bytes) is not a multiple of 16 bytes"
    return None


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
    dev = q.device
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=dev)
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)
    args = _ENTRY_ARGS.pack(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        torch._C._cuda_getCurrentRawStream(dev.index),
        _DTYPE_CODES[q.dtype], b, s, t, h, kv, d, int(causal),
        0 if window is None else int(window), t if kv_len is None else int(kv_len),
        float(scale), 0,
    )
    if dev.index == torch.cuda.current_device():
        rc = _kernel()(args)
    else:
        with torch.cuda.device(dev):
            rc = _kernel()(args)
    if rc == _TENSOR_MAP_REJECTED:
        why = [f"{name}: {err}" for name, x in (("q", q), ("k", k), ("v", v))
               if (err := tma_layout_error(x.shape, x.stride(), x.dtype, x.data_ptr() % 16))]
        raise ValueError(f"the bf16 kernel cannot read {'; '.join(why) or 'q, k or v'}: "
                         "TMA refused the tensor map")
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError {rc}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
