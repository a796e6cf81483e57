"""Public entry for the flash-attention kernel.

Takes model-layout tensors, q ``(B, S, H, D)`` and k/v ``(B, T, KV, D)``
with GQA, like ``repro/kernels/flash_attention/ops.py``.  CUDA tensors go
to the hand-written Hopper kernels in ``csrc/flash_attention.cu`` (the
forward and, under autograd, the backward); CPU tensors go to the plain
versions :func:`attention_ref` and :func:`attention_backward_ref`.  A CUDA call that
the kernel does not take raises: there is no fallback.  bfloat16 tensors
are read through TMA tensor maps; the C entry point refuses a layout TMA
cannot read, and :func:`tma_layout_error` (the same rule, in Python) then
says why.

``flash_attention.launches`` counts forward launches (a recomputed forward
under ``torch.utils.checkpoint`` counts again);
``flash_attention_backward.launches`` counts backward launches.
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
from repro_torch.kernels.flash_attention.ref import attention_backward_ref, attention_ref

__all__ = ["flash_attention", "flash_attention_backward", "tma_layout_error", "SOURCE",
           "HEAD_DIMS"]

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
HEAD_DIMS = (64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_TENSOR_MAP_REJECTED = -1  # the C entry's code for a bf16 layout TMA cannot read


# The C entries' argument blocks (``EntryArgs`` and ``BwdEntryArgs`` in the
# source).  Forward: q, k, v, o, lse pointers; their (batch, sequence, head)
# strides for q, k, v, o; the stream; dtype code, B, S, T, H, KV, D,
# causal, window, kv_len; scale; padding.  Backward: q, k, v, o, dO, lse,
# delta, dq, dk, dv pointers; strides for q, k, v, o, dO, dq, dk, dv; then
# as the forward.
_ENTRY_ARGS = struct.Struct("=5Q12qQ10ifi")
_BWD_ARGS = struct.Struct("=10Q24qQ10ifi")


@functools.lru_cache(maxsize=None)
def _entry(name: str):
    fn = getattr(build.load(SOURCE), name)
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


def _call(name: str, dev: torch.device, args: bytes) -> int:
    if dev.index == torch.cuda.current_device():
        return _entry(name)(args)
    with torch.cuda.device(dev):
        return _entry(name)(args)


def _cuda_checks(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    d = q.shape[3]
    if d not in HEAD_DIMS:
        raise ValueError(f"the CUDA kernel takes head dims {HEAD_DIMS}, got {d}")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"the CUDA kernel takes float32 or bfloat16, got {q.dtype}")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("the head dim of q, k and v must be contiguous")


def _layout_error(x: torch.Tensor) -> Optional[str]:
    return tma_layout_error(x.shape, x.stride(), x.dtype, x.data_ptr() % 16)


def _raise_tma_refusal(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    why = [f"{name}: {err}" for name, x in (("q", q), ("k", k), ("v", v))
           if (err := _layout_error(x))]
    raise ValueError(f"the bf16 kernel cannot read {'; '.join(why) or 'q, k or v'}: "
                     "TMA refused the tensor map")


def _scale(d: int, softmax_scale: Optional[float]) -> float:
    return float(softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d))


def _forward(q, k, v, causal, window, scale, kv_len, with_lse: bool):
    """One forward launch: (out, lse or None).  lse is (B, H, S) float32."""
    b, s, h, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    dev = q.device
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=dev)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=dev) if with_lse else None
    args = _ENTRY_ARGS.pack(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        0 if lse is None else lse.data_ptr(),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        torch._C._cuda_getCurrentRawStream(dev.index),
        _DTYPE_CODES[q.dtype], b, s, t, h, kv, d, int(causal),
        0 if window is None else int(window), t if kv_len is None else int(kv_len),
        scale, 0,
    )
    rc = _call("flash_attention_forward", dev, args)
    if rc == _TENSOR_MAP_REJECTED:
        _raise_tma_refusal(q, k, v)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError {rc}")
    flash_attention.launches += 1
    return out, lse


class _FlashAttention(torch.autograd.Function):
    """The CUDA forward (keeping each row's log-sum-exp) and the CUDA
    backward: what a CUDA call that carries gradients runs."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, kv_len):
        out, lse = _forward(q, k, v, causal, window, scale, kv_len, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = (causal, window, scale, kv_len)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, scale, kv_len = ctx.mask
        dq, dk, dv = flash_attention_backward(
            q, k, v, out, lse, dout, causal=causal, window=window, softmax_scale=scale,
            kv_len=kv_len)
        return dq, dk, dv, None, None, None, None


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
    """Blockwise online-softmax attention; output (B, S, H, D) in q's dtype.

    A CUDA call whose q, k or v requires grad (with grad mode on) keeps each
    row's log-sum-exp and differentiates through
    :func:`flash_attention_backward`; any other CUDA call writes the output
    only.  CPU tensors take :func:`attention_ref`, under autograd."""
    _check(q, k, v, kv_len, window)
    if q.device.type == "cpu":
        return attention_ref(
            q, k, v, causal=causal, window=window, softmax_scale=softmax_scale, kv_len=kv_len
        )
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device.type}")
    _cuda_checks(q, k, v)
    scale = _scale(q.shape[3], softmax_scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, window, scale, kv_len)
    return _forward(q, k, v, causal, window, scale, kv_len, with_lse=False)[0]


flash_attention.launches = 0


def flash_attention_backward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    dout: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softmax_scale: Optional[float] = None,
    kv_len: Optional[int] = None,
):
    """dq (B, S, H, D), dk and dv (B, T, KV, D), in q's dtype, from the
    forward's inputs, its output ``out``, its log-sum-exp ``lse`` (B, H, S)
    float32 and the output's gradient ``dout``.  dk and dv sum over each
    GQA group's q heads.  CUDA tensors launch the backward kernel (a delta
    pre-pass, then the dK/dV and dQ kernels; one count in ``launches``);
    CPU tensors take :func:`attention_backward_ref`.  In bf16, q, k, v and
    dO are read through TMA tensor maps: a q, k or v that breaks the rule
    raises, as in the forward; a ``dout`` or ``out`` that breaks it is
    copied first."""
    _check(q, k, v, kv_len, window)
    b, s, h, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    if out.shape != q.shape or dout.shape != q.shape or lse.shape != (b, h, s):
        raise ValueError(f"out {tuple(out.shape)}, dout {tuple(dout.shape)} and lse "
                         f"{tuple(lse.shape)} do not fit q {tuple(q.shape)}")
    if q.device.type == "cpu":
        return attention_backward_ref(
            q, k, v, out, lse, dout, causal=causal, window=window,
            softmax_scale=softmax_scale, kv_len=kv_len)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_backward runs on cuda or cpu, not {q.device.type}")
    _cuda_checks(q, k, v)
    if out.dtype != q.dtype or dout.dtype != q.dtype or lse.dtype != torch.float32:
        raise ValueError("out and dout must have q's dtype, lse float32")
    bf16 = q.dtype == torch.bfloat16
    if dout.stride(-1) != 1 or (bf16 and _layout_error(dout)):
        # dO is the one operand autograd shapes: a copy, not a fallback.
        dout = dout.clone(memory_format=torch.contiguous_format)
    if bf16 and _layout_error(out):
        out = out.clone(memory_format=torch.contiguous_format)  # the pre-pass reads 16-byte rows
    if out.stride(-1) != 1 or not lse.is_contiguous():
        raise ValueError("out's head dim and lse must be contiguous")
    dev = q.device
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dk = torch.empty((b, t, kv, d), dtype=q.dtype, device=dev)
    dv = torch.empty((b, t, kv, d), dtype=q.dtype, device=dev)
    delta = torch.empty((b, h, s), dtype=torch.float32, device=dev)
    args = _BWD_ARGS.pack(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *(st for x in (q, k, v, out, dout, dq, dk, dv) for st in x.stride()[:3]),
        torch._C._cuda_getCurrentRawStream(dev.index),
        _DTYPE_CODES[q.dtype], b, s, t, h, kv, d, int(causal),
        0 if window is None else int(window), t if kv_len is None else int(kv_len),
        _scale(d, softmax_scale), 0,
    )
    rc = _call("flash_attention_backward", dev, args)
    if rc == _TENSOR_MAP_REJECTED:
        _raise_tma_refusal(q, k, v)
    if rc != 0:
        raise RuntimeError(f"flash_attention_backward kernel launch failed: cudaError {rc}")
    flash_attention_backward.launches += 1
    return dq, dk, dv


flash_attention_backward.launches = 0
