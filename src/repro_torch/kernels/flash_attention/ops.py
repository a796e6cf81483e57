"""Public entry for the flash-attention kernel.

Takes model-layout tensors, q ``(B, S, H, Dqk)``, k ``(B, T, KV, Dqk)``
and v ``(B, T, KV, Dv)`` with GQA, like
``repro/kernels/flash_attention/ops.py``; v's head dim may differ from
q's and k's, as in ``repro.models.common.full_attention`` (DeepSeek-V2's
MLA: 192 and 128).  CUDA tensors go to the hand-written Hopper kernels in
``csrc/flash_attention.cu`` (the forward and, under autograd, the
backward); CPU tensors go to the plain versions :func:`attention_ref` and
:func:`attention_backward_ref`.  A CUDA call that the kernel does not
take raises: there is no fallback.  bfloat16 tensors are read through TMA
tensor maps; the C entry point refuses a layout TMA cannot read, and
:func:`tma_layout_error` (the same rule, in Python) then says why.

``flash_attention.launches`` counts forward launches (a recomputed forward
under ``torch.utils.checkpoint`` counts again);
``flash_attention_backward.launches`` counts backward launches.

Each launch is a ``torch.library`` custom op (``repro_torch::
flash_attention_forward`` and ``repro_torch::flash_attention_backward``)
with a fake implementation, which gives fake and meta tensors the
outputs' shapes, dtypes and strides so that the dry run traces the
kernel's route, and a FLOP formula (:func:`attention_pairs`), the
operations the kernel's bound counts.  Only fake and meta tensors reach
the fake implementations.  DTensors run the call on each rank's shards,
split over batch and heads (:mod:`repro_torch.kernels.sharded`).
"""
from __future__ import annotations

import ctypes
import functools
import math
import pathlib
import struct
from typing import Optional, Tuple

import numpy as np
import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import attention_backward_ref, attention_ref
from repro_torch.kernels.sharded import local_over_batch_heads
from repro_torch.sharding.context import is_dtensor

__all__ = ["flash_attention", "flash_attention_backward", "tma_layout_error", "SOURCE",
           "HEAD_DIMS", "attention_pairs"]

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
# The (Dqk, Dv) pairs the CUDA kernels are instantiated for, by dtype: the
# bf16 wgmma kernels, and the float32 scalar ones, which also take the
# reduced configs' head dims (so that training them runs on the card).
HEAD_DIMS = {
    torch.bfloat16: ((64, 64), (128, 128), (192, 128)),
    torch.float32: ((32, 32), (48, 32), (64, 64), (128, 128), (192, 128)),
}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_TENSOR_MAP_REJECTED = -1  # the C entry's code for a bf16 layout TMA cannot read


# The C entries' argument blocks (``EntryArgs`` and ``BwdEntryArgs`` in the
# source, whose sizes both sides assert).  Forward: q, k, v, o, lse
# pointers; their (batch, sequence, head) strides for q, k, v, o; the
# stream; dtype code, B, S, T, H, KV, Dqk, Dv, causal, window, kv_len;
# scale.  Backward: q, k, v, o, dO, lse, delta, dq, dk, dv pointers;
# strides for q, k, v, o, dO, dq, dk, dv; then as the forward.
_ENTRY_ARGS = struct.Struct("=5Q12qQ11if")
_BWD_ARGS = struct.Struct("=10Q24qQ11if")
assert (_ENTRY_ARGS.size, _BWD_ARGS.size) == (192, 328)


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
        raise ValueError("q, k, v must be (B, S, H, Dqk), (B, T, KV, Dqk), (B, T, KV, Dv)")
    b, _, h, d = q.shape
    if k.shape[:3] != v.shape[:3] or k.shape[0] != b or k.shape[3] != d:
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
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"the CUDA kernel takes float32 or bfloat16, got {q.dtype}")
    dims = (q.shape[3], v.shape[3])
    if dims not in HEAD_DIMS[q.dtype]:
        raise ValueError(f"the {q.dtype} CUDA kernel takes (Dqk, Dv) head dims "
                         f"{HEAD_DIMS[q.dtype]}, got {dims}")
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


def attention_pairs(s: int, t: int, causal: bool, window: Optional[int],
                    kv_len: Optional[int]) -> int:
    """The (query, key) pairs an attention call computes: key j of query i
    counts when j < kv_len (default T), j <= i if causal, and j > i -
    window if windowed (the kernel's mask)."""
    q = np.arange(s, dtype=np.int64)
    hi = np.full(s, (t if kv_len is None else kv_len) - 1, dtype=np.int64)
    if causal:
        hi = np.minimum(hi, q)
    lo = np.maximum(q - window + 1, 0) if window is not None else 0
    return int(np.maximum(hi - lo + 1, 0).sum())


@torch.library.custom_op("repro_torch::flash_attention_forward", mutates_args=(),
                         device_types="cuda")
def _forward_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                window: Optional[int], scale: float, kv_len: Optional[int],
                with_lse: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """One forward launch: (out (B, S, H, Dv), lse (B, H, S) float32, or an
    empty lse without ``with_lse``)."""
    b, s, h, d = q.shape
    t, kv, dv = k.shape[1], k.shape[2], v.shape[3]
    dev = q.device
    out = torch.empty((b, s, h, dv), dtype=q.dtype, device=dev)
    lse = torch.empty((b, h, s) if with_lse else (0,), dtype=torch.float32, device=dev)
    args = _ENTRY_ARGS.pack(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if with_lse else 0,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        torch._C._cuda_getCurrentRawStream(dev.index),
        _DTYPE_CODES[q.dtype], b, s, t, h, kv, d, dv, int(causal),
        0 if window is None else int(window), t if kv_len is None else int(kv_len),
        scale,
    )
    rc = _call("flash_attention_forward", dev, args)
    if rc == _TENSOR_MAP_REJECTED:
        _raise_tma_refusal(q, k, v)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError {rc}")
    flash_attention.launches += 1
    return out, lse


@_forward_op.register_fake
def _(q, k, v, causal, window, scale, kv_len, with_lse):
    b, s, h, _ = q.shape
    return (q.new_empty((b, s, h, v.shape[3])),
            q.new_empty((b, h, s) if with_lse else (0,), dtype=torch.float32))


@register_flop_formula(torch.ops.repro_torch.flash_attention_forward)
def _forward_flops(q_shape, k_shape, v_shape, causal, window, scale, kv_len, with_lse,
                   *args, **kwargs) -> int:
    """2 (Dqk + Dv) B H x the pairs: the forward bound's operations."""
    b, s, h, dqk = q_shape
    return 2 * (dqk + v_shape[3]) * b * h * attention_pairs(s, k_shape[1], causal, window,
                                                             kv_len)


def _forward(q, k, v, causal, window, scale, kv_len, with_lse: bool):
    """One forward launch: (out, lse or None).  out is (B, S, H, Dv), lse
    (B, H, S) float32."""
    out, lse = _forward_op(q, k, v, causal, window, scale, kv_len, with_lse)
    return out, lse if with_lse else None


def _sharded(q, k, v, **mask):
    """:func:`flash_attention` on DTensors: each rank's shards, over batch
    and heads as q is split (after pinning q, k and v to the reference's
    attention layouts).  When q's heads are split over m ranks and the GQA
    kv heads do not split m ways, k and v stay whole over those ranks and
    each rank takes the kv head of each of its query heads (the
    reference's GQA repeat, per rank)."""
    from repro_torch.sharding.context import constrain, rank_block

    q = constrain(q, ("batch", None, "heads", None))
    h, kv = q.shape[2], k.shape[2]
    mesh = q.device_mesh
    splits = [i for i, p in enumerate(q.placements) if p.is_shard(2)]
    m = math.prod(mesh.size(i) for i in splits)
    attend = functools.partial(flash_attention, **mask)
    if kv % m == 0:
        heads = "heads" if kv == h else "kv_heads"
        k = constrain(k, ("batch", None, heads, None))
        v = constrain(v, ("batch", None, heads, None))
        fn, kv_dims = attend, (0, 2)
    else:
        k = constrain(k, ("batch", None, None, None))
        v = constrain(v, ("batch", None, None, None))
        part = rank_block(mesh, splits)  # this rank's block of query heads

        def fn(q_l, k_l, v_l):
            h_l = q_l.shape[2]
            idx = (part * h_l + torch.arange(h_l, device=q_l.device)) // (h // kv)
            return attend(q_l, k_l[:, :, idx], v_l[:, :, idx])

        kv_dims = (0, None)
    return local_over_batch_heads(fn, [q, k, v], [(0, 2), kv_dims, kv_dims], [(0, 2)])


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
    """Blockwise online-softmax attention; output (B, S, H, Dv) in q's
    dtype, scaled by ``softmax_scale`` (default ``1/sqrt(Dqk)``).

    A CUDA call whose q, k or v requires grad (with grad mode on) keeps each
    row's log-sum-exp and differentiates through
    :func:`flash_attention_backward`; any other CUDA call writes the output
    only.  CPU tensors take :func:`attention_ref`, under autograd.
    DTensors compute on each rank's shards (:func:`_sharded`)."""
    _check(q, k, v, kv_len, window)
    if is_dtensor(q):
        return _sharded(q, k, v, causal=causal, window=window, softmax_scale=softmax_scale,
                        kv_len=kv_len)
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
    """dq (B, S, H, Dqk), dk (B, T, KV, Dqk) and dv (B, T, KV, Dv), in q's
    dtype, from the forward's inputs, its output ``out`` (B, S, H, Dv), its
    log-sum-exp ``lse`` (B, H, S) float32 and the output's gradient
    ``dout``.  dk and dv sum over each GQA group's q heads.  CUDA tensors
    launch the backward kernel (a delta pre-pass, then the dK/dV and dQ
    kernels; one count in ``launches``); CPU tensors take
    :func:`attention_backward_ref`.  In bf16, q, k, v and dO are read
    through TMA tensor maps: a q, k or v that breaks the rule raises, as in
    the forward; a ``dout`` or ``out`` that breaks it is copied first."""
    _check(q, k, v, kv_len, window)
    b, s, h, d = q.shape
    t, kv, dv_dim = k.shape[1], k.shape[2], v.shape[3]
    if out.shape != (b, s, h, dv_dim) or dout.shape != out.shape or lse.shape != (b, h, s):
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
    return tuple(_backward_op(q, k, v, out, lse, dout, causal, window,
                              _scale(d, softmax_scale), kv_len))


@torch.library.custom_op("repro_torch::flash_attention_backward", mutates_args=(),
                         device_types="cuda")
def _backward_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                 lse: torch.Tensor, dout: torch.Tensor, causal: bool, window: Optional[int],
                 scale: float, kv_len: Optional[int]) -> Tuple[torch.Tensor, torch.Tensor,
                                                               torch.Tensor]:
    """One backward launch (three kernels): (dq, dk, dv)."""
    b, s, h, d = q.shape
    t, kv, dv_dim = k.shape[1], k.shape[2], v.shape[3]
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
    dv = torch.empty((b, t, kv, dv_dim), dtype=q.dtype, device=dev)
    delta = torch.empty((b, h, s), dtype=torch.float32, device=dev)
    args = _BWD_ARGS.pack(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *(st for x in (q, k, v, out, dout, dq, dk, dv) for st in x.stride()[:3]),
        torch._C._cuda_getCurrentRawStream(dev.index),
        _DTYPE_CODES[q.dtype], b, s, t, h, kv, d, dv_dim, int(causal),
        0 if window is None else int(window), t if kv_len is None else int(kv_len),
        scale,
    )
    rc = _call("flash_attention_backward", dev, args)
    if rc == _TENSOR_MAP_REJECTED:
        _raise_tma_refusal(q, k, v)
    if rc != 0:
        raise RuntimeError(f"flash_attention_backward kernel launch failed: cudaError {rc}")
    flash_attention_backward.launches += 1
    return dq, dk, dv


@_backward_op.register_fake
def _(q, k, v, out, lse, dout, causal, window, scale, kv_len):
    b, t, kv = k.shape[:3]
    return (torch.empty_like(q, memory_format=torch.contiguous_format),
            q.new_empty((b, t, kv, q.shape[3])), q.new_empty((b, t, kv, v.shape[3])))


@register_flop_formula(torch.ops.repro_torch.flash_attention_backward)
def _backward_flops(q_shape, k_shape, v_shape, out_shape_, lse_shape, dout_shape, causal,
                    window, scale, kv_len, *args, **kwargs) -> int:
    """2 (3 Dqk + 2 Dv) B H x the pairs: the backward bound's operations."""
    b, s, h, dqk = q_shape
    return 2 * (3 * dqk + 2 * v_shape[3]) * b * h * attention_pairs(s, k_shape[1], causal,
                                                                     window, kv_len)


flash_attention_backward.launches = 0
