"""Public entry for the flash-attention kernel.

Takes model-layout tensors, q ``(B, S, H, Dqk)``, k ``(B, T, KV, Dqk)``
and v ``(B, T, KV, Dv)`` with GQA, like
``repro/kernels/flash_attention/ops.py``; v's head dim may differ from
q's and k's, as in ``repro.models.common.full_attention`` (DeepSeek-V2's
MLA: 192 and 128).  CUDA tensors go to the hand-written Hopper kernels in
``csrc/flash_attention.cu`` (the forward and, under autograd, the
backward); CPU tensors go to the plain versions :func:`attention_ref` and
:func:`attention_backward_ref`, which compute in float32 whatever float
dtypes q, k and v have, as the Pallas kernel does, and return q's dtype.

The CUDA kernels take float32, bfloat16 and float16 at every (Dqk, Dv)
up to ``MAX_HEAD_DIM``: :func:`reach_error` says whether a call is inside
that, and a CUDA call outside it raises (there is no fallback).  They are
instantiated at the pairs ``HEAD_DIMS``; a call runs on the smallest
instance that holds its dims (:func:`instance`), on copies of q, k and v
padded by zero channels (which add exact zeros to every product), and
gets its own columns back.  q, k and v in two or three dtypes run on
float32 copies, the output cast to q's dtype and each gradient to its
input's (a copy, not a fallback: the float32 kernel runs).  Which body
serves an instance (:func:`uses_wgmma`): bfloat16 and float16 at (64, 64),
(128, 128) and (192, 128) run the wgmma kernels, which read q, k, v and dO
through TMA tensor maps; the C entry point refuses a layout TMA cannot
read, and :func:`tma_layout_error` (the same rule, in Python) then says
why.  float32 at every pair and the 16-bit types at the others run the
mma.sync kernels, which read 16-byte rows with cp.async under the same
rule; there the C entry's refusal is answered with contiguous copies.
The source is built into one library per element type
(``library_defines``), so that the three build side by side.

``flash_attention.launches`` counts forward launches (a recomputed forward
under ``torch.utils.checkpoint`` counts again);
``flash_attention_backward.launches`` counts backward launches.  Each also
keeps ``launches_by_instance``, the same launches by the CUDA instance
that ran them, ``(dtype name, Dqk, Dv)`` (e.g. ``("bf16", 16, 16)``; a
padded call counts at its instance).

Each launch is a ``torch.library`` custom op (``repro_torch::
flash_attention_forward`` and ``repro_torch::flash_attention_backward``)
with a fake implementation, which gives fake and meta tensors the
outputs' shapes, dtypes and strides so that the dry run traces the
kernel's route, and a FLOP formula (:func:`attention_pairs`), the
operations the kernel's bound counts; both at the caller's head dims (the
padding happens inside the op).  Only fake and meta tensors reach the
fake implementations.  DTensors run the call on each rank's shards, split
over batch and heads (:mod:`repro_torch.kernels.sharded`).
"""
from __future__ import annotations

import collections
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
           "HEAD_DIMS", "MAX_HEAD_DIM", "DTYPES", "attention_pairs", "uses_wgmma",
           "backward_kernels", "reach_error", "instance", "library_defines"]

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
# The (Dqk, Dv) pairs the CUDA kernels are instantiated for, by dtype: the
# 16-bit types' wgmma kernels at (64, 64), (128, 128) and (192, 128), and
# the mma.sync ones at every other pair and at every pair in float32: the
# reduced configs' head dims (16, 16) (hymba-1.5b), (32, 32) (llama3-8b,
# whisper-large-v3) and (48, 32) (deepseek-v2-236b's MLA), and (256, 256)
# (gemma-7b's head dim), the largest.  A call of other dims runs on the
# smallest pair that holds them (``instance``), padded.
# tests/test_torch_kernel_coverage.py holds every config in ARCHS, at both
# widths, inside the reach (``reach_error``).
_PAIRS = ((16, 16), (32, 32), (48, 32), (64, 64), (128, 128), (192, 128), (256, 256))
HEAD_DIMS = {torch.bfloat16: _PAIRS, torch.float16: _PAIRS, torch.float32: _PAIRS}
MAX_HEAD_DIM = 256
DTYPES = (torch.float32, torch.bfloat16, torch.float16)
_WGMMA_DIMS = ((64, 64), (128, 128), (192, 128))  # bf16 and f16 on the wgmma kernels
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_DTYPE_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16"}
_TENSOR_MAP_REJECTED = -1  # the C entry's code for a layout its kernels cannot read


# The C entries' argument blocks (``EntryArgs`` and ``BwdEntryArgs`` in the
# source, whose sizes both sides assert).  Forward: q, k, v, o, lse
# pointers; their (batch, sequence, head) strides for q, k, v, o; the
# stream; dtype code, B, S, T, H, KV, Dqk, Dv, causal, window, kv_len;
# scale.  Backward: q, k, v, o, dO, lse, delta, dq, dk, dv pointers;
# strides for q, k, v, o, dO, dq, dk, dv; then as the forward.
_ENTRY_ARGS = struct.Struct("=5Q12qQ11if")
_BWD_ARGS = struct.Struct("=10Q24qQ11if")
assert (_ENTRY_ARGS.size, _BWD_ARGS.size) == (192, 328)


def library_defines(dtype: torch.dtype) -> Tuple[str, ...]:
    """The ``nvcc`` defines of the library that holds ``dtype``'s instances
    (``FLASH_ELEM`` in the source: its dtype code)."""
    return (f"-DFLASH_ELEM={_DTYPE_CODES[dtype]}",)


@functools.lru_cache(maxsize=None)
def _entry(name: str, dtype: torch.dtype):
    fn = getattr(build.load(SOURCE, library_defines(dtype)), name)
    fn.argtypes = [ctypes.c_char_p]
    fn.restype = ctypes.c_int
    return fn


def instance(dtype: torch.dtype, dqk: int, dv: int) -> Tuple[int, int]:
    """The (Dqk, Dv) instance a CUDA call at (dtype, Dqk, Dv) runs on: the
    smallest pair of ``HEAD_DIMS[dtype]`` that holds both dims (the call
    inside ``reach_error``)."""
    return min((p for p in HEAD_DIMS[dtype] if dqk <= p[0] and dv <= p[1]),
               key=lambda p: (p[0] + p[1], p[0]))


def reach_error(dtype: torch.dtype, dqk: int, dv: int) -> Optional[str]:
    """Why the CUDA kernels do not take a call with an input (q, k or v) in
    ``dtype`` at head dims (Dqk, Dv), naming the limit, or None when they
    do."""
    if dtype not in DTYPES:
        return f"the CUDA kernels take DTYPES = (float32, bfloat16, float16), got {dtype}"
    if not (1 <= dqk <= MAX_HEAD_DIM and 1 <= dv <= MAX_HEAD_DIM):
        return (f"the CUDA kernels take head dims from 1 to MAX_HEAD_DIM = {MAX_HEAD_DIM}, "
                f"got (Dqk, Dv) = ({dqk}, {dv})")
    return None


def tma_layout_error(shape, strides, dtype: torch.dtype, ptr_mod_16: int) -> Optional[str]:
    """Why a 16-bit ``(B, L, heads, D)`` tensor cannot be read through a
    TMA tensor map, or None if it can.  TMA needs a 16-byte aligned base, a
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
    if kv_len is not None and not 0 <= kv_len <= k.shape[1]:
        raise ValueError(f"kv_len {kv_len} outside [0, {k.shape[1]}]")
    if window is not None and window < 1:
        raise ValueError("window must be a positive int or None")


def _call(name: str, dtype: torch.dtype, dev: torch.device, args: bytes) -> int:
    if dev.index == torch.cuda.current_device():
        return _entry(name, dtype)(args)
    with torch.cuda.device(dev):
        return _entry(name, dtype)(args)


def _cuda_checks(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for x in (q, k, v):
        why = reach_error(x.dtype, q.shape[3], v.shape[3])
        if why:
            raise ValueError(why)
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("the head dim of q, k and v must be contiguous")


def uses_wgmma(dtype: torch.dtype, dqk: int, dv: int) -> bool:
    """Whether a CUDA call at (dtype, Dqk, Dv) runs the wgmma kernels
    (bf16 and f16 whose instance is (64, 64), (128, 128) or (192, 128))
    rather than the mma.sync ones."""
    return dtype in (torch.bfloat16, torch.float16) and instance(dtype, dqk, dv) in _WGMMA_DIMS


def backward_kernels(dtype: torch.dtype, dqk: int, dv: int) -> int:
    """CUDA kernels one backward launch runs: the wgmma instances' delta
    pre-pass, dK/dV and dQ; the mma.sync instances' dQ (which writes delta)
    and dK/dV."""
    return 3 if uses_wgmma(dtype, dqk, dv) else 2


def _dense(*xs: torch.Tensor):
    """Contiguous copies: what the mma.sync kernels read when the C entry
    refused a view whose rows break their cp.async reads' 16-byte rule (the
    rule of :func:`tma_layout_error`).  A copy, not a fallback: the same
    kernel runs on them."""
    return tuple(x.clone(memory_format=torch.contiguous_format) for x in xs)


def _padded(x: torch.Tensor, width: int) -> torch.Tensor:
    """``x`` with its head dim padded by zero channels to ``width`` (a new
    contiguous tensor), or ``x`` itself at that width."""
    return x if x.shape[3] == width else torch.nn.functional.pad(x, (0, width - x.shape[3]))


def _own(x: torch.Tensor, width: int) -> torch.Tensor:
    """The first ``width`` channels of a padded call's output, contiguous."""
    return x if x.shape[3] == width else x[..., :width].contiguous()


def _layout_error(x: torch.Tensor) -> Optional[str]:
    return tma_layout_error(x.shape, x.stride(), x.dtype, x.data_ptr() % 16)


def _raise_tma_refusal(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    why = [f"{name}: {err}" for name, x in (("q", q), ("k", k), ("v", v))
           if (err := _layout_error(x))]
    raise ValueError(f"the {_DTYPE_NAMES[q.dtype]} wgmma kernel cannot read "
                     f"{'; '.join(why) or 'q, k or v'}: TMA refused the tensor map")


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
    """One forward launch, q, k, v in one dtype: (out (B, S, H, Dv), lse
    (B, H, S) float32, or an empty lse without ``with_lse``).  Head dims
    short of their instance's run on copies padded by zero channels."""
    b, s, h, d = q.shape
    t, kv, dv = k.shape[1], k.shape[2], v.shape[3]
    di, dvi = instance(q.dtype, d, dv)
    dev = q.device
    q, k, v = _padded(q, di), _padded(k, di), _padded(v, dvi)
    out = torch.empty((b, s, h, dvi), dtype=q.dtype, device=dev)
    lse = torch.empty((b, h, s) if with_lse else (0,), dtype=torch.float32, device=dev)

    def launch(q, k, v):
        return _call("flash_attention_forward", q.dtype, dev, _ENTRY_ARGS.pack(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if with_lse else 0,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
            torch._C._cuda_getCurrentRawStream(dev.index),
            _DTYPE_CODES[q.dtype], b, s, t, h, kv, di, dvi, int(causal),
            0 if window is None else int(window), t if kv_len is None else int(kv_len),
            scale,
        ))

    rc = launch(q, k, v)
    if rc == _TENSOR_MAP_REJECTED and not uses_wgmma(q.dtype, di, dvi):
        q, k, v = _dense(q, k, v)
        rc = launch(q, k, v)
    if rc == _TENSOR_MAP_REJECTED:
        _raise_tma_refusal(q, k, v)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError {rc}")
    flash_attention.launches += 1
    flash_attention.launches_by_instance[(_DTYPE_NAMES[q.dtype], di, dvi)] += 1
    return _own(out, dv), lse


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
    dtype, scaled by ``softmax_scale`` (default ``1/sqrt(Dqk)``, of the
    caller's Dqk).

    A CUDA call whose q, k or v requires grad (with grad mode on) keeps each
    row's log-sum-exp and differentiates through
    :func:`flash_attention_backward`; any other CUDA call writes the output
    only.  q, k and v in more than one dtype run on float32 copies (each
    gradient comes back in its input's dtype).  CPU tensors take
    :func:`attention_ref`, under autograd.  DTensors compute on each rank's
    shards (:func:`_sharded`)."""
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
    out_dtype = q.dtype
    if len({q.dtype, k.dtype, v.dtype}) > 1:  # float32 copies, under autograd
        q, k, v = q.float(), k.float(), v.float()
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        out = _FlashAttention.apply(q, k, v, causal, window, scale, kv_len)
    else:
        out = _forward(q, k, v, causal, window, scale, kv_len, with_lse=False)[0]
    return out.to(out_dtype)


flash_attention.launches = 0
flash_attention.launches_by_instance = collections.Counter()


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
    """dq (B, S, H, Dqk), dk (B, T, KV, Dqk) and dv (B, T, KV, Dv), each in
    its input's dtype, from the forward's inputs, its output ``out`` (B, S,
    H, Dv), its log-sum-exp ``lse`` (B, H, S) float32 and the output's
    gradient ``dout``.  dk and dv sum over each GQA group's q heads.  CUDA
    tensors launch the backward kernels (:func:`backward_kernels` a call;
    one count in ``launches``), on float32 copies where q, k and v do not
    share a dtype, and on copies padded by zero channels where the head
    dims are short of their instance's; CPU tensors take
    :func:`attention_backward_ref`.  On the wgmma instances q, k, v and dO
    are read through TMA tensor maps: a q, k or v that breaks the rule
    raises, as in the forward; a ``dout`` or ``out`` that breaks it is
    copied first.  The mma.sync instances copy q, k, v and dO when the C
    entry refuses their layout."""
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
    if lse.dtype != torch.float32:
        raise ValueError("lse must be float32")
    run = q.dtype if q.dtype == k.dtype == v.dtype else torch.float32  # float32 copies
    grads = _backward_op(*(x.to(run) for x in (q, k, v, out)), lse, dout.to(run), causal,
                         window, _scale(d, softmax_scale), kv_len)
    return tuple(g.to(x.dtype) for g, x in zip(grads, (q, k, v)))


@torch.library.custom_op("repro_torch::flash_attention_backward", mutates_args=(),
                         device_types="cuda")
def _backward_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                 lse: torch.Tensor, dout: torch.Tensor, causal: bool, window: Optional[int],
                 scale: float, kv_len: Optional[int]) -> Tuple[torch.Tensor, torch.Tensor,
                                                               torch.Tensor]:
    """One backward launch (``backward_kernels`` kernels), every tensor but
    lse in one dtype: (dq, dk, dv).  Head dims short of their instance's
    run on copies padded by zero channels (q, k to Dqk's; v, out and dout
    to Dv's), and the padded columns of dq, dk and dv are dropped."""
    b, s, h, d = q.shape
    t, kv, dv_dim = k.shape[1], k.shape[2], v.shape[3]
    di, dvi = instance(q.dtype, d, dv_dim)
    wgmma = uses_wgmma(q.dtype, di, dvi)
    q, k = _padded(q, di), _padded(k, di)
    v, out, dout = _padded(v, dvi), _padded(out, dvi), _padded(dout, dvi)
    if dout.stride(-1) != 1 or (wgmma and _layout_error(dout)):
        # dO is the one operand autograd shapes: a copy, not a fallback.
        dout = dout.clone(memory_format=torch.contiguous_format)
    if wgmma and _layout_error(out):
        out = out.clone(memory_format=torch.contiguous_format)  # the pre-pass reads 16-byte rows
    if out.stride(-1) != 1 or not lse.is_contiguous():
        raise ValueError("out's head dim and lse must be contiguous")
    dev = q.device
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dk = torch.empty((b, t, kv, di), dtype=q.dtype, device=dev)
    dv = torch.empty((b, t, kv, dvi), dtype=q.dtype, device=dev)
    delta = torch.empty((b, h, s), dtype=torch.float32, device=dev)

    def launch(q, k, v, dout):
        return _call("flash_attention_backward", q.dtype, dev, _BWD_ARGS.pack(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *(st for x in (q, k, v, out, dout, dq, dk, dv) for st in x.stride()[:3]),
            torch._C._cuda_getCurrentRawStream(dev.index),
            _DTYPE_CODES[q.dtype], b, s, t, h, kv, di, dvi, int(causal),
            0 if window is None else int(window), t if kv_len is None else int(kv_len),
            scale,
        ))

    rc = launch(q, k, v, dout)
    if rc == _TENSOR_MAP_REJECTED and not wgmma:
        q, k, v, dout = _dense(q, k, v, dout)
        rc = launch(q, k, v, dout)
    if rc == _TENSOR_MAP_REJECTED:
        _raise_tma_refusal(q, k, v)
    if rc != 0:
        raise RuntimeError(f"flash_attention_backward kernel launch failed: cudaError {rc}")
    flash_attention_backward.launches += 1
    flash_attention_backward.launches_by_instance[(_DTYPE_NAMES[q.dtype], di, dvi)] += 1
    return _own(dq, d), _own(dk, d), _own(dv, dv_dim)


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
flash_attention_backward.launches_by_instance = collections.Counter()
