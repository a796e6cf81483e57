"""Public entry for the WKV kernel: model layout (B, T, H, K) + u (H, K),
float32, bfloat16 or float16.

The signature of ``repro/kernels/rwkv6_wkv/ops.py::wkv``.  CUDA tensors go
to the hand-written Hopper kernel in ``csrc/wkv.cu`` (two passes: the
states entering every chunk, then every chunk's output), which reads r/k/
v/log_w in place through their strides in their own dtype (``DTYPES``),
widens them to float32, and masks the ragged last chunk itself; out comes
back in r's dtype, rounded once, the state float32.  The kernel is instantiated at
the head sizes ``HEAD_SIZES``; a call of another head size runs on the
first that holds it, on copies padded by zero channels (whose state rows
and columns stay 0), and gets its own channels back.  r, k, v and log_w
in two dtypes run as float32 copies, a 16-bit view the kernel cannot read
as 8-byte rows as a contiguous copy; u is read in float32.  CPU tensors go
to the plain version :func:`wkv_chunked`, which widens every input first,
whatever its float dtype, as the Pallas kernel does.  :func:`reach_error`
says whether the kernel takes a call (``DTYPES``, head sizes up to 128,
chunks up to ``MAX_CHUNK``, ``MAX_CHUNK_K128`` past head size 64); a CUDA
call outside that raises: there is no fallback.  The C entry also refuses a float32 layout it cannot read as
16-byte rows, and :func:`layout_error` (the same rule, in Python) then
says why.

A CUDA call whose inputs require grad (with grad mode on) runs the same
forward under :class:`_WKV`, whose backward launches the hand-written
kernel in ``csrc/wkv_backward.cu`` (chunk-parallel products on the tensor
cores, as ``ref.wkv_backward_chunked`` decomposes them) through
:func:`wkv_backward`; CPU tensors differentiate through the plain
version.

``wkv.launches`` counts calls that launch the kernel's passes, and
``wkv_backward.launches`` calls that launch the backward kernel; each
also keeps ``launches_by_instance``, the same launches by the instance
that ran, ``(dtype name, head size of the instance)`` (``("f32", 64)``).

Each launch is a ``torch.library`` custom op (``repro_torch::wkv_forward``,
``repro_torch::wkv_backward``) with a fake implementation for fake and
meta tensors (the dry run's kernel route) and a FLOP formula, the
operations the kernel's bound counts.  DTensors run the call on each
rank's shards, split over batch and heads
(:mod:`repro_torch.kernels.sharded`).
"""
from __future__ import annotations

import collections
import ctypes
import functools
import pathlib
import struct
from typing import Optional, Sequence, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build
from repro_torch.kernels.rwkv6_wkv.ref import wkv_backward_ref, wkv_chunked
from repro_torch.kernels.sharded import local_over_batch_heads
from repro_torch.sharding.context import is_dtensor

__all__ = [
    "wkv", "wkv_with_chunk_states", "wkv_backward", "layout_error", "reach_error", "instance",
    "SOURCE", "BACKWARD_SOURCE", "HEAD_SIZES", "MAX_CHUNK", "MAX_CHUNK_K128", "DTYPES",
]

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "wkv.cu"
BACKWARD_SOURCE = SOURCE.with_name("wkv_backward.cu")
# The head sizes the CUDA kernels are instantiated for: a call of head size
# K runs on the first that holds K, padded by zero channels (the reduced
# rwkv6-7b config's 32 and the published one's 64 run as they are).
HEAD_SIZES = (32, 64, 128)
# The longest chunk (chunks over 64 run on 128-row tiles), and the longest
# at the 128 instance, whose second pass would not fit in shared memory on
# 128-row tiles.
MAX_CHUNK = 128
MAX_CHUNK_K128 = 64
# The element types the kernels read and write, and their codes in the C
# entries' ``dtype`` field.
DTYPES = (torch.float32, torch.bfloat16, torch.float16)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_DTYPE_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16"}
BACKWARD_CHUNK = 32  # the backward kernel's chunk (kChunk in wkv_backward.cu)
_REJECTED = -1  # the C entry's code for a head size, chunk or layout it does not take

# The C entry's argument block (``EntryArgs`` in the source): r, k, v,
# log_w, u, out, state and chunk-state pointers; the (batch, time, head,
# channel) strides of r, k, v, log_w and out; the stream; B, T, H, K,
# chunk; the dtype code of the inputs and out.
_ENTRY_ARGS = struct.Struct("=8Q20qQ6i")
# The backward entry's block (``EntryArgs`` in wkv_backward.cu): r, k, v,
# log_w, dout, u, final state, its gradient (0: none), dr, dk, dv, dlog_w,
# du, du-scratch and dr-state-term pointers; the (batch, time, head,
# channel) strides of r, k, v, log_w and dout; the stream; B, T, H, K,
# chunk; the dtype code of the inputs and their gradients.
_BACKWARD_ARGS = struct.Struct("=15Q20qQ6i")
assert (_ENTRY_ARGS.size, _BACKWARD_ARGS.size) == (256, 312)


def _entry(source: pathlib.Path, name: str):
    fn = getattr(build.load(source), name)
    fn.argtypes = [ctypes.c_char_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _kernel():
    return _entry(SOURCE, "wkv_forward")


@functools.lru_cache(maxsize=None)
def _backward_kernel():
    return _entry(BACKWARD_SOURCE, "wkv_backward")


def _stream(dev: torch.device) -> int:
    return torch._C._cuda_getCurrentRawStream(dev.index)


def layout_error(shape: Sequence[int], strides: Sequence[int], ptr_mod_16: int) -> Optional[str]:
    """Why the kernel cannot read a float32 ``(B, T, H, K)`` tensor as
    16-byte rows, or None if it can: a 16-byte aligned base, a contiguous
    channel dim and every other stride a multiple of 4 elements (a dim of
    size 1 is never stepped, so its stride does not matter)."""
    if strides[-1] != 1:
        return "the channel dim must be contiguous"
    if ptr_mod_16:
        return f"the base address is {ptr_mod_16} bytes off a 16-byte boundary"
    for dim in range(len(shape) - 1):
        if shape[dim] > 1 and strides[dim] % 4:
            return f"dim {dim}'s stride ({strides[dim]} elements) is not a multiple of 4"
    return None


def instance(k: int) -> int:
    """The head size of the instance a head size ``k`` (<= 128) runs on."""
    return next(size for size in HEAD_SIZES if k <= size)


def reach_error(dtype: torch.dtype, k: int, chunk: int) -> Optional[str]:
    """Why the CUDA kernels do not take a call whose r/k/v/log_w are
    ``dtype`` at head size ``k`` and chunk ``chunk`` (the chunk a call
    runs, ``min(chunk, T)``), naming the limit, or None when they do."""
    if dtype not in DTYPES:
        return f"the CUDA kernels take DTYPES = (float32, bfloat16, float16), got {dtype}"
    if not 1 <= k <= HEAD_SIZES[-1]:
        return f"the CUDA kernels take head sizes up to HEAD_SIZES[-1] = {HEAD_SIZES[-1]}, got {k}"
    if not 1 <= chunk <= MAX_CHUNK:
        return f"the CUDA kernels take chunks of 1 to MAX_CHUNK = {MAX_CHUNK}, got {chunk}"
    if instance(k) == HEAD_SIZES[-1] and chunk > MAX_CHUNK_K128:
        return (f"the CUDA kernels take chunks of at most MAX_CHUNK_K128 = {MAX_CHUNK_K128} "
                f"at head sizes over {HEAD_SIZES[-2]}, got {chunk} at {k}")
    return None


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
    if not r.device == k.device == v.device == log_w.device == u.device:
        raise ValueError("r, k, v, log_w and u must be on one device")


def _rejected(r, k, v, log_w, c) -> ValueError:
    why = reach_error(r.dtype, r.shape[-1], c)
    if why:
        return ValueError(why)
    if any(x.stride(-1) != 1 for x in (r, k, v, log_w)):
        return ValueError("the channel dim of r, k, v and log_w must be contiguous")
    why = [f"{name}: {err}" for name, x in (("r", r), ("k", k), ("v", v), ("log_w", log_w))
           if (err := layout_error(x.shape, x.stride(), x.data_ptr() % 16))]
    return ValueError(f"the CUDA kernel copies float32 rows as 16-byte vectors and cannot read "
                      f"{'; '.join(why) or 'r, k, v or log_w'}")


def _rows(x: torch.Tensor, ki: int) -> torch.Tensor:
    """``x`` (..., K) as the kernels read it at instance ``ki``: padded by
    zero channels to ``ki`` where K is short of it, and a 16-bit view off
    the 8-byte row rule (a base on 8 bytes, the channel dim contiguous,
    every other stride a multiple of 4) copied contiguous.  A copy, not a
    fallback: the same kernel runs."""
    if x.shape[-1] < ki:
        return torch.nn.functional.pad(x, (0, ki - x.shape[-1]))
    if x.dtype.itemsize == 2 and (
            x.stride(-1) != 1 or x.data_ptr() % 8
            or any(n > 1 and st % 4 for n, st in zip(x.shape[:-1], x.stride()[:-1]))):
        return x.clone(memory_format=torch.contiguous_format)
    return x


def _square(x: torch.Tensor, ki: int) -> torch.Tensor:
    """A (..., K, K) state padded by zero rows and columns to ``ki``: what
    the kernels hold for the padded channels."""
    kk = x.shape[-1]
    return x if kk >= ki else torch.nn.functional.pad(x, (0, ki - kk, 0, ki - kk))


def _channels(x: torch.Tensor, kk: int, dims: int = 1) -> torch.Tensor:
    """The first ``kk`` channels of each of ``x``'s last ``dims`` dims,
    contiguous: a padded call's own."""
    if x.shape[-1] == kk:
        return x
    index = (Ellipsis,) + (slice(0, kk),) * dims
    return x[index].contiguous()


def _one_dtype(*xs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """``xs`` as they are when they share a dtype, else float32 copies of all."""
    if len({x.dtype for x in xs}) == 1:
        return xs
    return tuple(x.float() for x in xs)


@torch.library.custom_op("repro_torch::wkv_forward", mutates_args=(), device_types="cuda")
def _launch(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, log_w: torch.Tensor,
            u: torch.Tensor, chunk: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Both passes on the card, r/k/v/log_w in one dtype; returns (out in
    that dtype, final state, scratch), the scratch starting with the chunk
    states at the instance's head size."""
    b, t, h, kk = r.shape
    ki = instance(min(kk, HEAD_SIZES[-1]))
    c = min(chunk, t)
    n_chunks = -(-t // c)
    dev = r.device
    r, k, v, log_w = (_rows(x, ki) for x in (r, k, v, log_w))
    u = _rows(u.float(), ki).contiguous()  # (H, K): read once a block
    out = torch.empty((b, t, h, ki), dtype=r.dtype, device=dev)
    state = torch.empty((b, h, ki, ki), dtype=torch.float32, device=dev)
    # The chunk states, then one int32 flag per chunk state (pass A -> pass B).
    scratch = torch.empty(b * h * n_chunks * (ki * ki + 1), dtype=torch.float32, device=dev)
    args = _ENTRY_ARGS.pack(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), log_w.data_ptr(), u.data_ptr(),
        out.data_ptr(), state.data_ptr(), scratch.data_ptr(),
        *r.stride(), *k.stride(), *v.stride(), *log_w.stride(), *out.stride(),
        _stream(dev),
        b, t, h, r.shape[-1], int(chunk), _DTYPE_CODES[r.dtype],
    )
    with torch.cuda.device(dev):
        rc = _kernel()(args)
    if rc == _REJECTED:
        raise _rejected(r, k, v, log_w, c)
    if rc != 0:
        raise RuntimeError(f"wkv kernel launch failed: cudaError {rc}")
    wkv.launches += 1
    wkv.launches_by_instance[(_DTYPE_NAMES[r.dtype], ki)] += 1
    return _channels(out, kk), _channels(state, kk, 2), scratch


@_launch.register_fake
def _(r, k, v, log_w, u, chunk):
    b, t, h, kk = r.shape
    ki = instance(min(kk, HEAD_SIZES[-1]))
    n_chunks = -(-t // min(chunk, t))
    return (r.new_empty((b, t, h, kk)),
            r.new_empty((b, h, kk, kk), dtype=torch.float32),
            r.new_empty((b * h * n_chunks * (ki * ki + 1),), dtype=torch.float32))


@register_flop_formula(torch.ops.repro_torch.wkv_forward)
def _launch_flops(r_shape, *args, **kwargs) -> int:
    """4 K^2 per token and head: the forward bound's operations."""
    b, t, h, kk = r_shape
    return 4 * kk * kk * b * t * h


def wkv(
    r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, log_w: torch.Tensor, u: torch.Tensor,
    *, chunk: int = 64,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """r/k/v/log_w: (B, T, H, K); u: (H, K); float32, bfloat16 or float16
    on the card (``DTYPES``), any float dtype on the CPU.
    Returns (out (B, T, H, K) in r's dtype, final state (B, H, K, K)
    float32).  DTensors compute on each rank's shards."""
    _check(r, k, v, log_w, u, chunk)
    if is_dtensor(r):
        return local_over_batch_heads(functools.partial(wkv, chunk=chunk), [r, k, v, log_w, u],
                                      [(0, 2)] * 4 + [(None, 0)], [(0, 2), (0, 1)])
    if r.device.type == "cpu":
        return wkv_chunked(r, k, v, log_w, u, chunk=chunk)
    if r.device.type != "cuda":
        raise ValueError(f"wkv runs on cuda or cpu, not {r.device.type}")
    _cuda_checks(r, k, v, log_w, u, chunk)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (r, k, v, log_w, u)):
        return _WKV.apply(r, k, v, log_w, u, chunk)
    out, state, _ = _forward(r, k, v, log_w, u, chunk)
    return out, state


def _cuda_checks(r, k, v, log_w, u, chunk) -> None:
    """The CUDA route's reach (``reach_error`` for each input's dtype)."""
    for x in (r, k, v, log_w, u):
        why = reach_error(x.dtype, r.shape[-1], min(chunk, r.shape[1]))
        if why:
            raise ValueError(why)


def _forward(r, k, v, log_w, u, chunk):
    """:func:`_launch` with r/k/v/log_w in one dtype (float32 copies when
    they are not, out cast once to r's)."""
    out, state, scratch = _launch(*_one_dtype(r, k, v, log_w), u, chunk)
    return out.to(r.dtype), state, scratch


class _WKV(torch.autograd.Function):
    """The CUDA forward and the CUDA backward: what a CUDA call that
    carries gradients runs.  The forward saves its inputs and its final
    state (the backward's log-decay term needs S_T); a final-state gradient
    of None is taken as zero."""

    @staticmethod
    def forward(ctx, r, k, v, log_w, u, chunk):
        out, state, _ = _forward(r, k, v, log_w, u, chunk)
        ctx.save_for_backward(r, k, v, log_w, u, state)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return out, state

    @staticmethod
    def backward(ctx, d_out, d_state):
        r, k, v, log_w, u, state = ctx.saved_tensors
        if d_out is None:
            d_out = torch.zeros_like(r)
        grads = wkv_backward(r, k, v, log_w, u, state, d_out, d_state, chunk=ctx.chunk)
        return (*grads, None)


@torch.library.custom_op("repro_torch::wkv_backward", mutates_args=(), device_types="cuda")
def _launch_backward(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, log_w: torch.Tensor,
                     u: torch.Tensor, state: torch.Tensor, d_out: torch.Tensor,
                     d_state: Optional[torch.Tensor], chunk: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                                torch.Tensor]:
    """The backward kernel on ``r``'s device, r/k/v/log_w/d_out in one
    dtype: (dr, dk, dv, dlog_w) in that dtype, du in float32.  A head size
    short of its instance runs padded by zero channels, as the forward,
    the state and its gradient by zero rows and columns."""
    b, t, h, kk = r.shape
    ki = instance(min(kk, HEAD_SIZES[-1]))
    dev = r.device
    if d_out.stride(-1) != 1 or (d_out.dtype == torch.float32 and layout_error(
            d_out.shape, d_out.stride(), d_out.data_ptr() % 16)):
        d_out = d_out.contiguous()
    r, k, v, log_w, d_out = (_rows(x, ki) for x in (r, k, v, log_w, d_out))
    u = _rows(u.float(), ki).contiguous()
    state, d_state = (None if x is None else _square(x.float(), ki).contiguous()
                      for x in (state, d_state))
    grads = [torch.empty((b, t, h, ki), dtype=r.dtype, device=dev) for _ in range(4)]
    du = torch.empty((h, ki), dtype=torch.float32, device=dev)
    partial = torch.empty((b, h, ki), dtype=torch.float32, device=dev)
    # dr's state term, which the second kernel adds to: dr itself in float32.
    dr_state = grads[0] if r.dtype == torch.float32 else torch.empty(
        (b, t, h, ki), dtype=torch.float32, device=dev)
    inputs = (r, k, v, log_w, d_out)
    args = _BACKWARD_ARGS.pack(
        *(x.data_ptr() for x in inputs), u.data_ptr(), state.data_ptr(),
        0 if d_state is None else d_state.data_ptr(),
        *(g.data_ptr() for g in grads), du.data_ptr(), partial.data_ptr(), dr_state.data_ptr(),
        *(st for x in inputs for st in x.stride()),
        _stream(dev),
        b, t, h, r.shape[-1], int(chunk), _DTYPE_CODES[r.dtype],
    )
    with torch.cuda.device(dev):
        rc = _backward_kernel()(args)
    if rc == _REJECTED:
        raise _rejected(r, k, v, log_w, min(chunk, t))
    if rc != 0:
        raise RuntimeError(f"wkv backward kernel launch failed: cudaError {rc}")
    wkv_backward.launches += 1
    wkv_backward.launches_by_instance[(_DTYPE_NAMES[r.dtype], ki)] += 1
    return (*(_channels(g, kk) for g in grads), _channels(du, kk))


@_launch_backward.register_fake
def _(r, k, v, log_w, u, state, d_out, d_state, chunk):
    b, t, h, kk = r.shape
    grads = [r.new_empty((b, t, h, kk)) for _ in range(4)]
    return (*grads, r.new_empty((h, kk), dtype=torch.float32))


@register_flop_formula(torch.ops.repro_torch.wkv_backward)
def _launch_backward_flops(r_shape, *args, **kwargs) -> int:
    """2 (5 K^2 + 6 C K) per token and head at the backward's chunk C: the
    backward bound's operations (the chunked form's)."""
    b, t, h, kk = r_shape
    return 2 * (5 * kk * kk + 6 * BACKWARD_CHUNK * kk) * b * t * h


def wkv_backward(
    r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, log_w: torch.Tensor, u: torch.Tensor,
    state: torch.Tensor, d_out: torch.Tensor, d_state: Optional[torch.Tensor] = None,
    *, chunk: int = 64,
) -> Tuple[torch.Tensor, ...]:
    """The gradient of :func:`wkv` (from a zero initial state) given the
    output's gradient ``d_out`` (B, T, H, K) and the final state's
    ``d_state`` (B, H, K, K; None is zero): (dr, dk, dv, dlog_w (B, T, H,
    K), du (H, K)), each in its input's dtype, rounded once from float32.
    ``state`` is the forward's final state.  CUDA tensors go to the kernel
    in ``csrc/wkv_backward.cu`` (the forward's reach and layout rule; r, k,
    v, log_w and d_out in two dtypes run as float32 copies), CPU tensors to
    :func:`wkv_backward_ref`."""
    _check(r, k, v, log_w, u, chunk)
    if d_out.shape != r.shape:
        raise ValueError(f"d_out {tuple(d_out.shape)} != r {tuple(r.shape)}")
    inputs = (r, k, v, log_w, u)
    if r.device.type == "cpu":
        grads = wkv_backward_ref(r, k, v, log_w, u, d_out, d_state)
    elif r.device.type != "cuda":
        raise ValueError(f"wkv_backward runs on cuda or cpu, not {r.device.type}")
    else:
        _cuda_checks(r, k, v, log_w, u, chunk)
        rr, kk, vv, ww, dd = _one_dtype(r, k, v, log_w, d_out)
        grads = _launch_backward(rr, kk, vv, ww, u, state, dd, d_state, chunk)
    return tuple(g.to(x.dtype) for g, x in zip(grads, inputs))


def wkv_with_chunk_states(
    r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, log_w: torch.Tensor, u: torch.Tensor,
    *, chunk: int = 64,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`wkv` on the card, also returning the first pass's states
    entering each chunk ``(B, H, n_chunks, K, K)`` (its scratch), for
    checking the passes one by one against :func:`wkv_chunk_states`.
    CUDA tensors only."""
    _check(r, k, v, log_w, u, chunk)
    if r.device.type != "cuda":
        raise ValueError(f"wkv_with_chunk_states runs on cuda only, not {r.device.type}")
    _cuda_checks(r, k, v, log_w, u, chunk)
    out, state, scratch = _forward(r, k, v, log_w, u, chunk)
    b, t, h, kk = r.shape
    ki = instance(kk)
    n_chunks = -(-t // min(chunk, t))
    states = scratch[: b * h * n_chunks * ki * ki].view(b, h, n_chunks, ki, ki)
    return out, state, states[..., :kk, :kk]


wkv.launches = 0
wkv_backward.launches = 0
wkv.launches_by_instance = collections.Counter()
wkv_backward.launches_by_instance = collections.Counter()
