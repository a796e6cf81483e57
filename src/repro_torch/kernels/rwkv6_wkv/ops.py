"""Public entry for the WKV kernel: model layout (B, T, H, K) + u (H, K).

The signature of ``repro/kernels/rwkv6_wkv/ops.py::wkv``.  CUDA tensors go
to the hand-written Hopper kernel in ``csrc/wkv.cu`` (two passes: the
states entering every chunk, then every chunk's output), which reads r/k/
v/log_w in place through their strides and masks the ragged last chunk
itself; CPU tensors go to the plain version :func:`wkv_chunked`.  A CUDA
call that the kernel does not take raises: there is no fallback.  The C
entry refuses a head size, chunk or layout it cannot take, and
:func:`layout_error` (the same rule, in Python) then says why.

A CUDA call whose inputs require grad (with grad mode on) runs the same
forward under :class:`_WKV`, whose backward launches the hand-written
kernel in ``csrc/wkv_backward.cu`` (chunk-parallel products on the tensor
cores, as ``ref.wkv_backward_chunked`` decomposes them) through
:func:`wkv_backward`; CPU tensors differentiate through the plain
version.

``wkv.launches`` counts calls that launch the kernel's passes, and
``wkv_backward.launches`` calls that launch the backward kernel.

Each launch is a ``torch.library`` custom op (``repro_torch::wkv_forward``,
``repro_torch::wkv_backward``) with a fake implementation for fake and
meta tensors (the dry run's kernel route) and a FLOP formula, the
operations the kernel's bound counts.  DTensors run the call on each
rank's shards, split over batch and heads
(:mod:`repro_torch.kernels.sharded`).
"""
from __future__ import annotations

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
    "wkv", "wkv_with_chunk_states", "wkv_backward", "layout_error", "SOURCE", "BACKWARD_SOURCE",
    "HEAD_SIZE", "MAX_CHUNK",
]

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "wkv.cu"
BACKWARD_SOURCE = SOURCE.with_name("wkv_backward.cu")
HEAD_SIZE = 64
MAX_CHUNK = 64
BACKWARD_CHUNK = 32  # the backward kernel's chunk (kChunk in wkv_backward.cu)
_REJECTED = -1  # the C entry's code for a head size, chunk or layout it does not take

# The C entry's argument block (``EntryArgs`` in the source): r, k, v,
# log_w, u, out, state and chunk-state pointers; the (batch, time, head,
# channel) strides of r, k, v, log_w and out; the stream; B, T, H, K,
# chunk; one unused int.
_ENTRY_ARGS = struct.Struct("=8Q20qQ6i")
# The backward entry's block (``EntryArgs`` in wkv_backward.cu): r, k, v,
# log_w, dout, u, final state, its gradient (0: none), dr, dk, dv, dlog_w,
# du and scratch pointers; the (batch, time, head, channel) strides of r,
# k, v, log_w and dout; the stream; B, T, H, K, chunk; one unused int.
_BACKWARD_ARGS = struct.Struct("=14Q20qQ6i")


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
    if not r.dtype == k.dtype == v.dtype == log_w.dtype == u.dtype == torch.float32:
        raise ValueError(f"wkv takes float32, got {sorted({str(x.dtype) for x in tensors})}")
    if not r.device == k.device == v.device == log_w.device == u.device:
        raise ValueError("r, k, v, log_w and u must be on one device")


def _rejected(r, k, v, log_w, c) -> ValueError:
    kk = r.shape[-1]
    if kk != HEAD_SIZE:
        return ValueError(f"the CUDA kernel takes head size {HEAD_SIZE}, got {kk}")
    if c > MAX_CHUNK:
        return ValueError(f"the CUDA kernel takes chunks of at most {MAX_CHUNK}, got {c}")
    why = [f"{name}: {err}" for name, x in (("r", r), ("k", k), ("v", v), ("log_w", log_w))
           if (err := layout_error(x.shape, x.stride(), x.data_ptr() % 16))]
    return ValueError(f"the CUDA kernel copies rows as 16-byte vectors and cannot read "
                      f"{'; '.join(why) or 'r, k, v or log_w'}")


@torch.library.custom_op("repro_torch::wkv_forward", mutates_args=(), device_types="cuda")
def _launch(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, log_w: torch.Tensor,
            u: torch.Tensor, chunk: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Both passes on the card; returns (out, final state, scratch), the
    scratch starting with the chunk states."""
    b, t, h, kk = r.shape
    c = min(chunk, t)
    n_chunks = -(-t // c)
    dev = r.device
    u = u.contiguous()
    out = torch.empty((b, t, h, kk), dtype=torch.float32, device=dev)
    state = torch.empty((b, h, kk, kk), dtype=torch.float32, device=dev)
    # The chunk states, then one int32 flag per chunk state (pass A -> pass B).
    scratch = torch.empty(b * h * n_chunks * (kk * kk + 1), dtype=torch.float32, device=dev)
    args = _ENTRY_ARGS.pack(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), log_w.data_ptr(), u.data_ptr(),
        out.data_ptr(), state.data_ptr(), scratch.data_ptr(),
        *r.stride(), *k.stride(), *v.stride(), *log_w.stride(), *out.stride(),
        _stream(dev),
        b, t, h, kk, int(chunk), 0,
    )
    with torch.cuda.device(dev):
        rc = _kernel()(args)
    if rc == _REJECTED:
        raise _rejected(r, k, v, log_w, c)
    if rc != 0:
        raise RuntimeError(f"wkv kernel launch failed: cudaError {rc}")
    wkv.launches += 1
    return out, state, scratch


@_launch.register_fake
def _(r, k, v, log_w, u, chunk):
    b, t, h, kk = r.shape
    n_chunks = -(-t // min(chunk, t))
    return (r.new_empty((b, t, h, kk), dtype=torch.float32),
            r.new_empty((b, h, kk, kk), dtype=torch.float32),
            r.new_empty((b * h * n_chunks * (kk * kk + 1),), dtype=torch.float32))


@register_flop_formula(torch.ops.repro_torch.wkv_forward)
def _launch_flops(r_shape, *args, **kwargs) -> int:
    """4 K^2 per token and head: the forward bound's operations."""
    b, t, h, kk = r_shape
    return 4 * kk * kk * b * t * h


def wkv(
    r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, log_w: torch.Tensor, u: torch.Tensor,
    *, chunk: int = 64,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """r/k/v/log_w: (B, T, H, K) float32; u: (H, K) float32.
    Returns (out (B, T, H, K), final state (B, H, K, K) float32).
    DTensors compute on each rank's shards."""
    _check(r, k, v, log_w, u, chunk)
    if is_dtensor(r):
        return local_over_batch_heads(functools.partial(wkv, chunk=chunk), [r, k, v, log_w, u],
                                      [(0, 2)] * 4 + [(None, 0)], [(0, 2), (0, 1)])
    if r.device.type == "cpu":
        return wkv_chunked(r, k, v, log_w, u, chunk=chunk)
    if r.device.type != "cuda":
        raise ValueError(f"wkv runs on cuda or cpu, not {r.device.type}")
    if torch.is_grad_enabled() and any(x.requires_grad for x in (r, k, v, log_w, u)):
        return _WKV.apply(r, k, v, log_w, u, chunk)
    out, state, _ = _launch(r, k, v, log_w, u, chunk)
    return out, state


class _WKV(torch.autograd.Function):
    """The CUDA forward and the CUDA backward: what a CUDA call that
    carries gradients runs.  The forward saves its inputs and its final
    state (the backward's log-decay term needs S_T); a final-state gradient
    of None is taken as zero."""

    @staticmethod
    def forward(ctx, r, k, v, log_w, u, chunk):
        out, state, _ = _launch(r, k, v, log_w, u, chunk)
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
    """The backward kernel on ``r``'s device: (dr, dk, dv, dlog_w, du)."""
    b, t, h, kk = r.shape
    dev = r.device
    if d_out.stride(-1) != 1 or layout_error(d_out.shape, d_out.stride(), d_out.data_ptr() % 16):
        d_out = d_out.contiguous()
    u, state = u.contiguous(), state.contiguous()
    if d_state is not None:
        d_state = d_state.float().contiguous()
    grads = [torch.empty((b, t, h, kk), dtype=torch.float32, device=dev) for _ in range(4)]
    du = torch.empty((h, kk), dtype=torch.float32, device=dev)
    partial = torch.empty((b, h, kk), dtype=torch.float32, device=dev)
    inputs = (r, k, v, log_w, d_out)
    args = _BACKWARD_ARGS.pack(
        *(x.data_ptr() for x in inputs), u.data_ptr(), state.data_ptr(),
        0 if d_state is None else d_state.data_ptr(),
        *(g.data_ptr() for g in grads), du.data_ptr(), partial.data_ptr(),
        *(st for x in inputs for st in x.stride()),
        _stream(dev),
        b, t, h, kk, int(chunk), 0,
    )
    with torch.cuda.device(dev):
        rc = _backward_kernel()(args)
    if rc == _REJECTED:
        raise _rejected(r, k, v, log_w, min(chunk, t))
    if rc != 0:
        raise RuntimeError(f"wkv backward kernel launch failed: cudaError {rc}")
    wkv_backward.launches += 1
    return (*grads, du)


@_launch_backward.register_fake
def _(r, k, v, log_w, u, state, d_out, d_state, chunk):
    b, t, h, kk = r.shape
    grads = [r.new_empty((b, t, h, kk), dtype=torch.float32) for _ in range(4)]
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
    K), du (H, K)), float32.  ``state`` is the forward's final state.  CUDA
    tensors go to the kernel in ``csrc/wkv_backward.cu`` (the forward's
    limits: K = 64, chunk <= 64, 16-byte rows), CPU tensors to
    :func:`wkv_backward_ref`."""
    _check(r, k, v, log_w, u, chunk)
    if d_out.shape != r.shape:
        raise ValueError(f"d_out {tuple(d_out.shape)} != r {tuple(r.shape)}")
    if r.device.type == "cpu":
        return wkv_backward_ref(r, k, v, log_w, u, d_out, d_state)
    if r.device.type != "cuda":
        raise ValueError(f"wkv_backward runs on cuda or cpu, not {r.device.type}")
    return _launch_backward(r, k, v, log_w, u, state, d_out.float(), d_state, chunk)


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
    out, state, scratch = _launch(r, k, v, log_w, u, chunk)
    b, t, h, kk = r.shape
    n_chunks = -(-t // min(chunk, t))
    return out, state, scratch[: b * h * n_chunks * kk * kk].view(b, h, n_chunks, kk, kk)


wkv.launches = 0
wkv_backward.launches = 0
