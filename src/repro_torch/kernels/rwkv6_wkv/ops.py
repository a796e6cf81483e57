"""Public entry for the WKV kernel: model layout (B, T, H, K) + u (H, K).

The signature of ``repro/kernels/rwkv6_wkv/ops.py::wkv``.  CUDA tensors go
to the hand-written Hopper kernel in ``csrc/wkv.cu`` (two passes: the
states entering every chunk, then every chunk's output), which reads r/k/
v/log_w in place through their strides and masks the ragged last chunk
itself; CPU tensors go to the plain version :func:`wkv_chunked`.  A CUDA
call that the kernel does not take raises: there is no fallback.  The C
entry refuses a head size, chunk or layout it cannot take, and
:func:`layout_error` (the same rule, in Python) then says why.

``wkv.launches`` counts calls that launch the kernel's passes.
"""
from __future__ import annotations

import ctypes
import functools
import pathlib
import struct
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.rwkv6_wkv.ref import wkv_chunked

__all__ = ["wkv", "wkv_with_chunk_states", "layout_error", "SOURCE", "HEAD_SIZE", "MAX_CHUNK"]

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "wkv.cu"
HEAD_SIZE = 64
MAX_CHUNK = 64
_REJECTED = -1  # the C entry's code for a head size, chunk or layout it does not take

# The C entry's argument block (``EntryArgs`` in the source): r, k, v,
# log_w, u, out, state and chunk-state pointers; the (batch, time, head,
# channel) strides of r, k, v, log_w and out; the stream; B, T, H, K,
# chunk; one unused int.
_ENTRY_ARGS = struct.Struct("=8Q20qQ6i")


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = build.load(SOURCE).wkv_forward
    fn.argtypes = [ctypes.c_char_p]
    fn.restype = ctypes.c_int
    return fn


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


def _launch(r, k, v, log_w, u, chunk):
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
        torch._C._cuda_getCurrentRawStream(dev.index),
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
    out, state, _ = _launch(r, k, v, log_w, u, chunk)
    return out, state


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
