"""Public entry for the selective-scan kernel: u/dt (B, T, D), b_t/c_t
(B, T, N), log_a (D, N), float32, bfloat16 or float16.

The signature of ``repro/kernels/ssm_scan/ops.py::ssm_scan`` without
``d_block`` and ``interpret``, with the Pallas kernel's reach: any state
size N, any chunk, and inputs that are widened to float32 before any
arithmetic (y in u's dtype, rounded once; the state float32).  CUDA
tensors go to the hand-written Hopper kernel in ``csrc/ssm_scan.cu``
(time split into segments whose carries follow
``ref.selective_scan_segments``), which reads u/dt/b_t/c_t in place
through their strides in their own dtype, takes any D and any T, and masks
the ragged edges itself.  It is instantiated at the state sizes
``STATE_SIZES``: fewer states run on the next one up with B, C and log_a
padded by zero states (small copies; u and dt, the large inputs, are read
in place), and N over ``GROUP`` runs as groups of ``GROUP`` states, one
launch each (y summed in float32, the states side by side).  u, dt, b_t
and c_t in two dtypes, or in groups, run as float32 copies, y cast once;
log_a is read in float32.  CPU tensors go to the plain version
:func:`selective_scan_ref` on float32 copies, whatever their float dtype,
as the Pallas kernel widens them.  :func:`reach_error` says whether the
kernel takes a call (``DTYPES``, every N and chunk); a CUDA call outside
that raises: there is no fallback.

A CUDA call whose inputs require grad (with grad mode on) runs the same
forward under :class:`_SSMScan`, which also keeps the state entering every
``BACKWARD_TILE`` steps; its backward launches the hand-written kernel in
``csrc/ssm_scan_backward.cu`` (segments side by side, as
``ref.ssm_scan_backward_segments`` decomposes it) through
:func:`ssm_scan_backward`, starting from those states; each gradient comes
back in its input's dtype.  CPU tensors differentiate through the plain
version.

``ssm_scan.launches`` counts calls that launch the kernel, one per call,
and ``ssm_scan_backward.launches`` calls that launch the backward kernel;
each also keeps ``launches_by_instance``, the same launches by the
instance that ran, ``(dtype name, state size)`` (``("bf16", 16)``; a
group counts at its own instance).

Each launch is a ``torch.library`` custom op
(``repro_torch::ssm_scan_forward``, ``repro_torch::ssm_scan_backward``)
with a fake implementation for fake and meta tensors (the dry run's
kernel route) and a FLOP formula, the operations the kernel's bound
counts.  DTensors run the call on each rank's shards, split over batch and
channels (:mod:`repro_torch.kernels.sharded`).
"""
from __future__ import annotations

import collections
import ctypes
import functools
import pathlib
import struct
from typing import Optional, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build
from repro_torch.kernels.sharded import local_over_batch_heads
from repro_torch.sharding.context import is_dtensor
from repro_torch.kernels.ssm_scan.ref import selective_scan_ref, ssm_scan_backward_ref

__all__ = [
    "ssm_scan", "ssm_scan_backward", "ssm_scan_tile_states", "reach_error", "instance",
    "SOURCE", "BACKWARD_SOURCE", "STATE_SIZES", "GROUP", "DTYPES", "BACKWARD_TILE",
]

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "ssm_scan.cu"
BACKWARD_SOURCE = SOURCE.with_name("ssm_scan_backward.cu")
# The state sizes the CUDA kernels are instantiated for (kN): a call of N
# states runs on the first that holds N, padded by zero states (the
# reduced hymba-1.5b config's 8 and the published one's 16 exactly).
STATE_SIZES = (8, 16, 32, 64)
# States per launch: N over GROUP runs as groups of GROUP, one launch each.
GROUP = STATE_SIZES[-1]
# The element types the kernels read and write, and their codes in the C
# entries' ``dtype`` field.
DTYPES = (torch.float32, torch.bfloat16, torch.float16)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_DTYPE_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16"}
# Steps per tile of the backward kernel (kTile in ssm_scan_backward.cu,
# kBwdTile in ssm_scan.cu): it starts each tile from the state entering it.
BACKWARD_TILE = 64

# The C entry's argument block (``EntryArgs`` in the source): u, dt, b_t,
# c_t, log_a, y, state and tile-state (0: none) pointers; the (batch, time)
# strides of u, dt, b_t and c_t; the stream; B, T, D, N, chunk; the dtype
# code of the inputs and y.
_ENTRY_ARGS = struct.Struct("=8Q8qQ6i")
# The backward entry's block (``EntryArgs`` in ssm_scan_backward.cu): u, dt,
# b_t, c_t, dy, log_a, dh (0: none) and tile-state pointers; du, ddt, db_t,
# dc_t, dlog_a and scratch pointers; the (batch, time) strides of u, dt,
# b_t, c_t and dy; the stream; B, T, D, N, chunk; the dtype code of the
# inputs and their gradients.
_BACKWARD_ARGS = struct.Struct("=14Q10qQ6i")
assert (_ENTRY_ARGS.size, _BACKWARD_ARGS.size) == (160, 224)


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = build.load(SOURCE).ssm_scan_forward
    fn.argtypes = [ctypes.c_char_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _backward_kernel():
    """(entry, scratch floats for (B, T, D, N)) of the backward library."""
    lib = build.load(BACKWARD_SOURCE)
    fn, scratch = lib.ssm_scan_backward, lib.ssm_scan_backward_scratch
    fn.argtypes = [ctypes.c_char_p]
    fn.restype = ctypes.c_int
    scratch.argtypes = [ctypes.c_int] * 4
    scratch.restype = ctypes.c_longlong
    return fn, scratch


def _stream(dev: torch.device) -> int:
    return torch._C._cuda_getCurrentRawStream(dev.index)


def instance(n: int) -> int:
    """The state size of the instance a group of ``n`` (<= GROUP) states runs on."""
    return next(size for size in STATE_SIZES if n <= size)


def reach_error(dtype: torch.dtype, n: int, chunk: int) -> Optional[str]:
    """Why the CUDA kernels do not take a call whose inputs are ``dtype``
    with ``n`` states at chunk ``chunk``, naming the limit, or None when
    they do: every N >= 1 and every chunk >= 1 in ``DTYPES``."""
    if dtype not in DTYPES:
        return f"the CUDA kernels take DTYPES = (float32, bfloat16, float16), got {dtype}"
    if n < 1:
        return f"the state size must be at least 1, got {n}"
    if chunk < 1:
        return f"chunk must be positive, got {chunk}"
    return None


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
    if len({x.device for x in (u, dt, b_t, c_t, log_a)}) != 1:
        raise ValueError("u, dt, b_t, c_t and log_a must be on one device")


def _one_dtype(*xs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """``xs`` as they are when they share a dtype, else float32 copies of all."""
    if len({x.dtype for x in xs}) == 1:
        return xs
    return tuple(x.float() for x in xs)


def _padded(x: torch.Tensor, kn: int) -> torch.Tensor:
    """``x`` with its last dim (states) padded by zeros to ``kn``, or ``x``
    itself when it has ``kn`` states."""
    n = x.shape[-1]
    return x if n == kn else torch.nn.functional.pad(x, (0, kn - n))


def _cut(x: torch.Tensor, n: int) -> torch.Tensor:
    """The first ``n`` states of ``x`` (the last dim), contiguous."""
    return x if x.shape[-1] == n else x[..., :n].contiguous()


def _groups(n: int):
    """The groups of at most GROUP states, each as (its states, its columns
    of the tile states): a group's instance's state size wide, side by side."""
    groups, col = [], 0
    for g in range(0, n, GROUP):
        width = instance(min(GROUP, n - g))
        groups.append((slice(g, min(g + GROUP, n)), slice(col, col + width)))
        col += width
    return groups


def ssm_scan(
    u: torch.Tensor, dt: torch.Tensor, b_t: torch.Tensor, c_t: torch.Tensor,
    log_a: torch.Tensor, *, chunk: int = 64,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B, T, D) in u's dtype, final state (B, D, N) float32).
    ``chunk`` is the reference's time tile; the CUDA kernel picks its own
    tiles, which do not change the result.  DTensors compute on each rank's
    shards (over batch and channels)."""
    _check(u, dt, b_t, c_t, log_a, chunk)
    if is_dtensor(u):
        return local_over_batch_heads(
            functools.partial(ssm_scan, chunk=chunk), [u, dt, b_t, c_t, log_a],
            [(0, 2), (0, 2), (0, None), (0, None), (None, 0)], [(0, 2), (0, 1)])
    if u.device.type == "cpu":
        y, h = selective_scan_ref(u.float(), dt.float(), log_a.float(), b_t.float(), c_t.float())
        return y.to(u.dtype), h
    if u.device.type != "cuda":
        raise ValueError(f"ssm_scan runs on cuda or cpu, not {u.device.type}")
    _cuda_checks(u, dt, b_t, c_t, log_a, chunk)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (u, dt, b_t, c_t, log_a)):
        return _SSMScan.apply(u, dt, b_t, c_t, log_a, chunk)
    return _forward(u, dt, b_t, c_t, log_a, chunk, False)[:2]


def _cuda_checks(u, dt, b_t, c_t, log_a, chunk) -> None:
    """The CUDA route's reach (``reach_error`` for each input's dtype) and
    layout: the last dims contiguous."""
    for x in (u, dt, b_t, c_t, log_a):
        why = reach_error(x.dtype, b_t.shape[2], chunk)
        if why:
            raise ValueError(why)
    if any(x.stride(-1) != 1 for x in (u, dt, b_t, c_t)):
        raise ValueError("the last dim of u, dt, b_t and c_t must be contiguous")


def _tile_shape(u, n):
    """The tile states of N states: (B, ceil(T / 64), D, N') with N' the
    instance's state size (the states past N zero), past GROUP states the
    groups' side by side."""
    bsz, t, d = u.shape
    return bsz, -(-t // BACKWARD_TILE), d, _groups(n)[-1][1].stop


def _forward(u, dt, b_t, c_t, log_a, chunk, with_tiles):
    """The forward kernel, a launch per group of GROUP states: (y in u's
    dtype, final state, tiles (empty without ``with_tiles``)).  Inputs in
    two dtypes, or past GROUP states, run as float32 copies, y cast once."""
    y_dtype = u.dtype
    u, dt, b_t, c_t = _one_dtype(u, dt, b_t, c_t)
    n = b_t.shape[2]
    if n <= GROUP:
        y, h, tiles = _launch(u, dt, b_t, c_t, log_a, chunk, with_tiles)
        return y.to(y_dtype), h, tiles
    u, dt, b_t, c_t = (x.float() for x in (u, dt, b_t, c_t))
    parts = [_launch(u, dt, b_t[..., g], c_t[..., g], log_a[:, g], chunk, with_tiles)
             for g, _ in _groups(n)]
    y = functools.reduce(torch.add, [part[0] for part in parts]).to(y_dtype)
    h = torch.cat([part[1] for part in parts], dim=2)
    tiles = torch.cat([part[2] for part in parts], dim=-1) if with_tiles else parts[0][2]
    return y, h, tiles


@torch.library.custom_op("repro_torch::ssm_scan_forward", mutates_args=(), device_types="cuda")
def _launch(u: torch.Tensor, dt: torch.Tensor, b_t: torch.Tensor, c_t: torch.Tensor,
            log_a: torch.Tensor, chunk: int, with_tiles: bool
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The forward kernel on ``u``'s device for N <= GROUP states, u, dt,
    b_t and c_t in one dtype: (y in that dtype, final state, tiles); with
    ``with_tiles`` it also writes the state entering every
    ``BACKWARD_TILE`` steps into tiles (B, ceil(T / 64), D, instance(N)),
    which is empty without.  B, C and log_a of fewer states than the
    instance's are padded with zero states (whose h stays 0)."""
    bsz, t, d = u.shape
    n = b_t.shape[2]
    kn = instance(n)
    b_t, c_t = _padded(b_t, kn), _padded(c_t, kn)
    log_a = _padded(log_a.float(), kn).contiguous()  # (D, N): read once a thread
    y = torch.empty((bsz, t, d), dtype=u.dtype, device=u.device)
    h = torch.empty((bsz, d, kn), dtype=torch.float32, device=u.device)
    tiles = torch.empty(_tile_shape(u, n) if with_tiles else (0,), dtype=torch.float32,
                        device=u.device)
    dev = u.device
    args = _ENTRY_ARGS.pack(
        u.data_ptr(), dt.data_ptr(), b_t.data_ptr(), c_t.data_ptr(), log_a.data_ptr(),
        y.data_ptr(), h.data_ptr(), tiles.data_ptr() if with_tiles else 0,
        *u.stride()[:2], *dt.stride()[:2], *b_t.stride()[:2], *c_t.stride()[:2],
        _stream(dev),
        bsz, t, d, kn, int(chunk), _DTYPE_CODES[u.dtype],
    )
    if dev.index == torch.cuda.current_device():
        rc = _kernel()(args)
    else:
        with torch.cuda.device(dev):
            rc = _kernel()(args)
    if rc != 0:
        raise RuntimeError(f"ssm_scan kernel launch failed: cudaError {rc}")
    ssm_scan.launches += 1
    ssm_scan.launches_by_instance[(_DTYPE_NAMES[u.dtype], kn)] += 1
    return y, _cut(h, n), tiles


@_launch.register_fake
def _(u, dt, b_t, c_t, log_a, chunk, with_tiles):
    bsz, t, d = u.shape
    n = b_t.shape[2]
    return (u.new_empty((bsz, t, d)),
            u.new_empty((bsz, d, n), dtype=torch.float32),
            u.new_empty(_tile_shape(u, n) if with_tiles else (0,), dtype=torch.float32))


@register_flop_formula(torch.ops.repro_torch.ssm_scan_forward)
def _launch_flops(u_shape, dt_shape, b_shape, *args, **kwargs) -> int:
    """7 per (token, channel, state): the forward bound's operations."""
    bsz, t, d = u_shape
    return 7 * bsz * t * d * b_shape[2]


class _SSMScan(torch.autograd.Function):
    """The CUDA forward and the CUDA backward: what a CUDA call that
    carries gradients runs.  The forward keeps the state entering every
    ``BACKWARD_TILE`` steps (B x ceil(T / 64) x D x N' float32, which the
    backward would otherwise form in a pass of its own); a final-state
    gradient of None is taken as zero."""

    @staticmethod
    def forward(ctx, u, dt, b_t, c_t, log_a, chunk):
        y, h, tiles = _forward(u, dt, b_t, c_t, log_a, chunk, True)
        ctx.save_for_backward(u, dt, b_t, c_t, log_a, tiles)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        u, dt, b_t, c_t, log_a, tiles = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(u)
        du, ddt, db, dc, dlog_a = ssm_scan_backward(
            u, dt, b_t, c_t, log_a, dy, dh, chunk=ctx.chunk, tiles=tiles)
        return du, ddt, db, dc, dlog_a, None


def ssm_scan_tile_states(
    u: torch.Tensor, dt: torch.Tensor, b_t: torch.Tensor, c_t: torch.Tensor,
    log_a: torch.Tensor, *, chunk: int = 64,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`ssm_scan` on the card as a call that carries gradients runs
    it: (y, final state, the state entering every ``BACKWARD_TILE`` steps
    (B, ceil(T / 64), D, N'), N' the instance's state size, zeros past N;
    past GROUP states the groups' side by side), for
    :func:`ssm_scan_backward`'s ``tiles``.  CUDA tensors only."""
    _check(u, dt, b_t, c_t, log_a, chunk)
    if u.device.type != "cuda":
        raise ValueError(f"ssm_scan_tile_states runs on cuda only, not {u.device.type}")
    _cuda_checks(u, dt, b_t, c_t, log_a, chunk)
    return _forward(u, dt, b_t, c_t, log_a, chunk, True)


@torch.library.custom_op("repro_torch::ssm_scan_backward", mutates_args=(),
                         device_types="cuda")
def _launch_backward(u: torch.Tensor, dt: torch.Tensor, b_t: torch.Tensor, c_t: torch.Tensor,
                     log_a: torch.Tensor, dy: torch.Tensor, dh: Optional[torch.Tensor],
                     chunk: int, tiles: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                                torch.Tensor]:
    """The backward kernel on ``u``'s device for N <= GROUP states, u, dt,
    b_t, c_t and dy in one dtype, from the forward's ``tiles`` (contiguous,
    the instance's states wide): (du, ddt, db_t, dc_t) in that dtype
    and dlog_a in float32.  B, C, log_a and dh of fewer states than the
    instance's are padded with zero states, as the forward's."""
    bsz, t, d = u.shape
    n = b_t.shape[2]
    kn = instance(n)
    dev = u.device
    if dy.stride(-1) != 1:
        dy = dy.contiguous()
    b_t, c_t = _padded(b_t, kn), _padded(c_t, kn)
    log_a = _padded(log_a.float(), kn).contiguous()  # (D, N): read once a block
    if dh is not None:
        dh = _padded(dh.float(), kn).contiguous()
    fn, scratch_floats = _backward_kernel()
    outs = [torch.empty((bsz, t, d), dtype=u.dtype, device=dev) for _ in range(2)]
    outs += [torch.empty((bsz, t, kn), dtype=u.dtype, device=dev) for _ in range(2)]
    outs.append(torch.empty((d, kn), dtype=torch.float32, device=dev))
    scratch = torch.empty(scratch_floats(bsz, t, d, kn), dtype=torch.float32, device=dev)
    inputs = (u, dt, b_t, c_t, dy)
    args = _BACKWARD_ARGS.pack(
        *(x.data_ptr() for x in inputs), log_a.data_ptr(), 0 if dh is None else dh.data_ptr(),
        tiles.data_ptr(),
        *(o.data_ptr() for o in outs), scratch.data_ptr(),
        *(st for x in inputs for st in x.stride()[:2]),
        _stream(dev),
        bsz, t, d, kn, int(chunk), _DTYPE_CODES[u.dtype],
    )
    with torch.cuda.device(dev):
        rc = fn(args)
    if rc != 0:
        raise RuntimeError(f"ssm_scan backward kernel launch failed: cudaError {rc}")
    ssm_scan_backward.launches += 1
    ssm_scan_backward.launches_by_instance[(_DTYPE_NAMES[u.dtype], kn)] += 1
    return (*outs[:2], *(_cut(x, n) for x in outs[2:]))


@_launch_backward.register_fake
def _(u, dt, b_t, c_t, log_a, dy, dh, chunk, tiles):
    bsz, t, d = u.shape
    n = b_t.shape[2]
    return (u.new_empty((bsz, t, d)), u.new_empty((bsz, t, d)), u.new_empty((bsz, t, n)),
            u.new_empty((bsz, t, n)), u.new_empty((d, n), dtype=torch.float32))


@register_flop_formula(torch.ops.repro_torch.ssm_scan_backward)
def _launch_backward_flops(u_shape, dt_shape, b_shape, *args, **kwargs) -> int:
    """16 per (token, channel, state): the backward bound's operations."""
    bsz, t, d = u_shape
    return 16 * bsz * t * d * b_shape[2]


def ssm_scan_backward(
    u: torch.Tensor, dt: torch.Tensor, b_t: torch.Tensor, c_t: torch.Tensor,
    log_a: torch.Tensor, dy: torch.Tensor, dh: Optional[torch.Tensor] = None,
    *, chunk: int = 64, tiles: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, ...]:
    """The gradient of :func:`ssm_scan` (from h = 0) given the output's
    gradient ``dy`` (B, T, D) and the final state's ``dh`` (B, D, N; None
    is zero): (du, ddt (B, T, D), db_t, dc_t (B, T, N), dlog_a (D, N)),
    each in its input's dtype, rounded once from float32.  CUDA tensors go
    to the kernel in ``csrc/ssm_scan_backward.cu`` (the forward's reach:
    last dims contiguous; u, dt, b_t, c_t and dy in two dtypes, or N over
    GROUP, run as float32 copies, the latter as groups with du and ddt
    summed over them),
    which starts from ``tiles`` (the forward's states entering every
    ``BACKWARD_TILE`` steps, :func:`ssm_scan_tile_states`; when None the
    forward kernel forms them first); CPU tensors go to
    :func:`ssm_scan_backward_ref` on float32 copies."""
    _check(u, dt, b_t, c_t, log_a, chunk)
    if dy.shape != u.shape:
        raise ValueError(f"dy {tuple(dy.shape)} != u {tuple(u.shape)}")
    inputs = (u, dt, b_t, c_t, log_a)
    if u.device.type == "cpu":
        grads = ssm_scan_backward_ref(u, dt, b_t, c_t, log_a, dy, dh)
        return tuple(g.to(x.dtype) for g, x in zip(grads, inputs))
    if u.device.type != "cuda":
        raise ValueError(f"ssm_scan_backward runs on cuda or cpu, not {u.device.type}")
    _cuda_checks(u, dt, b_t, c_t, log_a, chunk)
    n = b_t.shape[2]
    if tiles is None:
        _, _, tiles = ssm_scan_tile_states(u, dt, b_t, c_t, log_a, chunk=chunk)
    elif tiles.shape != _tile_shape(u, n) or tiles.dtype != torch.float32 or not (
            tiles.is_contiguous() and tiles.device == u.device):
        raise ValueError(f"tiles must be float32 {_tile_shape(u, n)}, contiguous on {u.device}")
    uu, dtt, bb, cc, dyy = _one_dtype(u, dt, b_t, c_t, dy)
    if n <= GROUP:
        grads = _launch_backward(uu, dtt, bb, cc, log_a, dyy, dh, chunk, tiles)
    else:  # float32 sums over the groups, rounded once
        uu, dtt, bb, cc, dyy = (x.float() for x in (uu, dtt, bb, cc, dyy))
        parts = [_launch_backward(uu, dtt, bb[..., g], cc[..., g], log_a[:, g], dyy,
                                  None if dh is None else dh[..., g], chunk,
                                  tiles[..., cols].contiguous())
                 for g, cols in _groups(n)]
        grads = (functools.reduce(torch.add, [p[0] for p in parts]),
                 functools.reduce(torch.add, [p[1] for p in parts]),
                 torch.cat([p[2] for p in parts], dim=2), torch.cat([p[3] for p in parts], dim=2),
                 torch.cat([p[4] for p in parts], dim=1))
    return tuple(g.to(x.dtype) for g, x in zip(grads, inputs))


ssm_scan.launches = 0
ssm_scan_backward.launches = 0
ssm_scan.launches_by_instance = collections.Counter()
ssm_scan_backward.launches_by_instance = collections.Counter()
