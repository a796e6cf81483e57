"""Checkpointing: nested state <-> .npz with keypath-string keys.

The counterpart of ``repro/train/checkpoint.py``, with numpy and torch
only, writing the same file layout, so that either package verifies and
restores the other's files:

* a tree of dicts, lists, tuples and named tuples is flattened into one
  ``.npz`` entry per leaf, keyed by its path joined with ``/`` (dict keys
  as they are, sequence indices as numbers, named-tuple fields as
  ``.<field>``; dict keys in sorted order; ``None`` holds no leaf) — the
  strings ``jax.tree_util`` keypaths give;
* leaves are torch tensors (gathered to the host), numpy arrays and
  scalars, or Python scalars; bfloat16 has no numpy dtype, so such leaves
  are stored as float32 and named in the ``__dtypes__`` tag;
* a sha256 digest over the canonical payload (sorted key, dtype, shape,
  raw bytes) is stored as ``__sha256__`` and verified on load
  (:class:`CheckpointCorruptError` on a mismatch); ``__generation__``
  carries :class:`CheckpointManager`'s monotone counter;
* a file is written to ``<path>.tmp`` and renamed over ``path`` once
  complete, so a failed write never leaves a truncated archive where a
  valid one was.

:class:`CheckpointManager` keeps the newest ``keep`` generations
(``<dir>/<name>.gen<NNNNNN>.ckpt.npz``) and restores the newest one that
verifies, rolling back past corrupt heads.  Files without a digest still
restore.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

Tree = Any

__all__ = [
    "save",
    "restore",
    "LocalIO",
    "CheckpointCorruptError",
    "verify_checkpoint",
    "checkpoint_generation",
    "CheckpointManager",
]

_DTYPE_TAG = "__dtypes__"
_CHECKSUM_TAG = "__sha256__"
_GENERATION_TAG = "__generation__"


class CheckpointCorruptError(ValueError):
    """The checkpoint's payload does not match its embedded sha256 digest
    (or the archive is unreadable where a digest was expected)."""


class LocalIO:
    """Default checkpoint I/O: the local filesystem.  Any object with
    ``open(path, mode)`` and ``replace(src, dst)`` works (fault injection
    makes writes fail through this seam)."""

    def open(self, path: str, mode: str):
        return open(path, mode)

    def replace(self, src: str, dst: str) -> None:
        os.replace(src, dst)


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree: Tree, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[str, Any]]:
    """``(key, leaf)`` pairs in the order ``jax.tree_util`` flattens."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], prefix + (str(k),))
    elif _is_namedtuple(tree):
        for name in tree._fields:
            yield from _flatten(getattr(tree, name), prefix + ("." + name,))
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _flatten(sub, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def _unflatten(like: Tree, leaves: Iterator[Any]) -> Tree:
    """A tree shaped as ``like`` with its leaves taken from ``leaves`` in
    :func:`_flatten`'s order."""
    if like is None:
        return None
    if isinstance(like, dict):
        out = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: out[k] for k in like}
    if _is_namedtuple(like):
        return type(like)(*(_unflatten(getattr(like, f), leaves) for f in like._fields))
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(sub, leaves) for sub in like)
    return next(leaves)


def _host(leaf) -> Tuple[np.ndarray, bool]:
    """``(array, was_bfloat16)``: a leaf on the host as numpy, bfloat16 as
    float32."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.float().numpy(), True
        return t.numpy(), False
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        return arr.astype(np.float32), True
    return arr, False


def _payload_digest(flat: Dict[str, np.ndarray]) -> str:
    """sha256 over the canonicalized payload: sorted key, dtype, shape, raw
    bytes (the digest entry itself is excluded by callers)."""
    h = hashlib.sha256()
    for k in sorted(flat):
        arr = np.ascontiguousarray(flat[k])
        h.update(k.encode())
        h.update(str(arr.dtype).encode())
        h.update(str(arr.shape).encode())
        h.update(arr.tobytes())
    return h.hexdigest()


def _digest_array(digest: str) -> np.ndarray:
    return np.frombuffer(digest.encode(), dtype=np.uint8)


def save(
    path: str,
    tree: Tree,
    *,
    io: Any = None,
    generation: Optional[int] = None,
) -> None:
    """Atomically write ``tree`` to ``path``, with its sha256 digest and,
    when given, the ``generation`` counter."""
    if io is None:
        io = LocalIO()
    flat: Dict[str, np.ndarray] = {}
    dtypes: Dict[str, str] = {}
    for k, leaf in _flatten(tree):
        arr, bf16 = _host(leaf)
        if bf16:
            dtypes[k] = "bfloat16"
        flat[k] = arr
    flat[_DTYPE_TAG] = np.frombuffer(json.dumps(dtypes).encode(), dtype=np.uint8)
    if generation is not None:
        flat[_GENERATION_TAG] = np.int64(generation)
    flat[_CHECKSUM_TAG] = _digest_array(_payload_digest(
        {k: v for k, v in flat.items() if k != _CHECKSUM_TAG}
    ))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp"
    try:
        with io.open(tmp, "wb") as f:
            np.savez(f, **flat)
        io.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            try:
                os.remove(tmp)
            except OSError:
                pass


def _verify_open(data) -> None:
    """Raise :class:`CheckpointCorruptError` when the open archive's payload
    does not match its embedded digest (archives without one pass)."""
    if _CHECKSUM_TAG not in data.files:
        return
    stored = bytes(data[_CHECKSUM_TAG]).decode()
    flat = {k: data[k] for k in data.files if k != _CHECKSUM_TAG}
    actual = _payload_digest(flat)
    if actual != stored:
        raise CheckpointCorruptError(
            f"checkpoint payload digest mismatch: stored {stored[:12]}…, "
            f"computed {actual[:12]}…"
        )


def verify_checkpoint(path: str) -> bool:
    """True iff ``path`` is a readable checkpoint whose payload matches its
    embedded sha256 digest (archives without a digest pass)."""
    try:
        with np.load(path) as data:
            _verify_open(data)
        return True
    except Exception:
        return False


def checkpoint_generation(path: str) -> Optional[int]:
    """The generation counter stamped into ``path`` (None if unstamped or
    unreadable)."""
    try:
        with np.load(path) as data:
            if _GENERATION_TAG in data.files:
                return int(data[_GENERATION_TAG])
    except Exception:
        return None
    return None


def _restored_leaf(arr: np.ndarray, like, bf16: bool):
    """A saved array in the kind of leaf ``like`` is: a tensor on ``like``'s
    device (bfloat16 when tagged, else the saved dtype), a Python scalar of
    ``like``'s type, or the saved numpy value."""
    if isinstance(like, torch.Tensor):
        t = torch.from_numpy(np.array(arr))
        if bf16:
            t = t.to(torch.bfloat16)
        return t.to(like.device)
    if isinstance(like, (bool, int, float)) and arr.shape == ():
        return type(like)(arr.item())
    return arr  # a tagged bfloat16 leaf stays float32: numpy has no bfloat16


def restore(path: str, like: Tree) -> Tree:
    """Restore into the structure of ``like`` (shapes validated, payload
    digest verified when present — :class:`CheckpointCorruptError` on a
    mismatch)."""
    with np.load(path) as data:
        _verify_open(data)
        dtypes: Dict[str, str] = {}
        if _DTYPE_TAG in data.files:
            dtypes = json.loads(bytes(data[_DTYPE_TAG]).decode())
        leaves = []
        for k, leaf in _flatten(like):
            if k not in data.files:
                raise KeyError(f"checkpoint missing leaf {k!r}")
            arr = data[k]
            want_shape = tuple(leaf.shape) if isinstance(leaf, torch.Tensor) else np.shape(leaf)
            if tuple(arr.shape) != tuple(want_shape):
                raise ValueError(
                    f"shape mismatch for {k}: checkpoint {arr.shape} vs model {tuple(want_shape)}"
                )
            leaves.append(_restored_leaf(arr, leaf, dtypes.get(k) == "bfloat16"))
    return _unflatten(like, iter(leaves))


class CheckpointManager:
    """Checksummed, versioned checkpoint generations with rollback.

    On-disk layout: ``<directory>/<name>.gen<NNNNNN>.ckpt.npz`` where
    ``NNNNNN`` is the zero-padded monotone generation counter (also stamped
    inside the archive).  ``save`` writes generation ``latest + 1`` and
    prunes to the newest ``keep`` generations; ``restore`` walks newest to
    oldest past corrupt or unreadable heads (each skip counted in
    ``rollbacks`` and recorded in ``corrupt_generations``) and raises
    :class:`CheckpointCorruptError` only when no generation verifies.  The
    generation scan is on-disk state, so a fresh manager in a new process
    resumes the same sequence.
    """

    _GEN_RE = re.compile(r"\.gen(\d{6})\.ckpt\.npz$")

    def __init__(
        self,
        directory: str,
        name: str,
        *,
        keep: int = 3,
        io: Any = None,
    ) -> None:
        if keep < 1:
            raise ValueError("keep must be >= 1")
        self.directory = directory
        self.name = name
        self.keep = int(keep)
        self.io = io
        self.rollbacks = 0
        self.corrupt_generations: List[str] = []

    def _gen_path(self, gen: int) -> str:
        return os.path.join(self.directory, f"{self.name}.gen{gen:06d}.ckpt.npz")

    def generations(self) -> List[Tuple[int, str]]:
        """(generation, path) pairs on disk, ascending."""
        out: List[Tuple[int, str]] = []
        prefix = f"{self.name}.gen"
        try:
            entries = os.listdir(self.directory)
        except OSError:
            return out
        for fname in entries:
            if not fname.startswith(prefix):
                continue
            m = self._GEN_RE.search(fname)
            if m:
                out.append((int(m.group(1)), os.path.join(self.directory, fname)))
        return sorted(out)

    @property
    def latest_generation(self) -> int:
        gens = self.generations()
        return gens[-1][0] if gens else 0

    @property
    def latest_path(self) -> Optional[str]:
        gens = self.generations()
        return gens[-1][1] if gens else None

    def save(self, tree: Tree, *, io: Any = None) -> str:
        """Write the next generation (atomic, checksummed) and prune to the
        retention bound.  A failed write leaves no file, so the counter
        does not advance — retries land on the same generation."""
        os.makedirs(self.directory, exist_ok=True)
        gen = self.latest_generation + 1
        path = self._gen_path(gen)
        save(path, tree, io=io if io is not None else self.io, generation=gen)
        self._prune()
        return path

    def _prune(self) -> None:
        gens = self.generations()
        for _, path in gens[: max(len(gens) - self.keep, 0)]:
            try:
                os.remove(path)
            except OSError:
                pass

    def restore(self, like: Tree) -> Tuple[Tree, int, str]:
        """Restore the newest generation that verifies, rolling back past
        corrupt heads.  Returns ``(tree, generation, path)``."""
        gens = self.generations()
        for gen, path in reversed(gens):
            try:
                tree = restore(path, like)
            except Exception:
                # Digest mismatch, unreadable zip, missing/mismatched
                # leaves: all mean "this generation cannot be trusted".
                self.rollbacks += 1
                self.corrupt_generations.append(path)
                continue
            return tree, gen, path
        raise CheckpointCorruptError(
            f"no valid checkpoint generation for {self.name!r} "
            f"in {self.directory} ({len(gens)} on disk, all corrupt)"
        )
