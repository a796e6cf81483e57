"""Build the port's CUDA kernels from the repository's sources at first use.

Each kernel is one ``.cu`` file with a plain C interface.  ``nvcc``
compiles it for ``sm_90a`` into a shared library under ``build/kernels/``
at the repository root, named by a hash of the source and the flags, and
``ctypes`` loads it.  A source may be built more than once with
different ``-D`` defines (the flash source, once per element type), each
into a library of its own.  A missing ``nvcc`` or a failed compile raises; nothing here is
touched when a module is imported.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import pathlib
import shutil
import subprocess
import time
from typing import List, Sequence

__all__ = ["BuildResult", "build", "load", "nvcc_path", "BUILD_DIR"]

REPO_ROOT = pathlib.Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
]


@dataclasses.dataclass(frozen=True)
class BuildResult:
    path: pathlib.Path
    seconds: float   # 0.0 when the library was already built
    log: str         # nvcc's output (ptxas register / shared-memory report)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the CUDA toolkit")


def build(source: pathlib.Path, defines: Sequence[str] = ()) -> BuildResult:
    """Compile ``source`` with ``defines`` (``-DNAME=VALUE`` flags) unless a
    library built from the same bytes and flags exists."""
    source = pathlib.Path(source)
    flags = [*NVCC_FLAGS, *defines]
    digest = hashlib.sha256(source.read_bytes() + " ".join(flags).encode()).hexdigest()
    out = BUILD_DIR / f"{source.stem}-{digest[:16]}.so"
    if out.exists():
        return BuildResult(out, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd: List[str] = [nvcc_path(), *flags, "-o", str(tmp), str(source)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {source.name} (rc {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    return BuildResult(out, seconds, log)


def load(source: pathlib.Path, defines: Sequence[str] = ()) -> ctypes.CDLL:
    """Build if needed and load ``source``'s library built with ``defines``."""
    return ctypes.CDLL(str(build(source, defines).path))
