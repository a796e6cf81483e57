"""PyTorch/CUDA port of the Cannikin reproduction, laid out like ``repro``.

Each module here is the counterpart of the module under the same path in
the JAX package.  Host-side numpy modules are copied verbatim; device code
is PyTorch, and the Pallas TPU kernels become hand-written Hopper kernels
under :mod:`repro_torch.kernels`.

Entry points take ``device=None``, which means the first CUDA card.
Without a card they raise unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` -> ``cuda``.  A CUDA device without a card raises; the
    port never moves to the CPU unless it is asked to."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU"
        )
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
