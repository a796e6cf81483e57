"""Weight bridge: the reference's parameter tree -> the port's state_dict.

The JAX package keeps parameters in a nested dict with every per-layer
leaf stacked on a leading layer dim (``layers/attn/wq`` is ``(L, d, h,
dh)``).  The port's modules hold one ``nn.Module`` per layer, so the
stacked dim unrolls into ``layers.<i>`` names::

    {"embed": E, "layers": {"attn": {"wq": WQ}}}
        -> {"embed": E, "layers.0.attn.wq": WQ[0], "layers.1.attn.wq": WQ[1], ...}

Every top-level key named ``layers`` or ending in ``_layers`` is such a
stack (whisper's ``enc_layers`` and ``dec_layers`` unroll into
``enc_layers.<i>`` and ``dec_layers.<i>``); each stack's leaves share one
depth.

numpy in, torch out (CPU tensors; ``load_state_dict`` copies them to the
model's device).  Leaves that numpy holds as ``bfloat16`` (``ml_dtypes``)
cross exactly through float32.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

__all__ = ["to_tensor", "state_dict_from_tree", "is_stack"]


def to_tensor(arr) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def _flatten(tree: Mapping, prefix: str, out: Dict[str, np.ndarray]) -> None:
    for key, sub in tree.items():
        name = f"{prefix}{key}"
        if isinstance(sub, Mapping):
            _flatten(sub, name + ".", out)
        else:
            out[name] = sub


def is_stack(key: str) -> bool:
    """True for a top-level key whose leaves stack the layers."""
    return key == "layers" or key.endswith("_layers")


def state_dict_from_tree(tree: Mapping) -> Dict[str, torch.Tensor]:
    """Flatten a reference parameter tree into the port's state_dict."""
    flat: Dict[str, np.ndarray] = {}
    _flatten({k: v for k, v in tree.items() if not is_stack(k)}, "", flat)
    out = {name: to_tensor(arr) for name, arr in flat.items()}
    for key in (k for k in tree if is_stack(k)):
        layers: Dict[str, np.ndarray] = {}
        _flatten(tree[key], "", layers)
        n_layers = {np.shape(arr)[0] for arr in layers.values()}
        if len(n_layers) > 1:
            raise ValueError(f"stacked {key} leaves disagree on depth: {sorted(n_layers)}")
        for name, arr in layers.items():
            stacked = to_tensor(arr)
            for i in range(stacked.shape[0]):
                out[f"{key}.{i}.{name}"] = stacked[i].clone()
    return out
