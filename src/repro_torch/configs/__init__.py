"""Ported architecture configs.

``ARCHS`` maps arch id -> config module, in the reference's order;
`get_api(arch_id, reduced=False)` returns a ready `ModelApi`.  Every
reference arch is here.
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.configs import (
    chameleon_34b,
    deepseek_v2_236b,
    hymba_1_5b,
    internlm2_20b,
    llama3_8b,
    minitron_4b,
    mixtral_8x7b,
    olmo_1b,
    rwkv6_7b,
    whisper_large_v3,
)
from repro_torch.configs.shapes import REDUCED_SHAPES, SHAPES, InputShape
from repro_torch.models.registry import ModelApi, build_api

_MODULES = [
    minitron_4b,
    deepseek_v2_236b,
    whisper_large_v3,
    hymba_1_5b,
    olmo_1b,
    chameleon_34b,
    rwkv6_7b,
    internlm2_20b,
    llama3_8b,
    mixtral_8x7b,
]

ARCHS: Dict[str, object] = {m.ARCH_ID: m for m in _MODULES}


def arch_ids() -> List[str]:
    return list(ARCHS.keys())


def get_api(arch_id: str, *, reduced: bool = False) -> ModelApi:
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; available: {sorted(ARCHS)}")
    mod = ARCHS[arch_id]
    cfg = mod.reduced() if reduced else mod.config()
    return build_api(arch_id, cfg)


__all__ = ["ARCHS", "arch_ids", "get_api", "SHAPES", "REDUCED_SHAPES", "InputShape"]
