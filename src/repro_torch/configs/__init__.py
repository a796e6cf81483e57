"""Ported architecture configs.

``ARCHS`` maps arch id -> config module; `get_api(arch_id, reduced=False)`
returns a ready `ModelApi`.  The other dense configs (internlm2, minitron,
chameleon) and the other families (moe, deepseek, whisper) come with
later slices.
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.configs import hymba_1_5b, llama3_8b, olmo_1b, rwkv6_7b
from repro_torch.models.registry import ModelApi, build_api

ARCHS: Dict[str, object] = {m.ARCH_ID: m for m in (olmo_1b, llama3_8b, rwkv6_7b, hymba_1_5b)}


def arch_ids() -> List[str]:
    return list(ARCHS.keys())


def get_api(arch_id: str, *, reduced: bool = False) -> ModelApi:
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; available: {sorted(ARCHS)}")
    mod = ARCHS[arch_id]
    cfg = mod.reduced() if reduced else mod.config()
    return build_api(arch_id, cfg)


__all__ = ["ARCHS", "arch_ids", "get_api"]
