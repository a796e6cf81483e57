"""Plain PyTorch version of flash attention: the kernel's oracle and its CPU path."""
from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = ["attention_ref"]


def attention_ref(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,  # (B, T, KV, D)
    v: torch.Tensor,  # (B, T, KV, D)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softmax_scale: Optional[float] = None,
    kv_len: Optional[int] = None,
) -> torch.Tensor:
    """Softmax attention over whole rows in float32, output in q's dtype.

    Query head ``h`` reads kv head ``h // (H // KV)``.  Keys at index
    ``>= kv_len`` are masked; rows with no valid key give zeros.
    """
    b, s, h, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    r = h // kv
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)
    qg = (q.float() * scale).reshape(b, s, kv, r, d)
    scores = torch.einsum("bskrd,btkd->bkrst", qg, k.float())
    q_pos = torch.arange(s, device=q.device)[:, None]
    k_pos = torch.arange(t, device=q.device)[None, :]
    mask = k_pos < (t if kv_len is None else kv_len)
    if causal:
        mask = mask & (k_pos <= q_pos)
    if window is not None:
        mask = mask & (k_pos > q_pos - window)
    scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1).nan_to_num(nan=0.0)
    out = torch.einsum("bkrst,btkd->bskrd", probs, v.float())
    return out.reshape(b, s, h, d).to(q.dtype)
