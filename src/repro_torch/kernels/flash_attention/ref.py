"""Plain PyTorch versions of flash attention, the kernels' oracles and CPU path.

:func:`attention_ref` is the forward (differentiable: CPU training runs
autograd through it).  :func:`attention_lse_ref` and
:func:`attention_backward_ref` are the plain versions of what the CUDA
training path adds: each row's log-sum-exp, and dQ, dK, dV recomputed from
it with the backward kernel's formulas.  v's head dim ``Dv`` may differ
from q's and k's ``Dqk`` (DeepSeek-V2's MLA: 192 and 128): the output, dO
and dv have ``Dv``, and the scale defaults to ``1/sqrt(Dqk)``.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

__all__ = ["attention_ref", "attention_lse_ref", "attention_backward_ref"]


def _scores(q, k, causal, window, softmax_scale, kv_len) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scaled float32 scores (B, KV, R, S, T), masked to -inf, and the mask
    (S, T).  Query head ``h`` reads kv head ``h // (H // KV)``."""
    b, s, h, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)
    qg = (q.float() * scale).reshape(b, s, kv, h // kv, d)
    scores = torch.einsum("bskrd,btkd->bkrst", qg, k.float())
    q_pos = torch.arange(s, device=q.device)[:, None]
    k_pos = torch.arange(t, device=q.device)[None, :]
    mask = k_pos < (t if kv_len is None else kv_len)
    if causal:
        mask = mask & (k_pos <= q_pos)
    if window is not None:
        mask = mask & (k_pos > q_pos - window)
    return scores.masked_fill(~mask, float("-inf")), mask


def attention_ref(
    q: torch.Tensor,  # (B, S, H, Dqk)
    k: torch.Tensor,  # (B, T, KV, Dqk)
    v: torch.Tensor,  # (B, T, KV, Dv)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softmax_scale: Optional[float] = None,
    kv_len: Optional[int] = None,
) -> torch.Tensor:
    """Softmax attention over whole rows in float32, output (B, S, H, Dv)
    in q's dtype.

    Query head ``h`` reads kv head ``h // (H // KV)``.  Keys at index
    ``>= kv_len`` are masked; rows with no valid key give zeros.
    """
    b, s, h, _ = q.shape
    scores, _ = _scores(q, k, causal, window, softmax_scale, kv_len)
    probs = torch.softmax(scores, dim=-1).nan_to_num(nan=0.0)
    out = torch.einsum("bkrst,btkd->bskrd", probs, v.float())
    return out.reshape(b, s, h, v.shape[-1]).to(q.dtype)


def attention_lse_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softmax_scale: Optional[float] = None,
    kv_len: Optional[int] = None,
) -> torch.Tensor:
    """Each row's log-sum-exp of its scaled scores, (B, H, S) float32, as the
    forward kernel writes it; -inf for a row with no valid key."""
    b, s, h, _ = q.shape
    scores, _ = _scores(q, k, causal, window, softmax_scale, kv_len)
    return torch.logsumexp(scores, dim=-1).reshape(b, h, s)


def attention_backward_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    dout: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softmax_scale: Optional[float] = None,
    kv_len: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """dq, dk, dv in q's dtype, with the backward kernel's formulas in
    float32: P = exp(scores - lse) where the mask allows, delta = rowsum(dO
    * O), dS = P (dO V^T - delta), dV = P^T dO, dK = scale dS^T Q, dQ =
    scale dS K; dK and dV sum over each GQA group's q heads.  out and dout
    are (B, S, H, Dv)."""
    b, s, h, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    r = h // kv
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)
    scores, mask = _scores(q, k, causal, window, softmax_scale, kv_len)
    lse_g = lse.float().reshape(b, kv, r, s, 1)
    probs = torch.where(mask, torch.exp(scores - torch.where(mask, lse_g, 0.0)), 0.0)
    do_g = dout.float().reshape(b, s, kv, r, dout.shape[-1])
    delta = (dout.float() * out.float()).sum(-1).reshape(b, s, kv, r).permute(0, 2, 3, 1)
    dp = torch.einsum("bskrd,btkd->bkrst", do_g, v.float())
    ds = probs * (dp - delta[..., None])
    dv = torch.einsum("bkrst,bskrd->btkd", probs, do_g)
    dk = torch.einsum("bkrst,bskrd->btkd", ds, q.float().reshape(b, s, kv, r, d)) * scale
    dq = torch.einsum("bkrst,btkd->bskrd", ds, k.float()) * scale
    # Contiguous, as the backward kernel writes them.
    return tuple(x.to(q.dtype).contiguous() for x in (dq.reshape(b, s, h, d), dk, dv))
