"""Shared building blocks of the ported model families (PyTorch).

The counterpart of ``repro/models/common.py``, for the functions the dense
and rwkv6 models run with.  Tensor layouts at every function are the
reference's: activations ``(B, S, d)``, heads ``(B, S, H, D)``, caches
stacked over layers ``(L, B, T, KV, D)``.  Norm and softmax statistics run
in float32 and results return in the input dtype, as in the reference.

Full-sequence attention is not here: the port runs it through the Hopper
flash-attention kernel (:mod:`repro_torch.kernels.flash_attention`), whose
plain version serves CPU tensors.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import resolve_device

__all__ = [
    "Param",
    "init_param",
    "new_parameter",
    "stacked",
    "rms_norm",
    "layer_norm",
    "rope_freqs",
    "apply_rope",
    "decode_attention",
    "swiglu",
    "relu2",
    "ACTIVATIONS",
    "make_kv_cache",
    "cache_update",
    "weighted_cross_entropy",
]

# ---------------------------------------------------------------------------
# Parameter schema
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Param:
    """Declares one parameter: shape and initializer.  The reference's
    logical sharding axes wait for the sharded slice."""

    shape: Tuple[int, ...]
    init: str = "normal"          # normal | zeros | ones | embed
    scale: Optional[float] = None  # overrides fan-in scaling


def init_param(
    p: Param, dtype: torch.dtype, generator: torch.Generator, device: torch.device
) -> torch.Tensor:
    """One seeded leaf, with the reference's init laws (``common.py:52``).
    Draws in float32 on ``generator``'s device and casts, as the
    reference casts after ``jax.random.normal``.  Each model draws
    every leaf of its schema from one generator, the counterpart of the
    reference's ``init_from_schema``."""
    if p.init == "zeros":
        return torch.zeros(p.shape, dtype=dtype, device=device)
    if p.init == "ones":
        return torch.ones(p.shape, dtype=dtype, device=device)
    if p.init == "embed":
        scale = p.scale if p.scale is not None else 0.02
    elif p.init == "normal":
        fan_in = math.prod(p.shape[:-1]) if len(p.shape) > 1 else p.shape[0]
        scale = p.scale if p.scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
    else:
        raise ValueError(f"unknown init {p.init!r}")
    x = torch.randn(p.shape, generator=generator, device=device, dtype=torch.float32)
    return (x * scale).to(dtype)


def new_parameter(
    p: Param, dtype: torch.dtype, device: torch.device, generator: Optional[torch.Generator]
) -> nn.Parameter:
    """A frozen parameter seeded from ``generator``, or left empty for a
    state_dict to fill when ``generator`` is None."""
    if generator is None:
        t = torch.empty(p.shape, dtype=dtype, device=device)
    else:
        t = init_param(p, dtype, generator, device)
    return nn.Parameter(t, requires_grad=False)


def stacked(schema, n_layers: int):
    """Prepend a stacked-layer dim to every Param in a schema (the
    reference's layout, which the bridge reads)."""
    if isinstance(schema, Param):
        return Param((n_layers,) + schema.shape, schema.init, schema.scale)
    return {key: stacked(sub, n_layers) for key, sub in schema.items()}


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, weight: Optional[torch.Tensor], eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    if weight is not None:
        out = out * weight.float()
    return out.to(x.dtype)


def layer_norm(
    x: torch.Tensor,
    weight: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    eps: float = 1e-5,
) -> torch.Tensor:
    """LayerNorm; with weight=bias=None this is OLMo's non-parametric LN."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    out = (xf - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        out = out * weight.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies, shape (head_dim//2,)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """Rotate interleaved pairs: x (..., S, H, D), positions (S,)."""
    d = x.shape[-1]
    inv = rope_freqs(d, theta, device=x.device)
    angles = positions.to(torch.float32)[..., None] * inv  # (S, D/2)
    cos = torch.cos(angles)[..., None, :]  # (S, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    x1 = x[..., 0::2].float()
    x2 = x[..., 1::2].float()
    out1 = x1 * cos - x2 * sin
    out2 = x2 * cos + x1 * sin
    return torch.stack([out1, out2], dim=-1).reshape(x.shape).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    *,
    pos: int,
    window: Optional[int] = None,
    softmax_scale: Optional[float] = None,
) -> torch.Tensor:
    """Single-token attention against a KV cache, in plain torch.

    q: (B, 1, H, D); caches: (B, T, KV, D); cache entries at indices
    <= ``pos`` (a host int) are valid, and ``window`` masks entries at or
    before ``pos - window``.  Entries past ``pos`` are masked to an exact
    zero weight in the reference, so they are not read here.
    """
    b, _, h, d = q.shape
    t, kv = k_cache.shape[1], k_cache.shape[2]
    r = h // kv
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)
    t_valid = min(int(pos) + 1, t)
    k = k_cache[:, :t_valid].permute(0, 2, 3, 1)  # (B, KV, D, T)
    v = v_cache[:, :t_valid].permute(0, 2, 1, 3)  # (B, KV, T, D)
    qg = (q * scale).reshape(b, kv, r, d)
    scores = torch.matmul(qg.float(), k.float())  # (B, KV, R, T)
    if window is not None:
        kv_pos = torch.arange(t_valid, device=q.device)
        scores = scores.masked_fill((kv_pos <= int(pos) - window), float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.matmul(probs.to(v.dtype), v)  # (B, KV, R, D)
    return out.reshape(b, 1, h, d).to(q.dtype)


# ---------------------------------------------------------------------------
# Feed-forward activations
# ---------------------------------------------------------------------------


def swiglu(x_gate: torch.Tensor, x_up: torch.Tensor) -> torch.Tensor:
    return F.silu(x_gate) * x_up


def relu2(x: torch.Tensor) -> torch.Tensor:
    """Squared ReLU (Minitron/Nemotron)."""
    y = F.relu(x)
    return y * y


ACTIVATIONS: Dict[str, Callable] = {
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu2": relu2,
    "silu": F.silu,
}


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def weighted_cross_entropy(
    logits: torch.Tensor, labels: torch.Tensor, weights: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token-level CE.  ``weights`` (same shape as labels) realizes Eq. (9)
    weighted gradient aggregation: pass per-sample weights broadcast over the
    sequence dim; pads get 0.  Returns (scalar weighted-SUM loss, total
    weight) — divide outside if a mean is wanted.
    """
    logits_f = logits.float()
    logz = torch.logsumexp(logits_f, dim=-1)
    gold = torch.gather(logits_f, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if weights is None:
        weights = torch.ones_like(nll)
    return (nll * weights).sum(), weights.sum()


# ---------------------------------------------------------------------------
# KV caches
# ---------------------------------------------------------------------------


def make_kv_cache(
    n_layers: int,
    batch: int,
    length: int,
    kv_heads: int,
    head_dim: int,
    dtype: torch.dtype = torch.bfloat16,
    device: Optional[Union[str, torch.device]] = None,
) -> Dict[str, object]:
    """Stacked-over-layers KV cache + host-int position, on ``device``
    (default the first CUDA card; ``"cpu"`` must be asked for)."""
    device = resolve_device(device)
    shape = (n_layers, batch, length, kv_heads, head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": 0,
    }


def cache_update(
    cache_layer_k: torch.Tensor,
    cache_layer_v: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    pos: int,
    *,
    ring: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write one token's K/V (B, 1, KV, D) at ``pos`` (mod length if ring)
    into the layer caches (B, T, KV, D), in place, and return them."""
    length = cache_layer_k.shape[1]
    idx = int(pos) % length if ring else int(pos)
    if not 0 <= idx < length:
        raise IndexError(f"cache position {idx} outside cache length {length}")
    cache_layer_k[:, idx : idx + 1] = k_new
    cache_layer_v[:, idx : idx + 1] = v_new
    return cache_layer_k, cache_layer_v
