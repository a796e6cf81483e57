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
import functools
import math
from typing import Callable, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import resolve_device
from repro_torch.sharding.context import constrain, is_dtensor, rank_block

__all__ = [
    "Param",
    "init_param",
    "new_parameter",
    "stacked",
    "init_from_schema",
    "specs_from_schema",
    "heads",
    "block_input",
    "rms_norm",
    "layer_norm",
    "rope_freqs",
    "apply_rope",
    "decode_attention",
    "swiglu",
    "relu2",
    "ACTIVATIONS",
    "constrain",
    "make_kv_cache",
    "cache_update",
    "write_slot",
    "weighted_cross_entropy",
    "embedding",
]

# ---------------------------------------------------------------------------
# Parameter schema
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Param:
    """Declares one parameter: shape, logical sharding axes, initializer."""

    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"          # normal | zeros | ones | embed
    scale: Optional[float] = None  # overrides fan-in scaling

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape/axes rank mismatch: {self.shape} vs {self.axes}")


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
    """Prepend a stacked-layer dim (replicated) to every Param in a schema
    (the reference's layout, which the bridge reads)."""
    if isinstance(schema, Param):
        return Param((n_layers,) + schema.shape, (None,) + schema.axes, schema.init,
                     schema.scale)
    return {key: stacked(sub, n_layers) for key, sub in schema.items()}


def init_from_schema(schema, dtype: torch.dtype, *, device=None):
    """The schema's tree with an uninitialised tensor per Param leaf, made
    under whatever mode is active: under ``FakeTensorMode`` or on the meta
    device, shapes and dtypes without storage (the dry run's parameters).
    Seeded weights come from each model's ``generator`` instead."""
    if isinstance(schema, Param):
        return torch.empty(schema.shape, dtype=dtype, device=device)
    return {key: init_from_schema(sub, dtype, device=device) for key, sub in schema.items()}


def specs_from_schema(schema, rules, path: str = ""):
    """The spec tree matching the schema: each Param's logical axes
    resolved by ``rules`` (:class:`repro_torch.sharding.rules.MeshRules`)
    at its shape, with the reference's ``a/b/c`` paths in the fallback
    records, made in the reference's order (keys sorted, as a pytree's)."""
    if isinstance(schema, Param):
        return rules.spec(schema.axes, schema.shape, path=path)
    return {key: specs_from_schema(schema[key], rules, f"{path}/{key}" if path else str(key))
            for key in sorted(schema)}


def block_input(x: torch.Tensor) -> torch.Tensor:
    """Under a sharding context, ``x`` (B, ..., d) pinned whole on the
    ranks that split a block's heads or hidden dim (batch split only), so
    that its gradient, a partial sum on each of them, is reduced once
    there; ``x`` itself otherwise."""
    return constrain(x, ("batch",) + (None,) * (x.ndim - 1))


def heads(x: torch.Tensor, w: torch.Tensor, axis: str = "heads") -> torch.Tensor:
    """x (B, S, din) x w (din, h, dh) -> (B, S, h, dh).  Under a sharding
    context the product's (h x dh) dim is pinned to the layout ``axis``
    gives h heads, so that it splits by whole heads."""
    d, h, dh = w.shape
    y = x @ w.reshape(d, h * dh)
    y = constrain(y, ("batch",) + (None,) * (y.ndim - 2) + (axis,),
                  sizes=tuple(y.shape[:-1]) + (h,))
    return y.view(*x.shape[:-1], h, dh)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def _rowwise(fn: Callable, x: torch.Tensor, *params) -> torch.Tensor:
    """``fn(x, *params)``, a function of each row of ``x`` over its last
    dim, on DTensors: each rank's rows, the last dim whole there, the
    parameters whole (their gradients partial sums over the ranks that
    split the rows).  Left to DTensor, a norm's backward may split the
    sequence to reduce a partial sum, a layout later reshapes cannot
    follow."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    last = x.ndim - 1
    rows = tuple(Replicate() if p.is_shard(last) or p.is_partial() else p for p in x.placements)
    whole = tuple(Replicate() for _ in rows)
    summed = tuple(Partial() if p.is_shard() else Replicate() for p in rows)
    return local_map(fn, out_placements=list(rows),
                     in_placements=(rows,) + tuple(None if p is None else whole for p in params),
                     in_grad_placements=(rows,) + tuple(None if p is None else summed
                                                        for p in params),
                     device_mesh=x.device_mesh, redistribute_inputs=True)(x, *params)


def rms_norm(x: torch.Tensor, weight: Optional[torch.Tensor], eps: float = 1e-6) -> torch.Tensor:
    if is_dtensor(x):
        return _rowwise(functools.partial(rms_norm, eps=eps), x, weight)
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
    if is_dtensor(x):
        return _rowwise(functools.partial(layer_norm, eps=eps), x, weight, bias)
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
    k_cache = constrain(k_cache, ("batch", "cache_seq", "kv_heads", None))
    v_cache = constrain(v_cache, ("batch", "cache_seq", "kv_heads", None))
    if is_dtensor(q):
        return _split_decode_attention(q, k_cache, v_cache, pos, window, softmax_scale)
    r = h // kv
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)
    t_valid = min(int(pos) + 1, t)
    if t_valid < t:  # a full cache is read whole, unsliced
        k_cache, v_cache = k_cache[:, :t_valid], v_cache[:, :t_valid]
    k = k_cache.permute(0, 2, 3, 1)  # (B, KV, D, T)
    v = v_cache.permute(0, 2, 1, 3)  # (B, KV, T, D)
    qg = (q * scale).reshape(b, kv, r, d)
    scores = torch.matmul(qg.float(), k.float())  # (B, KV, R, T)
    if window is not None:
        kv_pos = torch.arange(t_valid, device=q.device)
        scores = scores.masked_fill((kv_pos <= int(pos) - window), float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.matmul(probs.to(v.dtype), v)  # (B, KV, R, D)
    return out.reshape(b, 1, h, d).to(q.dtype)


def _split_softmax_mix(scores: torch.Tensor, mix: Callable, out_axes) -> torch.Tensor:
    """``mix(softmax(scores))`` for DTensor scores whose last (key) dim may
    be split over ranks (a decode step against a cache split along its
    sequence): the row max and the sum of exponentials are reduced and
    pinned whole on every rank, ``mix`` of the unnormalised weights is
    reduced and pinned to ``out_axes``, then divided by the sum.  The
    flash-decode split of one softmax."""
    lead = ("batch",) + (None,) * (scores.ndim - 2)
    m = constrain(scores.detach().amax(dim=-1), lead)
    p = torch.exp(scores - m[..., None])
    total = constrain(p.sum(dim=-1), lead)
    return constrain(mix(p), out_axes) / total[..., None]


def _split_decode_attention(q, k_cache, v_cache, pos, window, softmax_scale):
    """:func:`decode_attention` on DTensors: the one query whole on every
    rank, the cache split as it lies (batch, cache sequence), the softmax
    by :func:`_split_softmax_mix`.  A full cache is read whole."""
    b, _, h, d = q.shape
    t, kv = k_cache.shape[1], k_cache.shape[2]
    q = constrain(q, ("batch", None, None, None))
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)
    t_valid = min(int(pos) + 1, t)
    if t_valid < t:
        k_cache, v_cache = k_cache[:, :t_valid], v_cache[:, :t_valid]
    qg = (q * scale).reshape(b, kv, h // kv, d)
    scores = torch.matmul(qg.float(), k_cache.permute(0, 2, 3, 1).float())  # (B, KV, R, T)
    if window is not None:
        kv_pos = torch.arange(t_valid, device=q.device)
        scores = scores.masked_fill((kv_pos <= int(pos) - window), float("-inf"))
    v = v_cache.permute(0, 2, 1, 3)  # (B, KV, T, D)
    out = _split_softmax_mix(scores, lambda p: torch.matmul(p.to(v.dtype), v),
                            ("batch", None, None, None))
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


def embedding(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``: each token's row of the (V, d) table.  A DTensor
    table is read on each rank, from its tokens: where the vocab dim is
    split over mesh dims, each rank looks tokens up in its slice of the
    rows (tokens outside it give 0) and the ranks' parts are summed, as a
    vocab-parallel embedding does, rather than gathering the table whole;
    the table's gradient is a partial sum over the ranks that split the
    tokens."""
    if not is_dtensor(table):
        return table[tokens]
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = table.device_mesh
    splits = [i for i, p in enumerate(table.placements) if p.is_shard(0)]
    tokens_pl = tuple(tokens.placements) if is_dtensor(tokens) else (Replicate(),) * mesh.ndim
    if any(tokens_pl[i].is_shard() for i in splits):
        raise ValueError("tokens may not be split over the table's vocab mesh dims")
    table_pl = tuple(Shard(0) if i in splits else Replicate() for i in range(mesh.ndim))
    table_grad = tuple(Shard(0) if i in splits else Partial() if p.is_shard() else Replicate()
                       for i, p in enumerate(tokens_pl))
    rows_pl = [Partial() if i in splits else p for i, p in enumerate(tokens_pl)]

    def local(tab, tok):
        if not splits:
            return tab[tok]
        v_local = tab.shape[0]
        idx = tok - rank_block(mesh, splits) * v_local
        inside = (idx >= 0) & (idx < v_local)
        rows = tab[idx.clamp(0, v_local - 1)]
        return torch.where(inside[..., None], rows, torch.zeros_like(rows))

    return local_map(local, out_placements=rows_pl, in_placements=(table_pl, tokens_pl),
                     in_grad_placements=(table_grad, tokens_pl), device_mesh=mesh,
                     redistribute_inputs=True)(table, tokens)


def _logsumexp(logits: torch.Tensor) -> torch.Tensor:
    """logsumexp over the last dim.  For a DTensor, formed from its parts
    (the row max, then the sum of exponentials), each reduced over a split
    vocab dim and pinned to the tokens' layout."""
    last = logits.ndim - 1
    if not is_dtensor(logits) or not any(p.is_shard(last) for p in logits.placements):
        return torch.logsumexp(logits, dim=-1)
    tokens = ("batch",) + (None,) * (logits.ndim - 2)
    m = constrain(logits.detach().amax(dim=-1), tokens)
    return m + torch.log(constrain(torch.exp(logits - m[..., None]).sum(dim=-1), tokens))


def _gold(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Each token's logit at its label.  A DTensor whose vocab dim is split
    over mesh dims gathers on each rank's slice of the vocab (labels
    outside it give 0) and sums the ranks' parts, as a vocab-parallel loss
    does, rather than gathering the logits whole."""
    vdim = logits.ndim - 1
    if not is_dtensor(logits) or not any(p.is_shard(vdim) for p in logits.placements):
        return torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh = logits.device_mesh
    splits = [i for i, p in enumerate(logits.placements) if p.is_shard(vdim)]
    label_pl = [Replicate() if p.is_shard(vdim) else p for p in logits.placements]
    gold_pl = [Partial() if p.is_shard(vdim) else p for p in logits.placements]

    def local(lg, lb):
        v_local = lg.shape[-1]
        idx = lb.long() - rank_block(mesh, splits) * v_local
        inside = (idx >= 0) & (idx < v_local)
        g = torch.gather(lg, -1, idx.clamp(0, v_local - 1)[..., None])[..., 0]
        return torch.where(inside, g, torch.zeros_like(g))

    gold = local_map(local, out_placements=gold_pl, in_placements=(logits.placements, label_pl),
                     device_mesh=mesh, redistribute_inputs=True)(logits, labels)
    return constrain(gold, ("batch",) + (None,) * (labels.ndim - 1))


def weighted_cross_entropy(
    logits: torch.Tensor, labels: torch.Tensor, weights: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token-level CE.  ``weights`` (same shape as labels) realizes Eq. (9)
    weighted gradient aggregation: pass per-sample weights broadcast over the
    sequence dim; pads get 0.  Returns (scalar weighted-SUM loss, total
    weight) — divide outside if a mean is wanted.
    """
    logits_f = constrain(logits.float(), ("batch",) + (None,) * (logits.ndim - 2) + ("vocab",))
    logz = _logsumexp(logits_f)
    gold = _gold(logits_f, labels)
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
    write_slot(cache_layer_k, k_new, idx)
    write_slot(cache_layer_v, v_new, idx)
    return cache_layer_k, cache_layer_v


def write_slot(cache: torch.Tensor, new: torch.Tensor, idx: int) -> None:
    """``cache[:, idx:idx + 1] = new``, in place.  A DTensor cache split
    along its sequence dim (dim 1) is written on the ranks whose slice
    holds ``idx``, from ``new`` laid out as the cache's other dims are."""
    if not is_dtensor(cache):
        cache[:, idx:idx + 1] = new
        return
    from torch.distributed.tensor import Replicate

    mesh = cache.device_mesh
    new = new.redistribute(mesh, [Replicate() if p.is_shard(1) else p
                                  for p in cache.placements]).to_local()
    local = cache.to_local()
    lo = rank_block(mesh, [i for i, p in enumerate(cache.placements) if p.is_shard(1)])
    lo *= local.shape[1]
    if lo <= idx < lo + local.shape[1]:
        local[:, idx - lo:idx - lo + 1] = new
