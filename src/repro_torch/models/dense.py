"""Dense decoder-only transformer family (PyTorch).

The counterpart of ``repro/models/dense.py`` for the archs ported so far:
  * olmo-1b    — MHA, SwiGLU, *non-parametric* LayerNorm
  * llama3-8b  — GQA, SwiGLU, RMSNorm, rope theta 5e5

Weights keep the reference's per-layer layouts (``wq (d, h, dh)``,
``wo (h, dh, d)``, ``w_gate (d, ff)``, ...) and the state_dict names follow
its parameter tree, with the stacked layer dim unrolled into
``layers.<i>``: :mod:`repro_torch.bridge` maps one onto the other.

Full-sequence attention (``forward``/``prefill``/``train_forward``) goes
through the Hopper flash-attention kernel on CUDA tensors and through its
plain version on CPU tensors; single-token decode attention is plain torch,
as it is plain jnp in the reference.  ``prefill`` and ``decode_step`` write
K/V into the preallocated cache in place and return the same cache dict.

``train_forward`` is the one forward that carries gradients (the loss's);
the others run under ``no_grad``.  With ``cfg.remat`` (the reference's
switch, default True) each layer is recomputed in the backward pass
(``torch.utils.checkpoint``), flash forward included.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import common
from repro_torch.models.common import Param

__all__ = [
    "DenseConfig",
    "DenseModel",
    "layer_schema",
    "schema",
    "MODEL",
    "cache_length",
    "init_cache",
]


@dataclasses.dataclass(frozen=True)
class DenseConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 128
    rope_theta: float = 10000.0
    norm: str = "rmsnorm"            # rmsnorm | nonparam_ln
    act: str = "swiglu"              # swiglu | relu2 | gelu
    qk_norm: bool = False
    window: Optional[int] = None     # sliding-window attention (all layers)
    decode_window: Optional[int] = None  # ring-cache size for long-ctx decode
    max_full_cache: int = 32768      # use a full cache up to this seq length
    tie_embeddings: bool = False
    param_dtype: torch.dtype = torch.bfloat16
    compute_dtype: torch.dtype = torch.bfloat16
    remat: bool = True               # recompute each layer in the backward pass

    @property
    def family(self) -> str:
        return "dense"


# ---------------------------------------------------------------------------
# Schema
# ---------------------------------------------------------------------------


def layer_schema(cfg: DenseConfig) -> Dict[str, object]:
    d, h, kv, dh, ff = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff
    s: Dict[str, object] = {
        "attn": {
            "wq": Param((d, h, dh), ("embed", "heads", None)),
            "wk": Param((d, kv, dh), ("embed", "kv_heads", None)),
            "wv": Param((d, kv, dh), ("embed", "kv_heads", None)),
            "wo": Param((h, dh, d), ("heads", None, "embed")),
        },
    }
    if cfg.qk_norm:
        s["attn"]["q_norm"] = Param((dh,), (None,), init="ones")
        s["attn"]["k_norm"] = Param((dh,), (None,), init="ones")
    if cfg.act == "swiglu":
        s["mlp"] = {
            "w_gate": Param((d, ff), ("embed", "ff")),
            "w_up": Param((d, ff), ("embed", "ff")),
            "w_down": Param((ff, d), ("ff", "embed")),
        }
    else:
        s["mlp"] = {"w_in": Param((d, ff), ("embed", "ff")),
                    "w_down": Param((ff, d), ("ff", "embed"))}
    if cfg.norm == "rmsnorm":
        s["attn_norm"] = Param((d,), (None,), init="ones")
        s["mlp_norm"] = Param((d,), (None,), init="ones")
    return s


def schema(cfg: DenseConfig) -> Dict[str, object]:
    """The reference's parameter tree, layers stacked on a leading dim."""
    s: Dict[str, object] = {
        "embed": Param((cfg.vocab, cfg.d_model), ("vocab", None), init="embed"),
        "layers": common.stacked(layer_schema(cfg), cfg.n_layers),
    }
    if cfg.norm == "rmsnorm":
        s["final_norm"] = Param((cfg.d_model,), (None,), init="ones")
    if not cfg.tie_embeddings:
        s["lm_head"] = Param((cfg.d_model, cfg.vocab), ("embed", "vocab"))
    return s


def _param(p: Param, cfg: DenseConfig, device, generator) -> nn.Parameter:
    return common.new_parameter(p, cfg.param_dtype, device, generator)


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------


class DenseLayer(nn.Module):
    """One layer: ``attn`` / ``mlp`` parameter dicts plus optional norms."""

    def __init__(self, cfg: DenseConfig, *, device, generator=None):
        super().__init__()
        s = layer_schema(cfg)
        for group in ("attn", "mlp"):
            setattr(self, group, nn.ParameterDict({
                name: _param(s[group][name], cfg, device, generator)
                for name in sorted(s[group])
            }))
        for name in ("attn_norm", "mlp_norm"):
            p = s.get(name)
            self.register_parameter(
                name, None if p is None else _param(p, cfg, device, generator)
            )


class DenseModel(nn.Module):
    """The dense decoder; ``forward(tokens)`` returns float32 logits."""

    def __init__(self, cfg: DenseConfig, *, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        s = schema(cfg)
        self.cfg = cfg
        self.embed = _param(s["embed"], cfg, device, generator)
        self.layers = nn.ModuleList(
            DenseLayer(cfg, device=device, generator=generator)
            for _ in range(cfg.n_layers)
        )
        for name in ("final_norm", "lm_head"):
            p = s.get(name)
            self.register_parameter(
                name, None if p is None else _param(p, cfg, device, generator)
            )

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def _embed(self, tokens) -> torch.Tensor:
        tokens = torch.as_tensor(tokens, dtype=torch.long, device=self.device)
        x = common.embedding(self.embed, tokens).to(self.cfg.compute_dtype)
        return common.constrain(x, ("batch", None, None))

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        x = common.block_input(_norm(x, self.final_norm, self.cfg))
        head = self.embed.T if self.cfg.tie_embeddings else self.lm_head
        return (x @ head.to(self.cfg.compute_dtype)).float()

    @torch.no_grad()
    def forward(self, tokens) -> torch.Tensor:
        """tokens (B, S) int -> logits (B, S, vocab) float32."""
        x = self._embed(tokens)
        positions = torch.arange(x.shape[1], device=self.device)
        attend = functools.partial(flash_attention, causal=True, window=self.cfg.window)
        for layer in self.layers:
            x = _layer(layer, x, positions, self.cfg, attend)
        return self._logits(x)

    def train_forward(self, tokens, *, attend: Optional[Attend] = None) -> torch.Tensor:
        """tokens (B, S) int -> logits (B, S, vocab) float32, carrying
        gradients to the parameters that require them.  ``attend`` replaces
        the flash-attention call (a seam for holding the kernel against a
        plain attention); with ``cfg.remat`` every layer is recomputed in
        the backward pass, as the reference's ``jax.checkpoint`` does."""
        x = self._embed(tokens)
        positions = torch.arange(x.shape[1], device=self.device)
        if attend is None:
            attend = functools.partial(flash_attention, causal=True, window=self.cfg.window)
        for layer in self.layers:
            if self.cfg.remat:
                x = checkpoint(_layer, layer, x, positions, self.cfg, attend, use_reentrant=False)
            else:
                x = _layer(layer, x, positions, self.cfg, attend)
        return self._logits(x)

    @torch.no_grad()
    def prefill(self, cache: Dict[str, object], tokens) -> Tuple[torch.Tensor, Dict[str, object]]:
        """Fused full-sequence prefill: one forward pass over tokens (B, S)
        that also writes the KV cache at positions [0, S), in place.

        Returns ``(logits (B, S, vocab), cache)`` with ``cache["pos"] = S``
        so ``decode_step`` continues at position S.  Requires an empty full
        cache of length >= S; ring caches must use the stepped loop (their
        physical layout depends on the write order).  Matches the stepped
        decode loop to float tolerance, not bit-exactly.
        """
        x = self._embed(tokens)
        b, s = x.shape[:2]
        length = cache["k"].shape[2]
        cfg = self.cfg
        if cfg.decode_window is not None and length == cfg.decode_window and length < s:
            raise ValueError(
                "fused prefill needs a full-length cache; ring caches "
                f"(length {length} < prompt {s}) must use the stepped decode loop"
            )
        if length < s:
            raise ValueError(f"cache length {length} shorter than prompt {s}")
        if cache["k"].shape[1] != b:
            raise ValueError(f"cache batch {cache['k'].shape[1]} != token batch {b}")
        positions = torch.arange(s, device=self.device)
        full = functools.partial(flash_attention, causal=True, window=cfg.window)
        for i, layer in enumerate(self.layers):
            k_cache, v_cache = cache["k"][i], cache["v"][i]

            def attend(q, k, v, k_cache=k_cache, v_cache=v_cache):
                # K/V enter the cache post-RoPE, exactly as decode_step writes them.
                k_cache[:, :s] = k
                v_cache[:, :s] = v
                return full(q, k, v)

            x = _layer(layer, x, positions, cfg, attend)
        cache["pos"] = s
        return self._logits(x), cache

    @torch.no_grad()
    def decode_step(
        self, cache: Dict[str, object], tokens, pos: int
    ) -> Tuple[torch.Tensor, Dict[str, object]]:
        """One-token decode. tokens (B, 1); ``pos`` a host int (current index).

        With a ring cache (decode_window set and smaller than the logical
        context), the physical insert index is pos mod window and the window
        constraint is enforced by the cache size itself.
        """
        pos = int(pos)
        cfg = self.cfg
        length = cache["k"].shape[2]
        ring = cfg.decode_window is not None and length == cfg.decode_window
        x = self._embed(tokens)
        positions = torch.full((1,), pos, device=self.device)
        for i, layer in enumerate(self.layers):
            k_cache, v_cache = cache["k"][i], cache["v"][i]

            def attend(q, k, v, k_cache=k_cache, v_cache=v_cache):
                common.cache_update(k_cache, v_cache, k, v, pos, ring=ring)
                # Ring caches enforce the window by construction; full caches
                # attend to the whole context (cfg.window, if any, still applies).
                return common.decode_attention(
                    q, k_cache, v_cache, pos=pos, window=None if ring else cfg.window
                )

            x = _layer(layer, x, positions, cfg, attend)
        cache["pos"] = pos + 1
        return self._logits(x), cache


MODEL = DenseModel


# ---------------------------------------------------------------------------
# Layer math
# ---------------------------------------------------------------------------


def _norm(x: torch.Tensor, weight: Optional[torch.Tensor], cfg: DenseConfig) -> torch.Tensor:
    if cfg.norm == "rmsnorm":
        return common.rms_norm(x, weight)
    return common.layer_norm(x)  # non-parametric (OLMo)


def _mlp(lp: DenseLayer, x: torch.Tensor, cfg: DenseConfig) -> torch.Tensor:
    if cfg.act == "swiglu":
        hidden = common.swiglu(x @ lp.mlp["w_gate"], x @ lp.mlp["w_up"])
    else:
        hidden = common.ACTIVATIONS[cfg.act](x @ lp.mlp["w_in"])
    return hidden @ lp.mlp["w_down"]


def _heads(x: torch.Tensor, w: torch.Tensor, axis: str = "heads") -> torch.Tensor:
    """x (B, S, d) x w (d, h, dh) -> (B, S, h, dh)."""
    return common.heads(x, w, axis)


def _qkv(lp: DenseLayer, x: torch.Tensor, positions: torch.Tensor, cfg: DenseConfig):
    q = _heads(x, lp.attn["wq"])
    k = _heads(x, lp.attn["wk"], "kv_heads")
    v = _heads(x, lp.attn["wv"], "kv_heads")
    if cfg.qk_norm:
        q = common.rms_norm(q, lp.attn["q_norm"])
        k = common.rms_norm(k, lp.attn["k_norm"])
    q = common.apply_rope(q, positions, cfg.rope_theta)
    k = common.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


Attend = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


def _layer(
    lp: DenseLayer, x: torch.Tensor, positions: torch.Tensor, cfg: DenseConfig, attend: Attend
) -> torch.Tensor:
    h = common.block_input(_norm(x, lp.attn_norm, cfg))
    q, k, v = _qkv(lp, h, positions, cfg)
    attn = attend(q, k, v)
    wo = lp.attn["wo"]
    # Under a sharding context the two projections' partial sums are
    # reduced into the replicated residual stream (a no-op otherwise).
    x = x + common.constrain(attn.reshape(*attn.shape[:2], -1) @ wo.reshape(-1, wo.shape[-1]),
                             ("batch", None, None))
    h = common.block_input(_norm(x, lp.mlp_norm, cfg))
    return x + common.constrain(_mlp(lp, h, cfg), ("batch", None, None))


# ---------------------------------------------------------------------------
# Decode caches
# ---------------------------------------------------------------------------


def cache_length(cfg: DenseConfig, seq_len: int) -> int:
    """Full cache while it is affordable; ring (sliding-window) cache beyond
    ``max_full_cache`` when the config declares a decode window."""
    if cfg.decode_window is not None and seq_len > cfg.max_full_cache:
        return min(cfg.decode_window, seq_len)
    return seq_len


def init_cache(cfg: DenseConfig, batch: int, seq_len: int, dtype=None, *, device):
    # The cache holds the K/V the decode step produces: the compute dtype.
    if dtype is None:
        dtype = cfg.compute_dtype
    return common.make_kv_cache(
        cfg.n_layers, batch, cache_length(cfg, seq_len), cfg.n_kv_heads, cfg.head_dim,
        dtype, device,
    )
