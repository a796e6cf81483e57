"""Whisper-large-v3 backbone (arXiv:2212.04356), PyTorch — encoder-decoder.

The counterpart of ``repro/models/whisper.py``.  The modality frontend
(log-mel spectrogram and the two conv layers) is a stub, as in the
reference: the batch supplies post-conv frame embeddings ``audio_embed``
(B, S_enc, d_model).  A bidirectional encoder over the frames, then a
causal decoder over text tokens with cross-attention to the encoder
output; sinusoidal positions on both sides, LayerNorm with weight and
bias, GELU (tanh form, as ``jax.nn.gelu``'s default) MLPs, no attention
biases, and a head tied to the token embedding.

Weights keep the reference's layouts and leaf names; the state_dict
unrolls its two stacked layer dims into ``enc_layers.<i>.*`` and
``dec_layers.<i>.*``.

The three full-sequence attentions run through the Hopper flash kernel on
CUDA tensors and through its plain version on CPU tensors: encoder
self-attention and cross-attention non-causal (cross: S_text queries
against S_enc keys), decoder self-attention causal.  ``train_forward``
carries gradients (the kernel's backward on the card) and takes a seam for
each of the three, with each layer recomputed in the backward pass under
``cfg.remat`` as the reference's ``jax.checkpoint`` does.

Decode: ``prime_cache`` fills the cross-attention K/V once from the
encoder output, whole (their length is the encoder output's); each
``decode_step`` writes one token's self-attention K/V into the cache in
place and attends over every frame, in plain torch, as the reference's
jnp decode does.  There is no fused prefill: the decoder's prompt steps
the decode loop.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import common
from repro_torch.models.common import Param

__all__ = [
    "WhisperConfig",
    "WhisperModel",
    "MODEL",
    "enc_layer_schema",
    "dec_layer_schema",
    "schema",
    "init_cache",
]

# A full-sequence attention entry: (q, k, v) -> out, as flash_attention
# with its mask bound (or the plain ``attention_ref``).
Attend = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class WhisperConfig:
    name: str
    n_enc_layers: int
    n_dec_layers: int
    d_model: int
    n_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 64
    enc_frames: int = 1500        # encoder length used for decode shapes
    param_dtype: torch.dtype = torch.bfloat16
    compute_dtype: torch.dtype = torch.bfloat16
    remat: bool = True            # recompute each layer in the backward pass

    @property
    def family(self) -> str:
        return "audio"

    @property
    def n_kv_heads(self) -> int:
        return self.n_heads  # MHA


def _sinusoid(positions: torch.Tensor, d: int) -> torch.Tensor:
    """(S,) positions -> (S, d) float32: sines, then cosines."""
    half = d // 2
    exps = torch.arange(half, dtype=torch.float32, device=positions.device)
    freqs = torch.exp(-math.log(10000.0) * exps / max(half - 1, 1))
    ang = positions[:, None].to(torch.float32) * freqs[None]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# Schema
# ---------------------------------------------------------------------------


def _attn_schema(cfg: WhisperConfig) -> Dict[str, object]:
    d, h, dh = cfg.d_model, cfg.n_heads, cfg.head_dim
    return {
        "wq": Param((d, h, dh)),
        "wk": Param((d, h, dh)),
        "wv": Param((d, h, dh)),
        "wo": Param((h, dh, d)),
    }


def _mlp_schema(cfg: WhisperConfig) -> Dict[str, object]:
    return {"w_in": Param((cfg.d_model, cfg.d_ff)), "w_out": Param((cfg.d_ff, cfg.d_model))}


def _norm_schema(prefix: str, d: int) -> Dict[str, object]:
    return {f"{prefix}_w": Param((d,), init="ones"), f"{prefix}_b": Param((d,), init="zeros")}


def enc_layer_schema(cfg: WhisperConfig) -> Dict[str, object]:
    d = cfg.d_model
    return {"attn": _attn_schema(cfg), **_norm_schema("attn_norm", d),
            "mlp": _mlp_schema(cfg), **_norm_schema("mlp_norm", d)}


def dec_layer_schema(cfg: WhisperConfig) -> Dict[str, object]:
    d = cfg.d_model
    return {"self_attn": _attn_schema(cfg), **_norm_schema("self_norm", d),
            "cross_attn": _attn_schema(cfg), **_norm_schema("cross_norm", d),
            "mlp": _mlp_schema(cfg), **_norm_schema("mlp_norm", d)}


def schema(cfg: WhisperConfig) -> Dict[str, object]:
    """The reference's parameter tree, each side's layers stacked on a
    leading dim."""
    d = cfg.d_model
    return {
        "embed": Param((cfg.vocab, d), init="embed"),
        "enc_layers": common.stacked(enc_layer_schema(cfg), cfg.n_enc_layers),
        "dec_layers": common.stacked(dec_layer_schema(cfg), cfg.n_dec_layers),
        **_norm_schema("enc_norm", d),
        **_norm_schema("dec_norm", d),
    }


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------


class WhisperLayer(nn.Module):
    """One encoder or decoder layer from its schema: an ``nn.ParameterDict``
    per attention and the MLP, a parameter per norm weight and bias."""

    def __init__(self, layer_schema: Dict[str, object], cfg: WhisperConfig, *, device,
                 generator=None):
        super().__init__()
        for name in sorted(layer_schema):
            p = layer_schema[name]
            if isinstance(p, Param):
                self.register_parameter(
                    name, common.new_parameter(p, cfg.param_dtype, device, generator))
            else:
                setattr(self, name, nn.ParameterDict({
                    key: common.new_parameter(p[key], cfg.param_dtype, device, generator)
                    for key in sorted(p)
                }))


class WhisperModel(nn.Module):
    """The encoder-decoder; ``forward(audio_embed, tokens)`` returns float32
    decoder logits."""

    def __init__(self, cfg: WhisperConfig, *, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        s = schema(cfg)
        self.embed = common.new_parameter(s["embed"], cfg.param_dtype, device, generator)
        self.enc_layers = nn.ModuleList(
            WhisperLayer(enc_layer_schema(cfg), cfg, device=device, generator=generator)
            for _ in range(cfg.n_enc_layers))
        self.dec_layers = nn.ModuleList(
            WhisperLayer(dec_layer_schema(cfg), cfg, device=device, generator=generator)
            for _ in range(cfg.n_dec_layers))
        for name in ("enc_norm_w", "enc_norm_b", "dec_norm_w", "dec_norm_b"):
            self.register_parameter(
                name, common.new_parameter(s[name], cfg.param_dtype, device, generator))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def _positions(self, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        """x (already in the compute dtype) plus the float32 sinusoid cast
        to the compute dtype, in the reference's order."""
        return x + _sinusoid(positions, self.cfg.d_model)[None].to(self.cfg.compute_dtype)

    def _embed(self, tokens, positions: torch.Tensor) -> torch.Tensor:
        tokens = torch.as_tensor(tokens, dtype=torch.long, device=self.device)
        return self._positions(self.embed[tokens].to(self.cfg.compute_dtype), positions)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        x = common.layer_norm(x, self.dec_norm_w, self.dec_norm_b)
        return (x @ self.embed.to(self.cfg.compute_dtype).T).float()

    def _encode(self, audio_embed, attend: Attend, remat: bool) -> torch.Tensor:
        x = torch.as_tensor(audio_embed, device=self.device).to(self.cfg.compute_dtype)
        x = self._positions(x, torch.arange(x.shape[1], device=self.device))
        body = functools.partial(_enc_layer, attend=attend)
        for layer in self.enc_layers:
            x = checkpoint(body, layer, x, use_reentrant=False) if remat else body(layer, x)
        return common.layer_norm(x, self.enc_norm_w, self.enc_norm_b)

    def _decode(self, tokens, enc_out: torch.Tensor, self_attend: Attend,
                cross_attend: Attend, remat: bool) -> torch.Tensor:
        tokens = torch.as_tensor(tokens, dtype=torch.long, device=self.device)
        x = self._embed(tokens, torch.arange(tokens.shape[1], device=self.device))
        body = functools.partial(_train_dec_layer, self_attend=self_attend,
                                 cross_attend=cross_attend)
        for layer in self.dec_layers:
            x = (checkpoint(body, layer, x, enc_out, use_reentrant=False) if remat
                 else body(layer, x, enc_out))
        return self._logits(x)

    @torch.no_grad()
    def encode(self, audio_embed) -> torch.Tensor:
        """audio_embed (B, S_enc, d) -> encoder output (B, S_enc, d) in the
        compute dtype."""
        return self._encode(audio_embed, functools.partial(flash_attention, causal=False),
                            remat=False)

    @torch.no_grad()
    def forward(self, audio_embed, tokens) -> torch.Tensor:
        """(audio frames (B, S_enc, d), text tokens (B, S)) -> decoder logits
        (B, S, vocab) float32."""
        return self._decode(tokens, self.encode(audio_embed),
                            functools.partial(flash_attention, causal=True),
                            functools.partial(flash_attention, causal=False), remat=False)

    def train_forward(self, audio_embed, tokens, *, enc_attend: Attend = None,
                      self_attend: Attend = None, cross_attend: Attend = None) -> torch.Tensor:
        """(audio frames, text tokens) -> logits (B, S, vocab) float32,
        carrying gradients to the parameters that require them.
        ``enc_attend``, ``self_attend`` and ``cross_attend`` replace the
        encoder's (non-causal), the decoder's (causal) and the cross (non-causal,
        S_text against S_enc) flash-attention calls: seams for holding the
        kernel against a plain attention.  With ``cfg.remat`` every layer
        is recomputed in the backward pass."""
        remat = self.cfg.remat
        enc_out = self._encode(
            audio_embed, enc_attend or functools.partial(flash_attention, causal=False), remat)
        return self._decode(
            tokens, enc_out, self_attend or functools.partial(flash_attention, causal=True),
            cross_attend or functools.partial(flash_attention, causal=False), remat)

    @torch.no_grad()
    def prime_cache(self, cache: Dict[str, object], enc_out: torch.Tensor) -> Dict[str, object]:
        """Every decoder layer's cross-attention K/V from the encoder output
        (B, S_enc, d), replacing the cache's whole (their length is S_enc),
        in the cache's dtype; returns the same cache dict."""
        enc_out = torch.as_tensor(enc_out, device=self.device)
        kv = [_cross_kv(layer, enc_out) for layer in self.dec_layers]
        for i, key in enumerate(("cross_k", "cross_v")):
            cache[key] = torch.stack([pair[i] for pair in kv]).to(cache[key].dtype)
        return cache

    @torch.no_grad()
    def decode_step(
        self, cache: Dict[str, object], tokens, pos: int
    ) -> Tuple[torch.Tensor, Dict[str, object]]:
        """One-token decode: tokens (B, 1); ``pos`` a host int.  The self
        K/V enter the cache at ``pos``; cross-attention reads every frame
        of the primed cross K/V."""
        pos = int(pos)
        x = self._embed(tokens, torch.full((1,), pos, device=self.device))
        enc_last = cache["cross_k"].shape[2] - 1
        for i, layer in enumerate(self.dec_layers):
            k_cache, v_cache = cache["k"][i], cache["v"][i]

            def self_attend(q, k, v, k_cache=k_cache, v_cache=v_cache):
                common.cache_update(k_cache, v_cache, k, v, pos)
                return common.decode_attention(q, k_cache, v_cache, pos=pos)

            x = _dec_layer(layer, x, cache["cross_k"][i], cache["cross_v"][i], self_attend,
                           functools.partial(common.decode_attention, pos=enc_last))
        cache["pos"] = pos + 1
        return self._logits(x), cache


MODEL = WhisperModel


# ---------------------------------------------------------------------------
# Layer math
# ---------------------------------------------------------------------------


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, S, d) x w (d, h, dh) -> (B, S, h, dh)."""
    d, h, dh = w.shape
    return (x @ w.reshape(d, h * dh)).view(*x.shape[:-1], h, dh)


def _merge(attn: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """attn (B, S, h, dh) x wo (h, dh, d) -> (B, S, d)."""
    return attn.reshape(*attn.shape[:2], -1) @ wo.reshape(-1, wo.shape[-1])


def _mlp(mlp: nn.ParameterDict, x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x @ mlp["w_in"], approximate="tanh") @ mlp["w_out"]


def _enc_layer(lp: WhisperLayer, x: torch.Tensor, attend: Attend) -> torch.Tensor:
    h = common.layer_norm(x, lp.attn_norm_w, lp.attn_norm_b)
    attn = attend(_heads(h, lp.attn["wq"]), _heads(h, lp.attn["wk"]), _heads(h, lp.attn["wv"]))
    x = x + _merge(attn, lp.attn["wo"])
    h = common.layer_norm(x, lp.mlp_norm_w, lp.mlp_norm_b)
    return x + _mlp(lp.mlp, h)


def _cross_kv(lp: WhisperLayer, enc_out: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return _heads(enc_out, lp.cross_attn["wk"]), _heads(enc_out, lp.cross_attn["wv"])


def _dec_layer(lp: WhisperLayer, x: torch.Tensor, cross_k: torch.Tensor,
               cross_v: torch.Tensor, self_attend: Attend, cross_attend: Attend) -> torch.Tensor:
    h = common.layer_norm(x, lp.self_norm_w, lp.self_norm_b)
    sa = lp.self_attn
    attn = self_attend(_heads(h, sa["wq"]), _heads(h, sa["wk"]), _heads(h, sa["wv"]))
    x = x + _merge(attn, sa["wo"])
    h = common.layer_norm(x, lp.cross_norm_w, lp.cross_norm_b)
    attn = cross_attend(_heads(h, lp.cross_attn["wq"]), cross_k, cross_v)
    x = x + _merge(attn, lp.cross_attn["wo"])
    h = common.layer_norm(x, lp.mlp_norm_w, lp.mlp_norm_b)
    return x + _mlp(lp.mlp, h)


def _train_dec_layer(lp: WhisperLayer, x: torch.Tensor, enc_out: torch.Tensor,
                     self_attend: Attend, cross_attend: Attend) -> torch.Tensor:
    """A decoder layer over the full text, its cross K/V projected from the
    encoder output (inside the recomputed body under remat)."""
    return _dec_layer(lp, x, *_cross_kv(lp, enc_out), self_attend, cross_attend)


# ---------------------------------------------------------------------------
# Decode caches
# ---------------------------------------------------------------------------


def init_cache(cfg: WhisperConfig, batch: int, seq_len: int, dtype=None, *, device):
    """The decoder's self-attention KV cache (``seq_len``) and the
    cross-attention K/V (``enc_frames``), which ``prime_cache`` fills from
    the encoder output; in the compute dtype by default, which is what
    decode writes."""
    if dtype is None:
        dtype = cfg.compute_dtype
    cache = common.make_kv_cache(
        cfg.n_dec_layers, batch, seq_len, cfg.n_heads, cfg.head_dim, dtype, device)
    cross = (cfg.n_dec_layers, batch, cfg.enc_frames, cfg.n_heads, cfg.head_dim)
    dev = cache["k"].device
    cache["cross_k"] = torch.zeros(cross, dtype=dtype, device=dev)
    cache["cross_v"] = torch.zeros(cross, dtype=dtype, device=dev)
    return cache
