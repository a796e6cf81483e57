"""DeepSeek-V2 (236B): Multi-head Latent Attention + fine-grained MoE (PyTorch).

The counterpart of ``repro/models/deepseek.py``.  MLA (arXiv:2405.04434):
queries go through a low-rank bottleneck (``q_lora_rank``); keys and
values are reconstructed from a shared compressed latent ``c_kv``
(``kv_lora_rank`` = 512) plus one shared 64-dim RoPE key.

* The full-sequence forward materializes per-head q and k at
  ``qk_nope + qk_rope`` = 192 and v at 128, as the reference does, and
  attends through the Hopper flash-attention kernel at that (192, 128)
  pair with scale ``1/sqrt(192)`` on CUDA tensors (its plain version on CPU
  tensors), where the reference calls ``common.full_attention``.
* Decode is the absorbed form, in plain torch as the reference's einsums:
  ``W_uk`` is folded into the query, scores and the weighted sum run
  against the latent cache (512 + 64 values per token and layer), and
  ``W_uv`` maps the result back.  Only the cache entries up to ``pos`` are
  read: the reference masks the rest to an exact zero weight.  There is no
  fused prefill: prompts step the decode loop, as in the reference.
* Layer 0 is a dense SwiGLU FFN; layers 1..L-1 are MoE with shared experts
  (:func:`repro_torch.models.moe.moe_apply`).  The forward's stats are the
  means over the MoE layers, as the reference's scan gives them.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import common
from repro_torch.models.common import Param
from repro_torch.models.moe import (
    STAT_KEYS, Attend, MoEConfig, MoEParams, moe_apply, moe_layer_schema,
)

__all__ = [
    "DeepSeekConfig",
    "DeepSeekModel",
    "MODEL",
    "mla_schema",
    "layer_schema",
    "schema",
    "init_cache",
]


@dataclasses.dataclass(frozen=True)
class DeepSeekConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    d_ff_expert: int            # routed-expert hidden (1536)
    d_ff_dense: int             # layer-0 dense hidden
    vocab: int
    n_experts: int = 160
    top_k: int = 6
    n_shared_experts: int = 2
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    rope_theta: float = 10000.0
    capacity_factor: float = 1.25
    param_dtype: torch.dtype = torch.bfloat16
    compute_dtype: torch.dtype = torch.bfloat16
    remat: bool = True

    @property
    def family(self) -> str:
        return "moe"

    @property
    def qk_dim(self) -> int:
        return self.qk_nope_dim + self.qk_rope_dim

    @property
    def moe(self) -> MoEConfig:
        return MoEConfig(
            n_experts=self.n_experts,
            top_k=self.top_k,
            d_model=self.d_model,
            d_ff=self.d_ff_expert,
            capacity_factor=self.capacity_factor,
            n_shared_experts=self.n_shared_experts,
            d_ff_shared=self.n_shared_experts * self.d_ff_expert,
        )


# ---------------------------------------------------------------------------
# Schema
# ---------------------------------------------------------------------------


def mla_schema(cfg: DeepSeekConfig) -> Dict[str, Param]:
    d, h = cfg.d_model, cfg.n_heads
    qr, kr = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    return {
        "w_dq": Param((d, qr), ("embed", None)),
        "q_norm": Param((qr,), (None,), init="ones"),
        "w_uq": Param((qr, h, dn + dr), (None, "heads", None)),
        "w_dkv": Param((d, kr), ("embed", None)),
        "kv_norm": Param((kr,), (None,), init="ones"),
        "w_kr": Param((d, dr), ("embed", None)),
        "w_uk": Param((kr, h, dn), (None, "heads", None)),
        "w_uv": Param((kr, h, dv), (None, "heads", None)),
        "wo": Param((h, dv, d), ("heads", None, "embed")),
    }


def layer_schema(cfg: DeepSeekConfig, *, dense: bool) -> Dict[str, object]:
    d = cfg.d_model
    s: Dict[str, object] = {
        "attn": mla_schema(cfg),
        "attn_norm": Param((d,), (None,), init="ones"),
        "mlp_norm": Param((d,), (None,), init="ones"),
    }
    if dense:
        s["mlp"] = {
            "w_gate": Param((d, cfg.d_ff_dense), ("embed", "ff")),
            "w_up": Param((d, cfg.d_ff_dense), ("embed", "ff")),
            "w_down": Param((cfg.d_ff_dense, d), ("ff", "embed")),
        }
    else:
        s["moe"] = moe_layer_schema(cfg.moe)
    return s


def schema(cfg: DeepSeekConfig) -> Dict[str, object]:
    """The reference's parameter tree: the dense layer 0 apart, the MoE
    layers stacked on a leading dim."""
    return {
        "embed": Param((cfg.vocab, cfg.d_model), ("vocab", None), init="embed"),
        "dense_layer": layer_schema(cfg, dense=True),
        "layers": common.stacked(layer_schema(cfg, dense=False), cfg.n_layers - 1),
        "final_norm": Param((cfg.d_model,), (None,), init="ones"),
        "lm_head": Param((cfg.d_model, cfg.vocab), ("embed", "vocab")),
    }


class DeepSeekLayer(nn.Module):
    """One layer's parameters under the reference's names: ``attn``, the
    norms, and ``mlp`` (the dense layer 0) or ``moe``."""

    def __init__(self, cfg: DeepSeekConfig, *, dense: bool, device, generator=None):
        super().__init__()
        s = layer_schema(cfg, dense=dense)
        dtype = cfg.param_dtype
        self.dense = dense

        def group(sub):
            return nn.ParameterDict({
                name: common.new_parameter(sub[name], dtype, device, generator)
                for name in sorted(sub)
            })

        self.attn = group(s["attn"])
        for name in ("attn_norm", "mlp_norm"):
            self.register_parameter(
                name, common.new_parameter(s[name], dtype, device, generator))
        if dense:
            self.mlp = group(s["mlp"])
        else:
            self.moe = MoEParams(cfg.moe, dtype, device=device, generator=generator)


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------


class DeepSeekModel(nn.Module):
    """DeepSeek-V2; ``forward(tokens)`` returns ``(float32 logits, stats)``
    with the MoE stats averaged over the MoE layers."""

    def __init__(self, cfg: DeepSeekConfig, *, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        s = schema(cfg)
        self.cfg = cfg

        def param(name):
            return common.new_parameter(s[name], cfg.param_dtype, device, generator)

        self.embed = param("embed")
        self.dense_layer = DeepSeekLayer(cfg, dense=True, device=device, generator=generator)
        self.layers = nn.ModuleList(
            DeepSeekLayer(cfg, dense=False, device=device, generator=generator)
            for _ in range(cfg.n_layers - 1)
        )
        self.final_norm = param("final_norm")
        self.lm_head = param("lm_head")

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def _embed(self, tokens) -> torch.Tensor:
        tokens = torch.as_tensor(tokens, dtype=torch.long, device=self.device)
        x = common.embedding(self.embed, tokens).to(self.cfg.compute_dtype)
        return common.constrain(x, ("batch", None, None))

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        x = common.block_input(common.rms_norm(x, self.final_norm))
        return (x @ self.lm_head.to(self.cfg.compute_dtype)).float()

    def _run(self, tokens, *, remat: bool, attend: Attend):
        x = self._embed(tokens)
        positions = torch.arange(x.shape[1], device=self.device)
        per_layer = []
        for layer in (self.dense_layer, *self.layers):
            body = functools.partial(_layer, positions=positions, cfg=self.cfg, attend=attend)
            x, *stats = checkpoint(body, layer, x, use_reentrant=False) if remat else body(layer, x)
            if stats:
                per_layer.append(stats)
        mean_stats = {key: torch.stack(vals).mean()
                      for key, vals in zip(STAT_KEYS, zip(*per_layer))}
        return self._logits(x), mean_stats

    def _flash(self) -> Attend:
        return functools.partial(flash_attention, causal=True,
                                 softmax_scale=1.0 / math.sqrt(self.cfg.qk_dim))

    @torch.no_grad()
    def forward(self, tokens) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """tokens (B, S) int -> (logits (B, S, vocab) float32, stats)."""
        return self._run(tokens, remat=False, attend=self._flash())

    def train_forward(self, tokens, *, attend: Optional[Attend] = None):
        """``forward`` carrying gradients to the parameters that require
        them, stats included.  ``attend`` replaces the flash-attention call
        (a seam for holding the kernel against a plain attention, which
        takes q, k at ``qk_dim`` and v at ``v_head_dim`` with the default
        scale ``1/sqrt(qk_dim)``); with ``cfg.remat`` every layer is
        recomputed in the backward pass."""
        return self._run(tokens, remat=self.cfg.remat, attend=attend or self._flash())

    @torch.no_grad()
    def decode_step(
        self, cache: Dict[str, object], tokens, pos: int
    ) -> Tuple[torch.Tensor, Dict[str, object]]:
        """One-token decode in the absorbed form.  tokens (B, 1); ``pos`` a
        host int; the latent caches ``c`` (L, B, T, kv_lora) and ``kr``
        (L, B, T, rope) are written at ``pos`` in place."""
        pos = int(pos)
        if not 0 <= pos < cache["c"].shape[2]:
            raise IndexError(f"cache position {pos} outside cache length {cache['c'].shape[2]}")
        x = self._embed(tokens)
        for i, layer in enumerate((self.dense_layer, *self.layers)):
            h = common.rms_norm(x, layer.attn_norm)
            x = x + _mla_absorbed(layer.attn, h, cache["c"][i], cache["kr"][i], pos, self.cfg)
            x = x + _ffn(layer, common.rms_norm(x, layer.mlp_norm), self.cfg)[0]
        cache["pos"] = pos + 1
        return self._logits(x), cache


MODEL = DeepSeekModel


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, S, r) x w (r, h, k) -> (B, S, h, k)."""
    return common.heads(x, w)


def _mla_full(ap, x: torch.Tensor, positions: torch.Tensor, cfg: DeepSeekConfig,
              attend: Attend) -> torch.Tensor:
    """Full-sequence MLA: per-head q, k (``qk_dim``) and v (``v_head_dim``)
    from the latents, attention, then the output projection."""
    dn = cfg.qk_nope_dim
    q = _heads(common.block_input(common.rms_norm(x @ ap["w_dq"], ap["q_norm"])), ap["w_uq"])
    q = torch.cat([q[..., :dn], common.apply_rope(q[..., dn:], positions, cfg.rope_theta)], -1)
    c_kv = common.block_input(common.rms_norm(x @ ap["w_dkv"], ap["kv_norm"]))
    k_rope = common.apply_rope((x @ ap["w_kr"])[:, :, None, :], positions, cfg.rope_theta)
    k_nope = _heads(c_kv, ap["w_uk"])
    k = torch.cat([k_nope, k_rope.expand(*k_nope.shape[:3], cfg.qk_rope_dim)], -1)
    attn = attend(q, k, _heads(c_kv, ap["w_uv"]))
    wo = ap["wo"]
    return common.constrain(attn.reshape(*attn.shape[:2], -1) @ wo.reshape(-1, wo.shape[-1]),
                            ("batch", None, None))


def _mla_absorbed(ap, x: torch.Tensor, c_cache: torch.Tensor, kr_cache: torch.Tensor,
                  pos: int, cfg: DeepSeekConfig) -> torch.Tensor:
    """Absorbed decode of x (B, 1, d) against one layer's latent caches
    (B, T, kv_lora) and (B, T, rope), written at ``pos``: (B, 1, d)."""
    dn = cfg.qk_nope_dim
    positions = torch.full((1,), pos, device=x.device)
    q = _heads(common.rms_norm(x @ ap["w_dq"], ap["q_norm"]), ap["w_uq"])  # (B,1,H,dn+dr)
    q_rope = common.apply_rope(q[..., dn:], positions, cfg.rope_theta)
    common.write_slot(c_cache, common.rms_norm(x @ ap["w_dkv"], ap["kv_norm"]), pos)
    common.write_slot(kr_cache, common.apply_rope(
        (x @ ap["w_kr"])[:, :, None, :], positions, cfg.rope_theta)[:, :, 0, :], pos)
    c = common.constrain(c_cache, ("batch", "cache_seq", None))
    kr = common.constrain(kr_cache, ("batch", "cache_seq", None))
    if pos + 1 < c.shape[1]:  # a full cache is read whole, unsliced
        c, kr = c[:, :pos + 1], kr[:, :pos + 1]
    # W_uk absorbed into the query: q_eff (B, H, kv_lora).
    q_eff = torch.einsum("bshk,chk->bhc", q[..., :dn], ap["w_uk"])
    scores = torch.einsum("bhc,btc->bht", q_eff.float(), c.float())
    scores = scores + torch.einsum("bshr,btr->bht", q_rope.float(), kr.float())
    probs = torch.softmax(scores / math.sqrt(cfg.qk_dim), dim=-1)
    out_lat = torch.einsum("bht,btc->bhc", probs.to(c.dtype), c)
    out = torch.einsum("bhc,chk->bhk", out_lat, ap["w_uv"])  # (B, H, v_dim)
    return torch.einsum("bhk,hkd->bd", out, ap["wo"])[:, None, :]


def _ffn(lp: DeepSeekLayer, h: torch.Tensor, cfg: DeepSeekConfig):
    """The dense SwiGLU FFN of layer 0 as ``(out,)``, or a MoE layer's
    ``(out, lb_loss, z_loss, drop_frac)``."""
    if lp.dense:
        mp = lp.mlp
        return (common.constrain(common.swiglu(h @ mp["w_gate"], h @ mp["w_up"]) @ mp["w_down"],
                                 ("batch", None, None)),)
    out, stats = moe_apply(lp.moe, h, cfg.moe)
    return (common.constrain(out, ("batch", None, None)),) + tuple(
        stats[key] for key in STAT_KEYS)


def _layer(lp: DeepSeekLayer, x: torch.Tensor, *, positions: torch.Tensor,
           cfg: DeepSeekConfig, attend: Attend):
    """One layer: ``(x,)`` for the dense layer 0, ``(x, lb_loss, z_loss,
    drop_frac)`` for a MoE layer, a tuple so that ``torch.utils.checkpoint``
    carries the stats' gradients."""
    h = common.block_input(common.rms_norm(x, lp.attn_norm))
    x = x + _mla_full(lp.attn, h, positions, cfg, attend)
    out, *stats = _ffn(lp, common.block_input(common.rms_norm(x, lp.mlp_norm)), cfg)
    return (x + out, *stats)


def init_cache(cfg: DeepSeekConfig, batch: int, seq_len: int, dtype=None, *, device):
    """The latent cache: 512 + 64 values per token and layer, in the
    compute dtype that ``decode_step`` writes, and a host-int position."""
    if dtype is None:
        dtype = cfg.compute_dtype
    device = resolve_device(device)
    return {
        "c": torch.zeros((cfg.n_layers, batch, seq_len, cfg.kv_lora_rank), dtype=dtype,
                         device=device),
        "kr": torch.zeros((cfg.n_layers, batch, seq_len, cfg.qk_rope_dim), dtype=dtype,
                          device=device),
        "pos": 0,
    }
