"""Mixture-of-Experts layer + Mixtral-8x7B model (PyTorch).

The counterpart of ``repro/models/moe.py``.  Dispatch is capacity-based
(GShard-style, token-dropping) through scatter/gather, as in the
reference: every (token, k) routing takes the next slot of its expert's
queue in token-major order, routings past the expert's capacity are
dropped, and the experts' SwiGLU FFNs run batched over ``(E, capacity,
d)`` buffers.  With at most ``DECODE_GATHER_MAX`` routings (decode) only
the selected experts run: the routings are grouped by expert and each
selected expert's SwiGLU runs once on its rows, so each of its weights is
read once (the reference gathers a weight copy per routing instead; the
function is the same).  The expert products are ``torch.bmm`` /
``torch.matmul``, as the reference's are plain einsums.

The reference's ``constrain``/``active_rules`` dispatch layout hints are
GSPMD sharding constraints, no-ops without active mesh rules; the port has
no counterpart until the sharded layouts are (ROADMAP §1.6).

Aux losses: switch-style load-balance loss and router z-loss, returned in a
stats dict (with the dropped share of routings) so the loss can add them
with their weights (``registry.MOE_LB_WEIGHT``, ``MOE_Z_WEIGHT``).

Mixtral's attention is the Hopper flash-attention kernel with its sliding
window (GQA, head dim 128) on CUDA tensors and its plain version on CPU
tensors; decode attention is plain torch against a ring cache of
``min(decode_window, seq_len)`` entries.  There is no fused prefill:
prompts step the decode loop, as in the reference.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Dict, Mapping, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import common
from repro_torch.models.common import Param

__all__ = [
    "MoEConfig",
    "moe_layer_schema",
    "capacity",
    "dispatch",
    "DECODE_GATHER_MAX",
    "moe_apply",
    "MixtralConfig",
    "MixtralModel",
    "MODEL",
    "layer_schema",
    "schema",
    "init_cache",
]

STAT_KEYS = ("lb_loss", "z_loss", "drop_frac")


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_model: int
    d_ff: int                     # per-expert hidden
    capacity_factor: float = 1.25
    n_shared_experts: int = 0     # DeepSeek-style always-on experts
    d_ff_shared: int = 0          # hidden of the fused shared expert
    router_dtype: torch.dtype = torch.float32


def moe_layer_schema(cfg: MoEConfig) -> Dict[str, object]:
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    s: Dict[str, object] = {
        "router": Param((d, e), scale=0.02),
        "w_gate": Param((e, d, f)),
        "w_up": Param((e, d, f)),
        "w_down": Param((e, f, d)),
    }
    if cfg.n_shared_experts:
        fs = cfg.d_ff_shared or cfg.d_ff * cfg.n_shared_experts
        s["shared"] = {
            "w_gate": Param((d, fs)),
            "w_up": Param((d, fs)),
            "w_down": Param((fs, d)),
        }
    return s


# Tokens*top_k at or below this run only the selected experts (decode).
DECODE_GATHER_MAX = 16


def capacity(cfg: MoEConfig, n_tokens: int) -> int:
    c = math.ceil(n_tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    c = max(int(c), 4)
    if c >= 32:
        c = -(-c // 32) * 32  # round up, as the reference (its capacity dim shards)
    return c


def _one_hot(flat_e: torch.Tensor, n_experts: int) -> torch.Tensor:
    """(N,) expert ids -> (N, E) int64 one-hot, built by comparison so that
    the capacity path issues no host sync."""
    return (flat_e[:, None] == torch.arange(n_experts, device=flat_e.device)).long()


def dispatch(expert_idx: torch.Tensor, n_experts: int, cap: int):
    """Each (token, k) routing's slot: ``(keep, dest)`` over the (T*k,)
    routings in token-major order.  A routing's position in its expert's
    queue is the count of earlier routings to that expert; those at or past
    ``cap`` are dropped (``keep`` False) and sent to the drop slot ``E *
    cap``, the others to ``expert * cap + position``."""
    flat_e = expert_idx.reshape(-1)
    onehot = _one_hot(flat_e, n_experts)
    pos_in_e = (torch.cumsum(onehot, dim=0) - onehot).gather(1, flat_e[:, None])[:, 0]
    keep = pos_in_e < cap
    dest = torch.where(keep, flat_e * cap + pos_in_e, torch.full_like(flat_e, n_experts * cap))
    return keep, dest


def _swiglu_ffn(x, w_gate, w_up, w_down):
    return common.swiglu(x @ w_gate, x @ w_up) @ w_down


def _selected_experts(lp, xf, gate_vals, expert_idx):
    """The decode path: each selected expert's SwiGLU once over the rows
    routed to it (one host read of the routing), the results put back in
    (T*k) routing order and combined with the gates as the reference
    combines its per-routing products."""
    t, k = expert_idx.shape
    flat_e = expert_idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    rows = torch.div(order, k, rounding_mode="floor")
    counts = torch.bincount(flat_e, minlength=lp["w_gate"].shape[0]).tolist()
    parts, start = [], 0
    for e, n in enumerate(counts):
        if n:
            xe = xf[rows[start:start + n]]
            parts.append(_swiglu_ffn(xe, lp["w_gate"][e], lp["w_up"][e], lp["w_down"][e]))
            start += n
    by_expert = torch.cat(parts)
    routed = by_expert.new_empty(by_expert.shape).index_copy(0, order, by_expert)
    return (routed.view(t, k, -1) * gate_vals[..., None].to(routed.dtype)).sum(dim=1)


def moe_apply(
    lp: Mapping[str, object], x: torch.Tensor, cfg: MoEConfig
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x (B, S, d) -> (out (B, S, d), stats).

    ``lp`` maps the reference's leaf names (``router``, ``w_gate``, ``w_up``,
    ``w_down`` and an optional ``shared`` group) to tensors.  Token-dropping
    capacity router: tokens beyond an expert's capacity are dropped
    (contribute zero from that expert), matching GShard/Switch semantics.
    Gates are renormalized over the chosen top-k.
    """
    b, s, d = x.shape
    t = b * s
    xf = x.reshape(t, d)

    logits = xf.to(cfg.router_dtype) @ lp["router"].to(cfg.router_dtype)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, cfg.top_k, dim=-1)  # (T, k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    z_loss = (torch.logsumexp(logits, dim=-1) ** 2).mean().float()

    if t * cfg.top_k <= DECODE_GATHER_MAX:
        out = _selected_experts(lp, xf, gate_vals, expert_idx)
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        stats = {"lb_loss": zero, "z_loss": z_loss, "drop_frac": zero}
    else:
        cap = capacity(cfg, t)
        n_slots = cfg.n_experts * cap
        keep, dest = dispatch(expert_idx, cfg.n_experts, cap)
        # Scatter the routings into (E*cap + 1, d) (the last row: dropped).
        src = xf[:, None].expand(t, cfg.top_k, d).reshape(t * cfg.top_k, d)  # (T*k, d)
        buf = xf.new_zeros((n_slots + 1, d)).index_put((dest,), src)
        expert_in = buf[:n_slots].view(cfg.n_experts, cap, d)
        h = common.swiglu(torch.bmm(expert_in, lp["w_gate"]), torch.bmm(expert_in, lp["w_up"]))
        expert_out = torch.bmm(h, lp["w_down"]).reshape(n_slots, d)
        # Gather back and combine with the gates (dropped routings weigh 0).
        routed = torch.cat([expert_out, expert_out.new_zeros((1, d))])[dest]
        gates = (gate_vals.reshape(-1) * keep).to(routed.dtype)
        out = (routed * gates[:, None]).reshape(t, cfg.top_k, d).sum(dim=1)

        flat_e = expert_idx.reshape(-1)
        me = probs.mean(dim=0)                                        # (E,)
        ce = _one_hot(flat_e, cfg.n_experts).sum(dim=0).to(probs.dtype) / (t * cfg.top_k)
        stats = {
            "lb_loss": (cfg.n_experts * torch.sum(me * ce)).float(),
            "z_loss": z_loss,
            # The reference's mean of the keep mask, op by op: its float32
            # sum over n, correctly rounded (a product with 1/n can differ
            # by an ulp).
            "drop_frac": 1.0 - keep.sum(dtype=torch.float32) / keep.numel(),
        }

    if "shared" in lp:
        sp = lp["shared"]
        out = out + _swiglu_ffn(xf, sp["w_gate"], sp["w_up"], sp["w_down"])
    return out.reshape(b, s, d), stats


# ---------------------------------------------------------------------------
# Mixtral-8x7B
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MixtralConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int                  # per-expert hidden
    vocab: int
    n_experts: int = 8
    top_k: int = 2
    head_dim: int = 128
    rope_theta: float = 1e6
    window: Optional[int] = 4096   # Mixtral SWA
    decode_window: Optional[int] = 4096
    capacity_factor: float = 1.25
    param_dtype: torch.dtype = torch.bfloat16
    compute_dtype: torch.dtype = torch.bfloat16
    remat: bool = True

    @property
    def family(self) -> str:
        return "moe"

    @property
    def moe(self) -> MoEConfig:
        return MoEConfig(
            n_experts=self.n_experts,
            top_k=self.top_k,
            d_model=self.d_model,
            d_ff=self.d_ff,
            capacity_factor=self.capacity_factor,
        )


def layer_schema(cfg: MixtralConfig) -> Dict[str, object]:
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "attn": {
            "wq": Param((d, h, dh)),
            "wk": Param((d, kv, dh)),
            "wv": Param((d, kv, dh)),
            "wo": Param((h, dh, d)),
        },
        "attn_norm": Param((d,), init="ones"),
        "mlp_norm": Param((d,), init="ones"),
        "moe": moe_layer_schema(cfg.moe),
    }


def schema(cfg: MixtralConfig) -> Dict[str, object]:
    """The reference's parameter tree, layers stacked on a leading dim."""
    return {
        "embed": Param((cfg.vocab, cfg.d_model), init="embed"),
        "layers": common.stacked(layer_schema(cfg), cfg.n_layers),
        "final_norm": Param((cfg.d_model,), init="ones"),
        "lm_head": Param((cfg.d_model, cfg.vocab)),
    }


class MoEParams(nn.Module):
    """One layer's ``moe`` group, indexed by the reference's leaf names
    (``lp["w_gate"]``, ``"shared" in lp``) as :func:`moe_apply` reads it."""

    def __init__(self, cfg: MoEConfig, dtype: torch.dtype, *, device, generator=None):
        super().__init__()
        s = moe_layer_schema(cfg)
        for name in sorted(k for k in s if k != "shared"):
            self.register_parameter(name, common.new_parameter(s[name], dtype, device, generator))
        if "shared" in s:
            self.shared = nn.ParameterDict({
                name: common.new_parameter(s["shared"][name], dtype, device, generator)
                for name in sorted(s["shared"])
            })

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules


class MixtralLayer(nn.Module):
    def __init__(self, cfg: MixtralConfig, *, device, generator=None):
        super().__init__()
        s = layer_schema(cfg)
        dtype = cfg.param_dtype
        self.attn = nn.ParameterDict({
            name: common.new_parameter(s["attn"][name], dtype, device, generator)
            for name in sorted(s["attn"])
        })
        for name in ("attn_norm", "mlp_norm"):
            self.register_parameter(
                name, common.new_parameter(s[name], dtype, device, generator))
        self.moe = MoEParams(cfg.moe, dtype, device=device, generator=generator)


Attend = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


class MixtralModel(nn.Module):
    """Mixtral; ``forward(tokens)`` returns ``(float32 logits, stats)``
    with the MoE stats averaged over the layers."""

    def __init__(self, cfg: MixtralConfig, *, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        s = schema(cfg)
        self.cfg = cfg

        def param(name):
            return common.new_parameter(s[name], cfg.param_dtype, device, generator)

        self.embed = param("embed")
        self.layers = nn.ModuleList(
            MixtralLayer(cfg, device=device, generator=generator) for _ in range(cfg.n_layers)
        )
        self.final_norm = param("final_norm")
        self.lm_head = param("lm_head")

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def _embed(self, tokens) -> torch.Tensor:
        tokens = torch.as_tensor(tokens, dtype=torch.long, device=self.device)
        return self.embed[tokens].to(self.cfg.compute_dtype)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        x = common.rms_norm(x, self.final_norm)
        return (x @ self.lm_head.to(self.cfg.compute_dtype)).float()

    def _run(self, tokens, *, remat: bool, attend: Attend):
        x = self._embed(tokens)
        positions = torch.arange(x.shape[1], device=self.device)
        per_layer = []
        for layer in self.layers:
            body = functools.partial(_layer, positions=positions, cfg=self.cfg, attend=attend)
            x, *stats = checkpoint(body, layer, x, use_reentrant=False) if remat else body(layer, x)
            per_layer.append(stats)
        mean_stats = {key: torch.stack(vals).mean()
                      for key, vals in zip(STAT_KEYS, zip(*per_layer))}
        return self._logits(x), mean_stats

    def _flash(self) -> Attend:
        return functools.partial(flash_attention, causal=True, window=self.cfg.window)

    @torch.no_grad()
    def forward(self, tokens) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """tokens (B, S) int -> (logits (B, S, vocab) float32, stats)."""
        return self._run(tokens, remat=False, attend=self._flash())

    def train_forward(self, tokens, *, attend: Optional[Attend] = None):
        """``forward`` carrying gradients to the parameters that require
        them, stats included (the aux losses train the router).  ``attend``
        replaces the flash-attention call (a seam for holding the kernel
        against a plain attention); with ``cfg.remat`` every layer is
        recomputed in the backward pass, as the reference's
        ``jax.checkpoint`` does."""
        return self._run(tokens, remat=self.cfg.remat, attend=attend or self._flash())

    @torch.no_grad()
    def decode_step(
        self, cache: Dict[str, object], tokens, pos: int
    ) -> Tuple[torch.Tensor, Dict[str, object]]:
        """One-token decode. tokens (B, 1); ``pos`` a host int.  A cache of
        ``decode_window`` entries is a ring (insert at pos mod window, the
        window kept by the cache itself); a shorter one holds the whole
        context and attends with ``cfg.window``."""
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
                return common.decode_attention(
                    q, k_cache, v_cache, pos=pos, window=None if ring else cfg.window
                )

            x, *_ = _layer(layer, x, positions=positions, cfg=cfg, attend=attend)
        cache["pos"] = pos + 1
        return self._logits(x), cache


MODEL = MixtralModel


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, S, d) x w (d, h, dh) -> (B, S, h, dh)."""
    d, h, dh = w.shape
    return (x @ w.reshape(d, h * dh)).view(*x.shape[:-1], h, dh)


def _layer(lp: MixtralLayer, x: torch.Tensor, *, positions: torch.Tensor,
           cfg: MixtralConfig, attend: Attend):
    """One layer: (x, lb_loss, z_loss, drop_frac), a tuple so that
    ``torch.utils.checkpoint`` carries the stats' gradients."""
    h = common.rms_norm(x, lp.attn_norm)
    q = common.apply_rope(_heads(h, lp.attn["wq"]), positions, cfg.rope_theta)
    k = common.apply_rope(_heads(h, lp.attn["wk"]), positions, cfg.rope_theta)
    attn = attend(q, k, _heads(h, lp.attn["wv"]))
    wo = lp.attn["wo"]
    x = x + attn.reshape(*attn.shape[:2], -1) @ wo.reshape(-1, wo.shape[-1])
    out, stats = moe_apply(lp.moe, common.rms_norm(x, lp.mlp_norm), cfg.moe)
    return (x + out,) + tuple(stats[key] for key in STAT_KEYS)


def init_cache(cfg: MixtralConfig, batch: int, seq_len: int, dtype=None, *, device):
    """The reference's rule: ``min(decode_window or seq_len, seq_len)``
    entries, in the compute dtype that ``decode_step`` writes."""
    if dtype is None:
        dtype = cfg.compute_dtype
    length = min(cfg.decode_window or seq_len, seq_len)
    return common.make_kv_cache(
        cfg.n_layers, batch, length, cfg.n_kv_heads, cfg.head_dim, dtype, device
    )
