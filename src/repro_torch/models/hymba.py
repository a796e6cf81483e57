"""Hymba (arXiv:2411.13676), PyTorch — hybrid-head architecture: every layer
runs attention heads and Mamba (selective-SSM) heads in parallel on the
same input, then fuses the two normalized branch outputs.

The counterpart of ``repro/models/hymba.py``.  Per layer:
  * attention — sliding-window (``window``) in every layer except the
    first, middle and last (``global_layers()``), which attend causally
    over the whole sequence;
  * Mamba branch — in-projection to (x, z) of d_inner, a short causal
    depthwise conv, the selective scan over state dim N, silu(z) gating,
    out-projection;
  * fusion — mean of the per-branch RMS-normalized outputs (learnable
    scales), then a SwiGLU MLP.

Weights keep the reference's layouts and leaf names; the state_dict unrolls
its stacked layer dim into ``layers.<i>.attn.*`` / ``.ssm.*`` / ``.mlp.*``
and ``layers.<i>.<norm scale>``.

The full-sequence forward launches two kernels per layer on CUDA tensors:
:func:`repro_torch.kernels.flash_attention.flash_attention` (with the
window on the windowed layers) and
:func:`repro_torch.kernels.ssm_scan.ssm_scan`; CPU tensors take their plain
versions.  Decode carries a ring KV cache of ``min(window, seq_len)``
entries for every layer (global layers included, as in the reference),
the SSM state and the conv tail — O(1) per token — through plain torch
(:func:`selective_scan_ref`, ``common.decode_attention``), and updates the
cache in place.  There is no fused prefill: prompts step the decode loop,
as in the reference.  ``train_forward`` is the full-sequence forward
carrying gradients (both kernels' backwards on the card), each layer
recomputed in the backward pass with ``cfg.remat`` as the reference's
``jax.checkpoint`` does.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ssm_scan import selective_scan_ref, ssm_scan
from repro_torch.models import common
from repro_torch.models.common import Param

__all__ = [
    "HymbaConfig",
    "HymbaModel",
    "MODEL",
    "layer_schema",
    "schema",
    "init_cache",
]

# The full-sequence forward's two kernel entries: attention (q, k, v, *,
# causal, window) -> out, as :func:`flash_attention` (or the plain
# ``attention_ref``), and the scan (u, dt, b_t, c_t, log_a, *, chunk) ->
# (y, final state), as :func:`ssm_scan`.
Attend = Callable[..., torch.Tensor]
Scan = Callable[..., Tuple[torch.Tensor, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class HymbaConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 64
    ssm_state: int = 16
    d_inner: Optional[int] = None      # default 2 * d_model
    conv_kernel: int = 4
    dt_rank: Optional[int] = None      # default ceil(d_model / 16)
    window: int = 1024
    rope_theta: float = 10000.0
    n_meta_tokens: int = 0
    ssm_chunk: int = 64
    param_dtype: torch.dtype = torch.bfloat16
    compute_dtype: torch.dtype = torch.bfloat16
    remat: bool = True                 # recompute each layer in the backward pass

    @property
    def family(self) -> str:
        return "hybrid"

    @property
    def inner(self) -> int:
        return self.d_inner or 2 * self.d_model

    @property
    def dtr(self) -> int:
        return self.dt_rank or -(-self.d_model // 16)

    def global_layers(self) -> Tuple[int, ...]:
        return (0, self.n_layers // 2, self.n_layers - 1)


# ---------------------------------------------------------------------------
# Schema
# ---------------------------------------------------------------------------


def layer_schema(cfg: HymbaConfig) -> Dict[str, object]:
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    di, n, dtr = cfg.inner, cfg.ssm_state, cfg.dtr
    return {
        "attn": {
            "wq": Param((d, h, dh), ("embed", "heads", None)),
            "wk": Param((d, kv, dh), ("embed", "kv_heads", None)),
            "wv": Param((d, kv, dh), ("embed", "kv_heads", None)),
            "wo": Param((h, dh, d), ("heads", None, "embed")),
        },
        "ssm": {
            "w_in": Param((d, 2 * di), ("embed", "ssm_inner")),
            "conv_w": Param((cfg.conv_kernel, di), (None, "ssm_inner")),
            "conv_b": Param((di,), ("ssm_inner",), init="zeros"),
            "w_dt_in": Param((di, dtr), ("ssm_inner", None)),
            "w_dt_out": Param((dtr, di), (None, "ssm_inner")),
            "dt_bias": Param((di,), ("ssm_inner",), init="zeros"),
            "w_bc": Param((di, 2 * n), ("ssm_inner", None)),
            "log_a": Param((di, n), ("ssm_inner", None), init="zeros"),
            "d_skip": Param((di,), ("ssm_inner",), init="ones"),
            "w_out": Param((di, d), ("ssm_inner", "embed")),
        },
        "attn_scale": Param((d,), (None,), init="ones"),
        "ssm_scale": Param((d,), (None,), init="ones"),
        "in_norm": Param((d,), (None,), init="ones"),
        "mlp_norm": Param((d,), (None,), init="ones"),
        "mlp": {
            "w_gate": Param((d, cfg.d_ff), ("embed", "ff")),
            "w_up": Param((d, cfg.d_ff), ("embed", "ff")),
            "w_down": Param((cfg.d_ff, d), ("ff", "embed")),
        },
    }


def schema(cfg: HymbaConfig) -> Dict[str, object]:
    """The reference's parameter tree, layers stacked on a leading dim."""
    s: Dict[str, object] = {
        "embed": Param((cfg.vocab, cfg.d_model), ("vocab", None), init="embed"),
        "layers": common.stacked(layer_schema(cfg), cfg.n_layers),
        "final_norm": Param((cfg.d_model,), (None,), init="ones"),
        "lm_head": Param((cfg.d_model, cfg.vocab), ("embed", "vocab")),
    }
    if cfg.n_meta_tokens:
        s["meta_tokens"] = Param((cfg.n_meta_tokens, cfg.d_model), (None, None), init="embed")
    return s


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------

_GROUPS = ("attn", "ssm", "mlp")
_SCALES = ("attn_scale", "ssm_scale", "in_norm", "mlp_norm")


class HymbaLayer(nn.Module):
    """One layer: ``attn`` / ``ssm`` / ``mlp`` parameter dicts and the four
    norm scales."""

    def __init__(self, cfg: HymbaConfig, *, device, generator=None):
        super().__init__()
        s = layer_schema(cfg)

        def param(p: Param) -> nn.Parameter:
            return common.new_parameter(p, cfg.param_dtype, device, generator)

        for group in _GROUPS:
            setattr(self, group, nn.ParameterDict(
                {name: param(s[group][name]) for name in sorted(s[group])}
            ))
        for name in _SCALES:
            setattr(self, name, param(s[name]))


class HymbaModel(nn.Module):
    """The Hymba stack; ``forward(tokens)`` returns float32 logits."""

    def __init__(self, cfg: HymbaConfig, *, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        s = schema(cfg)
        self.cfg = cfg

        def param(p: Param) -> nn.Parameter:
            return common.new_parameter(p, cfg.param_dtype, device, generator)

        self.embed = param(s["embed"])
        self.layers = nn.ModuleList(
            HymbaLayer(cfg, device=device, generator=generator) for _ in range(cfg.n_layers)
        )
        self.final_norm = param(s["final_norm"])
        self.lm_head = param(s["lm_head"])
        if cfg.n_meta_tokens:
            self.meta_tokens = param(s["meta_tokens"])

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

    @torch.no_grad()
    def forward(self, tokens) -> torch.Tensor:
        """tokens (B, S) int -> logits (B, S, vocab) float32; one
        flash-attention and one selective-scan launch per layer on the card."""
        return self._run(tokens, remat=False)

    def train_forward(
        self, tokens, *, attend: Optional[Attend] = None, scan: Optional[Scan] = None,
    ) -> torch.Tensor:
        """tokens (B, S) int -> logits (B, S, vocab) float32, carrying
        gradients to the parameters that require them.  ``attend`` and
        ``scan`` replace the flash-attention and selective-scan calls (seams
        for holding the kernels against their plain versions); with
        ``cfg.remat`` every layer is recomputed in the backward pass."""
        return self._run(tokens, remat=self.cfg.remat, attend=attend, scan=scan)

    def _run(self, tokens, *, remat: bool, attend: Optional[Attend] = None,
             scan: Optional[Scan] = None) -> torch.Tensor:
        """The full-sequence forward: the meta-token prefix, every layer
        (through ``torch.utils.checkpoint`` with ``remat``), the prefix
        sliced off before the head."""
        cfg = self.cfg
        x = self._embed(tokens)
        if cfg.n_meta_tokens:
            meta = self.meta_tokens.to(cfg.compute_dtype)[None].expand(x.shape[0], -1, -1)
            x = torch.cat([meta, x], dim=1)
        positions = torch.arange(x.shape[1], device=self.device)
        global_layers = cfg.global_layers()
        for i, layer in enumerate(self.layers):
            body = functools.partial(
                _layer, positions=positions, cfg=cfg, is_global=i in global_layers,
                attend=attend or flash_attention, scan=scan or ssm_scan)
            x = checkpoint(body, layer, x, use_reentrant=False) if remat else body(layer, x)
        if cfg.n_meta_tokens:
            x = x[:, cfg.n_meta_tokens:]
        return self._logits(x)

    @torch.no_grad()
    def decode_step(
        self, cache: Dict[str, object], tokens, pos: int
    ) -> Tuple[torch.Tensor, Dict[str, object]]:
        """One-token decode. tokens (B, 1); ``pos`` a host int.  K/V go to
        ring index ``pos % length`` and attention reads the whole ring, as in
        the reference; the SSM state and conv tail are updated in place."""
        pos = int(pos)
        cfg = self.cfg
        x = self._embed(tokens)
        positions = torch.full((1,), pos, device=self.device)
        for i, layer in enumerate(self.layers):
            h = common.rms_norm(x, layer.in_norm)
            q, k, v = _qkv(layer.attn, h, positions, cfg)
            k_cache, v_cache = common.cache_update(
                cache["k"][i], cache["v"][i], k, v, pos, ring=True
            )
            attn = common.decode_attention(q, k_cache, v_cache, pos=pos, window=None)
            attn_out = _out_proj(layer.attn, attn)
            ssm_out, h_new, tail = _ssm_branch(
                layer.ssm, h, cfg, h0=cache["ssm"][i], conv_tail=cache["conv"][i]
            )
            cache["ssm"][i] = h_new
            cache["conv"][i] = tail
            x = x + _fuse(layer, attn_out, ssm_out)
            x = x + _mlp(layer.mlp, common.rms_norm(x, layer.mlp_norm))
        cache["pos"] = pos + 1
        return self._logits(x), cache


MODEL = HymbaModel


# ---------------------------------------------------------------------------
# Branches
# ---------------------------------------------------------------------------


def _heads(x: torch.Tensor, w: torch.Tensor, axis: str = "heads") -> torch.Tensor:
    """x (B, S, d) x w (d, h, dh) -> (B, S, h, dh)."""
    return common.heads(x, w, axis)


def _qkv(ap: nn.ParameterDict, x: torch.Tensor, positions: torch.Tensor, cfg: HymbaConfig):
    q = common.apply_rope(_heads(x, ap["wq"]), positions, cfg.rope_theta)
    k = common.apply_rope(_heads(x, ap["wk"], "kv_heads"), positions, cfg.rope_theta)
    return q, k, _heads(x, ap["wv"], "kv_heads")


def _out_proj(ap: nn.ParameterDict, attn: torch.Tensor) -> torch.Tensor:
    wo = ap["wo"]
    return common.constrain(attn.reshape(*attn.shape[:2], -1) @ wo.reshape(-1, wo.shape[-1]),
                            ("batch", None, None))


def _attn_branch(
    ap: nn.ParameterDict, x: torch.Tensor, positions: torch.Tensor, cfg: HymbaConfig,
    *, is_global: bool, attend: Attend = flash_attention,
) -> torch.Tensor:
    q, k, v = _qkv(ap, x, positions, cfg)
    attn = attend(q, k, v, causal=True, window=None if is_global else cfg.window)
    return _out_proj(ap, attn)


def _causal_conv(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, tail: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv.  x (B, T, di); w (K, di).  ``tail`` (B, K-1,
    di) supplies left context for decode; returns (y, new tail)."""
    k, t = w.shape[0], x.shape[1]
    if tail is None:
        tail = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    xp = torch.cat([tail.to(x.dtype), x], dim=1)
    y = sum(xp[:, i : i + t] * w[i] for i in range(k)) + b
    new_tail = xp[:, t:]
    return y, new_tail


def _ssm_branch(
    sp: nn.ParameterDict,
    x: torch.Tensor,
    cfg: HymbaConfig,
    *,
    h0: Optional[torch.Tensor] = None,
    conv_tail: Optional[torch.Tensor] = None,
    scan: Scan = ssm_scan,
):
    """Mamba heads.  Without ``h0`` (the full-sequence forward) the scan
    goes to the kernel (``scan``) in float32; with it (decode) the plain
    recurrence carries the state.  Returns (out, final state, conv tail)."""
    di, n = cfg.inner, cfg.ssm_state
    # Under a sharding context xz is gathered whole so that u and z each
    # split over the channels (a no-op otherwise).
    xz = common.constrain(x @ sp["w_in"], ("batch", None, None))
    u = common.constrain(xz[..., :di], ("batch", None, "ssm_inner"))
    z = common.constrain(xz[..., di:], ("batch", None, "ssm_inner"))
    u, new_tail = _causal_conv(u, sp["conv_w"], sp["conv_b"], conv_tail)
    u = F.silu(u)
    # The two products over the split channels, reduced whole (no-ops
    # outside a sharding context).
    dt_low = common.constrain(u @ sp["w_dt_in"], ("batch", None, None))
    dt = F.softplus(dt_low @ sp["w_dt_out"] + sp["dt_bias"])
    bc = common.constrain(u @ sp["w_bc"], ("batch", None, None))
    b_t, c_t = bc[..., :n], bc[..., n:]
    if h0 is None:
        y, h = scan(
            u.float(), dt.float(), b_t.float(), c_t.float(), sp["log_a"].float(),
            chunk=cfg.ssm_chunk,
        )
        y = y.to(cfg.compute_dtype)
    else:
        y, h = selective_scan_ref(u, dt, sp["log_a"], b_t, c_t, h0=h0)
    y = (y + sp["d_skip"] * u) * F.silu(z)
    return common.constrain(y @ sp["w_out"], ("batch", None, None)), h, new_tail


def _fuse(lp: HymbaLayer, attn_out: torch.Tensor, ssm_out: torch.Tensor) -> torch.Tensor:
    return 0.5 * (
        common.rms_norm(attn_out, lp.attn_scale) + common.rms_norm(ssm_out, lp.ssm_scale)
    )


def _mlp(mp: nn.ParameterDict, x: torch.Tensor) -> torch.Tensor:
    return common.swiglu(x @ mp["w_gate"], x @ mp["w_up"]) @ mp["w_down"]


def _layer(
    lp: HymbaLayer, x: torch.Tensor, *, positions: torch.Tensor, cfg: HymbaConfig,
    is_global: bool, attend: Attend, scan: Scan,
) -> torch.Tensor:
    """One layer of the full-sequence forward: both branches on the normed
    input, their fusion, then the MLP (the unit that ``train_forward``
    recomputes)."""
    h = common.block_input(common.rms_norm(x, lp.in_norm))
    attn_out = _attn_branch(lp.attn, h, positions, cfg, is_global=is_global, attend=attend)
    ssm_out, _, _ = _ssm_branch(lp.ssm, h, cfg, scan=scan)
    x = x + _fuse(lp, attn_out, ssm_out)
    return x + common.constrain(_mlp(lp.mlp, common.block_input(common.rms_norm(x, lp.mlp_norm))),
                                ("batch", None, None))


# ---------------------------------------------------------------------------
# Decode state
# ---------------------------------------------------------------------------


def init_cache(cfg: HymbaConfig, batch: int, seq_len: int, dtype=None, *, device):
    """A ring KV cache of ``min(window, seq_len)`` entries for every layer
    (global layers fall back to the window in decode, as in the reference),
    the float32 SSM state and the conv tail."""
    if dtype is None:
        dtype = cfg.compute_dtype  # the K/V and conv inputs decode_step writes
    length = min(cfg.window, seq_len)
    kv = common.make_kv_cache(
        cfg.n_layers, batch, length, cfg.n_kv_heads, cfg.head_dim, dtype, device
    )
    return {
        "k": kv["k"],
        "v": kv["v"],
        "ssm": torch.zeros(
            (cfg.n_layers, batch, cfg.inner, cfg.ssm_state), dtype=torch.float32, device=device
        ),
        "conv": torch.zeros(
            (cfg.n_layers, batch, cfg.conv_kernel - 1, cfg.inner), dtype=dtype, device=device
        ),
        "pos": 0,
    }
