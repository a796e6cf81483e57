"""RWKV-6 "Finch" (arXiv:2404.05892), PyTorch — attention-free RNN with
data-dependent per-channel decay.

The counterpart of ``repro/models/rwkv6.py``.  Per layer:
  * time mixing — r/k/v/g projections of token-shift-lerped inputs; the WKV
    recurrence per head (state S in R^{K x K}):
        out_t = r_t . (diag(u) k_t^T v_t + S_{t-1})
        S_t   = diag(w_t) S_{t-1} + k_t^T v_t
    with decay w_t = exp(-exp(w0 + lora(x_t))) and per-head bonus u.
  * channel mixing — token-shifted squared-ReLU MLP with sigmoid receptance.

Weights keep the reference's layouts and leaf names; the state_dict unrolls
its stacked layer dim into ``layers.<i>.time.*`` / ``layers.<i>.chan.*``.

The full-sequence forward runs the WKV recurrence through
:func:`repro_torch.kernels.rwkv6_wkv.wkv` (the Hopper kernel on CUDA
tensors, the chunked plain version on CPU tensors), as the reference does
with ``use_kernel``.  ``train_forward`` is the same forward carrying
gradients (the kernel's backward on the card), each layer recomputed in
the backward pass with ``cfg.remat`` as the reference's ``jax.checkpoint``
does.  Decode carries (state S, shift registers) per layer —
O(1) per token — through the step-by-step :func:`wkv_scan_ref`; it
updates the cache in place and returns the same dict.  There is no fused
prefill: prompts step the decode loop, as in the reference.
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
from repro_torch.kernels.rwkv6_wkv import LOG_DECAY_MIN, wkv, wkv_chunked, wkv_scan_ref
from repro_torch.kernels.sharded import local_over_batch_heads
from repro_torch.models import common
from repro_torch.models.common import Param
from repro_torch.sharding.context import is_dtensor

__all__ = [
    "RWKV6Config",
    "RWKV6Model",
    "MODEL",
    "layer_schema",
    "schema",
    "init_cache",
    "wkv_chunked",
    "wkv_scan_ref",
    "LOG_DECAY_MIN",
]

# The WKV entry of the full-sequence forward: (r, k, v, log_w, u, *, chunk)
# -> (out, final state), as :func:`wkv` (or the plain :func:`wkv_chunked`).
Scan = Callable[..., Tuple[torch.Tensor, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class RWKV6Config:
    name: str
    n_layers: int
    d_model: int
    d_ff: int
    vocab: int
    head_size: int = 64
    decay_lora: int = 64
    wkv_chunk: int = 32
    param_dtype: torch.dtype = torch.bfloat16
    compute_dtype: torch.dtype = torch.bfloat16
    remat: bool = True               # recompute each layer in the backward pass

    @property
    def family(self) -> str:
        return "ssm"

    @property
    def n_heads(self) -> int:
        return self.d_model // self.head_size


# ---------------------------------------------------------------------------
# Schema
# ---------------------------------------------------------------------------


def layer_schema(cfg: RWKV6Config) -> Dict[str, object]:
    d, h, k = cfg.d_model, cfg.n_heads, cfg.head_size
    return {
        "time": {
            "mu_r": Param((d,), (None,), init="zeros"),
            "mu_k": Param((d,), (None,), init="zeros"),
            "mu_v": Param((d,), (None,), init="zeros"),
            "mu_w": Param((d,), (None,), init="zeros"),
            "mu_g": Param((d,), (None,), init="zeros"),
            "w0": Param((h, k), ("heads", None), init="zeros"),
            "w_lora_a": Param((d, cfg.decay_lora), ("embed", None)),
            "w_lora_b": Param((cfg.decay_lora, h, k), (None, "heads", None)),
            "u": Param((h, k), ("heads", None), init="zeros"),
            "w_r": Param((d, h, k), ("embed", "heads", None)),
            "w_k": Param((d, h, k), ("embed", "heads", None)),
            "w_v": Param((d, h, k), ("embed", "heads", None)),
            "w_g": Param((d, h, k), ("embed", "heads", None)),
            "w_o": Param((h, k, d), ("heads", None, "embed")),
            "ln_x": Param((h, k), ("heads", None), init="ones"),
        },
        "chan": {
            "mu_ck": Param((d,), (None,), init="zeros"),
            "mu_cr": Param((d,), (None,), init="zeros"),
            "w_ck": Param((d, cfg.d_ff), ("embed", "ff")),
            "w_cv": Param((cfg.d_ff, d), ("ff", "embed")),
            "w_cr": Param((d, d), ("embed", None)),
        },
        "time_norm": Param((d,), (None,), init="ones"),
        "chan_norm": Param((d,), (None,), init="ones"),
    }


def schema(cfg: RWKV6Config) -> Dict[str, object]:
    """The reference's parameter tree, layers stacked on a leading dim."""
    return {
        "embed": Param((cfg.vocab, cfg.d_model), ("vocab", None), init="embed"),
        "layers": common.stacked(layer_schema(cfg), cfg.n_layers),
        "final_norm": Param((cfg.d_model,), (None,), init="ones"),
        "lm_head": Param((cfg.d_model, cfg.vocab), ("embed", "vocab")),
    }


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------


class RWKV6Layer(nn.Module):
    """One layer: ``time`` / ``chan`` parameter dicts and the two norms."""

    def __init__(self, cfg: RWKV6Config, *, device, generator=None):
        super().__init__()
        s = layer_schema(cfg)

        def param(p: Param) -> nn.Parameter:
            return common.new_parameter(p, cfg.param_dtype, device, generator)

        for group in ("time", "chan"):
            setattr(self, group, nn.ParameterDict(
                {name: param(s[group][name]) for name in sorted(s[group])}
            ))
        self.time_norm = param(s["time_norm"])
        self.chan_norm = param(s["chan_norm"])


class RWKV6Model(nn.Module):
    """The RWKV6 stack; ``forward(tokens)`` returns float32 logits."""

    def __init__(self, cfg: RWKV6Config, *, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        s = schema(cfg)
        self.cfg = cfg
        self.embed = common.new_parameter(s["embed"], cfg.param_dtype, device, generator)
        self.layers = nn.ModuleList(
            RWKV6Layer(cfg, device=device, generator=generator) for _ in range(cfg.n_layers)
        )
        self.final_norm = common.new_parameter(s["final_norm"], cfg.param_dtype, device, generator)
        self.lm_head = common.new_parameter(s["lm_head"], cfg.param_dtype, device, generator)

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
        """tokens (B, T) int -> logits (B, T, vocab) float32; one WKV kernel
        launch per layer on the card when T > 1."""
        x = self._embed(tokens)
        for layer in self.layers:
            x, _ = _layer(layer, x, self.cfg)
        return self._logits(x)

    def train_forward(self, tokens, *, scan: Optional[Scan] = None) -> torch.Tensor:
        """tokens (B, T) int -> logits (B, T, vocab) float32, carrying
        gradients to the parameters that require them.  ``scan`` replaces
        the WKV call (a seam for holding the kernel against the plain
        :func:`wkv_chunked`); with ``cfg.remat`` every layer is recomputed
        in the backward pass."""
        x = self._embed(tokens)
        body = functools.partial(_train_layer, cfg=self.cfg, scan=scan or wkv)
        for layer in self.layers:
            if self.cfg.remat:
                x = checkpoint(body, layer, x, use_reentrant=False)
            else:
                x = body(layer, x)
        return self._logits(x)

    @torch.no_grad()
    def decode_step(
        self, cache: Dict[str, object], tokens, pos: int
    ) -> Tuple[torch.Tensor, Dict[str, object]]:
        """One-token decode. tokens (B, 1); ``pos`` a host int.  The state
        and shift registers of each layer are updated in place."""
        x = self._embed(tokens)
        for i, layer in enumerate(self.layers):
            x, (s, t_shift, c_shift) = _layer(
                layer, x, self.cfg,
                state=cache["wkv"][i],
                t_shift=cache["time_shift"][i],
                c_shift=cache["chan_shift"][i],
            )
            cache["wkv"][i] = s
            cache["time_shift"][i] = t_shift
            cache["chan_shift"][i] = c_shift
        cache["pos"] = int(pos) + 1
        return self._logits(x), cache


MODEL = RWKV6Model


# ---------------------------------------------------------------------------
# Layer math
# ---------------------------------------------------------------------------


def _shift(x: torch.Tensor, prev: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token shift: the previous token's features (zeros / ``prev`` at t=0)."""
    first = torch.zeros_like(x[:, :1]) if prev is None else prev[:, None, :].to(x.dtype)
    return torch.cat([first, x[:, :-1]], dim=1)


def _heads(x: torch.Tensor, w: torch.Tensor, axis: str = "heads") -> torch.Tensor:
    """x (B, T, d) x w (d, h, k) -> (B, T, h, k)."""
    return common.heads(x, w, axis)


def _decay(tp: nn.ParameterDict, xw: torch.Tensor) -> torch.Tensor:
    """Data-dependent log-decay, (B, T, H, K) float32, clamped."""
    lora = common.block_input(torch.tanh(xw @ tp["w_lora_a"].float()))
    log_w = -torch.exp(tp["w0"].float() + _heads(lora, tp["w_lora_b"].float()))
    return log_w.clamp(LOG_DECAY_MIN, 0.0)


def _time_mix(
    tp: nn.ParameterDict,
    x: torch.Tensor,
    cfg: RWKV6Config,
    *,
    shift_prev: Optional[torch.Tensor] = None,
    state: Optional[torch.Tensor] = None,
    scan: Scan = wkv,
) -> Tuple[torch.Tensor, torch.Tensor]:
    b, t, d = x.shape
    xs = _shift(x, shift_prev)

    def mix(mu: torch.Tensor) -> torch.Tensor:
        return common.block_input(x + (xs - x) * mu)

    r = _heads(mix(tp["mu_r"]), tp["w_r"])
    k = _heads(mix(tp["mu_k"]), tp["w_k"])
    v = _heads(mix(tp["mu_v"]), tp["w_v"])
    g = F.silu(_heads(mix(tp["mu_g"]), tp["w_g"]))
    log_w = _decay(tp, mix(tp["mu_w"]).float())
    u = tp["u"].float()
    if t > 1 and state is None:
        out, s_new = scan(r.float(), k.float(), v.float(), log_w, u, chunk=cfg.wkv_chunk)
        out = out.to(cfg.compute_dtype)
    elif is_dtensor(r):  # each rank's batch and heads (the dry run's decode)
        out, s_new = local_over_batch_heads(
            lambda *a: wkv_scan_ref(*a[:5], s0=a[5]), [r, k, v, log_w, u, state],
            [(0, 2)] * 4 + [(None, 0), (0, 1)], [(0, 2), (0, 1)])
    else:
        out, s_new = wkv_scan_ref(r, k, v, log_w, u, s0=state)
    # Per-head LayerNorm (GroupNorm equivalent), then gate and project.
    out = common.layer_norm(out.float()) * tp["ln_x"].float()
    out = out.to(cfg.compute_dtype) * g
    w_o = tp["w_o"]
    out = common.constrain(out.reshape(b, t, -1) @ w_o.reshape(-1, d), ("batch", None, None))
    return out, s_new


def _chan_mix(
    cp: nn.ParameterDict, x: torch.Tensor, *, shift_prev: Optional[torch.Tensor] = None
) -> torch.Tensor:
    xs = _shift(x, shift_prev)
    xk = common.block_input(x + (xs - x) * cp["mu_ck"])
    xr = common.block_input(x + (xs - x) * cp["mu_cr"])
    k = common.relu2(xk @ cp["w_ck"])
    r = torch.sigmoid(xr @ cp["w_cr"])
    return r * common.constrain(k @ cp["w_cv"], ("batch", None, None))


def _layer(
    lp: RWKV6Layer,
    x: torch.Tensor,
    cfg: RWKV6Config,
    *,
    state: Optional[torch.Tensor] = None,
    t_shift: Optional[torch.Tensor] = None,
    c_shift: Optional[torch.Tensor] = None,
    scan: Scan = wkv,
):
    """One layer; returns (x, (final WKV state, last normed input of each
    mixer)) — the last two are the next step's shift registers."""
    h = common.rms_norm(x, lp.time_norm)
    t_out, s_new = _time_mix(lp.time, h, cfg, shift_prev=t_shift, state=state, scan=scan)
    new_t_shift = h[:, -1]
    x = x + t_out
    h = common.rms_norm(x, lp.chan_norm)
    new_c_shift = h[:, -1]
    x = x + _chan_mix(lp.chan, h, shift_prev=c_shift)
    return x, (s_new, new_t_shift, new_c_shift)


def _train_layer(lp: RWKV6Layer, x: torch.Tensor, *, cfg: RWKV6Config, scan: Scan):
    """:func:`_layer` from a zero state, returning x alone (the unit that
    ``train_forward`` recomputes)."""
    return _layer(lp, x, cfg, scan=scan)[0]


# ---------------------------------------------------------------------------
# Decode state
# ---------------------------------------------------------------------------


def init_cache(cfg: RWKV6Config, batch: int, seq_len: int, dtype=None, *, device):
    """O(1) state: the WKV matrix and the two token-shift registers per
    layer; ``seq_len`` does not size anything."""
    if dtype is None:
        dtype = cfg.compute_dtype
    h, kk, d, n = cfg.n_heads, cfg.head_size, cfg.d_model, cfg.n_layers
    return {
        "wkv": torch.zeros((n, batch, h, kk, kk), dtype=torch.float32, device=device),
        "time_shift": torch.zeros((n, batch, d), dtype=dtype, device=device),
        "chan_shift": torch.zeros((n, batch, d), dtype=dtype, device=device),
        "pos": 0,
    }
