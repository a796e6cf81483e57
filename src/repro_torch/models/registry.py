"""Uniform model API over the six families (dense, moe with deepseek's MLA,
rwkv6's ssm, hymba's hybrid, whisper's audio encoder-decoder).

The counterpart of ``repro/models/registry.py``.  Each family module names
its ``nn.Module`` class as ``MODEL`` and provides ``schema`` and
``init_cache``.  ``params`` in the reference's calling convention is the
port's ``nn.Module``.  MoE forwards return ``(logits, stats)``; the API
hands out the logits, and the loss adds the stats' aux terms.  The
encoder-decoder (whisper) reads ``batch["audio_embed"]`` (B, S_enc,
d_model) beside the tokens:

  api.init(seed, device=)                    -> model with seeded weights
  api.load(state_dict, device=)              -> model with given weights
  api.logits(params, batch)                  -> logits
  api.loss(params, batch, denom=None)        -> (scalar loss, aux dict)
  api.init_cache(batch_size, seq_len, device=) -> cache dict
  api.decode_step(params, cache, tok, pos)   -> (logits, cache)
  api.prefill(params, cache, tokens)         -> (logits, cache)
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.models import common, deepseek, dense, hymba, moe, rwkv6, whisper
from repro_torch.models.common import Param

__all__ = ["ModelApi", "build_api", "MOE_LB_WEIGHT", "MOE_Z_WEIGHT"]

MOE_LB_WEIGHT = 0.01
MOE_Z_WEIGHT = 1e-3


def _token_loss(logits, labels, weights, denom=None):
    """Per-token CE.  ``denom`` overrides the normalizer — used by gradient
    accumulation so microbatch gradients sum to the exact global-batch
    gradient even with non-uniform per-sample weights (Eq. 9)."""
    if weights is not None:
        w = torch.broadcast_to(weights[:, None], labels.shape).float()
    else:
        w = None
    loss_sum, w_sum = common.weighted_cross_entropy(logits, labels, w)
    if denom is None:
        denom = torch.clamp(
            w_sum if weights is not None else torch.tensor(float(labels.numel())), min=1e-9
        )
    return loss_sum / denom


def _leaves(tree):
    if isinstance(tree, Param):
        yield tree
    else:
        for sub in tree.values():
            yield from _leaves(sub)


@dataclasses.dataclass
class ModelApi:
    arch_id: str
    cfg: Any
    family: str
    _module: Any

    @property
    def has_moe_stats(self) -> bool:
        """True if the forward returns (logits, stats) (the MoE family)."""
        return self.family == "moe"

    @property
    def is_encoder_decoder(self) -> bool:
        """True if the forward takes ``(audio_embed, tokens)`` (whisper)."""
        return self.family == "audio"

    # -- params ---------------------------------------------------------
    def schema(self):
        return self._module.schema(self.cfg)

    def param_count(self) -> int:
        return int(sum(math.prod(p.shape) for p in _leaves(self.schema())))

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: shared + top-k routed experts
        only) — the N in MODEL_FLOPS = 6*N*D."""
        total = self.param_count()
        cfg = self.cfg
        if isinstance(cfg, moe.MixtralConfig):
            expert = 3 * cfg.d_model * cfg.d_ff  # swiglu expert
            return total - cfg.n_layers * (cfg.n_experts - cfg.top_k) * expert
        if isinstance(cfg, deepseek.DeepSeekConfig):
            expert = 3 * cfg.d_model * cfg.d_ff_expert  # layer 0 is dense
            return total - (cfg.n_layers - 1) * (cfg.n_experts - cfg.top_k) * expert
        return total

    def init(self, seed: int = 0, *, device=None) -> torch.nn.Module:
        """Weights drawn from a ``torch.Generator`` seeded with ``seed`` on
        ``device`` (default cuda)."""
        device = resolve_device(device)
        generator = torch.Generator(device=device).manual_seed(int(seed))
        return self._module.MODEL(self.cfg, device=device, generator=generator)

    def load(self, state_dict: Dict[str, torch.Tensor], *, device=None) -> torch.nn.Module:
        """A model holding ``state_dict`` (e.g. from :mod:`repro_torch.bridge`)."""
        model = self._module.MODEL(self.cfg, device=resolve_device(device))
        model.load_state_dict(state_dict, strict=True)
        return model

    # -- forward --------------------------------------------------------
    def supports_training(self) -> bool:
        """True if the family has a grad-carrying forward (``loss``)."""
        return hasattr(self._module.MODEL, "train_forward")

    def _inputs(self, params, batch: Dict[str, Any]) -> Tuple:
        """The forward's inputs from ``batch``: the tokens, after the audio
        frames for the encoder-decoder, on the model's device."""
        tokens = torch.as_tensor(batch["tokens"], device=params.device)
        if self.is_encoder_decoder:
            return torch.as_tensor(batch["audio_embed"], device=params.device), tokens
        return (tokens,)

    def logits(self, params, batch: Dict[str, Any]) -> torch.Tensor:
        out = params(*self._inputs(params, batch))
        return out[0] if self.has_moe_stats else out

    def loss(self, params, batch: Dict[str, Any], *, denom=None) -> Tuple[torch.Tensor, Dict]:
        """Token-level CE over ``batch["tokens"]``/``["labels"]`` (and the
        encoder-decoder's ``["audio_embed"]``), carrying
        gradients, with the optional per-sample ``weights`` (B,) — the
        Eq. (9) hook: pads weigh 0 and the mean runs over the weighted
        tokens.  MoE adds ``MOE_LB_WEIGHT * lb_loss + MOE_Z_WEIGHT *
        z_loss`` and returns its stats in ``aux``; ``aux["ce_loss"]`` is the
        total, as in the reference.  Every ported family has a
        grad-carrying forward; a model without one raises."""
        train_forward = getattr(params, "train_forward", None)
        if train_forward is None:
            raise NotImplementedError(f"{self.arch_id} ({self.family}) does not train yet")
        inputs = self._inputs(params, batch)
        labels = torch.as_tensor(batch["labels"], device=params.device)
        weights = batch.get("weights")
        if weights is not None:
            weights = torch.as_tensor(weights, device=params.device)
        aux: Dict[str, torch.Tensor] = {}
        if self.has_moe_stats:
            logits, stats = train_forward(*inputs)
            aux.update(stats)
        else:
            logits = train_forward(*inputs)
        loss = _token_loss(logits, labels, weights, denom)
        if self.has_moe_stats:
            loss = loss + MOE_LB_WEIGHT * aux["lb_loss"] + MOE_Z_WEIGHT * aux["z_loss"]
        aux["ce_loss"] = loss
        return loss, aux

    # -- serving --------------------------------------------------------
    def init_cache(self, batch: int, seq_len: int, dtype=None, *, device=None):
        # None defers to the config's compute dtype, which is what
        # decode_step writes into the cache.
        return self._module.init_cache(
            self.cfg, batch, seq_len, dtype, device=resolve_device(device)
        )

    def decode_step(self, params, cache, tokens, pos):
        return params.decode_step(cache, tokens, pos)

    def supports_prefill(self) -> bool:
        """True if the family has a fused full-sequence prefill (one forward
        pass fills the KV cache); otherwise callers step the decode loop."""
        return hasattr(self._module.MODEL, "prefill")

    def prefill(self, params, cache, tokens):
        """Fused prompt ingestion: (logits (B, S, V), cache at pos=S)."""
        if not self.supports_prefill():
            raise NotImplementedError(
                f"{self.arch_id} ({self.family}) has no fused prefill; "
                "use the stepped decode_step loop"
            )
        return params.prefill(cache, tokens)


FAMILIES = {
    dense.DenseConfig: dense,
    moe.MixtralConfig: moe,
    deepseek.DeepSeekConfig: deepseek,
    rwkv6.RWKV6Config: rwkv6,
    hymba.HymbaConfig: hymba,
    whisper.WhisperConfig: whisper,
}


def build_api(arch_id: str, cfg: Any) -> ModelApi:
    module = FAMILIES.get(type(cfg))
    if module is None:
        raise TypeError(f"config type {type(cfg).__name__} is not ported yet")
    return ModelApi(arch_id, cfg, cfg.family, module)
