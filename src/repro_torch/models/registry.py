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
  api.specs(rules)                           -> {state_dict name: spec}
  api.cache_specs(rules, batch, seq_len)     -> {cache name: spec}
  api.train_batch_specs(batch, seq)          -> {name: (shape, dtype)}
  api.batch_sharding(rules, batch_specs)     -> {name: spec}

A spec is :meth:`repro_torch.sharding.rules.MeshRules.spec`'s tuple, what
the reference's ``PartitionSpec`` holds.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.bridge import is_stack
from repro_torch.models import common, deepseek, dense, hymba, moe, rwkv6, whisper
from repro_torch.models.common import Param
from repro_torch.sharding.rules import MeshRules

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


def _flat(tree, prefix: str = ""):
    """(dotted name, leaf) pairs of a nested dict."""
    for key, sub in tree.items():
        if isinstance(sub, dict):
            yield from _flat(sub, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", sub


def _unrolled(schema, specs) -> Dict[str, Tuple]:
    """``specs`` (a tree matching ``schema``) by the port's state_dict
    names: each stack's leaf once per layer (``layers.<i>.attn.wq``), its
    leading (replicated) layer dim dropped, as :mod:`repro_torch.bridge`
    unrolls the weights."""
    out: Dict[str, Tuple] = {}
    for key in schema:
        if not is_stack(key):
            out.update(_flat({key: specs[key]}))
            continue
        leaves = dict(_flat(schema[key]))
        for name, spec in _flat(specs[key]):
            if spec and spec[0] is not None:
                raise ValueError(f"{key}.{name}: the layer dim must stay replicated, got {spec}")
            for i in range(leaves[name].shape[0]):
                out[f"{key}.{i}.{name}"] = tuple(spec[1:])
    return out


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

    def specs(self, rules: MeshRules) -> Dict[str, Tuple]:
        """Each parameter's spec by its state_dict name: the reference's
        ``api.specs(rules)`` (resolved on the stacked schema, so the
        fallback records are the reference's) with each layer's leading
        dim dropped."""
        schema = self.schema()
        return _unrolled(schema, common.specs_from_schema(schema, rules))

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

    def supports_long_context(self) -> bool:
        """True if decode over 500k positions is sub-quadratic / bounded-cache."""
        if self.family in ("ssm", "hybrid"):
            return True
        if self.arch_id.startswith("whisper"):
            return False
        cfg = self.cfg
        if getattr(cfg, "decode_window", None) is not None:
            return True
        if isinstance(cfg, deepseek.DeepSeekConfig):
            return True  # MLA latent cache: 576 floats/token
        return False

    def cache_logical_axes(self) -> Dict[str, Tuple]:
        """Logical axes per cache leaf name (leading dim = stacked layers)."""
        if self.arch_id.startswith("whisper"):
            kv = (None, "batch", "cache_seq", "heads", None)
            return {"k": kv, "v": kv, "cross_k": kv, "cross_v": kv, "pos": ()}
        if self.family == "ssm":  # rwkv6
            return {
                "wkv": (None, "batch", "heads", None, None),
                "time_shift": (None, "batch", None),
                "chan_shift": (None, "batch", None),
                "pos": (),
            }
        if self.family == "hybrid":  # hymba
            kv = (None, "batch", "cache_seq", "kv_heads", None)
            return {
                "k": kv,
                "v": kv,
                "ssm": (None, "batch", "ssm_inner", None),
                "conv": (None, "batch", None, "ssm_inner"),
                "pos": (),
            }
        if isinstance(self.cfg, deepseek.DeepSeekConfig):
            return {
                "c": (None, "batch", "cache_seq", None),
                "kr": (None, "batch", "cache_seq", None),
                "pos": (),
            }
        kv = (None, "batch", "cache_seq", "kv_heads", None)
        return {"k": kv, "v": kv, "pos": ()}

    def cache_specs(self, rules: MeshRules, batch: int, seq_len: int) -> Dict[str, Tuple]:
        """Spec per decode-cache leaf (divisibility-checked), from the
        cache's shapes on the meta device; the host-int ``pos`` is a
        scalar.  Resolved in the reference's (sorted) order."""
        shapes = {name: tuple(getattr(x, "shape", ()))
                  for name, x in self.init_cache(batch, seq_len, device="meta").items()}
        axes = self.cache_logical_axes()
        return {
            name: rules.spec(axes[name], shapes[name], path=f"cache/{name}")
            for name in sorted(shapes)
        }

    # -- dry-run input specs --------------------------------------------
    def train_batch_specs(self, batch: int, seq: int) -> Dict[str, Tuple[Tuple, torch.dtype]]:
        """``{name: (shape, dtype)}`` of a training batch; the
        encoder-decoder's text is ``max(seq // 4, 8)`` tokens against
        ``seq`` audio frames, as in the reference."""
        if self.is_encoder_decoder:
            st = max(seq // 4, 8)
            return {
                "audio_embed": ((batch, seq, self.cfg.d_model), torch.bfloat16),
                "tokens": ((batch, st), torch.int32),
                "labels": ((batch, st), torch.int32),
                "weights": ((batch,), torch.float32),
            }
        return {
            "tokens": ((batch, seq), torch.int32),
            "labels": ((batch, seq), torch.int32),
            "weights": ((batch,), torch.float32),
        }

    def batch_sharding(self, rules: MeshRules, specs: Dict[str, Any]) -> Dict[str, Tuple]:
        """The batch spec of each input: its leading dim over the batch
        axes.  ``specs`` holds ``(shape, dtype)`` pairs or tensors."""
        out = {}
        for name, sd in specs.items():
            shape = sd.shape if hasattr(sd, "shape") else sd[0]
            out[name] = rules.batch_spec(extra_dims=len(shape) - 1)
        return out


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
