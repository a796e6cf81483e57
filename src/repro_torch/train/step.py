"""Train / serve step builders (PyTorch).

The counterpart of ``repro/train/step.py``.  :func:`build_train_step`
returns the step the ``--mode spmd`` launcher runs: forward and backward
(with optional gradient accumulation over microbatches in float32), then
one optimizer update.  Per-sample weights flow through the loss, so one
step over the padded-uneven global batch realizes the paper's Eq. (9)
weighted aggregation exactly (see ``core/aggregation.py``).

Gradient accumulation normalizes every microbatch by the *global* weight
sum, so the accumulated gradient equals the unaccumulated one in exact
arithmetic.

``params`` is the model (an ``nn.Module`` whose parameters require
grad); the optimizer updates it in place, as everywhere in the port.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.models.registry import ModelApi
from repro_torch.optim.optimizers import Optimizer, global_norm

__all__ = [
    "build_train_step",
    "build_serve_step",
    "build_prefill_step",
    "node_step_specs",
]


def node_step_specs(rules) -> Dict[str, Any]:
    """Specs for the RealBackend's padded per-node batch layout.

    The sharded per-node step lays data out as (n, b_max, seq) with the
    leading node dim split over the ``nodes`` axis; params and the
    per-node ratio/validity vectors that feed ``guard_weights`` stay
    replicated (the guard needs the full (n,) view on every shard).
    """
    return {
        "tokens": rules.spec(["nodes", None, None]),
        "labels": rules.spec(["nodes", None, None]),
        "mask": rules.spec(["nodes", None]),
        "node_vec": rules.spec(["nodes"]),
        "replicated": rules.spec([]),
    }


def _global_denom(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    labels = batch["labels"]
    weights = batch.get("weights")
    if weights is not None:
        return torch.clamp(weights.sum().float(), min=1e-9)
    return torch.tensor(labels.numel() / labels.shape[-1], dtype=torch.float32,
                        device=labels.device)


def build_train_step(
    api: ModelApi,
    optimizer: Optimizer,
    *,
    microbatches: int = 1,
    with_metrics: bool = True,
    microbatch_shardings: Optional[Dict[str, Any]] = None,
) -> Callable:
    """Returns step(params, opt_state, batch, lr_scale) ->
    (params, opt_state, metrics).

    ``microbatch_shardings`` is the reference's GSPMD layout hint for each
    microbatch; it has no meaning for a model on one device, and any value
    but ``None`` raises until the dry run is ported (ROADMAP §1.9).
    """
    if microbatch_shardings is not None:
        raise NotImplementedError(
            "microbatch_shardings is a GSPMD layout hint; the port has no "
            "counterpart until the dry run (ROADMAP §1.9)"
        )

    def step(params, opt_state, batch, lr_scale=1.0):
        named = dict(params.named_parameters())
        leaves = list(named.values())
        batch = {k: torch.as_tensor(v, device=params.device) for k, v in batch.items()}
        seq = batch["labels"].shape[-1]
        denom = _global_denom(batch) * seq

        if microbatches == 1:
            loss, aux = api.loss(params, batch, denom=denom)
            grads = dict(zip(named, torch.autograd.grad(loss, leaves)))
            loss = loss.detach()
            aux = {k: v.detach() for k, v in aux.items()}
        else:
            def reshape(x):
                b = x.shape[0]
                if b % microbatches:
                    raise ValueError(
                        f"batch {b} not divisible by microbatches {microbatches}"
                    )
                return x.reshape((microbatches, b // microbatches) + tuple(x.shape[1:]))

            mbs = {k: reshape(v) for k, v in batch.items()}
            grads = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                     for k, p in named.items()}
            loss = torch.zeros((), dtype=torch.float32, device=params.device)
            auxs = []
            for m in range(microbatches):
                mb_loss, mb_aux = api.loss(params, {k: v[m] for k, v in mbs.items()},
                                           denom=denom)
                for acc, g in zip(grads.values(), torch.autograd.grad(mb_loss, leaves)):
                    acc.add_(g.float())
                loss = loss + mb_loss.detach()
                auxs.append({k: v.detach() for k, v in mb_aux.items()})
            aux = {k: torch.stack([a[k] for a in auxs]).mean() for k in auxs[0]}

        _, new_opt = optimizer.update(grads, opt_state, named, lr_scale)
        metrics = {"loss": loss}
        if with_metrics:
            metrics["grad_norm"] = global_norm(grads)
            metrics.update({f"aux/{k}": v for k, v in aux.items()})
        return params, new_opt, metrics

    return step


def build_serve_step(api: ModelApi) -> Callable:
    """One-token decode: step(params, cache, tokens, pos) -> (logits, cache)."""

    def step(params, cache, tokens, pos):
        return api.decode_step(params, cache, tokens, pos)

    return step


def build_prefill_step(api: ModelApi) -> Callable:
    """Full-sequence forward (no loss): step(params, batch) -> logits."""

    def step(params, batch):
        return api.logits(params, batch)

    return step
