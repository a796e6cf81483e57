"""Optimizers on dicts (or lists) of tensors — the port's parameter trees.

The counterpart of ``repro/optim/optimizers.py``: SGD with momentum and
AdamW, the schedules, and the ``lr_scale`` hook Cannikin's per-epoch LR
rule uses.  Parameters may be bf16; moments and the update math run in
float32 and the result is cast back to the parameter's dtype, with the
reference's formulas.

Unlike the reference (pure functions on immutable pytrees), ``update``
writes the new parameters and moments in place under ``torch.no_grad()``,
so a full-width model keeps one copy of each.  It returns the same
parameter tree and a new state tuple (the step count is a host int).
Schedules return float32 learning rates, as the reference's do.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator, Mapping, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

Tree = Union[Mapping[str, torch.Tensor], Sequence[torch.Tensor]]

__all__ = [
    "Optimizer",
    "SGDState",
    "AdamWState",
    "sgd",
    "adamw",
    "cosine_schedule",
    "constant_schedule",
    "global_norm",
    "clip_by_global_norm",
]


def _leaves(tree: Tree):
    return list(tree.values()) if isinstance(tree, Mapping) else list(tree)


def _map(fn: Callable, tree: Tree) -> Tree:
    if isinstance(tree, Mapping):
        return {key: fn(x) for key, x in tree.items()}
    return [fn(x) for x in tree]


def _zip(tree: Tree, *others: Tree) -> Iterator[Tuple[torch.Tensor, ...]]:
    """Leaves of ``tree`` with the matching leaves of ``others`` (by key
    for dicts, by position for lists)."""
    if isinstance(tree, Mapping):
        for key, x in tree.items():
            yield (x,) + tuple(o[key] for o in others)
    else:
        yield from zip(tree, *others)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """(init, update) pair.  update(grads, state, params, lr_scale) ->
    (params, new_state), parameters updated in place.  ``lr_scale`` is the
    Cannikin/AdaScale per-epoch multiplier."""

    init: Callable[[Tree], Any]
    update: Callable[[Tree, Any, Tree, float], Tuple[Tree, Any]]
    name: str = "optimizer"


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 squares (a 0-dim tensor on
    the leaves' device)."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in _leaves(tree)))


def clip_by_global_norm(tree: Tree, max_norm: float) -> Tuple[Tree, torch.Tensor]:
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return _map(lambda x: x * scale.to(x.dtype), tree), norm


def constant_schedule(lr: float) -> Callable[[int], np.float32]:
    return lambda step: np.float32(lr)


def cosine_schedule(
    lr: float, warmup_steps: int, total_steps: int, min_ratio: float = 0.1
) -> Callable[[int], np.float32]:
    def fn(step: int) -> np.float32:
        step = np.float32(step)
        warm = step / np.float32(max(warmup_steps, 1))
        frac = np.clip(
            (step - np.float32(warmup_steps)) / np.float32(max(total_steps - warmup_steps, 1)),
            np.float32(0.0), np.float32(1.0),
        )
        cos = np.float32(min_ratio) + np.float32((1 - min_ratio) * 0.5) * (
            np.float32(1.0) + np.cos(np.float32(np.pi) * frac))
        return np.float32(lr) * (warm if step < warmup_steps else cos)

    return fn


def _lr(schedule: Callable[[int], Any], step: int, lr_scale: float) -> float:
    """schedule(step) * lr_scale in float32, as a host float."""
    return float(np.float32(schedule(step)) * np.float32(lr_scale))


class SGDState(NamedTuple):
    momentum: Tree
    step: int


def sgd(
    schedule: Callable[[int], Any],
    momentum: float = 0.9,
    weight_decay: float = 0.0,
    max_grad_norm: Optional[float] = 1.0,
) -> Optimizer:
    def init(params: Tree) -> SGDState:
        return SGDState(
            momentum=_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                          params),
            step=0,
        )

    @torch.no_grad()
    def update(grads: Tree, state: SGDState, params: Tree, lr_scale: float = 1.0):
        if max_grad_norm is not None:
            grads, _ = clip_by_global_norm(grads, max_grad_norm)
        lr = _lr(schedule, state.step, lr_scale)
        for p, g, m in _zip(params, grads, state.momentum):
            g32 = g.float()
            if weight_decay:
                g32 = g32 + weight_decay * p.float()
            m.mul_(momentum).add_(g32)          # m_new = momentum * m + g32
            p.copy_(p.float() - lr * m)         # p32 - lr * m_new, cast back
        return params, SGDState(momentum=state.momentum, step=state.step + 1)

    return Optimizer(init=init, update=update, name="sgd")


class AdamWState(NamedTuple):
    m: Tree
    v: Tree
    step: int


def adamw(
    schedule: Callable[[int], Any],
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    max_grad_norm: Optional[float] = 1.0,
) -> Optimizer:
    def init(params: Tree) -> AdamWState:
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

        return AdamWState(m=_map(zeros, params), v=_map(zeros, params), step=0)

    @torch.no_grad()
    def update(grads: Tree, state: AdamWState, params: Tree, lr_scale: float = 1.0):
        if max_grad_norm is not None:
            grads, _ = clip_by_global_norm(grads, max_grad_norm)
        step = state.step + 1
        lr = _lr(schedule, state.step, lr_scale)
        bc1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(step))
        bc2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(step))
        for p, g, m, v in _zip(params, grads, state.m, state.v):
            g32 = g.float()
            m.mul_(b1).add_((1 - b1) * g32)
            v.mul_(b2).add_((1 - b2) * g32 * g32)
            p32 = p.float()
            p.copy_(p32 - lr * ((m / bc1) / (torch.sqrt(v / bc2) + eps) + weight_decay * p32))
        return params, AdamWState(m=state.m, v=state.v, step=step)

    return Optimizer(init=init, update=update, name="adamw")
