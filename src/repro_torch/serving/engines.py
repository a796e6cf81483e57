"""Decode engines behind the serving runtime: simulated and real.

The queue/allocator/metrics layers are identical whether ticks are
*simulated* from per-node cost laws (heterogeneous clusters on one host) or
*measured* from real PyTorch decode steps on the card.

An engine implements three calls, all per node:

* ``prefill(node, admitted)`` — build each admitted request's KV cache over
  its context (prompt + any tokens generated before a requeue) and emit its
  next token; returns the seconds spent.
* ``decode(node, actives)`` — one continuous-batching tick: every active
  request gains one token; returns the tick seconds (what the allocator's
  ``(batch, tick_time)`` refit telemetry observes).
* ``release(ar)`` — the request left the node (completed / requeued);
  drop its cache.

:class:`SimServingEngine` is a verbatim copy of the reference's: token
values are a pure function of (rid, step) and times come from ground-truth
coefficient laws, so same-seed runs are bit-identical to the JAX package's.
:class:`RealServingEngine` runs batch-1 slot caches through the port's
``init_cache``/``decode_step`` and the fused ``prefill``, whose attention
is the Hopper flash-attention kernel on the card.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Protocol, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.serving.queue import ActiveRequest

__all__ = [
    "ServingEngine",
    "SimServingEngine",
    "RealServingEngine",
    "prefill_cache",
]


class ServingEngine(Protocol):
    vocab: int

    def prefill(self, node: int, admitted: List[ActiveRequest]) -> float: ...

    def decode(self, node: int, actives: List[ActiveRequest]) -> float: ...

    def release(self, ar: ActiveRequest) -> None: ...


def _sim_token(rid: int, step: int, vocab: int) -> int:
    """Deterministic stand-in token stream (no model in the simulator)."""
    return (rid * 1000003 + step * 7919) % max(vocab, 1)


class SimServingEngine:
    """Tick times from ground-truth per-node linear cost laws.

    ``coeffs[node] = (alpha, c)``: a decode tick over ``b`` active slots
    takes ``alpha * b + c`` seconds; a prefill over ``P`` total context
    tokens takes ``alpha * P * prefill_factor + c`` (prefill processes the
    whole sequence in one fused pass, hence the < 1 factor).
    ``set_speed(node, factor)`` rescales a node mid-run — the capacity-drift
    vehicle the allocator's refit path is tested against.
    """

    def __init__(
        self,
        coeffs: Dict[int, Tuple[float, float]],
        *,
        vocab: int = 512,
        prefill_factor: float = 0.25,
    ):
        self._coeffs = {
            int(n): (float(a), float(c)) for n, (a, c) in coeffs.items()
        }
        self.vocab = int(vocab)
        self.prefill_factor = float(prefill_factor)

    def coeffs(self, node: int) -> Tuple[float, float]:
        return self._coeffs[node]

    def set_speed(self, node: int, factor: float) -> None:
        """Make ``node`` ``factor``x faster (slope and intercept divided)."""
        if factor <= 0:
            raise ValueError("speed factor must be positive")
        a, c = self._coeffs[node]
        self._coeffs[node] = (a / factor, c / factor)

    def prefill(self, node: int, admitted: List[ActiveRequest]) -> float:
        if not admitted:
            return 0.0
        a, c = self._coeffs[node]
        ctx = sum(ar.context_len for ar in admitted)
        for ar in admitted:
            ar.tokens.append(_sim_token(ar.rid, len(ar.tokens), self.vocab))
        return a * ctx * self.prefill_factor + c

    def decode(self, node: int, actives: List[ActiveRequest]) -> float:
        if not actives:
            return 0.0
        a, c = self._coeffs[node]
        for ar in actives:
            ar.tokens.append(_sim_token(ar.rid, len(ar.tokens), self.vocab))
        return a * len(actives) + c

    def release(self, ar: ActiveRequest) -> None:  # no per-request state
        return None


# ---------------------------------------------------------------------------
# Real engine: the port's models under the serving path
# ---------------------------------------------------------------------------


def prefill_cache(api, params, cache, tokens):
    """Prefill ``cache`` over ``tokens`` (B, S): fused where the family
    supports it, stepped single-token loop otherwise.

    Returns ``(logits_last, cache)`` where ``logits_last`` is (B, 1, V) for
    the final prompt position — argmax it for the first generated token.
    """
    if api.supports_prefill():
        logits, cache = api.prefill(params, cache, tokens)
        return logits[:, -1:], cache
    logits = None
    for pos in range(tokens.shape[1]):
        logits, cache = api.decode_step(params, cache, tokens[:, pos : pos + 1], pos)
    return logits[:, -1:], cache


class RealServingEngine:
    """Continuous batching over real batch-1 slot caches on one device.

    Each active request owns a ``(batch=1, max_len)`` KV cache; a decode
    tick steps every active slot once through ``decode_step`` and the tick
    time is the *measured* wall time — real telemetry into the same
    allocator refit path the simulator feeds.  Prefill goes through
    :func:`prefill_cache` (fused full-sequence where supported).

    Each slot's last token stays on the device between steps, and a tick
    reads all its new tokens back in one transfer at its end; that read
    waits for the device, so a tick's time covers the device work it
    queued.  "Nodes" share this device — heterogeneous speed classes are
    the simulator's job.
    """

    def __init__(self, api, params, *, max_len: int = 256,
                 prompts: Optional[Dict[int, np.ndarray]] = None, device=None):
        self.device = resolve_device(device)
        if params.device != self.device:
            raise ValueError(f"params live on {params.device}, engine device is {self.device}")
        self.api = api
        self.params = params
        self.vocab = int(api.cfg.vocab)
        self.max_len = int(max_len)
        self._prompts = prompts or {}
        self._slots: Dict[int, dict] = {}  # rid -> {"cache", "pos", "last"}

    def _context_tokens(self, ar: ActiveRequest) -> np.ndarray:
        prompt = self._prompts.get(ar.rid)
        if prompt is None:
            prompt = ar.request.prompt_tokens(self.vocab)
        return np.concatenate(
            [np.asarray(prompt, np.int64), np.asarray(ar.tokens, np.int64)]
        )

    def _emit(self, actives: List[ActiveRequest], lasts: List[torch.Tensor]) -> None:
        """One device->host read for the whole tick."""
        for ar, tok in zip(actives, torch.cat(lasts).view(-1).tolist()):
            ar.tokens.append(int(tok))

    def prefill(self, node: int, admitted: List[ActiveRequest]) -> float:
        t0 = time.perf_counter()
        lasts = []
        for ar in admitted:
            ctx = self._context_tokens(ar)
            total = ar.request.prompt_len + ar.request.gen_len
            if total > self.max_len:
                raise ValueError(
                    f"request {ar.rid} needs {total} positions > max_len {self.max_len}"
                )
            cache = self.api.init_cache(1, self.max_len, device=self.device)
            toks = torch.as_tensor(ctx[None, :], device=self.device)
            logits, cache = prefill_cache(self.api, self.params, cache, toks)
            last = torch.argmax(logits[:, -1], dim=-1, keepdim=True)  # (1, 1)
            lasts.append(last)
            self._slots[ar.rid] = {"cache": cache, "pos": len(ctx), "last": last}
        if admitted:
            self._emit(admitted, lasts)
        return time.perf_counter() - t0

    def decode(self, node: int, actives: List[ActiveRequest]) -> float:
        t0 = time.perf_counter()
        lasts = []
        for ar in actives:
            slot = self._slots[ar.rid]
            logits, cache = self.api.decode_step(
                self.params, slot["cache"], slot["last"], slot["pos"]
            )
            last = torch.argmax(logits[:, -1], dim=-1, keepdim=True)
            lasts.append(last)
            self._slots[ar.rid] = {"cache": cache, "pos": slot["pos"] + 1, "last": last}
        if actives:
            self._emit(actives, lasts)
        return time.perf_counter() - t0

    def release(self, ar: ActiveRequest) -> None:
        self._slots.pop(ar.rid, None)
