"""Seeded deterministic request / load-generator layer.

Serving traffic is described the same way :func:`repro.runtime.trace.
synthetic_trace` describes training churn: every random draw comes from ONE
``np.random.default_rng(seed)`` stream, so a workload is a pure function of
its parameters — two runs with the same seed see byte-identical requests,
which is what makes the serving bit-identity gates assertable.

Laws:

* **Arrivals** — ``"poisson"`` (exponential inter-arrival times, rate
  ``rate`` req/s) or ``"bursty"`` (a Markov-modulated Poisson process:
  alternating ON/OFF phases with exponential durations; the ON phase runs at
  ``burst_factor`` x the base rate, the OFF phase at ``rate / burst_factor``
  — the flash-crowd shape real inference traffic shows).
* **Lengths** — prompt and generation lengths are log-normal (the
  heavy-tailed law of production prompt logs), clipped into
  ``[min, max]`` bounds so caches stay allocatable.
* **Deadlines** — per-request completion deadline
  ``arrival + ttft_slack + gen_len * token_budget``: a fixed
  time-to-first-token allowance plus a per-generated-token latency budget
  (the SLO the goodput accounting scores misses against).

Prompt *token values* are not drawn here: they are derived lazily per
request id (:meth:`Request.prompt_tokens`) or streamed from the training
data pipeline (:func:`prompts_from_stream`), so generating a million-request
workload costs O(n) scalars, not O(n * prompt_len) tokens.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

__all__ = ["Request", "Workload", "generate_requests", "prompts_from_stream"]

ARRIVALS = ("poisson", "bursty")


@dataclasses.dataclass(frozen=True)
class Request:
    """One inference request: fixed at generation time, immutable after."""

    rid: int
    arrival: float          # seconds (simulated or wall-relative)
    prompt_len: int
    gen_len: int
    deadline: float         # absolute completion deadline
    seed: int = 0           # workload seed; with rid keys the token stream

    def prompt_tokens(self, vocab: int) -> np.ndarray:
        """Deterministic prompt tokens, keyed by (workload seed, rid)."""
        rng = np.random.default_rng((self.seed, self.rid))
        return rng.integers(0, vocab, size=self.prompt_len, dtype=np.int32)


@dataclasses.dataclass(frozen=True)
class Workload:
    """A generated request set plus the law parameters that produced it."""

    requests: tuple
    seed: int
    arrival: str
    rate: float

    def __iter__(self):
        return iter(self.requests)

    def __len__(self) -> int:
        return len(self.requests)

    @property
    def duration(self) -> float:
        """Arrival span (seconds) — offered load = len / duration."""
        if not self.requests:
            return 0.0
        return float(self.requests[-1].arrival)

    @property
    def offered_load(self) -> float:
        span = self.duration
        return len(self.requests) / span if span > 0 else float("inf")


def _clipped_lognormal(
    rng: np.random.Generator, mean: float, sigma: float, lo: int, hi: int
) -> int:
    """One clipped log-normal length draw around ``mean`` (the median)."""
    return int(np.clip(round(mean * float(rng.lognormal(0.0, sigma))), lo, hi))


def generate_requests(
    n_requests: int,
    *,
    seed: int = 0,
    rate: float = 10.0,
    arrival: str = "poisson",
    burst_factor: float = 4.0,
    burst_len: float = 2.0,
    idle_len: float = 4.0,
    prompt_mean: int = 24,
    prompt_sigma: float = 0.6,
    prompt_min: int = 4,
    prompt_max: int = 256,
    gen_mean: int = 12,
    gen_sigma: float = 0.6,
    gen_min: int = 1,
    gen_max: int = 128,
    ttft_slack: float = 2.0,
    token_budget: float = 0.5,
) -> Workload:
    """The canonical seeded serving workload (see module docstring).

    All draws come from one RNG in a fixed order (per request: inter-arrival
    gap, prompt length, generation length), so a workload is reproducible
    from ``(n_requests, seed, law parameters)`` alone.
    """
    if arrival not in ARRIVALS:
        raise ValueError(f"unknown arrival law {arrival!r}; one of {ARRIVALS}")
    if rate <= 0:
        raise ValueError("rate must be positive")
    if n_requests < 0:
        raise ValueError("n_requests must be >= 0")
    rng = np.random.default_rng(seed)
    requests: List[Request] = []
    t = 0.0
    # Bursty state: phase end time + current phase rate.  Phase lengths are
    # exponential so the process is Markov-modulated; the first phase is ON
    # (bursts lead, the worst case for admission).
    on = True
    phase_end = float(rng.exponential(burst_len)) if arrival == "bursty" else np.inf
    for rid in range(n_requests):
        if arrival == "poisson":
            gap = float(rng.exponential(1.0 / rate))
        else:
            cur_rate = rate * burst_factor if on else rate / burst_factor
            gap = float(rng.exponential(1.0 / cur_rate))
            # Phase switches consume the gap deterministically: cross as many
            # boundaries as the gap spans, re-drawing the residual at the new
            # phase's rate.
            while t + gap >= phase_end:
                carry = phase_end - t
                t = phase_end
                on = not on
                phase_end = t + float(
                    rng.exponential(burst_len if on else idle_len)
                )
                cur_rate = rate * burst_factor if on else rate / burst_factor
                gap = float(rng.exponential(1.0 / cur_rate))
                del carry  # boundary reached; residual re-drawn memorylessly
        t += gap
        p = _clipped_lognormal(rng, prompt_mean, prompt_sigma, prompt_min, prompt_max)
        g = _clipped_lognormal(rng, gen_mean, gen_sigma, gen_min, gen_max)
        requests.append(
            Request(
                rid=rid,
                arrival=t,
                prompt_len=p,
                gen_len=g,
                deadline=t + ttft_slack + g * token_budget,
                seed=seed,
            )
        )
    return Workload(
        requests=tuple(requests), seed=seed, arrival=arrival, rate=rate
    )


def prompts_from_stream(
    stream, requests, *, key: str = "tokens"
) -> Dict[int, np.ndarray]:
    """Draw prompt tokens for ``requests`` from a data-pipeline stream.

    ``stream`` is any iterator of batch dicts (e.g. the bounded-buffer
    :class:`repro.data.pipeline.BoundedStream` over a ``SyntheticLM``) —
    the serving request layer reuses the training pipeline's token source
    instead of inventing its own.  Rows are consumed in request order and
    truncated/tiled to each request's ``prompt_len``; returns
    ``{rid: (prompt_len,) int32 tokens}``.
    """
    out: Dict[int, np.ndarray] = {}
    it = iter(stream)
    batch: Optional[np.ndarray] = None
    row = 0
    for req in requests:
        if batch is None or row >= batch.shape[0]:
            batch = np.asarray(next(it)[key])
            row = 0
        toks = batch[row]
        row += 1
        if toks.shape[0] >= req.prompt_len:
            out[req.rid] = toks[: req.prompt_len].astype(np.int32)
        else:
            reps = -(-req.prompt_len // toks.shape[0])
            out[req.rid] = np.tile(toks, reps)[: req.prompt_len].astype(np.int32)
    return out
