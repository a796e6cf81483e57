"""Latency/throughput accounting shared by the serving runtime and bench.

All statistics derive from per-request :class:`RequestRecord` rows and
per-token timestamps, computed with plain NumPy so the same-seed serving
runs the determinism gates compare are bit-identical all the way through the
summary — :meth:`ServingMetrics.fingerprint` hashes the canonical record
stream for exactly that purpose.

Vocabulary:

* **sustained req/s** — completed requests / elapsed time;
* **token latency** — the gap between consecutive generated tokens of one
  request (the decode-tick time a request experiences); p50/p95/p99 are
  reported over all gaps of all requests;
* **TTFT** — arrival -> first generated token;
* **goodput** — completed requests that met their deadline, per second (the
  serving analogue of the trainer's statistically-efficient throughput);
* **utilization** — per-node busy time / elapsed.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Optional, Sequence

import numpy as np

__all__ = ["RequestRecord", "ServingMetrics", "percentiles"]


@dataclasses.dataclass
class RequestRecord:
    """Lifecycle timestamps of one request (simulated or wall seconds)."""

    rid: int
    arrival: float
    deadline: float
    gen_len: int
    prompt_len: int
    admitted: Optional[float] = None
    first_token: Optional[float] = None
    finished: Optional[float] = None
    node: int = -1                # node that completed it
    requeues: int = 0
    token_times: List[float] = dataclasses.field(default_factory=list)

    @property
    def completed(self) -> bool:
        return self.finished is not None

    @property
    def met_deadline(self) -> bool:
        return self.completed and self.finished <= self.deadline

    @property
    def ttft(self) -> Optional[float]:
        if self.first_token is None:
            return None
        return self.first_token - self.arrival

    def token_gaps(self) -> List[float]:
        ts = self.token_times
        return [b - a for a, b in zip(ts, ts[1:])]


def percentiles(values: Sequence[float], qs=(50.0, 95.0, 99.0)) -> Dict[str, float]:
    """Deterministic linear-interpolation percentiles; NaN on empty input."""
    if len(values) == 0:
        return {f"p{q:g}": float("nan") for q in qs}
    arr = np.asarray(sorted(values), dtype=np.float64)
    return {f"p{q:g}": float(np.percentile(arr, q)) for q in qs}


class ServingMetrics:
    """Accumulates request lifecycles, queue-depth samples, node busy time."""

    def __init__(self) -> None:
        self._records: Dict[int, RequestRecord] = {}
        self._queue_samples: List[int] = []
        self._busy: Dict[int, float] = {}
        self.started_at = 0.0
        self.finished_at = 0.0

    # -- recording ---------------------------------------------------------

    def on_arrival(self, rid: int, arrival: float, deadline: float,
                   prompt_len: int, gen_len: int) -> None:
        if rid in self._records:
            raise ValueError(f"request {rid} recorded twice")
        self._records[rid] = RequestRecord(
            rid=rid, arrival=arrival, deadline=deadline,
            gen_len=gen_len, prompt_len=prompt_len,
        )

    def on_admit(self, rid: int, now: float) -> None:
        rec = self._records[rid]
        if rec.admitted is None:  # first admission only; requeues re-admit
            rec.admitted = now

    def on_token(self, rid: int, now: float) -> None:
        rec = self._records[rid]
        if rec.first_token is None:
            rec.first_token = now
        rec.token_times.append(now)

    def on_complete(self, rid: int, now: float, node: int, requeues: int) -> None:
        rec = self._records[rid]
        if rec.finished is not None:
            raise ValueError(f"request {rid} completed twice")
        rec.finished = now
        rec.node = node
        rec.requeues = requeues
        self.finished_at = max(self.finished_at, now)

    def on_queue_sample(self, depth: int) -> None:
        self._queue_samples.append(int(depth))

    def on_node_busy(self, node: int, seconds: float) -> None:
        self._busy[node] = self._busy.get(node, 0.0) + float(seconds)

    # -- views -------------------------------------------------------------

    def records(self) -> List[RequestRecord]:
        return [self._records[rid] for rid in sorted(self._records)]

    @property
    def completed(self) -> int:
        return sum(1 for r in self._records.values() if r.completed)

    @property
    def total(self) -> int:
        return len(self._records)

    def elapsed(self) -> float:
        return max(self.finished_at - self.started_at, 0.0)

    def summary(self, elapsed: Optional[float] = None) -> Dict[str, object]:
        recs = self.records()
        done = [r for r in recs if r.completed]
        span = float(elapsed) if elapsed is not None else self.elapsed()
        span = max(span, 1e-12)
        gaps: List[float] = []
        ttfts: List[float] = []
        for r in done:
            gaps.extend(r.token_gaps())
            if r.ttft is not None:
                ttfts.append(r.ttft)
        tokens = sum(len(r.token_times) for r in recs)
        misses = sum(1 for r in done if not r.met_deadline)
        out: Dict[str, object] = {
            "requests": len(recs),
            "completed": len(done),
            "dropped": len(recs) - len(done),
            "elapsed_s": span,
            "sustained_req_s": len(done) / span,
            "goodput_req_s": sum(1 for r in done if r.met_deadline) / span,
            "token_throughput_s": tokens / span,
            "deadline_misses": misses,
            "deadline_miss_rate": misses / len(done) if done else float("nan"),
            "requeues": sum(r.requeues for r in recs),
            "mean_queue_depth": (
                float(np.mean(self._queue_samples)) if self._queue_samples else 0.0
            ),
            "max_queue_depth": max(self._queue_samples, default=0),
            "node_utilization": {
                node: self._busy[node] / span for node in sorted(self._busy)
            },
        }
        out["token_latency"] = percentiles(gaps)
        out["ttft"] = percentiles(ttfts)
        return out

    def fingerprint(self) -> str:
        """sha256 over the canonical per-request record stream — two serving
        runs are bit-identical iff their fingerprints match."""
        h = hashlib.sha256()
        for r in self.records():
            h.update(
                repr((
                    r.rid, r.arrival, r.deadline, r.prompt_len, r.gen_len,
                    r.admitted, r.first_token, r.finished, r.node,
                    r.requeues, tuple(r.token_times),
                )).encode()
            )
        h.update(repr(tuple(self._queue_samples)).encode())
        h.update(repr(sorted(self._busy.items())).encode())
        return h.hexdigest()
