"""The serving runtime: a step-driven event loop over the serving subsystem.

:class:`ServingRuntime` wires the four layers together —

* :mod:`repro_torch.serving.request`   (what arrives, when, with what deadline)
* :mod:`repro_torch.serving.queue`     (who decodes where, at what batch)
* :mod:`repro_torch.serving.allocator` (how many slots each node deserves)
* :mod:`repro_torch.serving.engines`   (what a tick costs / which tokens come out)

— under one deterministic event loop.  Events are ``(time, seq, kind)``
heap entries where ``seq`` is a monotone tie-breaker, so two same-seed runs
process the identical event sequence and the metrics fingerprint matches
bit-for-bit (the determinism gate in ``benchmarks/bench_serving.py``).

A node's life is a chain of *ticks*: admit waiting requests into free
water-fill slots, prefill the newcomers, run one decode step over the whole
active batch, complete finished requests, schedule the next tick at
``now + measured tick time``.  Tick times feed the allocator's refit
telemetry; every ``resolve_every`` seconds the allocator refits and
re-solves, and the scheduler reconciles allocations (evicting the newest
actives where a node shrank — tokens kept, no work lost).

Cluster churn speaks the trainer's event alphabet
(:class:`repro_torch.runtime.events.NodeJoin` / :class:`~repro_torch.runtime.events.
NodeLeave` via :meth:`ServingRuntime.post`): a leaving or quarantined node's
in-flight requests requeue at the queue *front* with their generated tokens,
re-prefill elsewhere (caches rebuilt), and finish — a mid-stream NodeLeave
completes every request with zero drops, which the serving-smoke CI lane
asserts end to end.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Dict, List, Optional, Tuple

from repro_torch.runtime.events import Event, NodeJoin, NodeLeave
from repro_torch.serving.allocator import ServingAllocator
from repro_torch.serving.engines import ServingEngine
from repro_torch.serving.metrics import ServingMetrics
from repro_torch.serving.queue import ActiveRequest, BatchScheduler
from repro_torch.serving.request import Workload

__all__ = ["ServingConfig", "ServingReport", "ServingRuntime"]


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """Loop policy knobs (all deterministic given the same inputs)."""

    total_slots: int = 16
    resolve_every: float = 0.0       # 0 disables periodic refit+re-solve
    max_time: float = math.inf       # hard stop (pending requests -> dropped)
    quarantine_factor: Optional[float] = None  # tick > factor*predicted ...
    quarantine_patience: int = 3               # ... this many times in a row
    rejoin_after: float = 5.0        # quarantined node re-joins after this


@dataclasses.dataclass(frozen=True)
class ServingReport:
    """What a run produced: the summary, the determinism fingerprint, and
    the final cluster shape."""

    summary: Dict[str, object]
    fingerprint: str
    allocations: Dict[int, int]
    counters: Dict[str, int]
    clock: float

    @property
    def sustained_req_s(self) -> float:
        return float(self.summary["sustained_req_s"])

    @property
    def goodput_req_s(self) -> float:
        return float(self.summary["goodput_req_s"])


class ServingRuntime:
    """Deterministic continuous-batching serving loop over one engine."""

    def __init__(
        self,
        engine: ServingEngine,
        allocator: ServingAllocator,
        workload: Workload,
        nodes: List[int],
        config: ServingConfig = ServingConfig(),
        metrics: Optional[ServingMetrics] = None,
    ):
        self.engine = engine
        self.allocator = allocator
        self.config = config
        self.metrics = metrics if metrics is not None else ServingMetrics()
        self.clock = 0.0
        self._arrivals = sorted(workload, key=lambda r: (r.arrival, r.rid))
        self._next_arrival = 0
        self._available: Dict[int, bool] = {int(n): True for n in nodes}
        self._tick_seq: Dict[int, int] = {int(n): 0 for n in nodes}
        self._busy_until: Dict[int, float] = {int(n): 0.0 for n in nodes}
        self._slow_ticks: Dict[int, int] = {int(n): 0 for n in nodes}
        self._heap: List[Tuple[float, int, str, object]] = []
        self._seq = 0
        self.events = {"leaves": 0, "joins": 0, "quarantines": 0, "resolves": 0}
        self.scheduler = BatchScheduler(self.allocator.solve(self._avail()))
        if config.resolve_every > 0:
            self._push(config.resolve_every, "resolve", None)

    # -- event plumbing ----------------------------------------------------

    def _push(self, time: float, kind: str, payload) -> None:
        heapq.heappush(self._heap, (float(time), self._seq, kind, payload))
        self._seq += 1

    def _avail(self) -> List[int]:
        return sorted(n for n, up in self._available.items() if up)

    def post(self, event: Event) -> None:
        """Inject a cluster-churn event (trainer alphabet): NodeJoin/NodeLeave."""
        if isinstance(event, NodeLeave):
            for node in event.nodes:
                self._push(event.time, "leave", int(node))
        elif isinstance(event, NodeJoin):
            for node in event.nodes:
                self._push(event.time, "join", int(node))
        else:
            raise TypeError(
                f"serving runtime only speaks NodeJoin/NodeLeave, got {type(event).__name__}"
            )

    # -- the loop ----------------------------------------------------------

    def run(self) -> ServingReport:
        """Process every arrival and event until the system drains (or
        ``max_time`` / total node loss strands the remainder as dropped)."""
        while True:
            ta = (
                self._arrivals[self._next_arrival].arrival
                if self._next_arrival < len(self._arrivals)
                else math.inf
            )
            te = self._heap[0][0] if self._heap else math.inf
            t = min(ta, te)
            if math.isinf(t) or t > self.config.max_time:
                break
            if ta <= te:
                self._on_arrival(self._arrivals[self._next_arrival])
            else:
                _, _, kind, payload = heapq.heappop(self._heap)
                self.clock = max(self.clock, te)
                if kind == "ready":
                    node, seq = payload
                    if self._available.get(node) and self._tick_seq[node] == seq:
                        self._tick(node)
                elif kind == "leave":
                    self._on_leave(payload)
                elif kind == "join":
                    self._on_join(payload)
                elif kind == "resolve":
                    self._on_resolve()
            if self._drained():
                break
        return self.report()

    def _drained(self) -> bool:
        if self._next_arrival < len(self._arrivals):
            return False
        if not self.scheduler.all_done():
            # Stranded only if nothing can ever make progress again: no
            # events pending and no available node to kick.
            return not self._heap and not self._avail()
        # Work done; churn events may remain but cannot create requests.
        return not any(k == "ready" for _, _, k, _ in self._heap)

    def _on_arrival(self, req) -> None:
        self.clock = max(self.clock, req.arrival)
        self._next_arrival += 1
        self.metrics.on_arrival(
            req.rid, req.arrival, req.deadline, req.prompt_len, req.gen_len
        )
        self.scheduler.enqueue(req)
        self.metrics.on_queue_sample(self.scheduler.queue_depth())
        self._kick_idle()

    def _kick_idle(self) -> None:
        for node in self._avail():
            if self._busy_until[node] <= self.clock:
                self._tick(node)

    def _tick(self, node: int) -> None:
        """One continuous-batching tick on ``node`` at ``self.clock``."""
        now = self.clock
        admitted = self.scheduler.admit(node, now)
        dt_prefill = self.engine.prefill(node, admitted) if admitted else 0.0
        actives = self.scheduler.active(node)
        if not actives:
            return  # idle: next arrival or requeue will kick us again
        decode_list = [ar for ar in actives if not ar.done]
        dt_decode = self.engine.decode(node, decode_list) if decode_list else 0.0
        t_prefill = now + dt_prefill
        t_end = t_prefill + dt_decode
        for ar in admitted:
            self.metrics.on_admit(ar.rid, now)
            self.metrics.on_token(ar.rid, t_prefill)
            if ar.first_token is None:
                ar.first_token = t_prefill
        for ar in decode_list:
            self.metrics.on_token(ar.rid, t_end)
        if decode_list:
            self.allocator.observe(node, len(decode_list), dt_decode)
            self._watch_quarantine(node, len(decode_list), dt_decode, t_end)
        for ar in [a for a in self.scheduler.active(node) if a.done]:
            self.scheduler.complete(ar)
            self.engine.release(ar)
            self.metrics.on_complete(ar.rid, t_end, node, ar.requeues)
        self.metrics.on_node_busy(node, dt_prefill + dt_decode)
        self._busy_until[node] = t_end
        self._tick_seq[node] += 1
        if not self.scheduler.all_done() or self._next_arrival < len(self._arrivals):
            self._push(t_end, "ready", (node, self._tick_seq[node]))

    def _watch_quarantine(self, node: int, batch: int, dt: float, now: float) -> None:
        factor = self.config.quarantine_factor
        if factor is None:
            return
        predicted = self.allocator.predicted_tick(node, batch)
        if predicted > 0 and dt > factor * predicted:
            self._slow_ticks[node] += 1
        else:
            self._slow_ticks[node] = 0
        if self._slow_ticks[node] >= self.config.quarantine_patience:
            self._slow_ticks[node] = 0
            self.events["quarantines"] += 1
            self._push(now, "leave", node)
            self._push(now + self.config.rejoin_after, "join", node)

    # -- churn -------------------------------------------------------------

    def _on_leave(self, node: int) -> None:
        if not self._available.get(node, False):
            return  # idempotent, like the trainer's runtime
        self._available[node] = False
        self._tick_seq[node] += 1  # invalidate any in-flight ready event
        victims = self.scheduler.drain_node(node)
        for ar in victims:
            self.engine.release(ar)
        self.events["leaves"] += 1
        self._reconcile()

    def _on_join(self, node: int) -> None:
        if self._available.get(node, False):
            return
        self._available[node] = True
        self._tick_seq.setdefault(node, 0)
        self._busy_until[node] = self.clock
        self._slow_ticks[node] = 0
        if node not in self.scheduler.nodes():
            self.scheduler.join_node(node, 0)
        self.events["joins"] += 1
        self._reconcile()

    def _on_resolve(self) -> None:
        self.events["resolves"] += 1
        self.allocator.refit()
        self._reconcile()
        work_left = (
            self._next_arrival < len(self._arrivals)
            or not self.scheduler.all_done()
        )
        # A re-solve can only matter if some node is (or will become) alive.
        alive = bool(self._avail()) or any(
            k == "join" for _, _, k, _ in self._heap
        )
        if work_left and alive:
            self._push(self.clock + self.config.resolve_every, "resolve", None)

    def _reconcile(self) -> None:
        """Re-solve over the available nodes and apply the new water-fill."""
        avail = self._avail()
        if not avail:
            return
        alloc = self.allocator.solve(avail)
        evicted = self.scheduler.set_allocations(alloc)
        for ar in evicted:
            self.engine.release(ar)
        self.metrics.on_queue_sample(self.scheduler.queue_depth())
        self._kick_idle()

    # -- results -----------------------------------------------------------

    def report(self) -> ServingReport:
        counters = dict(self.scheduler.counters)
        counters.update(self.events)
        counters["refits"] = self.allocator.refits
        counters["solves"] = self.allocator.solves
        return ServingReport(
            summary=self.metrics.summary(),
            fingerprint=self.metrics.fingerprint(),
            allocations={n: self.scheduler.allocation(n) for n in self.scheduler.nodes()},
            counters=counters,
            clock=self.clock,
        )
