"""Admission + continuous-batching scheduler.

The :class:`BatchScheduler` owns the request lifecycle between arrival and
completion:

    queued --admit--> active(node) --complete--> done
       ^                  |
       +----requeue-------+   (NodeLeave / quarantine / allocation shrink)

Per-node *decode batches* are continuous (Orca-style): a slot freed by a
completing request is refilled from the admission queue at the next tick
boundary, and newly admitted requests prefill between decode ticks.  The
number of slots a node may fill is its **water-fill allocation** — the
integer per-node batch the OptPerf solve assigns
(:class:`repro_torch.serving.allocator.ServingAllocator`) — so the invariant
``len(active[i]) <= allocation[i]`` is the serving twin of the trainer's
per-node batch partition.

Every transition is checked against a single authoritative state map, so a
request can never be dropped, double-scheduled, or resurrected — the
property tests in ``tests/test_serving.py`` drive random interleavings of
admit/complete/drain/shrink against exactly these checks.

Requeued requests keep the tokens they already generated: on re-admission
the engine re-prefills prompt + generated-so-far (cache rebuilt) and
generation continues, which is what makes a mid-stream NodeLeave complete
every in-flight request with zero drops.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence

from repro_torch.serving.request import Request

__all__ = ["ActiveRequest", "BatchScheduler", "SchedulingError"]


class SchedulingError(RuntimeError):
    """A lifecycle invariant was violated (drop / double-schedule / overfill)."""


@dataclasses.dataclass
class ActiveRequest:
    """A request occupying one decode slot on one node.

    ``tokens`` is the generated-so-far list (survives requeues); ``admitted``
    and ``first_token`` are stamped by the runtime for the latency metrics.
    """

    request: Request
    node: int
    tokens: List[int] = dataclasses.field(default_factory=list)
    admitted: float = 0.0
    first_token: Optional[float] = None
    requeues: int = 0

    @property
    def rid(self) -> int:
        return self.request.rid

    @property
    def done(self) -> bool:
        return len(self.tokens) >= self.request.gen_len

    @property
    def remaining(self) -> int:
        return self.request.gen_len - len(self.tokens)

    @property
    def context_len(self) -> int:
        """Prompt + generated-so-far — what a rebuild must re-prefill."""
        return self.request.prompt_len + len(self.tokens)


_QUEUED, _DONE = "queued", "done"


class BatchScheduler:
    """FIFO admission queue + per-node continuous decode batches."""

    def __init__(self, allocations: Dict[int, int]):
        self._alloc: Dict[int, int] = {}
        self._active: Dict[int, List[ActiveRequest]] = {}
        self._queue: Deque[ActiveRequest] = deque()
        self._state: Dict[int, object] = {}  # rid -> _QUEUED | node | _DONE
        self.counters = {
            "enqueued": 0,
            "admitted": 0,
            "completed": 0,
            "requeued": 0,
            "evicted": 0,
        }
        for node, cap in allocations.items():
            self._add_node(node, cap)

    # -- node membership -------------------------------------------------

    def _add_node(self, node: int, cap: int) -> None:
        if cap < 0:
            raise ValueError(f"negative allocation for node {node}")
        self._alloc[node] = int(cap)
        self._active.setdefault(node, [])

    def nodes(self) -> List[int]:
        return sorted(self._alloc)

    def allocation(self, node: int) -> int:
        return self._alloc.get(node, 0)

    def active(self, node: int) -> List[ActiveRequest]:
        return list(self._active.get(node, ()))

    def active_count(self, node: int) -> int:
        return len(self._active.get(node, ()))

    def free_slots(self, node: int) -> int:
        return max(self._alloc.get(node, 0) - self.active_count(node), 0)

    # -- lifecycle transitions --------------------------------------------

    def enqueue(self, request: Request) -> None:
        """A fresh arrival enters the admission queue."""
        if request.rid in self._state:
            raise SchedulingError(f"request {request.rid} enqueued twice")
        self._state[request.rid] = _QUEUED
        self._queue.append(ActiveRequest(request=request, node=-1))
        self.counters["enqueued"] += 1

    def admit(self, node: int, now: float, limit: Optional[int] = None) -> List[ActiveRequest]:
        """Fill ``node``'s free slots from the queue head (FIFO).

        Returns the newly admitted requests (the runtime prefills them).
        ``limit`` optionally admits fewer than the free-slot count (e.g. to
        bound prefill work per tick).
        """
        if node not in self._alloc:
            raise SchedulingError(f"admit on unknown node {node}")
        n = self.free_slots(node)
        if limit is not None:
            n = min(n, max(limit, 0))
        out: List[ActiveRequest] = []
        while n > 0 and self._queue:
            ar = self._queue.popleft()
            if self._state.get(ar.rid) is not _QUEUED:
                raise SchedulingError(
                    f"request {ar.rid} in queue but state is {self._state.get(ar.rid)!r}"
                )
            ar.node = node
            ar.admitted = now
            self._state[ar.rid] = node
            self._active[node].append(ar)
            out.append(ar)
            n -= 1
        self.counters["admitted"] += len(out)
        if len(self._active[node]) > self._alloc[node]:
            raise SchedulingError(
                f"node {node} overfilled: {len(self._active[node])} > {self._alloc[node]}"
            )
        return out

    def complete(self, ar: ActiveRequest) -> None:
        """A request finished generation; its slot frees for reuse."""
        self._check_active(ar)
        self._active[ar.node].remove(ar)
        self._state[ar.rid] = _DONE
        self.counters["completed"] += 1

    def _requeue(self, ar: ActiveRequest) -> None:
        ar.node = -1
        ar.requeues += 1
        self._state[ar.rid] = _QUEUED
        # Requeues go to the FRONT (oldest arrivals first among them): a
        # victim of node churn should not pay the whole queue again.
        self._queue.appendleft(ar)
        self.counters["requeued"] += 1

    def drain_node(self, node: int) -> List[ActiveRequest]:
        """NodeLeave/quarantine: requeue every in-flight request of ``node``
        (generated tokens kept; caches rebuilt on re-admission) and remove
        the node from the allocatable set.  Zero requests are dropped."""
        if node not in self._alloc:
            raise SchedulingError(f"drain on unknown node {node}")
        victims = self._active.pop(node)
        del self._alloc[node]
        # Reverse order so appendleft restores arrival order at the front.
        for ar in reversed(victims):
            self._check_state(ar, node)
            self._requeue(ar)
        return victims

    def join_node(self, node: int, cap: int = 0) -> None:
        """NodeJoin: (re-)add a node with allocation ``cap``."""
        if node in self._alloc:
            raise SchedulingError(f"node {node} joined twice")
        self._add_node(node, cap)

    def set_allocations(self, allocations: Dict[int, int]) -> List[ActiveRequest]:
        """Apply a fresh water-fill solve.

        Nodes keep their in-flight requests; where the new allocation is
        *smaller* than the current active count, the newest actives are
        evicted (requeued, tokens kept) so the ``active <= allocation``
        invariant holds unconditionally.  Returns the evicted requests.
        """
        unknown = set(allocations) - set(self._alloc)
        if unknown:
            raise SchedulingError(f"allocation for unknown nodes {sorted(unknown)}")
        evicted: List[ActiveRequest] = []
        for node, cap in allocations.items():
            self._alloc[node] = int(cap)
            active = self._active[node]
            while len(active) > self._alloc[node]:
                ar = active.pop()  # newest first: least progress lost
                self._check_state(ar, node)
                self._requeue(ar)
                evicted.append(ar)
                self.counters["evicted"] += 1
                self.counters["requeued"] -= 1  # counted as eviction, not churn
        return evicted

    # -- introspection ----------------------------------------------------

    def queue_depth(self) -> int:
        return len(self._queue)

    def in_flight(self) -> int:
        return sum(len(v) for v in self._active.values())

    def pending(self) -> int:
        """Requests not yet done (queued + active)."""
        return self.queue_depth() + self.in_flight()

    def all_done(self) -> bool:
        return self.pending() == 0

    def check_invariants(self) -> None:
        """Full structural sweep (the property tests call this after every
        transition): states partition exactly into queue/active/done, no
        rid appears twice, and no node exceeds its allocation."""
        seen: Dict[int, str] = {}
        for ar in self._queue:
            if ar.rid in seen:
                raise SchedulingError(f"rid {ar.rid} appears twice (queue)")
            seen[ar.rid] = "queue"
            if self._state.get(ar.rid) is not _QUEUED:
                raise SchedulingError(f"rid {ar.rid} queued but state mismatch")
        for node, actives in self._active.items():
            if len(actives) > self._alloc[node]:
                raise SchedulingError(f"node {node} over allocation")
            for ar in actives:
                if ar.rid in seen:
                    raise SchedulingError(f"rid {ar.rid} appears twice (active)")
                seen[ar.rid] = "active"
                if self._state.get(ar.rid) != node or ar.node != node:
                    raise SchedulingError(f"rid {ar.rid} active but state mismatch")
        for rid, state in self._state.items():
            if rid not in seen and state is not _DONE:
                raise SchedulingError(f"rid {rid} lost (state {state!r})")
        if self.counters["enqueued"] != len(self._state):
            raise SchedulingError("enqueue counter drifted from state map")

    # -- internals ---------------------------------------------------------

    def _check_active(self, ar: ActiveRequest) -> None:
        self._check_state(ar, ar.node)
        if ar not in self._active.get(ar.node, ()):
            raise SchedulingError(f"request {ar.rid} not active on node {ar.node}")

    def _check_state(self, ar: ActiveRequest, node: int) -> None:
        if self._state.get(ar.rid) != node:
            raise SchedulingError(
                f"request {ar.rid} state {self._state.get(ar.rid)!r} != node {node}"
            )
