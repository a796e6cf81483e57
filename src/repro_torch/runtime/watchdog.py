"""Deadline watchdog for OptPerf solves and backend epoch execution.

A hung solver (or a pathologically slow epoch) must not hang the reconcile
loop.  The watchdog is deliberately *single-threaded*: it measures each
guarded call after the fact and raises :class:`DeadlineExceeded` when the
solve deadline was breached — a thread-based kill would race with the
scheduler's in-place cache/allocation mutation, trading a hang for
corruption.  The stall the chaos plan injects (:class:`~repro_torch.runtime.
faults.SolverStall`) is a bounded real-time sleep, so "detect after the
fact" and "abort" coincide deterministically.

* ``guard_solve`` wraps one scheduler entry point.  An injected stall (the
  ``stall_hook`` seam, wired to :meth:`FaultInjector.solver_stall`) sleeps
  before the solve; if total elapsed time exceeds ``solve_deadline`` the
  watchdog counts a timeout and raises :class:`DeadlineExceeded`, which
  :class:`~repro_torch.runtime.policy.CannikinPolicy` catches in its existing
  engine-degradation chain (jax → batched → scalar → last-known-good).
  The injector consumes each stall once per epoch, so the degradation
  retry solves cleanly.
* ``guard_execute`` wraps one backend epoch.  Execution deadlines are
  *soft*: a breach is counted (``execute_deadline_misses``) but the
  epoch's results are kept — aborting a finished training step would
  throw away real gradient work and desync the data stream.

With no deadlines configured the guards are pass-throughs, so golden-path
runs are unchanged.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional

__all__ = ["DeadlineExceeded", "Watchdog"]


class DeadlineExceeded(RuntimeError):
    """A guarded call ran past its deadline."""

    def __init__(self, kind: str, elapsed: float, deadline: float) -> None:
        super().__init__(
            f"{kind} exceeded deadline: {elapsed:.3f}s > {deadline:.3f}s"
        )
        self.kind = kind
        self.elapsed = elapsed
        self.deadline = deadline


class Watchdog:
    """After-the-fact deadline checks with telemetry counters.

    ``solve_deadline``/``execute_deadline`` are real seconds (None disables
    the respective guard).  ``stall_hook`` is the injector's
    :meth:`~repro_torch.runtime.faults.FaultInjector.solver_stall` seam — it
    returns the seconds the next solve should artificially stall (0.0 when
    no stall is scheduled).
    """

    def __init__(
        self,
        *,
        solve_deadline: Optional[float] = None,
        execute_deadline: Optional[float] = None,
        stall_hook: Optional[Callable[[], float]] = None,
    ) -> None:
        self.solve_deadline = solve_deadline
        self.execute_deadline = execute_deadline
        self.stall_hook = stall_hook
        self.solver_timeouts = 0
        self.execute_deadline_misses = 0
        self.stalled_seconds = 0.0

    def guard_solve(self, fn: Callable[[], Any]) -> Any:
        t0 = time.perf_counter()
        if self.stall_hook is not None:
            delay = float(self.stall_hook())
            if delay > 0.0:
                self.stalled_seconds += delay
                time.sleep(delay)
        out = fn()
        elapsed = time.perf_counter() - t0
        if self.solve_deadline is not None and elapsed > self.solve_deadline:
            self.solver_timeouts += 1
            raise DeadlineExceeded("optperf-solve", elapsed, self.solve_deadline)
        return out

    def guard_execute(self, fn: Callable[[], Any]) -> Any:
        t0 = time.perf_counter()
        out = fn()
        elapsed = time.perf_counter() - t0
        if self.execute_deadline is not None and elapsed > self.execute_deadline:
            self.execute_deadline_misses += 1
        return out

    def counters(self) -> Dict[str, float]:
        return {
            "solver_timeouts": self.solver_timeouts,
            "execute_deadline_misses": self.execute_deadline_misses,
            "stalled_seconds": self.stalled_seconds,
        }
