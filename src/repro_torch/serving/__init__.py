"""Goodput-aware serving: the OptPerf water-fill under live inference traffic.

The serving subsystem reuses the trainer's allocation engine — per-node
decode batches are sized by the same :func:`repro_torch.core.optperf.
solve_optperf_batch` water-fill that sizes training micro-batches — and the
trainer's churn alphabet (:class:`repro_torch.runtime.events.NodeJoin` /
``NodeLeave``), under a continuous-batching admission scheduler with
per-request deadlines and goodput accounting.

Layers (each importable on its own):

* :mod:`repro_torch.serving.request`   — seeded load generator (Poisson / bursty)
* :mod:`repro_torch.serving.queue`     — admission + continuous batching
* :mod:`repro_torch.serving.allocator` — telemetry -> refit -> water-fill solve
* :mod:`repro_torch.serving.engines`   — simulated and real decode engines
* :mod:`repro_torch.serving.metrics`   — latency/throughput/goodput accounting
* :mod:`repro_torch.serving.server`    — the deterministic event loop
"""
from repro_torch.serving.allocator import (
    NodeTickFitter,
    ServingAllocator,
    serving_cluster_model,
    serving_node_model,
    uniform_split,
)
from repro_torch.serving.engines import (
    RealServingEngine,
    ServingEngine,
    SimServingEngine,
    prefill_cache,
)
from repro_torch.serving.metrics import RequestRecord, ServingMetrics, percentiles
from repro_torch.serving.queue import ActiveRequest, BatchScheduler, SchedulingError
from repro_torch.serving.request import (
    Request,
    Workload,
    generate_requests,
    prompts_from_stream,
)
from repro_torch.serving.server import ServingConfig, ServingReport, ServingRuntime

__all__ = [
    "ActiveRequest",
    "BatchScheduler",
    "NodeTickFitter",
    "RealServingEngine",
    "Request",
    "RequestRecord",
    "SchedulingError",
    "ServingAllocator",
    "ServingConfig",
    "ServingEngine",
    "ServingMetrics",
    "ServingReport",
    "ServingRuntime",
    "SimServingEngine",
    "Workload",
    "generate_requests",
    "percentiles",
    "prefill_cache",
    "prompts_from_stream",
    "serving_cluster_model",
    "serving_node_model",
    "uniform_split",
]
