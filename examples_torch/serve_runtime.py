"""Goodput-aware serving end to end: the OptPerf water-fill under live
inference traffic, with churn.

Three lanes, each asserting its own invariants (nonzero exit on violation —
this is the serving-smoke CI entrypoint):

1. **Water-fill vs uniform (sim)** — a seeded Poisson workload over a
   2-speed-class cluster (3 fast nodes, 5 nodes 8x slower, shared per-tick
   overhead).  The OptPerf-driven slot allocation must sustain >= 15%
   higher req/s than the uniform split at equal-or-better p99 token
   latency, and same-seed runs must be bit-identical (fingerprint match).
2. **Churn (sim)** — the same workload with one NodeLeave mid-stream and a
   later NodeJoin: every in-flight request on the lost node requeues (tokens
   kept, caches rebuilt elsewhere) and the run completes with ZERO drops.
3. **Real engine** — the reduced olmo-1b zoo model decoding real tokens
   (fused prefill through the flash-attention kernel + the decode step,
   batch-1 slot caches) on ``--device`` (default the CUDA card), prompts
   streamed from the training data pipeline, with one NodeLeave
   mid-stream.  Zero drops, every request completes.

    python examples_torch/serve_runtime.py [--requests N] [--skip-real] [--device cpu]
"""
import argparse
import time

import _common  # noqa: F401  (sys.path bootstrap)

from repro_torch import resolve_device
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.runtime.events import NodeJoin, NodeLeave
from repro_torch.serving import (
    ServingAllocator,
    ServingConfig,
    ServingRuntime,
    SimServingEngine,
    generate_requests,
    prompts_from_stream,
)

# 2-speed-class cluster: 3 fast, 5 at 8x the per-token cost, shared
# per-tick dispatch overhead (host-side, speed-independent).
FAST, SLOW, INTERCEPT = 0.004, 0.032, 0.03
COEFFS = {i: (FAST, INTERCEPT) for i in range(3)}
COEFFS.update({i: (SLOW, INTERCEPT) for i in range(3, 8)})
SLOTS = 32
WORKLOAD = dict(seed=7, rate=56.0, gen_mean=8, gen_max=64,
                token_budget=0.12, ttft_slack=1.0)


def _sim_run(n_requests, mode, post=()):
    wl = generate_requests(n_requests, **WORKLOAD)
    rt = ServingRuntime(
        SimServingEngine(dict(COEFFS)),
        ServingAllocator(dict(COEFFS), total_slots=SLOTS, mode=mode),
        wl,
        nodes=list(range(8)),
        config=ServingConfig(total_slots=SLOTS, resolve_every=1.0),
    )
    for ev in post:
        rt.post(ev)
    return rt.run()


def _show(name, rep):
    s = rep.summary
    print(
        f"  {name:10s} sustained {rep.sustained_req_s:6.2f} req/s  "
        f"goodput {rep.goodput_req_s:6.2f} req/s  "
        f"p99 token {s['token_latency']['p99'] * 1e3:6.1f} ms  "
        f"dropped {s['dropped']}  requeues {s['requeues']}"
    )


def lane_waterfill_vs_uniform(n_requests):
    print(f"[1] water-fill vs uniform on the 2-speed-class cluster "
          f"({n_requests} requests, {SLOTS} slots)")
    opt = _sim_run(n_requests, "optperf")
    uni = _sim_run(n_requests, "uniform")
    _show("optperf", opt)
    _show("uniform", uni)
    print(f"  optperf allocation: {opt.allocations}")
    ratio = opt.sustained_req_s / uni.sustained_req_s
    print(f"  sustained ratio {ratio:.3f} (gate >= 1.15), "
          f"goodput ratio {opt.goodput_req_s / uni.goodput_req_s:.3f}")
    assert opt.summary["dropped"] == 0 and uni.summary["dropped"] == 0
    assert ratio >= 1.15, f"water-fill advantage {ratio:.3f} below 1.15x"
    assert (
        opt.summary["token_latency"]["p99"]
        <= uni.summary["token_latency"]["p99"]
    ), "water-fill must not regress p99 token latency"
    rerun = _sim_run(n_requests, "optperf")
    assert rerun.fingerprint == opt.fingerprint, "same-seed run not bit-identical"
    print(f"  same-seed fingerprint match: {opt.fingerprint[:16]}…")


def lane_churn(n_requests):
    print("[2] churn: NodeLeave mid-stream (+ a later rejoin), zero drops")
    rep = _sim_run(
        n_requests, "optperf",
        post=[NodeLeave(time=2.0, nodes=(0, 4)), NodeJoin(time=5.0, nodes=(0,))],
    )
    _show("churn", rep)
    assert rep.summary["dropped"] == 0, "requests lost under churn"
    assert rep.summary["completed"] == rep.summary["requests"]
    assert rep.counters["requeued"] > 0, "drain should have requeued in-flight work"
    print(f"  leaves {rep.counters['leaves']}  joins {rep.counters['joins']}  "
          f"requeued {rep.counters['requeued']}  final alloc {rep.allocations}")


def lane_real_engine(n_requests, device=None):
    from repro_torch.configs import get_api
    from repro_torch.serving import RealServingEngine

    print(f"[3] real engine: reduced olmo-1b, {n_requests} requests, "
          "NodeLeave mid-stream")
    api = get_api("olmo-1b", reduced=True)
    params = api.init(0, device=device)
    wl = generate_requests(
        n_requests, seed=5, rate=50.0, prompt_min=16, prompt_max=16,
        gen_min=2, gen_max=8, gen_mean=4, token_budget=10.0,
    )
    # Prompts stream out of the training data pipeline (bounded buffer).
    src = SyntheticLM(vocab=api.cfg.vocab, seq_len=32, seed=3)
    prompts = prompts_from_stream(
        src.stream(8, steps=4 * n_requests, threaded=True), wl.requests
    )
    coeffs = {0: (0.01, 0.01), 1: (0.01, 0.01)}
    engine = RealServingEngine(api, params, max_len=32, prompts=prompts, device=device)
    rt = ServingRuntime(
        engine,
        ServingAllocator(dict(coeffs), total_slots=4),
        wl,
        nodes=[0, 1],
        config=ServingConfig(total_slots=4),
    )
    rt.post(NodeLeave(time=wl.requests[len(wl) // 3].arrival, nodes=(1,)))
    t0 = time.perf_counter()
    rep = rt.run()
    wall = time.perf_counter() - t0
    _show("real", rep)
    assert rep.summary["dropped"] == 0, "real engine dropped requests"
    assert rep.summary["completed"] == len(wl)
    assert rep.counters["leaves"] == 1
    toks = sum(len(r.token_times) for r in rt.metrics.records())
    print(f"  {toks} tokens in {wall:.1f}s wall "
          f"({toks / wall:.1f} tok/s incl. compile)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=400,
                    help="sim-lane request count")
    ap.add_argument("--real-requests", type=int, default=8,
                    help="real-lane request count")
    ap.add_argument("--skip-real", action="store_true",
                    help="skip the real-engine lane")
    ap.add_argument("--device", default=None,
                    help="where the real-engine lane runs (default: the CUDA card; "
                         "'cpu' runs the plain PyTorch path)")
    args = ap.parse_args(argv)
    device = None if args.skip_real else resolve_device(args.device)
    lane_waterfill_vs_uniform(args.requests)
    lane_churn(args.requests)
    if not args.skip_real:
        lane_real_engine(args.real_requests, device)
    print("serving runtime demo OK")


if __name__ == "__main__":
    main()
