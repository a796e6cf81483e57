#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one CUDA card and check its kernel.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, each of which fails the run:

1. device  — the card's name and power limit (``nvidia-smi``).
2. build   — compile ``csrc/flash_attention.cu`` for sm_90a into
             ``build/kernels/`` and print the build seconds and ptxas report.
3. kernel  — the flash-attention kernel against its plain PyTorch version on
             the card at the serving path's shapes (bf16 max abs error
             <= 1e-2: one output rounding plus another sum order; f32
             <= 1e-5), with the kernel's, the plain version's and
             ``scaled_dot_product_attention``'s times (CUDA events) beside
             the card's bound for the same work.
4. model   — full-width olmo-1b in float32 with seeded random weights:
             fused prefill of 128 tokens (through the kernel) against the
             stepped decode loop (plain decode attention), logits and cache
             K/V within 1e-3.
5. serving — full-width olmo-1b in bf16 under ``ServingRuntime`` with the
             OptPerf allocator over two nodes and ``RealServingEngine``:
             16 seeded requests, all completed, none dropped, every token
             inside the vocab, two undisturbed requests equal to a direct
             greedy decode, and one kernel launch per layer per prefill.

The last three lines of standard output are the card line from
``nvidia-smi``, a JSON line describing the kernel, and
``{"ok": true, "device": {...}}``.  Without a CUDA card, or without the
repository beside it, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_S = 3.35e12                  # H100 SXM device memory rate
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}  # tensor-core bf16; f32 off the tensor cores
REPLACES = "src/repro/kernels/flash_attention/flash_attention.py:85"
SOURCE_REL = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
MAIN_CASE = "olmo-1b S=512"            # the kernel line's shape: a typical prompt

# name, B, S, H, KV, dtype, window (all causal self-attention, D = 128)
KERNEL_CASES = [
    ("olmo-1b S=128", 1, 128, 16, 16, "bf16", None),
    ("olmo-1b S=512", 1, 512, 16, 16, "bf16", None),
    ("olmo-1b S=2048", 1, 2048, 16, 16, "bf16", None),
    ("llama3-8b heads S=1024", 1, 1024, 32, 8, "bf16", None),
    ("window=256 S=1024", 1, 1024, 16, 16, "bf16", 256),
    ("f32 S=T=300", 1, 300, 16, 16, "f32", None),
]
TOL = {"bf16": 1e-2, "f32": 1e-5}
DEVICE = "cuda"


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def cuda_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    """Mean milliseconds per call over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds per call on the host clock around synchronized work."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def attention_bound(b, s, h, kv, d, dtype, window):
    """Least time for one causal attention call: q, k, v read once and o
    written once over the memory rate, or the products over the valid
    (query, key) pairs of this call over the peak rate for the dtype."""
    elem = 2 if dtype == "bf16" else 4
    nbytes = elem * d * b * s * (2 * h + 2 * kv)
    w = s if window is None else min(window, s)
    pairs = sum(min(q + 1, w) for q in range(s))
    flops = 4 * d * b * h * pairs
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / PEAK_FLOPS[dtype]
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes"
    return t_ops * 1e3, "operations"


def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0 or not smi.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log("device", f"{card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")
    return card


def phase_build():
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops

    res = build.build(ops.SOURCE)
    log("build", f"{res.path.name}: {res.seconds:.2f} s")
    for line in res.log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log("build", line.strip())


def phase_kernel(torch):
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import attention_ref, flash_attention

    dtypes = {"bf16": torch.bfloat16, "f32": torch.float32}
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    rows = {}
    for name, b, s, h, kv, dt, window in KERNEL_CASES:
        d = 128

        def rand(shape):
            return torch.randn(shape, generator=gen, device=DEVICE).to(dtypes[dt])

        q, k, v = rand((b, s, h, d)), rand((b, s, kv, d)), rand((b, s, kv, d))
        out = flash_attention(q, k, v, causal=True, window=window)
        torch.cuda.synchronize()
        ref = attention_ref(q, k, v, causal=True, window=window)
        err = (out.float() - ref.float()).abs().max().item()
        if not err <= TOL[dt]:
            raise AssertionError(f"{name}: max abs err {err:.3e} > {TOL[dt]:.0e}")

        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        if window is None:
            def library():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=h != kv)
        else:
            pos = torch.arange(s, device=DEVICE)
            mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)

            def library():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, enable_gqa=h != kv)

        ms = cuda_ms(torch, lambda: flash_attention(q, k, v, causal=True, window=window), 20)
        plain_ms = cuda_ms(torch, lambda: attention_ref(q, k, v, causal=True, window=window), 5)
        library_ms = cuda_ms(torch, library, 20)
        bound_ms, bound_by = attention_bound(b, s, h, kv, d, dt, window)
        rows[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                          bound_ms=bound_ms, bound_by=bound_by)
        log("kernel", f"{name} B={b} H={h} KV={kv} D={d} {dt} window={window}: "
            f"max_abs_err={err:.3e} (tol {TOL[dt]:.0e}) ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms={library_ms:.4f} bound_ms={bound_ms:.5f} ({bound_by}) "
            f"of_bound={bound_ms / ms:.4f}")
        del q, k, v, out, ref
    return rows


def phase_model(torch):
    from repro_torch.configs import olmo_1b
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models.registry import build_api

    cfg = dataclasses.replace(
        olmo_1b.config(), param_dtype=torch.float32, compute_dtype=torch.float32)
    api = build_api("olmo-1b", cfg)
    model = api.init(0, device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    s = 128
    toks = torch.randint(0, cfg.vocab, (1, s), generator=gen, device=DEVICE)
    before = flash_attention.launches
    fused_logits, fused = api.prefill(model, api.init_cache(1, s, device=DEVICE), toks)
    if flash_attention.launches - before != cfg.n_layers:
        raise AssertionError("fused prefill did not launch the kernel once per layer")
    stepped = api.init_cache(1, s, device=DEVICE)
    rows = []
    for p in range(s):
        lg, stepped = api.decode_step(model, stepped, toks[:, p : p + 1], p)
        rows.append(lg)
    stepped_logits = torch.cat(rows, dim=1)
    torch.cuda.synchronize()
    if not torch.isfinite(fused_logits).all():
        raise AssertionError("non-finite prefill logits")
    errs = {
        "logits": (fused_logits - stepped_logits).abs().max().item(),
        "k": (fused["k"] - stepped["k"]).abs().max().item(),
        "v": (fused["v"] - stepped["v"]).abs().max().item(),
    }
    log("model", f"full olmo-1b f32 ({api.param_count()} params), prefill {s} tokens vs "
        f"stepped decode: " + ", ".join(f"{k} max abs err {v:.3e}" for k, v in errs.items())
        + f"; logits scale {stepped_logits.abs().max().item():.3f}")
    for key, err in errs.items():
        if not err <= 1e-3:
            raise AssertionError(f"fused vs stepped {key}: {err:.3e} > 1e-3")
    del model, fused, stepped


def phase_serving(torch):
    from repro_torch.configs import get_api
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.serving import (
        RealServingEngine, ServingAllocator, ServingConfig, ServingRuntime,
        generate_requests,
    )

    class Recording(RealServingEngine):
        """Keeps each request's token stream when it leaves a node."""

        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.streams = {}

        def release(self, ar):
            self.streams[ar.rid] = list(ar.tokens)
            super().release(ar)

    api = get_api("olmo-1b")
    cfg = api.cfg
    model = api.init(0, device=DEVICE)
    wl = generate_requests(
        16, seed=0, rate=8.0, prompt_min=64, prompt_mean=256, prompt_max=1024,
        gen_min=8, gen_mean=32, gen_max=64,
    )
    engine = Recording(api, model, max_len=2048, device=DEVICE)

    # Warm-up outside the counted run: cuBLAS handles, the kernel's first launch.
    warm = api.init_cache(1, 2048, device=DEVICE)
    _, warm = api.prefill(model, warm, torch.zeros((1, 64), dtype=torch.long, device=DEVICE))
    api.decode_step(model, warm, torch.zeros((1, 1), dtype=torch.long, device=DEVICE), 64)
    torch.cuda.synchronize()
    del warm

    alloc = ServingAllocator({0: (0.01, 0.01), 1: (0.01, 0.01)}, total_slots=8, mode="optperf")
    rt = ServingRuntime(engine, alloc, wl, nodes=[0, 1],
                        config=ServingConfig(total_slots=8, resolve_every=1.0))
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = 0
    t0 = time.perf_counter()
    rep = rt.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = flash_attention.launches

    summ = rep.summary
    prefills = rep.counters["admitted"]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log("serving", f"olmo-1b bf16 full width, 2 nodes, 8 slots, max_len 2048: "
        f"completed={summ['completed']}/{summ['requests']} dropped={summ['dropped']} "
        f"requeues={summ['requeues']} prefills={prefills} kernel_launches={launches}")
    log("serving", f"sustained_req_s={summ['sustained_req_s']:.4f} "
        f"token_throughput_s={summ['token_throughput_s']:.2f} "
        f"token_latency_s p50={summ['token_latency']['p50']:.5f} "
        f"p99={summ['token_latency']['p99']:.5f} "
        f"ttft_s p50={summ['ttft']['p50']:.5f} p99={summ['ttft']['p99']:.5f} "
        f"elapsed_s={summ['elapsed_s']:.4f} peak_mem_gb={peak_gb:.3f} wall_s={wall:.3f} "
        f"allocations={rep.allocations} refits={rep.counters['refits']}")
    if summ["completed"] != 16 or summ["dropped"] != 0:
        raise AssertionError(f"served {summ['completed']}/16 with {summ['dropped']} dropped")
    if launches != cfg.n_layers * prefills:
        raise AssertionError(f"{launches} kernel launches != {cfg.n_layers} x {prefills} prefills")
    for req in wl:
        stream = engine.streams[req.rid]
        if len(stream) != req.gen_len or not all(0 <= t < cfg.vocab for t in stream):
            raise AssertionError(f"request {req.rid}: bad stream {stream}")

    # Two requests served without a requeue must equal a direct greedy decode.
    undisturbed = [r for r in rt.metrics.records() if r.requeues == 0][:2]
    for rec in undisturbed:
        req = next(r for r in wl if r.rid == rec.rid)
        cache = api.init_cache(1, 2048, device=DEVICE)
        prompt = torch.as_tensor(req.prompt_tokens(cfg.vocab)[None, :], device=DEVICE)
        logits, cache = api.prefill(model, cache, prompt)
        toks = [int(logits[0, -1].argmax())]
        for pos in range(req.prompt_len, req.prompt_len + req.gen_len - 1):
            last = torch.tensor([[toks[-1]]], device=DEVICE)
            logits, cache = api.decode_step(model, cache, last, pos)
            toks.append(int(logits[0, -1].argmax()))
        if toks != engine.streams[req.rid]:
            raise AssertionError(f"request {req.rid}: served stream differs from direct decode")
    log("serving", f"requests {[r.rid for r in undisturbed]} equal a direct greedy decode")

    # What one tick is made of: a prefill, a decode step, and the kernel's share.
    s = 256
    prompt = torch.zeros((1, s), dtype=torch.long, device=DEVICE)
    cache = api.init_cache(1, 2048, device=DEVICE)
    prefill_ms = host_ms(torch, lambda: api.prefill(model, cache, prompt), 5)
    last = torch.zeros((1, 1), dtype=torch.long, device=DEVICE)
    decode_ms = host_ms(torch, lambda: api.decode_step(model, cache, last, s), 20)
    q = torch.randn((1, s, cfg.n_heads, cfg.head_dim), device=DEVICE, dtype=cfg.compute_dtype)
    kernel_ms = cuda_ms(torch, lambda: flash_attention(q, q, q), 20)
    log("serving", f"per call: prefill({s} tokens) {prefill_ms:.3f} ms, of which the kernel "
        f"{cfg.n_layers} x {kernel_ms:.4f} ms = {cfg.n_layers * kernel_ms / prefill_ms:.1%}; "
        f"decode_step at pos {s} {decode_ms:.3f} ms")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (fails here without the repository's src/)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    phase = "device"
    try:
        card = phase_device()
        phase = "build"
        phase_build()
        phase = "kernel"
        rows = phase_kernel(torch)
        phase = "model"
        phase_model(torch)
        phase = "serving"
        launches = phase_serving(torch)
    except Exception:  # the run's boundary: report the phase and fail
        traceback.print_exc()
        print(f"chip_smoke: phase {phase} failed", file=sys.stderr)
        return 1
    log("done", f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    main_row = rows[MAIN_CASE]
    kernels = [{
        "name": "flash_attention",
        "route": "cuda",
        "source": SOURCE_REL,
        "replaces": REPLACES,
        "launches": launches,
        "max_abs_err": main_row["max_abs_err"],
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
    }]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
