#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one CUDA card and check its kernels.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, each of which fails the run:

1. device        — the card's name and power limit (``nvidia-smi``).
2. build         — compile every ``csrc/*.cu`` of the port for sm_90a into
                   ``build/kernels/``, one ``nvcc`` per source, all started
                   together; print the build seconds and ptxas report.
3. kernel        — the flash-attention kernel against its plain PyTorch
                   version on the card at the serving path's shapes (bf16
                   max abs error <= 1e-2: one output rounding plus another
                   sum order; f32 <= 1e-5), with the kernel's, the plain
                   version's and ``scaled_dot_product_attention``'s times
                   (CUDA events) beside the card's bound for the same work.
4. kernel (wkv)  — the WKV kernel against its plain (chunked) version, all
                   float32 with K=64, out and final state within
                   1e-4 * max(1, max |plain|): float32 sums in another order
                   through decay factors up to exp(chunk * 4.6 / 2).
5. model         — full-width olmo-1b in float32 with seeded random weights:
                   fused prefill of 128 tokens (through the kernel) against
                   the stepped decode loop (plain decode attention), logits
                   and cache K/V within 1e-3.
6. serving       — full-width olmo-1b in bf16 under ``ServingRuntime`` with
                   the OptPerf allocator over two nodes and
                   ``RealServingEngine``: 16 seeded requests, all completed,
                   none dropped, every token inside the vocab, two
                   undisturbed requests equal to a direct greedy decode, and
                   one kernel launch per layer per prefill.
7. model (rwkv6) — full-width rwkv6-7b in float32 with seeded random
                   weights: the forward over 128 tokens launches the WKV
                   kernel once per layer and its logits equal the stepped
                   decode loop's (plain recurrence) within 1e-3.
8. serving (rwkv6) — full-width rwkv6-7b in bf16 under ``ServingRuntime``:
                   8 seeded requests whose prompts step the decode loop, as
                   the reference's engine does for a family with no fused
                   prefill; all completed, none dropped, tokens inside the
                   vocab, two undisturbed requests equal to a direct greedy
                   decode; then the per-call times of a 1024-token forward
                   and a decode step, and their device time and idle share
                   under ``torch.profiler``.
9. kernel (ssm)  — the selective-scan kernel against its plain (step by
                   step) version, float32 with N=16, y and final state
                   within 1e-5 * max(1, max |plain|): float32 sums over the
                   16 states in another order.
10. model (hymba) — full-width hymba-1.5b in float32 with seeded random
                   weights: the forward over 128 tokens (inside the window)
                   launches the flash-attention kernel (head dim 64) and the
                   selective-scan kernel once per layer each, and its logits
                   equal the stepped decode loop's (plain torch) within 1e-3.
11. serving (hymba) — full-width hymba-1.5b in bf16, as phase 8; then the
                   per-call times of a 1024-token forward and a decode step,
                   each kernel's share, device time and idle share.

The launch counts are set to 0 just before each model's path (phases 5-6
for olmo-1b, 7-8 for rwkv6-7b, 10-11 for hymba-1.5b) and read just after
it.  The last three lines of standard output are the card line from
``nvidia-smi``, a JSON line describing each kernel, and ``{"ok": true,
"device": {...}}``.  Without a CUDA card, or without the repository beside
it, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import concurrent.futures
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
WKV_REPLACES = "src/repro/kernels/rwkv6_wkv/rwkv6_wkv.py:86"
WKV_SOURCE_REL = "src/repro_torch/kernels/rwkv6_wkv/csrc/wkv.cu"
WKV_MAIN_CASE = "rwkv6-7b T=1024"      # the forward's shape at 1024 tokens
SSM_REPLACES = "src/repro/kernels/ssm_scan/ssm_scan.py:63"
SSM_SOURCE_REL = "src/repro_torch/kernels/ssm_scan/csrc/ssm_scan.cu"
SSM_MAIN_CASE = "hymba-1.5b T=1024"    # the forward's shape at 1024 tokens
HYMBA_FLASH_CASE = "hymba-1.5b global S=1024"

# name, B, S, H, KV, dtype, window, D (all causal self-attention)
KERNEL_CASES = [
    ("olmo-1b S=128", 1, 128, 16, 16, "bf16", None, 128),
    ("olmo-1b S=512", 1, 512, 16, 16, "bf16", None, 128),
    ("olmo-1b S=2048", 1, 2048, 16, 16, "bf16", None, 128),
    ("llama3-8b heads S=1024", 1, 1024, 32, 8, "bf16", None, 128),
    ("window=256 S=1024", 1, 1024, 16, 16, "bf16", 256, 128),
    ("f32 S=T=300", 1, 300, 16, 16, "f32", None, 128),
    ("hymba-1.5b global S=1024", 1, 1024, 25, 5, "bf16", None, 64),
    ("hymba-1.5b window=1024 S=2048", 1, 2048, 25, 5, "bf16", 1024, 64),
    ("D=64 f32 S=T=300", 1, 300, 25, 5, "f32", None, 64),
]
TOL = {"bf16": 1e-2, "f32": 1e-5}
# name, B, T, H, chunk (float32, K = 64)
WKV_CASES = [
    ("rwkv6-7b T=1024", 1, 1024, 64, 32),
    ("T=128", 1, 128, 64, 32),
    ("ragged T=300", 1, 300, 64, 32),
    ("B=4 T=256", 4, 256, 64, 32),
    ("chunk 64 T=1024", 1, 1024, 64, 64),
]
WKV_REL = 1e-4
# name, B, T, D, chunk, strong decay (float32, N = 16)
SSM_CASES = [
    ("hymba-1.5b T=1024", 1, 1024, 3200, 128, False),
    ("T=128", 1, 128, 3200, 128, False),
    ("ragged T=300", 1, 300, 3200, 128, False),
    ("B=4 T=256", 4, 256, 3200, 128, False),
    ("D=203 (last 8-channel tile ragged)", 1, 256, 203, 128, False),
    ("strong decay T=1024", 1, 1024, 3200, 128, True),
]
SSM_REL = 1e-5
SFU_EXP_S = 132 * 16 * 1.98e9          # H100 SXM: 16 exponentials per clock and SM at boost
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


def device_split(torch, fn, calls: int, wall_ms: float, kernels):
    """Device milliseconds per call (kernel time under ``torch.profiler``),
    each named kernel's part of it, and the device's idle share of
    ``wall_ms``, the unprofiled host time per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    device = 0.0
    named = dict.fromkeys(kernels, 0.0)
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA and not getattr(evt, "is_user_annotation", False):
            device += evt.self_device_time_total
            for kernel in kernels:
                if kernel in evt.key:
                    named[kernel] += evt.self_device_time_total
    device_ms = device / 1e3 / calls
    if device_ms <= 0.0:
        raise RuntimeError("the profiler recorded no device time")
    named_ms = {kernel: t / 1e3 / calls for kernel, t in named.items()}
    return device_ms, named_ms, 1.0 - device_ms / wall_ms


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
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops
    from repro_torch.kernels.ssm_scan import ops as ssm_ops

    sources = [flash_ops.SOURCE, wkv_ops.SOURCE, ssm_ops.SOURCE]
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        results = list(pool.map(build.build, sources))
    for res in results:
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
    for name, b, s, h, kv, dt, window, d in KERNEL_CASES:
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


def wkv_bound(b, t, h, k):
    """Least time for one WKV call: r, k, v, log_w read once, out written
    once, plus u and the final state (float32), over the memory rate; or
    the sequential recurrence's 4 K^2 operations per token and head over
    the float32 rate."""
    nbytes = 4 * (5 * b * t * h * k + h * k + b * h * k * k)
    flops = 4 * k * k * b * t * h
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / PEAK_FLOPS["f32"]
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes"
    return t_ops * 1e3, "operations"


def phase_kernel_wkv(torch):
    from repro_torch.kernels.rwkv6_wkv import wkv, wkv_chunked

    gen = torch.Generator(device=DEVICE).manual_seed(2)
    k = 64
    rows = {}
    for name, b, t, h, chunk in WKV_CASES:
        def rand(shape, scale):
            return torch.randn(shape, generator=gen, device=DEVICE) * scale

        r, kk, v = (rand((b, t, h, k), 0.5) for _ in range(3))
        lw = -torch.exp(rand((b, t, h, k), 1.0))
        u = rand((h, k), 0.2)
        out, state = wkv(r, kk, v, lw, u, chunk=chunk)
        torch.cuda.synchronize()
        ref_out, ref_state = wkv_chunked(r, kk, v, lw, u, chunk=chunk)
        errs = {}
        for key, got, want in (("out", out, ref_out), ("state", state, ref_state)):
            tol = WKV_REL * max(1.0, want.abs().max().item())
            errs[key] = (got - want).abs().max().item()
            if not errs[key] <= tol:
                raise AssertionError(f"wkv {name}: {key} max abs err {errs[key]:.3e} > {tol:.3e}")
        ms = cuda_ms(torch, lambda: wkv(r, kk, v, lw, u, chunk=chunk), 20)
        plain_ms = cuda_ms(torch, lambda: wkv_chunked(r, kk, v, lw, u, chunk=chunk), 3)
        bound_ms, bound_by = wkv_bound(b, t, h, k)
        err = max(errs.values())
        rows[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
                          bound_ms=bound_ms, bound_by=bound_by)
        log("kernel", f"wkv {name} B={b} H={h} K={k} chunk={chunk} f32: "
            f"max_abs_err out={errs['out']:.3e} state={errs['state']:.3e} "
            f"(tol {WKV_REL:.0e} x max(1, max|plain|) = {WKV_REL * max(1.0, ref_out.abs().max().item()):.3e}) "
            f"ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bound_ms:.5f} ({bound_by}) "
            f"of_bound={bound_ms / ms:.4f}")
        del r, kk, v, lw, out, state, ref_out, ref_state
    return rows


def ssm_bound(b, t, d, n):
    """Least time for one selective-scan call: u and dt read once and y
    written once, plus B, C, log_a and the final state (float32), over the
    memory rate; or about seven float32 operations (the exponential counted
    as one) per (token, channel, state) over the float32 rate.  Also the
    exponentials alone at the SFU's rate, which the table has no row for."""
    nbytes = 4 * (3 * b * t * d + 2 * b * t * n + d * n + b * d * n)
    flops = 7 * b * t * d * n
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / PEAK_FLOPS["f32"]
    sfu_ms = b * t * d * n / SFU_EXP_S * 1e3
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes", sfu_ms
    return t_ops * 1e3, "operations", sfu_ms


def phase_kernel_ssm(torch):
    from repro_torch.kernels.ssm_scan import selective_scan_ref, ssm_scan

    gen = torch.Generator(device=DEVICE).manual_seed(4)
    n = 16
    rows = {}
    for name, b, t, d, chunk, strong in SSM_CASES:
        def rand(*shape):
            return torch.randn(shape, generator=gen, device=DEVICE)

        u = rand(b, t, d)
        dt = torch.exp(rand(b, t, d) * 0.5) * (3.0 if strong else 0.3)
        bt, ct = rand(b, t, n), rand(b, t, n)
        log_a = rand(d, n) * (1.0 if strong else 0.5)
        y, h = ssm_scan(u, dt, bt, ct, log_a, chunk=chunk)
        torch.cuda.synchronize()
        ref_y, ref_h = selective_scan_ref(u, dt, log_a, bt, ct)
        errs = {}
        for key, got, want in (("y", y, ref_y), ("state", h, ref_h)):
            tol = SSM_REL * max(1.0, want.abs().max().item())
            errs[key] = (got - want).abs().max().item()
            if not errs[key] <= tol:
                raise AssertionError(f"ssm {name}: {key} max abs err {errs[key]:.3e} > {tol:.3e}")
        ms = cuda_ms(torch, lambda: ssm_scan(u, dt, bt, ct, log_a, chunk=chunk), 20)
        plain_ms = cuda_ms(torch, lambda: selective_scan_ref(u, dt, log_a, bt, ct), 2, warmup=1)
        bound_ms, bound_by, sfu_ms = ssm_bound(b, t, d, n)
        err = max(errs.values())
        rows[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
                          bound_ms=bound_ms, bound_by=bound_by)
        log("kernel", f"ssm {name}: B={b} T={t} D={d} N={n} chunk={chunk} f32: "
            f"max_abs_err y={errs['y']:.3e} state={errs['state']:.3e} "
            f"(tol {SSM_REL:.0e} x max(1, max|plain|) = {SSM_REL * max(1.0, ref_y.abs().max().item()):.3e}) "
            f"ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms=none bound_ms={bound_ms:.5f} "
            f"({bound_by}) of_bound={bound_ms / ms:.4f} sfu_exp_ms={sfu_ms:.5f}")
        del u, dt, bt, ct, log_a, y, h, ref_y, ref_h
    return rows


KERNEL_NAMES = ("flash_attention", "rwkv6_wkv", "ssm_scan")


def _wrappers():
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rwkv6_wkv import wkv
    from repro_torch.kernels.ssm_scan import ssm_scan

    return dict(zip(KERNEL_NAMES, (flash_attention, wkv, ssm_scan)))


def reset_launches():
    for fn in _wrappers().values():
        fn.launches = 0


def read_launches():
    return {name: fn.launches for name, fn in _wrappers().items()}


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


def recording(base):
    class Recording(base):
        """Keeps each request's token stream when it leaves a node."""

        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.streams = {}

        def release(self, ar):
            self.streams[ar.rid] = list(ar.tokens)
            super().release(ar)

    return Recording


def serving_summary(torch, name, rep, wall, counts):
    summ = rep.summary
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log("serving", f"{name} sustained_req_s={summ['sustained_req_s']:.4f} "
        f"token_throughput_s={summ['token_throughput_s']:.2f} "
        f"token_latency_s p50={summ['token_latency']['p50']:.5f} "
        f"p99={summ['token_latency']['p99']:.5f} "
        f"ttft_s p50={summ['ttft']['p50']:.5f} p99={summ['ttft']['p99']:.5f} "
        f"elapsed_s={summ['elapsed_s']:.4f} peak_mem_gb={peak_gb:.3f} wall_s={wall:.3f} "
        f"allocations={rep.allocations} refits={rep.counters['refits']} launches={counts}")


def check_streams(torch, api, model, engine, rt, wl, max_len):
    """Every stream has its length and stays inside the vocab; two requests
    served without a requeue equal a direct greedy decode."""
    from repro_torch.serving import prefill_cache

    vocab = api.cfg.vocab
    for req in wl:
        stream = engine.streams[req.rid]
        if len(stream) != req.gen_len or not all(0 <= t < vocab for t in stream):
            raise AssertionError(f"request {req.rid}: bad stream {stream}")
    undisturbed = [r for r in rt.metrics.records() if r.requeues == 0][:2]
    for rec in undisturbed:
        req = next(r for r in wl if r.rid == rec.rid)
        cache = api.init_cache(1, max_len, device=DEVICE)
        prompt = torch.as_tensor(req.prompt_tokens(vocab)[None, :], device=DEVICE)
        logits, cache = prefill_cache(api, model, cache, prompt)
        toks = [int(logits[0, -1].argmax())]
        for pos in range(req.prompt_len, req.prompt_len + req.gen_len - 1):
            last = torch.tensor([[toks[-1]]], device=DEVICE)
            logits, cache = api.decode_step(model, cache, last, pos)
            toks.append(int(logits[0, -1].argmax()))
        if toks != engine.streams[req.rid]:
            raise AssertionError(f"request {req.rid}: served stream differs from direct decode")
    return [r.rid for r in undisturbed]


def phase_serving(torch):
    from repro_torch.configs import get_api
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.serving import (
        RealServingEngine, ServingAllocator, ServingConfig, ServingRuntime,
        generate_requests,
    )

    Recording = recording(RealServingEngine)
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
    reset_launches()
    t0 = time.perf_counter()
    rep = rt.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_launches()
    launches = counts["flash_attention"]

    summ = rep.summary
    prefills = rep.counters["admitted"]
    log("serving", f"olmo-1b bf16 full width, 2 nodes, 8 slots, max_len 2048: "
        f"completed={summ['completed']}/{summ['requests']} dropped={summ['dropped']} "
        f"requeues={summ['requeues']} prefills={prefills} kernel_launches={launches}")
    serving_summary(torch, "olmo-1b", rep, wall, counts)
    if summ["completed"] != 16 or summ["dropped"] != 0:
        raise AssertionError(f"served {summ['completed']}/16 with {summ['dropped']} dropped")
    if launches != cfg.n_layers * prefills or counts["rwkv6_wkv"] or counts["ssm_scan"]:
        raise AssertionError(f"launches {counts} != {cfg.n_layers} x {prefills} prefills")
    rids = check_streams(torch, api, model, engine, rt, wl, 2048)
    log("serving", f"requests {rids} equal a direct greedy decode")

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
    for name, fn, wall_ms in (("prefill", lambda: api.prefill(model, cache, prompt), prefill_ms),
                              ("decode_step", lambda: api.decode_step(model, cache, last, s),
                               decode_ms)):
        dev, named, idle = device_split(torch, fn, 3, wall_ms, ("flash_fwd_kernel",))
        log("serving", f"profile olmo-1b {name}: device {dev:.3f} ms of {wall_ms:.3f} ms "
            f"(idle share {idle:.4f}), flash kernel {named['flash_fwd_kernel']:.3f} ms")
    return counts


def phase_model_rwkv6(torch):
    from repro_torch.configs import rwkv6_7b
    from repro_torch.models.registry import build_api

    cfg = dataclasses.replace(
        rwkv6_7b.config(), param_dtype=torch.float32, compute_dtype=torch.float32)
    api = build_api("rwkv6-7b", cfg)
    model = api.init(0, device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    s = 128
    toks = torch.randint(0, cfg.vocab, (1, s), generator=gen, device=DEVICE)
    before = read_launches()["rwkv6_wkv"]
    full = api.logits(model, {"tokens": toks})
    torch.cuda.synchronize()
    launched = read_launches()["rwkv6_wkv"] - before
    if launched != cfg.n_layers:
        raise AssertionError(f"the forward launched the WKV kernel {launched} times, "
                             f"not once per layer ({cfg.n_layers})")
    cache = api.init_cache(1, s, device=DEVICE)
    rows = []
    for p in range(s):
        lg, cache = api.decode_step(model, cache, toks[:, p : p + 1], p)
        rows.append(lg)
    stepped = torch.cat(rows, dim=1)
    torch.cuda.synchronize()
    if not torch.isfinite(full).all() or full.shape != (1, s, cfg.vocab):
        raise AssertionError(f"forward logits: shape {tuple(full.shape)} or non-finite values")
    err = (full - stepped).abs().max().item()
    log("model", f"full rwkv6-7b f32 ({api.param_count()} params), forward over {s} tokens "
        f"({launched} WKV launches) vs stepped decode: logits max abs err {err:.3e} "
        f"(limit 1e-3); logits scale {stepped.abs().max().item():.3f}")
    if not err <= 1e-3:
        raise AssertionError(f"forward vs stepped logits: {err:.3e} > 1e-3")
    del model, cache, full, stepped, rows


def phase_serving_rwkv6(torch, wkv_ms):
    from repro_torch.configs import get_api
    from repro_torch.serving import (
        RealServingEngine, ServingAllocator, ServingConfig, ServingRuntime,
        generate_requests,
    )

    api = get_api("rwkv6-7b")
    cfg = api.cfg
    model = api.init(0, device=DEVICE)
    max_len = 256
    wl = generate_requests(
        8, seed=0, rate=4.0, prompt_min=16, prompt_mean=48, prompt_max=128,
        gen_min=8, gen_mean=16, gen_max=32,
    )
    engine = recording(RealServingEngine)(api, model, max_len=max_len, device=DEVICE)

    # Warm-up outside the counted run: cuBLAS handles.
    warm = api.init_cache(1, max_len, device=DEVICE)
    api.decode_step(model, warm, torch.zeros((1, 1), dtype=torch.long, device=DEVICE), 0)
    torch.cuda.synchronize()
    del warm

    alloc = ServingAllocator({0: (0.01, 0.01), 1: (0.01, 0.01)}, total_slots=4, mode="optperf")
    rt = ServingRuntime(engine, alloc, wl, nodes=[0, 1],
                        config=ServingConfig(total_slots=4, resolve_every=1.0))
    torch.cuda.reset_peak_memory_stats()
    before = read_launches()
    t0 = time.perf_counter()
    rep = rt.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    after = read_launches()
    served = {k: after[k] - before[k] for k in after}

    summ = rep.summary
    log("serving", f"rwkv6-7b bf16 full width, 2 nodes, 4 slots, max_len {max_len}: "
        f"completed={summ['completed']}/{summ['requests']} dropped={summ['dropped']} "
        f"requeues={summ['requeues']} prefills={rep.counters['admitted']} "
        f"(prompts step the decode loop; launches in this run {served})")
    serving_summary(torch, "rwkv6-7b", rep, wall, served)
    if summ["completed"] != 8 or summ["dropped"] != 0:
        raise AssertionError(f"served {summ['completed']}/8 with {summ['dropped']} dropped")
    if any(served.values()):
        raise AssertionError(f"stepped prompt ingestion launched kernels: {served}")
    rids = check_streams(torch, api, model, engine, rt, wl, max_len)
    log("serving", f"rwkv6-7b requests {rids} equal a direct greedy decode")
    counts = read_launches()

    # What a forward and a tick are made of, and the kernel's share.
    s = 1024
    toks = torch.zeros((1, s), dtype=torch.long, device=DEVICE)
    logits_ms = host_ms(torch, lambda: api.logits(model, {"tokens": toks}), 3, warmup=1)
    cache = api.init_cache(1, max_len, device=DEVICE)
    last = torch.zeros((1, 1), dtype=torch.long, device=DEVICE)
    decode_ms = host_ms(torch, lambda: api.decode_step(model, cache, last, 0), 10)
    log("serving", f"per call: rwkv6-7b bf16 api.logits({s} tokens) {logits_ms:.3f} ms, of which "
        f"the WKV kernel {cfg.n_layers} x {wkv_ms:.4f} ms = "
        f"{cfg.n_layers * wkv_ms / logits_ms:.1%}; decode_step {decode_ms:.3f} ms")
    for name, fn, wall_ms in (("forward", lambda: api.logits(model, {"tokens": toks}), logits_ms),
                              ("decode_step", lambda: api.decode_step(model, cache, last, 0),
                               decode_ms)):
        dev, named, idle = device_split(torch, fn, 3, wall_ms, ("wkv_fwd_kernel",))
        log("serving", f"profile rwkv6-7b {name}: device {dev:.3f} ms of {wall_ms:.3f} ms "
            f"(idle share {idle:.4f}), WKV kernel {named['wkv_fwd_kernel']:.3f} ms")
    return counts


def phase_model_hymba(torch):
    from repro_torch.configs import hymba_1_5b
    from repro_torch.models.registry import build_api

    cfg = dataclasses.replace(
        hymba_1_5b.config(), param_dtype=torch.float32, compute_dtype=torch.float32)
    api = build_api("hymba-1.5b", cfg)
    model = api.init(0, device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    s = 128  # inside the window: the reference's forward and decode agree only there
    toks = torch.randint(0, cfg.vocab, (1, s), generator=gen, device=DEVICE)
    before = read_launches()
    full = api.logits(model, {"tokens": toks})
    torch.cuda.synchronize()
    after = read_launches()
    launched = {k: after[k] - before[k] for k in after}
    want = {"flash_attention": cfg.n_layers, "rwkv6_wkv": 0, "ssm_scan": cfg.n_layers}
    if launched != want:
        raise AssertionError(f"the forward launched {launched}, not {want}")
    cache = api.init_cache(1, s, device=DEVICE)
    rows = []
    for p in range(s):
        lg, cache = api.decode_step(model, cache, toks[:, p : p + 1], p)
        rows.append(lg)
    stepped = torch.cat(rows, dim=1)
    torch.cuda.synchronize()
    if not torch.isfinite(full).all() or full.shape != (1, s, cfg.vocab):
        raise AssertionError(f"forward logits: shape {tuple(full.shape)} or non-finite values")
    err = (full - stepped).abs().max().item()
    log("model", f"full hymba-1.5b f32 ({api.param_count()} params), forward over {s} tokens "
        f"(launches {launched}) vs stepped decode: logits max abs err {err:.3e} "
        f"(limit 1e-3); logits scale {stepped.abs().max().item():.3f}")
    if not err <= 1e-3:
        raise AssertionError(f"forward vs stepped logits: {err:.3e} > 1e-3")
    del model, cache, full, stepped, rows


def phase_serving_hymba(torch, flash_ms, ssm_ms):
    from repro_torch.configs import get_api
    from repro_torch.serving import (
        RealServingEngine, ServingAllocator, ServingConfig, ServingRuntime,
        generate_requests,
    )

    api = get_api("hymba-1.5b")
    cfg = api.cfg
    model = api.init(0, device=DEVICE)
    max_len = 256
    wl = generate_requests(
        8, seed=0, rate=4.0, prompt_min=16, prompt_mean=48, prompt_max=128,
        gen_min=8, gen_mean=16, gen_max=32,
    )
    engine = recording(RealServingEngine)(api, model, max_len=max_len, device=DEVICE)

    # Warm-up outside the counted run: cuBLAS handles.
    warm = api.init_cache(1, max_len, device=DEVICE)
    api.decode_step(model, warm, torch.zeros((1, 1), dtype=torch.long, device=DEVICE), 0)
    torch.cuda.synchronize()
    del warm

    alloc = ServingAllocator({0: (0.01, 0.01), 1: (0.01, 0.01)}, total_slots=4, mode="optperf")
    rt = ServingRuntime(engine, alloc, wl, nodes=[0, 1],
                        config=ServingConfig(total_slots=4, resolve_every=1.0))
    torch.cuda.reset_peak_memory_stats()
    before = read_launches()
    t0 = time.perf_counter()
    rep = rt.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    after = read_launches()
    served = {k: after[k] - before[k] for k in after}

    summ = rep.summary
    log("serving", f"hymba-1.5b bf16 full width, 2 nodes, 4 slots, max_len {max_len}: "
        f"completed={summ['completed']}/{summ['requests']} dropped={summ['dropped']} "
        f"requeues={summ['requeues']} prefills={rep.counters['admitted']} "
        f"(prompts step the decode loop; launches in this run {served})")
    serving_summary(torch, "hymba-1.5b", rep, wall, served)
    if summ["completed"] != 8 or summ["dropped"] != 0:
        raise AssertionError(f"served {summ['completed']}/8 with {summ['dropped']} dropped")
    if any(served.values()):
        raise AssertionError(f"stepped prompt ingestion launched kernels: {served}")
    rids = check_streams(torch, api, model, engine, rt, wl, max_len)
    log("serving", f"hymba-1.5b requests {rids} equal a direct greedy decode")
    counts = read_launches()

    # What a forward and a tick are made of, and each kernel's share.
    s = 1024
    toks = torch.zeros((1, s), dtype=torch.long, device=DEVICE)
    logits_ms = host_ms(torch, lambda: api.logits(model, {"tokens": toks}), 3, warmup=1)
    cache = api.init_cache(1, max_len, device=DEVICE)
    last = torch.zeros((1, 1), dtype=torch.long, device=DEVICE)
    decode_ms = host_ms(torch, lambda: api.decode_step(model, cache, last, 0), 10)
    n = cfg.n_layers
    log("serving", f"per call: hymba-1.5b bf16 api.logits({s} tokens) {logits_ms:.3f} ms, of "
        f"which the flash kernel {n} x {flash_ms:.4f} ms = {n * flash_ms / logits_ms:.1%} and "
        f"the selective-scan kernel {n} x {ssm_ms:.4f} ms = {n * ssm_ms / logits_ms:.1%}; "
        f"decode_step {decode_ms:.3f} ms")
    names = ("flash_fwd_kernel", "ssm_scan_fwd_kernel")
    for name, fn, wall_ms in (("forward", lambda: api.logits(model, {"tokens": toks}), logits_ms),
                              ("decode_step", lambda: api.decode_step(model, cache, last, 0),
                               decode_ms)):
        dev, named, idle = device_split(torch, fn, 3, wall_ms, names)
        log("serving", f"profile hymba-1.5b {name}: device {dev:.3f} ms of {wall_ms:.3f} ms "
            f"(idle share {idle:.4f}), flash kernel {named['flash_fwd_kernel']:.3f} ms, "
            f"selective-scan kernel {named['ssm_scan_fwd_kernel']:.3f} ms")
    return counts


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
        phase = "kernel (wkv)"
        wkv_rows = phase_kernel_wkv(torch)
        phase = "model"
        phase_model(torch)
        phase = "serving"
        olmo_counts = phase_serving(torch)
        torch.cuda.empty_cache()
        phase = "model (rwkv6)"
        reset_launches()
        phase_model_rwkv6(torch)
        torch.cuda.empty_cache()
        phase = "serving (rwkv6)"
        rwkv6_counts = phase_serving_rwkv6(torch, wkv_rows[WKV_MAIN_CASE]["ms"])
        log("serving", f"rwkv6-7b path launches {rwkv6_counts}")
        if rwkv6_counts != {"flash_attention": 0, "rwkv6_wkv": 32, "ssm_scan": 0}:
            raise AssertionError("the rwkv6-7b path must launch the WKV kernel once per "
                                 f"layer of its forward and nothing else: {rwkv6_counts}")
        torch.cuda.empty_cache()
        phase = "kernel (ssm)"
        ssm_rows = phase_kernel_ssm(torch)
        phase = "model (hymba)"
        reset_launches()
        phase_model_hymba(torch)
        torch.cuda.empty_cache()
        phase = "serving (hymba)"
        hymba_counts = phase_serving_hymba(
            torch, rows[HYMBA_FLASH_CASE]["ms"], ssm_rows[SSM_MAIN_CASE]["ms"])
        log("serving", f"hymba-1.5b path launches {hymba_counts}")
        if hymba_counts != {"flash_attention": 32, "rwkv6_wkv": 0, "ssm_scan": 32}:
            raise AssertionError("the hymba-1.5b path must launch the flash-attention and "
                                 "selective-scan kernels once per layer of its forward and "
                                 f"nothing else: {hymba_counts}")
    except Exception:  # the run's boundary: report the phase and fail
        traceback.print_exc()
        print(f"chip_smoke: phase {phase} failed", file=sys.stderr)
        return 1
    log("done", f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    kernels = []
    for name, source, replaces, main_row, launches in (
        ("flash_attention", SOURCE_REL, REPLACES, rows[MAIN_CASE],
         olmo_counts["flash_attention"]),
        ("rwkv6_wkv", WKV_SOURCE_REL, WKV_REPLACES, wkv_rows[WKV_MAIN_CASE],
         rwkv6_counts["rwkv6_wkv"]),
        ("ssm_scan", SSM_SOURCE_REL, SSM_REPLACES, ssm_rows[SSM_MAIN_CASE],
         hymba_counts["ssm_scan"]),
    ):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches,
            "max_abs_err": main_row["max_abs_err"],
            "ms": main_row["ms"],
            "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"],
        })
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
