#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one CUDA card and check its kernels.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, each of which fails the run:

1. device        — the card's name and power limit (``nvidia-smi``).
2. build         — compile every ``csrc/*.cu`` of the port for sm_90a into
                   ``build/kernels/``, one ``nvcc`` per source, all started
                   together; print the build seconds and ptxas report, and
                   the flash library's tensor-core (HGMMA) and TMA-load
                   (UTMALDG) instruction counts, the WKV library's
                   tensor-core (HMMA) count and the scan library's
                   special-function (MUFU) and shuffle (SHFL) counts from
                   ``cuobjdump -sass`` (the named ones must be non-zero; a
                   missing cuobjdump is printed); and, since the library's
                   count holds the forward's, the HGMMA and UTMALDG counts
                   of each bf16 backward kernel's own SASS (both head dims;
                   each must be non-zero) beside its ptxas registers and
                   spill bytes.
3. kernel        — the flash-attention kernel against its plain PyTorch
                   version on the card at the serving path's shapes (bf16
                   max abs error <= 1e-2: one output rounding plus another
                   sum order; f32 <= 1e-5), with the kernel's, the plain
                   version's and ``scaled_dot_product_attention``'s times
                   (CUDA events over back-to-back calls, which hold the
                   host's time between launches where that is longer)
                   beside the card's bound for the same work; also the
                   kernel's and the library call's device time per call
                   under ``torch.profiler`` (``device_ms``) and the host's
                   time to issue one kernel call (``issue_ms``).
4. kernel (wkv)  — the WKV kernel against its plain (chunked) version, all
                   float32 with K=64, out and final state within
                   1e-4 * max(1, max |plain|): float32 sums in another order
                   through decay factors up to exp(chunk * 4.6 / 2); also
                   the first pass's states entering each chunk against
                   ``wkv_chunk_states``, so that a wrong pass is named.  One
                   row puts every log-decay at the floor.
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
                   16 states in another order, through segments carried
                   with the reference's combine; rows cover a T with no
                   whole last segment and a T below one segment.  Beside
                   the times: busy ms, device ms with the L2 cache flushed
                   before every call (``cold_ms``) and the SM clock.
10. model (hymba) — full-width hymba-1.5b in float32 with seeded random
                   weights: the forward over 128 tokens (inside the window)
                   launches the flash-attention kernel (head dim 64) and the
                   selective-scan kernel once per layer each, and its logits
                   equal the stepped decode loop's (plain torch) within 1e-3.
11. serving (hymba) — full-width hymba-1.5b in bf16, as phase 8; then the
                   per-call times of a 1024-token forward and a decode step,
                   each kernel's share, device time and idle share.
12. kernel (flash bwd) — the flash-attention backward kernel (dQ, dK, dV
                   from the forward's log-sum-exp) against autograd through
                   the plain ``attention_ref`` on the card, at the training
                   shape and at hymba's, llama3-8b's and a float32 shape:
                   bf16 within 2e-2 * max(1, max |plain|), f32 within 1e-4 *
                   max(1, max |plain|), and a bf16 row's dq, dk, dv the same
                   bits on two calls (no atomics); with the kernel's, the
                   plain backward's (``attention_backward_ref``) and SDPA's
                   backward times (CUDA events, and SDPA's device ms under
                   ``torch.profiler``) beside the card's bound.
13. training (olmo-1b) — ``HeteroTrainer`` over ``RealBackend`` and
                   ``EpochLoop``: full-width olmo-1b in bf16 (remat on) on
                   the simulated ``cluster_A`` (3 nodes) with
                   ``CannikinController(3, [16, 32, 64], ref_batch=16)``,
                   ``SyntheticLM(seq 512, seed 0)``, SGD at lr 0.01, 2 steps
                   per epoch, 3 epochs (the third in the OptPerf phase).
                   Every loss finite, no node excluded, launch counts as the
                   path predicts, peak memory under 80 GB; each node step's
                   wall and device ms; and one node's float32 gradient at
                   full width (b=2, S=256) through the kernels against the
                   same gradient with the plain attention passed through the
                   layers' ``attend`` seam: global sq-norm within 1e-5
                   relative, every leaf within 1e-4 * max(1, max |g|).

The launch counts are set to 0 just before each model's path (phases 5-6
for olmo-1b, 7-8 for rwkv6-7b, 10-11 for hymba-1.5b, 13 for training) and
read just after it.  Device ms of a named kernel are per launch the
profiler recorded, with the count of records beside them.  The last three lines of standard output are the card line from
``nvidia-smi``, a JSON line describing each kernel, and ``{"ok": true,
"device": {...}}``.  Without a CUDA card, or without the repository beside
it, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import math
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
WKV_PROFILE_PREFIX = "wkv_"            # every CUDA kernel of the WKV passes
WKV_KERNELS = 2                        # wkv_states_kernel, wkv_out_kernel per call
SSM_REPLACES = "src/repro/kernels/ssm_scan/ssm_scan.py:63"
SSM_SOURCE_REL = "src/repro_torch/kernels/ssm_scan/csrc/ssm_scan.cu"
SSM_MAIN_CASE = "hymba-1.5b T=1024"    # the forward's shape at 1024 tokens
SSM_PROFILE_PREFIX = "ssm_"            # every CUDA kernel of the selective scan
HYMBA_FLASH_CASE = "hymba-1.5b global S=1024"
FLASH_PROFILE_NAME = "flash_fwd_kernel"  # both forward instances
BWD_PROFILE_NAME = "flash_bwd_"        # the backward's three kernels
BWD_SM90_KERNELS = ("flash_bwd_dkdv_kernel_sm90", "flash_bwd_dq_kernel_sm90")  # bf16
BWD_MAIN_CASE = "olmo-1b train S=512 B=8"
# name, B, S, H, KV, dtype, window, D (all causal self-attention)
BWD_CASES = [
    ("olmo-1b train S=512 B=8", 8, 512, 16, 16, "bf16", None, 128),
    ("hymba-1.5b global S=1024", 1, 1024, 25, 5, "bf16", None, 64),
    ("hymba-1.5b window=1024 S=2048", 1, 2048, 25, 5, "bf16", 1024, 64),
    ("llama3-8b heads S=1024", 1, 1024, 32, 8, "bf16", None, 128),
    ("f32 S=T=300", 1, 300, 16, 16, "f32", None, 128),
]
BWD_REL = {"bf16": 2e-2, "f32": 1e-4}

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
# name, B, T, H, chunk, strong decay (float32, K = 64)
WKV_CASES = [
    ("rwkv6-7b T=1024", 1, 1024, 64, 32, False),
    ("T=128", 1, 128, 64, 32, False),
    ("ragged T=300", 1, 300, 64, 32, False),
    ("B=4 T=256", 4, 256, 64, 32, False),
    ("chunk 64 T=1024", 1, 1024, 64, 64, False),
    ("strong decay T=1024", 1, 1024, 64, 32, True),
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
    ("T=1021 (no whole last segment)", 1, 1021, 3200, 128, False),
    ("T=5 (below one segment)", 1, 5, 3200, 128, True),
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


def device_split(torch, fn, calls: int, wall_ms: float, kernels, launches=None):
    """Device milliseconds per call (kernel time under ``torch.profiler``),
    each named kernel's part of it, the device's idle share of ``wall_ms``,
    the unprofiled host time per call, each named kernel's busy ms and its
    count of records (see ``profile_device``).  The total is per call made:
    a lost record lowers it, which the named kernels' records show."""
    dev, named, busy, records = profile_device(torch, fn, calls, kernels, launches=launches)
    return dev, named, 1.0 - dev / wall_ms, busy, records


def device_ms(torch, fn, calls: int, warmup: int = 3) -> float:
    """Milliseconds of device time per call: every kernel ``fn`` launches,
    under ``torch.profiler``.  Unlike ``cuda_ms`` it leaves out the host's
    time between launches, which bounds a short kernel's back-to-back rate."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    return profile_device(torch, fn, calls, ())[0]


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals: the time at least one
    of them runs."""
    total, reach = 0.0, float("-inf")
    for start, end in sorted(intervals):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total


def profile_device(torch, fn, calls: int, kernels, attempts: int = 3, launches=None):
    """Device milliseconds per call (the sum of kernel times under
    ``torch.profiler``), each named kernel's part of that sum (every kernel
    whose name holds the given name), each named kernel's busy milliseconds
    per call (the union of those same kernels' intervals, which counts once
    the time where they overlap, as the WKV passes do, and equals their
    part of the sum where none overlap), and each named kernel's count of
    records.  The profiler can lose kernel records (on an H100, this
    script's scan windows recorded 12-13 of 20 launches): where ``launches``
    gives a named kernel's launches per call, its part and busy time are
    taken per recorded launch times that count, not per call.  A window that records
    no device time at all is profiled again, up to ``attempts`` windows."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    launches = launches or {}
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        device = 0.0
        named = dict.fromkeys(kernels, 0.0)
        records = dict.fromkeys(kernels, 0)
        for evt in prof.key_averages():
            if evt.device_type == DeviceType.CUDA and not getattr(evt, "is_user_annotation", False):
                device += evt.self_device_time_total
                for kernel in kernels:
                    if kernel in evt.key:
                        named[kernel] += evt.self_device_time_total
                        records[kernel] += evt.count
        if device > 0.0 and all(records[k] for k in launches):
            per = {k: records[k] / launches[k] if k in launches else calls for k in kernels}
            named_ms = {kernel: t / 1e3 / per[kernel] for kernel, t in named.items()}
            busy_ms = {kernel: busy_us((evt.time_range.start, evt.time_range.end)
                                       for evt in prof.events()
                                       if evt.device_type == DeviceType.CUDA
                                       and evt.self_device_time_total > 0
                                       and kernel in evt.name) / 1e3 / per[kernel]
                       for kernel in kernels}
            return device / 1e3 / calls, named_ms, busy_ms, records
    raise RuntimeError(f"the profiler recorded no device time in {attempts} windows")


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
            if any(w in line for w in ("registers", "spill", "smem", "wgmma", "Function properties")):
                log("build", line.strip())
    for fn, regs, stores, loads in ptxas_summary(results[0].log, BWD_SM90_KERNELS):
        log("build", f"ptxas {fn}: registers={regs} spill_stores={stores} spill_loads={loads}")
    for res, need, why in ((results[0], ("HGMMA", "UTMALDG"), "run wgmma on TMA tiles"),
                           (results[1], ("HMMA",), "run its products on the tensor cores"),
                           (results[2], ("MUFU",), "compute its exponentials")):
        source = res.path.name.split("-")[0] + ".cu"
        by_fn = sass_counts(build, res.path)
        if by_fn is None:
            log("build", f"{source} SASS: cuobjdump is missing, {'/'.join(need)} not counted")
            continue
        counts = sum_counts(by_fn.values())
        log("build", f"{source} SASS: " + " ".join(f"{k}={v}" for k, v in counts.items()))
        if not all(counts[op] for op in need):
            raise AssertionError(f"{source} must {why}: {counts}")
        if res is not results[0]:
            continue
        # The library-wide count holds the forward's wgmma and TMA loads:
        # the bf16 backward kernels must show their own.
        for kernel in BWD_SM90_KERNELS:
            own = {fn: c for fn, c in by_fn.items() if kernel in fn}
            if len(own) != 2:  # head dims 64 and 128
                raise AssertionError(f"{kernel}: expected two instances in the SASS, got {list(own)}")
            for fn, c in sorted(own.items()):
                log("build", f"{source} SASS {kernel}<{'128' if 'ILi128E' in fn else '64'}>: "
                    + " ".join(f"{k}={c[k]}" for k in ("HGMMA", "UTMALDG")))
                if not (c["HGMMA"] and c["UTMALDG"]):
                    raise AssertionError(f"{fn} must run wgmma on TMA tiles: {c}")


def ptxas_summary(log_text, names):
    """(function, registers, spill-store bytes, spill-load bytes) from ptxas's
    ``-v`` report for each entry function whose name holds one of ``names``."""
    import re

    rows, current, spills = [], None, None
    for line in log_text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)", line)
        if m:
            current = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and current and any(n in current for n in names):
            rows.append((current, int(m.group(1)), *(spills or (None, None))))
            spills = None
    return rows


SASS_OPS = ("HGMMA", "HMMA", "UTMALDG", "LDGSTS", "MUFU", "SHFL")


def sum_counts(counts):
    total = dict.fromkeys(SASS_OPS, 0)
    for c in counts:
        for op in SASS_OPS:
            total[op] += c[op]
    return total


def sass_counts(build, lib):
    """Tensor-core (HGMMA: wgmma; HMMA: mma.sync), TMA-load (UTMALDG),
    cp.async (LDGSTS), special-function (MUFU: exponentials) and cross-lane
    (SHFL) instructions in each function of a built library's SASS (by its
    mangled name), or None without cuobjdump."""
    import shutil

    tool = shutil.which("cuobjdump")
    beside = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    if tool is None and os.path.exists(beside):
        tool = beside
    if tool is None:
        return None
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    by_fn, counts = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            counts = by_fn.setdefault(line.split("Function :", 1)[1].strip(),
                                      dict.fromkeys(SASS_OPS, 0))
            continue
        if counts is None:
            continue
        for word in line.split():
            op = word.split(".")[0]
            if op in counts:
                counts[op] += 1
    return by_fn


def issue_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    """Host milliseconds to issue one call: the host clock over ``iters``
    calls, read before the closing synchronize."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / iters


def flash_case(torch, flash_attention, attention_ref, case, gen):
    """One ``KERNEL_CASES`` row for a flash-attention entry and its plain
    version: the kernel's max abs error, its, the plain version's and
    ``scaled_dot_product_attention``'s CUDA-event ms over back-to-back calls
    (``ms``, ``plain_ms``, ``library_ms``), the kernel's device ms per
    recorded launch under ``torch.profiler`` (``device_ms``, with
    ``records`` of the 20 launches) and the library call's per call
    (``library_device_ms``), the host's ms to issue one kernel call
    (``issue_ms``) and the card's bound."""
    import torch.nn.functional as F

    name, b, s, h, kv, dt, window, d = case
    dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[dt]
    q, k, v = (torch.randn((b, s, n, d), generator=gen, device=DEVICE).to(dtype)
               for n in (h, kv, kv))

    def kernel():
        return flash_attention(q, k, v, causal=True, window=window)

    out = kernel()
    torch.cuda.synchronize()
    ref = attention_ref(q, k, v, causal=True, window=window)
    err = (out.float() - ref.float()).abs().max().item()
    del out, ref

    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    mask = None
    if window is not None:
        pos = torch.arange(s, device=DEVICE)
        mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)

    def library():
        return F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=mask is None, enable_gqa=h != kv)

    bound_ms, bound_by = attention_bound(b, s, h, kv, d, dt, window)
    ms = cuda_ms(torch, kernel, 20)
    _, named, _, records = profile_device(torch, kernel, 20, (FLASH_PROFILE_NAME,),
                                          launches={FLASH_PROFILE_NAME: 1})
    return dict(
        max_abs_err=err,
        ms=ms,
        plain_ms=cuda_ms(torch, lambda: attention_ref(q, k, v, causal=True, window=window), 5),
        library_ms=cuda_ms(torch, library, 20),
        device_ms=named[FLASH_PROFILE_NAME], records=records[FLASH_PROFILE_NAME],
        library_device_ms=device_ms(torch, library, 20),
        issue_ms=issue_ms(torch, kernel, 20),
        bound_ms=bound_ms, bound_by=bound_by,
    )


def phase_kernel(torch):
    from repro_torch.kernels.flash_attention import attention_ref, flash_attention

    gen = torch.Generator(device=DEVICE).manual_seed(0)
    rows = {}
    for case in KERNEL_CASES:
        name, b, s, h, kv, dt, window, d = case
        row = rows[name] = flash_case(torch, flash_attention, attention_ref, case, gen)
        err, ms = row["max_abs_err"], row["ms"]
        if not err <= TOL[dt]:
            raise AssertionError(f"{name}: max abs err {err:.3e} > {TOL[dt]:.0e}")
        log("kernel", f"{name} B={b} H={h} KV={kv} D={d} {dt} window={window}: "
            f"max_abs_err={err:.3e} (tol {TOL[dt]:.0e}) ms={ms:.4f} "
            f"plain_ms={row['plain_ms']:.4f} library_ms={row['library_ms']:.4f} "
            f"bound_ms={row['bound_ms']:.5f} ({row['bound_by']}) "
            f"of_bound={row['bound_ms'] / ms:.4f} device_ms={row['device_ms']:.4f} "
            f"records={row['records']}/20 "
            f"library_device_ms={row['library_device_ms']:.4f} issue_ms={row['issue_ms']:.4f}")
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


def wkv_case(torch, mod, case, gen):
    """One ``WKV_CASES`` row for a WKV package ``mod`` (its ``wkv`` and
    plain ``wkv_chunked``): max abs errors of out and the final state and,
    where the package has ``wkv_with_chunk_states``, of the first pass's
    states entering each chunk against ``wkv_chunk_states``, each beside
    its tolerance; the kernel's and the plain version's CUDA-event ms over
    back-to-back calls (``ms``, ``plain_ms``), the kernel's device ms per
    call under ``torch.profiler`` (``device_ms``: the WKV passes' summed
    time; ``busy_ms``: the union of their intervals, which counts their
    overlap once; both per recorded launch, ``records`` of the 40), the
    host's ms to issue one call (``issue_ms``) and the card's bound."""
    name, b, t, h, chunk, strong = case
    k = 64

    def rand(shape, scale):
        return torch.randn(shape, generator=gen, device=DEVICE) * scale

    r, kk, v = (rand((b, t, h, k), 0.5) for _ in range(3))
    if strong:  # every log-decay clamps to the floor: mid-point exponents +-chunk * 2.3
        lw = mod.LOG_DECAY_MIN - rand((b, t, h, k), 1.0).abs()
    else:
        lw = -torch.exp(rand((b, t, h, k), 1.0))
    u = rand((h, k), 0.2)
    pairs = []
    # A package from before the two-pass kernel (tools/kernel_compare.py
    # times one beside this checkout) has no chunk states to check.
    if hasattr(mod, "wkv_with_chunk_states"):
        out, state, states = mod.wkv_with_chunk_states(r, kk, v, lw, u, chunk=chunk)
        torch.cuda.synchronize()
        pairs.append(("states", states, mod.wkv_chunk_states(kk, v, lw, chunk=chunk)[0]))
    else:
        out, state = mod.wkv(r, kk, v, lw, u, chunk=chunk)
    ref_out, ref_state = mod.wkv_chunked(r, kk, v, lw, u, chunk=chunk)
    pairs += [("out", out, ref_out), ("state", state, ref_state)]
    errs = {key: (got - want).abs().max().item() for key, got, want in pairs}
    tols = {key: WKV_REL * max(1.0, want.abs().max().item()) for key, _, want in pairs}
    del pairs, out, state, ref_out, ref_state

    def kernel():
        return mod.wkv(r, kk, v, lw, u, chunk=chunk)

    bound_ms, bound_by = wkv_bound(b, t, h, k)
    ms = cuda_ms(torch, kernel, 20)
    _, named, busy, records = profile_device(torch, kernel, 20, (WKV_PROFILE_PREFIX,),
                                             launches={WKV_PROFILE_PREFIX: WKV_KERNELS})
    return dict(
        errs=errs, tols=tols, max_abs_err=max(errs.values()), ms=ms,
        plain_ms=cuda_ms(torch, lambda: mod.wkv_chunked(r, kk, v, lw, u, chunk=chunk), 3),
        library_ms=None, device_ms=named[WKV_PROFILE_PREFIX], busy_ms=busy[WKV_PROFILE_PREFIX],
        records=records[WKV_PROFILE_PREFIX],
        issue_ms=issue_ms(torch, kernel, 20),
        bound_ms=bound_ms, bound_by=bound_by,
    )


def phase_kernel_wkv(torch):
    from repro_torch.kernels import rwkv6_wkv

    gen = torch.Generator(device=DEVICE).manual_seed(2)
    rows = {}
    for case in WKV_CASES:
        name, b, t, h, chunk, strong = case
        row = rows[name] = wkv_case(torch, rwkv6_wkv, case, gen)
        errs, tols, ms = row["errs"], row["tols"], row["ms"]
        for key, err in errs.items():
            if not err <= tols[key]:
                raise AssertionError(f"wkv {name}: {key} max abs err {err:.3e} > {tols[key]:.3e}")
        log("kernel", f"wkv {name} B={b} H={h} K=64 chunk={chunk} f32: max_abs_err "
            + " ".join(f"{key}={err:.3e} (tol {tols[key]:.3e})" for key, err in errs.items())
            + f" ms={ms:.4f} plain_ms={row['plain_ms']:.4f} bound_ms={row['bound_ms']:.5f} "
            f"({row['bound_by']}) of_bound={row['bound_ms'] / ms:.4f} "
            f"device_ms={row['device_ms']:.4f} busy_ms={row['busy_ms']:.4f} "
            f"records={row['records']}/{20 * WKV_KERNELS} "
            f"of_bound_busy={row['bound_ms'] / row['busy_ms']:.4f} "
            f"issue_ms={row['issue_ms']:.4f}")
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


def sm_clock() -> str:
    """The card's SM clock and active clock-event reasons, as ``nvidia-smi``
    reads them now (its error text where the query fails)."""
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks_throttle_reasons.active",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return (proc.stdout.strip() or proc.stderr.strip()).splitlines()[0]


def cold_device_ms(torch, fn, calls: int, kernel: str, flush_mb: int = 256):
    """Device ms per call of the kernels named ``kernel`` (one launch per
    call) when every call finds the L2 cache cold: a ``flush_mb`` scratch
    tensor is written before each call, and only the named kernels' time is
    counted; and how many of the ``calls`` launches the profiler recorded."""
    flush = torch.empty(flush_mb * 2**18, dtype=torch.float32, device=DEVICE)

    def cold():
        flush.zero_()
        fn()

    for _ in range(2):
        cold()
    torch.cuda.synchronize()
    _, named, _, records = profile_device(torch, cold, calls, (kernel,), launches={kernel: 1})
    del flush
    return named[kernel], records[kernel]


def ssm_inputs(torch, case, gen):
    """Seeded float32 inputs of one ``SSM_CASES`` row: dt > 0 as softplus
    gives it, A = -exp(log_a) < 0; a strong-decay row draws dt |A| up to
    about 50, so the state forgets within a step."""
    name, b, t, d, chunk, strong = case
    n = 16

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=DEVICE)

    u = rand(b, t, d)
    dt = torch.exp(rand(b, t, d) * 0.5) * (3.0 if strong else 0.3)
    bt, ct = rand(b, t, n), rand(b, t, n)
    log_a = rand(d, n) * (1.0 if strong else 0.5)
    return u, dt, bt, ct, log_a


def ssm_row(torch, mod, inputs, chunk):
    """The selective-scan package ``mod`` (its ``ssm_scan`` and plain
    ``selective_scan_ref``) on ``inputs`` (u, dt, b_t, c_t, log_a): max abs
    errors of y and the final state, each beside its tolerance; the
    kernel's and the plain version's CUDA-event ms over back-to-back calls
    (``ms``, ``plain_ms``), the ``ssm_`` kernels' device ms per call under
    ``torch.profiler`` (``device_ms``: their summed time; ``busy_ms``: the
    union of their intervals), both per recorded launch, and how many of
    the 20 launches the profiler recorded (``records``), the same with the
    L2 cache flushed before every call (``cold_ms``, ``cold_records``), the
    host's ms to issue one call (``issue_ms``), the card's bound and the SM
    clock before and after the row."""
    u, dt, bt, ct, log_a = inputs
    b, t, d = u.shape
    n = bt.shape[-1]
    clock_before = sm_clock()
    y, h = mod.ssm_scan(u, dt, bt, ct, log_a, chunk=chunk)
    torch.cuda.synchronize()
    ref_y, ref_h = mod.selective_scan_ref(u, dt, log_a, bt, ct)
    pairs = (("y", y, ref_y), ("state", h, ref_h))
    errs = {key: (got - want).abs().max().item() for key, got, want in pairs}
    tols = {key: SSM_REL * max(1.0, want.abs().max().item()) for key, _, want in pairs}
    del pairs, y, h, ref_y, ref_h

    def kernel():
        return mod.ssm_scan(u, dt, bt, ct, log_a, chunk=chunk)

    bound_ms, bound_by, sfu_ms = ssm_bound(b, t, d, n)
    ms = cuda_ms(torch, kernel, 20)
    _, named, busy, records = profile_device(torch, kernel, 20, (SSM_PROFILE_PREFIX,),
                                             launches={SSM_PROFILE_PREFIX: 1})
    cold_ms, cold_records = cold_device_ms(torch, kernel, 20, SSM_PROFILE_PREFIX)
    return dict(
        errs=errs, tols=tols, max_abs_err=max(errs.values()), ms=ms,
        plain_ms=cuda_ms(torch, lambda: mod.selective_scan_ref(u, dt, log_a, bt, ct), 2,
                         warmup=1),
        library_ms=None, device_ms=named[SSM_PROFILE_PREFIX],
        busy_ms=busy[SSM_PROFILE_PREFIX], records=records[SSM_PROFILE_PREFIX],
        cold_ms=cold_ms, cold_records=cold_records,
        issue_ms=issue_ms(torch, kernel, 20),
        bound_ms=bound_ms, bound_by=bound_by, sfu_exp_ms=sfu_ms,
        clock_before=clock_before, clock_after=sm_clock(),
    )


def ssm_case(torch, mod, case, gen):
    """One ``SSM_CASES`` row for a selective-scan package ``mod``: see
    ``ssm_row``."""
    return ssm_row(torch, mod, ssm_inputs(torch, case, gen), case[4])


def log_ssm_row(label, row):
    errs, tols, ms = row["errs"], row["tols"], row["ms"]
    for key, err in errs.items():
        if not err <= tols[key]:
            raise AssertionError(f"ssm {label}: {key} max abs err {err:.3e} > {tols[key]:.3e}")
    log("kernel", f"ssm {label} f32: max_abs_err "
        + " ".join(f"{key}={err:.3e} (tol {tols[key]:.3e})" for key, err in errs.items())
        + f" ms={ms:.4f} plain_ms={row['plain_ms']:.4f} library_ms=none "
        f"bound_ms={row['bound_ms']:.5f} ({row['bound_by']}) sfu_exp_ms={row['sfu_exp_ms']:.5f} "
        f"device_ms={row['device_ms']:.4f} busy_ms={row['busy_ms']:.4f} "
        f"of_bound_device={row['bound_ms'] / row['device_ms']:.4f} "
        f"cold_ms={row['cold_ms']:.4f} records={row['records']}/20 cold_records="
        f"{row['cold_records']}/20 issue_ms={row['issue_ms']:.4f} "
        f"clock [{row['clock_before']}] -> [{row['clock_after']}]")


def phase_kernel_ssm(torch):
    from repro_torch.kernels import ssm_scan

    gen = torch.Generator(device=DEVICE).manual_seed(4)
    rows = {}
    for case in SSM_CASES:
        name, b, t, d, chunk, strong = case
        rows[name] = ssm_case(torch, ssm_scan, case, gen)
        log_ssm_row(f"{name}: B={b} T={t} D={d} N=16 chunk={chunk}", rows[name])
    return rows


KERNEL_NAMES = ("flash_attention", "rwkv6_wkv", "ssm_scan", "flash_attention_backward")


def _wrappers():
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_backward
    from repro_torch.kernels.rwkv6_wkv import wkv
    from repro_torch.kernels.ssm_scan import ssm_scan

    return dict(zip(KERNEL_NAMES, (flash_attention, wkv, ssm_scan, flash_attention_backward)))


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
    if (launches != cfg.n_layers * prefills or counts["rwkv6_wkv"] or counts["ssm_scan"]
            or counts["flash_attention_backward"]):
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
        launches = {FLASH_PROFILE_NAME: cfg.n_layers} if name == "prefill" else None
        dev, named, idle, _, records = device_split(torch, fn, 3, wall_ms, (FLASH_PROFILE_NAME,),
                                                    launches)
        log("serving", f"profile olmo-1b {name}: device {dev:.3f} ms of {wall_ms:.3f} ms "
            f"(idle share {idle:.4f}), flash kernel {named[FLASH_PROFILE_NAME]:.3f} ms "
            f"(records {records[FLASH_PROFILE_NAME]}/{3 * cfg.n_layers if launches else 0})")
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
        per = WKV_KERNELS * cfg.n_layers if name == "forward" else 0
        dev, named, idle, busy, records = device_split(
            torch, fn, 3, wall_ms, (WKV_PROFILE_PREFIX,),
            {WKV_PROFILE_PREFIX: per} if per else None)
        log("serving", f"profile rwkv6-7b {name}: device {dev:.3f} ms of {wall_ms:.3f} ms "
            f"(idle share {idle:.4f}), WKV kernel (every pass) "
            f"{named[WKV_PROFILE_PREFIX]:.3f} ms, busy {busy[WKV_PROFILE_PREFIX]:.3f} ms "
            f"(records {records[WKV_PROFILE_PREFIX]}/{3 * per})")
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
    want = {"flash_attention": cfg.n_layers, "rwkv6_wkv": 0, "ssm_scan": cfg.n_layers,
            "flash_attention_backward": 0}
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
    names = (FLASH_PROFILE_NAME, SSM_PROFILE_PREFIX)
    for name, fn, wall_ms in (("forward", lambda: api.logits(model, {"tokens": toks}), logits_ms),
                              ("decode_step", lambda: api.decode_step(model, cache, last, 0),
                               decode_ms)):
        launches = ({SSM_PROFILE_PREFIX: cfg.n_layers, FLASH_PROFILE_NAME: cfg.n_layers}
                    if name == "forward" else None)
        dev, named, idle, busy, records = device_split(torch, fn, 3, wall_ms, names, launches)
        want = 3 * cfg.n_layers if launches else 0
        log("serving", f"profile hymba-1.5b {name}: device {dev:.3f} ms of {wall_ms:.3f} ms "
            f"(idle share {idle:.4f}), flash kernel {named[FLASH_PROFILE_NAME]:.3f} ms, "
            f"selective-scan kernels {named[SSM_PROFILE_PREFIX]:.3f} ms, "
            f"busy {busy[SSM_PROFILE_PREFIX]:.3f} ms (records flash "
            f"{records[FLASH_PROFILE_NAME]}/{want}, scan {records[SSM_PROFILE_PREFIX]}/{want})")
    return counts


def attention_bwd_bound(b, s, h, kv, d, dtype, window):
    """Least time for one attention backward: q, k, v, o, dO and the lse
    read once, dq, dk, dv written once, over the memory rate; or its five
    products over the valid (query, key) pairs (S and dP recomputed, dV,
    dK, dQ: 2.5x the forward's two) over the peak rate for the dtype."""
    elem = 2 if dtype == "bf16" else 4
    nbytes = elem * d * b * s * (3 * h + 2 * kv) + 4 * b * h * s + elem * d * b * (h * s + 2 * kv * s)
    w = s if window is None else min(window, s)
    pairs = sum(min(q + 1, w) for q in range(s))
    flops = 10 * d * b * h * pairs
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / PEAK_FLOPS[dtype]
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes"
    return t_ops * 1e3, "operations"


def flash_bwd_case(torch, case, gen):
    """One ``BWD_CASES`` row: the backward kernel's dq, dk, dv against
    autograd through ``attention_ref`` (max abs errors, each beside its
    tolerance) and whether two calls give the same bits; the kernel's, the
    plain backward's (``attention_backward_ref``: the same inputs, the same
    formulas) and SDPA's backward's CUDA-event ms over back-to-back calls;
    the kernel's device ms per recorded call (its three kernels), SDPA's
    backward's device ms per call and the card's bound."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (
        attention_backward_ref, attention_ref, flash_attention_backward, ops)

    name, b, s, h, kv, dt, window, d = case
    dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[dt]
    q, k, v, do = (torch.randn((b, s, n, d), generator=gen, device=DEVICE).to(dtype)
                   for n in (h, kv, kv, h))
    scale = 1.0 / d ** 0.5
    out, lse = ops._forward(q, k, v, True, window, scale, None, with_lse=True)

    def kernel():
        return flash_attention_backward(q, k, v, out, lse, do, causal=True, window=window)

    got = kernel()
    again = kernel()
    torch.cuda.synchronize()
    bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
    del again
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(attention_ref(*leaves, causal=True, window=window), leaves, do)
    errs = {key: (g.float() - w.float()).abs().max().item()
            for key, g, w in zip(("dq", "dk", "dv"), got, want)}
    tols = {key: BWD_REL[dt] * max(1.0, w.float().abs().max().item())
            for key, w in zip(("dq", "dk", "dv"), want)}
    del got, want, leaves

    qt, kt, vt = (x.transpose(1, 2).detach().clone().requires_grad_() for x in (q, k, v))
    mask = None
    if window is not None:
        pos = torch.arange(s, device=DEVICE)
        mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
    lib_out = F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, is_causal=mask is None, enable_gqa=h != kv)
    lib_do = do.transpose(1, 2)

    def library():
        return torch.autograd.grad(lib_out, (qt, kt, vt), lib_do, retain_graph=True)

    bound_ms, bound_by = attention_bwd_bound(b, s, h, kv, d, dt, window)
    ms = cuda_ms(torch, kernel, 10)
    _, named, _, records = profile_device(torch, kernel, 10, (BWD_PROFILE_NAME,),
                                          launches={BWD_PROFILE_NAME: 3})
    row = dict(
        errs=errs, tols=tols, max_abs_err=max(errs.values()), bitwise_repeat=bitwise, ms=ms,
        plain_ms=cuda_ms(torch, lambda: attention_backward_ref(
            q, k, v, out, lse, do, causal=True, window=window), 2, warmup=1),
        library_ms=cuda_ms(torch, library, 10),
        device_ms=named[BWD_PROFILE_NAME], records=records[BWD_PROFILE_NAME],
        library_device_ms=device_ms(torch, library, 10),
        bound_ms=bound_ms, bound_by=bound_by,
    )
    del lib_out
    return row


def phase_kernel_bwd(torch):
    gen = torch.Generator(device=DEVICE).manual_seed(6)
    rows = {}
    for case in BWD_CASES:
        name, b, s, h, kv, dt, window, d = case
        row = rows[name] = flash_bwd_case(torch, case, gen)
        for key, err in row["errs"].items():
            if not err <= row["tols"][key]:
                raise AssertionError(f"flash bwd {name}: {key} max abs err {err:.3e} > "
                                     f"{row['tols'][key]:.3e}")
        if dt == "bf16" and not row["bitwise_repeat"]:
            raise AssertionError(f"flash bwd {name}: two calls gave different bits")
        log("kernel", f"flash bwd {name} B={b} H={h} KV={kv} D={d} {dt} window={window}: "
            "max_abs_err " + " ".join(f"{key}={err:.3e} (tol {row['tols'][key]:.3e})"
                                      for key, err in row["errs"].items())
            + f" ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
            f"library_ms={row['library_ms']:.4f} "
            f"library_device_ms={row['library_device_ms']:.4f} bound_ms={row['bound_ms']:.5f} "
            f"({row['bound_by']}) device_ms={row['device_ms']:.4f} "
            f"records={row['records']}/30 of_bound_device={row['bound_ms'] / row['device_ms']:.4f} "
            f"bitwise_repeat={row['bitwise_repeat']}")
    return rows


def node_grad_check(torch):
    """One node's float32 gradient at full width (b=2, S=256): through the
    flash kernels against the plain attention passed through the layers'
    ``attend`` seam."""
    import functools

    from repro_torch.configs import olmo_1b
    from repro_torch.kernels.flash_attention import attention_ref
    from repro_torch.models import common
    from repro_torch.models.registry import build_api

    cfg = dataclasses.replace(
        olmo_1b.config(), param_dtype=torch.float32, compute_dtype=torch.float32)
    model = build_api("olmo-1b", cfg).init(0, device=DEVICE).requires_grad_(True)
    gen = torch.Generator(device=DEVICE).manual_seed(7)
    tokens = torch.randint(0, cfg.vocab, (2, 257), generator=gen, device=DEVICE)
    grads = {}
    for name, attend in (("kernel", None),
                         ("plain", functools.partial(attention_ref, causal=True))):
        logits = model.train_forward(tokens[:, :-1], attend=attend)
        loss, w_sum = common.weighted_cross_entropy(logits, tokens[:, 1:])
        grads[name] = torch.autograd.grad(loss / w_sum, list(model.parameters()))
        del logits, loss
    sq = {k: sum(float((g.double() ** 2).sum()) for g in v) for k, v in grads.items()}
    rel_sq = abs(sq["kernel"] - sq["plain"]) / sq["plain"]
    worst = max(((g - w).abs().max().item() / max(1.0, w.abs().max().item()), n)
                for (n, _), g, w in zip(model.named_parameters(), grads["kernel"],
                                        grads["plain"]))
    log("training", f"full olmo-1b f32 node gradient (b=2, S=256), kernels vs plain "
        f"attention: global sq-norm {sq['kernel']:.6e} vs {sq['plain']:.6e} (rel {rel_sq:.3e}, "
        f"limit 1e-5); worst leaf {worst[1]} err {worst[0]:.3e} x max(1, max|g|) (limit 1e-4)")
    if not rel_sq <= 1e-5 or not worst[0] <= 1e-4:
        raise AssertionError(f"node gradient: sq-norm rel {rel_sq:.3e}, leaf {worst}")
    del model, grads


def node_step_row(torch, backend, data, b, b_max):
    """One node's step (its forward and backward, ``backend.node_grads``) on
    a padded (b_max, S) slice of ``data`` with b samples weighted: wall ms
    on the host clock, device ms and idle share under ``torch.profiler``,
    and the flash forward's and backward's parts per recorded launch with
    their records."""
    raw = data.batch(0, b_max)
    tok = torch.as_tensor(raw["tokens"], device=DEVICE)
    lab = torch.as_tensor(raw["labels"], device=DEVICE)
    msk = (torch.arange(b_max, device=DEVICE) < b).float()
    cfg = backend.api.cfg
    launches = {FLASH_PROFILE_NAME: (2 if cfg.remat else 1) * cfg.n_layers,
                BWD_PROFILE_NAME: 3 * cfg.n_layers}

    def step():
        return backend.node_grads(tok, lab, msk)

    wall_ms = host_ms(torch, step, 2, warmup=1)
    dev, named, idle, _, records = device_split(
        torch, step, 1, wall_ms, (FLASH_PROFILE_NAME, BWD_PROFILE_NAME), launches)
    return dict(wall_ms=wall_ms, device_ms=dev, idle_share=idle,
                flash_fwd_ms=named[FLASH_PROFILE_NAME],
                flash_fwd_records=records[FLASH_PROFILE_NAME],
                flash_fwd_launches=launches[FLASH_PROFILE_NAME],
                flash_bwd_ms=named[BWD_PROFILE_NAME],
                flash_bwd_records=records[BWD_PROFILE_NAME],
                flash_bwd_launches=launches[BWD_PROFILE_NAME])


def phase_training(torch):
    """Full-width olmo-1b trained by HeteroTrainer on the simulated cluster_A."""
    from repro_torch.configs import get_api
    from repro_torch.core.controller import CannikinController
    from repro_torch.core.simulator import SimulatedCluster, cluster_A
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.optim.optimizers import constant_schedule, sgd
    from repro_torch.train.hetero import HeteroTrainer

    api = get_api("olmo-1b")
    cfg = api.cfg
    profiles, comm = cluster_A()
    sim = SimulatedCluster(profiles, comm, noise=0.01, seed=0)
    policy = CannikinController(sim.n, batch_candidates=[16, 32, 64], ref_batch=16)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=512, seed=0)
    steps = 2
    trainer = HeteroTrainer(api, sgd(constant_schedule(0.01)), sim, policy, data,
                            steps_per_epoch=steps, seed=0, device=DEVICE)
    backend = trainer.backend
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    walls = []
    for _ in range(3):
        te = time.perf_counter()
        rec = trainer.run_epoch()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - te)
        res = trainer.loop.last_result
        log("training", f"epoch {rec.epoch} phase={rec.phase} total_batch={rec.total_batch} "
            f"batches={list(rec.batches)} lr_scale={rec.lr_scale:.6f} "
            f"predicted_batch_s={rec.predicted_batch_time} sim_epoch_s={rec.sim_seconds:.6f} "
            f"sim_clock_s={trainer.sim_time:.6f} losses={[round(x, 6) for x in res.losses]} "
            f"mean_loss={rec.mean_loss:.6f} b_noise={rec.b_noise:.6e} "
            f"sq_i={[[f'{x:.6e}' for x in o.local_sqnorms] for o in res.grad_observations]} "
            f"sq_g={[f'{o.global_sqnorm:.6e}' for o in res.grad_observations]} "
            f"anomalies={list(res.grad_anomalies)} wall_s={walls[-1]:.3f}")
        if not all(math.isfinite(x) for x in res.losses) or any(res.grad_anomalies):
            raise AssertionError(f"epoch {rec.epoch}: losses {res.losses}, anomalies "
                                 f"{res.grad_anomalies}")
    counts = read_launches()
    peak = torch.cuda.max_memory_allocated()
    n, layers = sim.n, cfg.n_layers
    per_node = 2 if cfg.remat else 1  # remat runs each layer's forward again
    want = {name: 0 for name in KERNEL_NAMES}
    want["flash_attention"] = 3 * steps * (n * per_node * layers + layers)
    want["flash_attention_backward"] = 3 * steps * n * layers
    log("training", f"olmo-1b bf16 full width, cluster_A ({n} nodes), 3 epochs x {steps} steps "
        f"in {time.perf_counter() - t0:.2f} s; launches {counts} (expected {want}); "
        f"peak_mem_gb={peak / 1e9:.3f}; transfers {backend.transfers.snapshot()}")
    if counts != want:
        raise AssertionError(f"training launches {counts} != {want}")
    if trainer.history[-1].phase != "optperf":
        raise AssertionError("the controller did not reach its OptPerf phase")
    if not peak < 80e9:
        raise AssertionError(f"peak device memory {peak / 1e9:.1f} GB")

    # Each node's step of the last plan: its forward and backward alone.
    batches = list(trainer.history[-1].batches)
    b_max = max(8, -(-max(batches) // 8) * 8)
    for i, b in enumerate(batches):
        row = node_step_row(torch, backend, data, b, b_max)
        log("training", f"node {i} step (b={b} of padded {b_max}, S=512): wall "
            f"{row['wall_ms']:.2f} ms, device {row['device_ms']:.2f} ms (idle share "
            f"{row['idle_share']:.4f}); flash forward {row['flash_fwd_ms']:.2f} ms (records "
            f"{row['flash_fwd_records']}/{row['flash_fwd_launches']}), flash backward "
            f"{row['flash_bwd_ms']:.2f} ms (records {row['flash_bwd_records']}/"
            f"{row['flash_bwd_launches']})")
    del trainer, backend
    torch.cuda.empty_cache()
    node_grad_check(torch)
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
        if rwkv6_counts != {"flash_attention": 0, "rwkv6_wkv": 32, "ssm_scan": 0,
                            "flash_attention_backward": 0}:
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
        if hymba_counts != {"flash_attention": 32, "rwkv6_wkv": 0, "ssm_scan": 32,
                            "flash_attention_backward": 0}:
            raise AssertionError("the hymba-1.5b path must launch the flash-attention and "
                                 "selective-scan kernels once per layer of its forward and "
                                 f"nothing else: {hymba_counts}")
        torch.cuda.empty_cache()
        phase = "kernel (flash bwd)"
        bwd_rows = phase_kernel_bwd(torch)
        torch.cuda.empty_cache()
        phase = "training (olmo-1b)"
        train_counts = phase_training(torch)
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
        ("flash_attention_backward", SOURCE_REL, REPLACES, bwd_rows[BWD_MAIN_CASE],
         train_counts["flash_attention_backward"]),
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
            "device_ms": main_row["device_ms"],
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
