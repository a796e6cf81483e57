#!/usr/bin/env python3
"""Time one checkout's flash-attention, WKV or selective-scan kernel, and
the model forwards that call it, on one CUDA card.

    python3 tools/kernel_compare.py --kernel KERNEL [--src DIR] [--label NAME] [--rows mma]
                                    [--cases NAME,...]

with KERNEL one of flash, flash_bwd, wkv, ssm, wkv_bwd, ssm_bwd, reach.

``--src`` is the ``src/`` directory whose ``repro_torch`` is timed (default
this checkout's); its kernels build into that checkout's ``build/kernels/``.

``--kernel flash``: each row of ``chip_smoke.KERNEL_CASES``, bf16 and
float32, is timed by ``chip_smoke.flash_case``, the kernel phase's own
timing; then full-width olmo-1b (bf16, seeded random weights) prefills 256
tokens and full-width hymba-1.5b (bf16) runs a 1024-token forward.

``--kernel flash_bwd``: each row of ``chip_smoke.BWD_CASES`` is timed by
``chip_smoke.flash_bwd_case``, the backward phase's own timing (errors and
the bitwise repeat included; the kernels a call are the checkout's own,
``chip_smoke.bwd_kernels``); then one node step of full-width olmo-1b
(bf16, remat on, seeded random weights) at b=34 of padded b=40, S=512,
by ``chip_smoke.node_step_row``, the training phase's own timing.

``--rows mma`` (flash and flash_bwd): only the rows the mma.sync kernels
serve (float32 at every head dim, bf16 at (16, 16), (32, 32), (48, 32)),
and no model forward or node step.  ``--cases``: only the kernel rows of
these case names, and no model forward or node step (a checkout that
refuses a row's inputs, a bf16 row before the kernels took bf16, is
compared on the rest).

``--kernel wkv``: each row of ``chip_smoke.WKV_CASES`` is timed by
``chip_smoke.wkv_case``, the WKV phase's own timing (errors included);
then full-width rwkv6-7b (bf16) runs a 1024-token forward.

``--kernel wkv_bwd`` / ``ssm_bwd``: each row of ``chip_smoke.WKV_BWD_CASES``
or ``SSM_BWD_CASES`` is timed by ``chip_smoke.wkv_bwd_case`` or
``ssm_bwd_case``, the backward phase's own timing (errors and the bitwise
repeat included; a checkout whose scan backward has three kernels a call
and no forward tile states is counted so); then one node step of
full-width rwkv6-7b at 12 layers or hymba-1.5b (bf16, remat on, seeded
random weights) at b=34 of padded b=40, S=512, by
``chip_smoke.node_step_row``, with each kernel's part.

``--kernel reach``: each case of phases 34 and 35 is timed in a process
of its own, away from the whole run's lost profile windows: the scan and
WKV cases (``chip_smoke.REACH_SSM_CASES``, ``REACH_WKV_CASES``,
``FLASH_REACH_SSM_CASES``, ``FLASH_REACH_WKV_CASES``) forward and
backward by ``chip_smoke.reach_row``, the flash cases
(``FLASH_REACH_CASES``) by ``flash_case`` and ``flash_bwd_case``, each
float16 one beside its bf16 twin (the same shape in bf16), those phases'
own timing with their errors.

``--kernel ssm``: each row of ``chip_smoke.SSM_CASES`` is timed by
``chip_smoke.ssm_case``, the scan phase's own timing (errors, L2-cold
device ms and the SM clock included); then full-width hymba-1.5b (bf16)
runs a 1024-token forward, and the scan's inputs in its first layer
(seeded random tokens, as the checkout's call site passes them: float32
copies before the scan took bf16, the model's bf16 tensors since) are
timed by ``chip_smoke.ssm_row`` as one more row;
before the forward, the scan's device time over D = 1056 k channels.

Every row is one JSON object.  A forward's row holds its wall ms per call
on the host clock, its device ms under ``torch.profiler``, the device's
idle share, the kernel's part of the device time and its busy ms (the
union of its kernels' intervals, see ``chip_smoke.profile_device``).
Compare two checkouts only within one call, in turns (A, B, B, A).  Exits non-zero
without a card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

# kernel -> (model, tokens, the profiler's name for the kernel's CUDA kernels)
FORWARDS = {
    "flash": (("olmo-1b", 256, "flash_fwd_kernel"), ("hymba-1.5b", 1024, "flash_fwd_kernel")),
    "flash_bwd": (),
    "wkv": (("rwkv6-7b", 1024, chip_smoke.WKV_PROFILE_PREFIX),),
    "ssm": (("hymba-1.5b", 1024, chip_smoke.SSM_PROFILE_PREFIX),),
    "wkv_bwd": (),
    "ssm_bwd": (),
    "reach": (),
}
# backward kernel -> (cases, case function, the node step's arch and layers)
BACKWARDS = {
    "wkv_bwd": (chip_smoke.WKV_BWD_CASES, chip_smoke.wkv_bwd_case, "rwkv6-7b",
                chip_smoke.RWKV6_TRAIN_LAYERS),
    "ssm_bwd": (chip_smoke.SSM_BWD_CASES, chip_smoke.ssm_bwd_case, "hymba-1.5b", None),
}


def mma_row(case) -> bool:
    """Whether a flash case runs the mma.sync kernels: float32, or bf16 at a
    reduced config's head dims."""
    return case[5] == "f32" or chip_smoke.head_dims(case[7]) in ((16, 16), (32, 32), (48, 32))


def kernel_rows(torch, kernel: str, label: str, rows: str, only=None) -> None:
    dev = chip_smoke.DEVICE
    if only is not None:
        rows = "cases"

    def chosen(case):
        return only is None or case[0] in only

    if kernel == "flash":
        from repro_torch.kernels.flash_attention import attention_ref, flash_attention

        gen = torch.Generator(device=dev).manual_seed(0)
        for case in filter(chosen, chip_smoke.KERNEL_CASES):
            if rows != "mma" or mma_row(case):
                row = chip_smoke.flash_case(torch, flash_attention, attention_ref, case, gen)
                print(json.dumps({"label": label, "case": case[0], **row}), flush=True)
        return
    if kernel == "flash_bwd":
        gen = torch.Generator(device=dev).manual_seed(6)
        for case in filter(chosen, chip_smoke.BWD_CASES):
            if rows != "mma" or mma_row(case):
                row = chip_smoke.flash_bwd_case(torch, case, gen)
                print(json.dumps({"label": label, "case": case[0], **row}), flush=True)
        if rows == "all":
            node_step(torch, label)
        return
    if kernel == "reach":
        from repro_torch.kernels.flash_attention import attention_ref, flash_attention

        gen = torch.Generator(device=dev).manual_seed(35)
        for case in filter(chosen, chip_smoke.FLASH_REACH_CASES):
            twins = [case] + ([(case[0] + " (bf16 twin)", *case[1:5], "bf16", *case[6:])]
                              if case[5] == "f16" else [])
            for c in twins:
                row = {"forward": chip_smoke.flash_case(torch, flash_attention, attention_ref,
                                                        c, gen),
                       "backward": chip_smoke.flash_bwd_case(torch, c, gen)}
                print(json.dumps({"label": label, "case": f"flash {c[0]}", **row}), flush=True)
        gen = torch.Generator(device=dev).manual_seed(34)
        cases = ([("ssm", c) for c in chip_smoke.REACH_SSM_CASES + chip_smoke.FLASH_REACH_SSM_CASES]
                 + [("wkv", c) for c in chip_smoke.REACH_WKV_CASES
                    + chip_smoke.FLASH_REACH_WKV_CASES])
        for family, case in cases:
            if chosen(case):
                row = chip_smoke.reach_row(torch, family, case, gen)
                print(json.dumps({"label": label, "case": f"{family} {case[0]}", **row}),
                      flush=True)
        return
    if kernel in BACKWARDS:
        from repro_torch.kernels import ssm_scan

        if not hasattr(ssm_scan, "ssm_scan_tile_states"):  # the first scan backward
            chip_smoke.BWD_KERNELS_PER_CALL[chip_smoke.SSM_BWD_PROFILE] = 3
        cases, case_fn, arch, layers = BACKWARDS[kernel]
        gen = torch.Generator(device=dev).manual_seed(8)
        for case in filter(chosen, cases):
            row = case_fn(torch, case, gen)
            print(json.dumps({"label": label, "case": case[0], **row}), flush=True)
        if rows == "all":
            node_step(torch, label, arch=arch, n_layers=layers)
        return
    if kernel == "ssm":
        from repro_torch.kernels import ssm_scan

        gen = torch.Generator(device=dev).manual_seed(4)
        for case in filter(chosen, chip_smoke.SSM_CASES):
            row = chip_smoke.ssm_case(torch, ssm_scan, case, gen)
            print(json.dumps({"label": label, "case": case[0], **row}), flush=True)
        if rows == "all":
            ssm_fill_rows(torch, ssm_scan, label, gen)
        return
    from repro_torch.kernels import rwkv6_wkv

    gen = torch.Generator(device=dev).manual_seed(2)
    for case in filter(chosen, chip_smoke.WKV_CASES):
        row = chip_smoke.wkv_case(torch, rwkv6_wkv, case, gen)
        print(json.dumps({"label": label, "case": case[0], **row}), flush=True)


def node_step(torch, label, b=34, b_max=40, arch="olmo-1b", n_layers=None) -> None:
    """One node step of ``arch`` (cut to ``n_layers`` when given) as phase
    13 times its first node at the OptPerf plan ([34, 21, 9], padded to
    40)."""
    import dataclasses

    from repro_torch.configs import get_api
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models.registry import build_api
    from repro_torch.optim.optimizers import constant_schedule, sgd
    from repro_torch.runtime.backend import RealBackend

    api = get_api(arch)
    if n_layers is not None:
        api = build_api(arch, dataclasses.replace(api.cfg, n_layers=n_layers))
    data = SyntheticLM(vocab=api.cfg.vocab, seq_len=512, seed=0)
    backend = RealBackend(api, sgd(constant_schedule(0.01)), data, seed=0,
                          device=chip_smoke.DEVICE)
    row = chip_smoke.node_step_row(torch, backend, data, b, b_max)
    layers = f" ({api.cfg.n_layers} layers)" if n_layers is not None else ""
    print(json.dumps({"label": label, "case": f"{arch}{layers} node step b={b} of {b_max} S=512",
                      **row, "clock": chip_smoke.sm_clock()}), flush=True)
    del backend
    torch.cuda.empty_cache()


def ssm_fill_rows(torch, mod, label, gen) -> None:
    """Device ms of the scan's ``ssm_`` kernels per call at T=1024 over D =
    1056 k channels, k = 1..4 (132 k of v3's 8-channel blocks): how the
    time grows with the blocks an SM runs."""
    prefix = chip_smoke.SSM_PROFILE_PREFIX
    for k in (1, 2, 3, 4):
        inputs = chip_smoke.ssm_inputs(torch, ("fill", 1, 1024, 1056 * k, 128, False), gen)

        def call():
            mod.ssm_scan(*inputs, chunk=128)

        for _ in range(3):
            call()
        torch.cuda.synchronize()
        named = chip_smoke.profile_device(torch, call, 20, (prefix,), launches={prefix: 1},
                                          sole=True)[1]
        print(json.dumps({"label": label, "case": f"fill D={1056 * k}", "device_ms": named[prefix],
                          "clock": chip_smoke.sm_clock()}), flush=True)


def captured_scan_inputs(torch, api, model, s):
    """The selective scan's arguments in the first layer of one forward over
    ``s`` seeded random tokens: (u, dt, b_t, c_t, log_a) as the model passes
    them, and the chunk."""
    from repro_torch.models import hymba

    gen = torch.Generator(device=chip_smoke.DEVICE).manual_seed(5)
    toks = torch.randint(0, api.cfg.vocab, (1, s), generator=gen, device=chip_smoke.DEVICE)
    calls = []
    scan = hymba.ssm_scan

    def capture(*args, chunk):
        if not calls:
            calls.append(([x.clone() for x in args], chunk))
        return scan(*args, chunk=chunk)

    hymba.ssm_scan = capture
    try:
        api.logits(model, {"tokens": toks})
    finally:
        hymba.ssm_scan = scan
    return calls[0]


def forward_rows(torch, kernel: str, label: str) -> None:
    from repro_torch.configs import get_api

    dev = chip_smoke.DEVICE
    for name, s, profile_name in FORWARDS[kernel]:
        api = get_api(name)
        model = api.init(0, device=dev)
        toks = torch.zeros((1, s), dtype=torch.long, device=dev)
        if name == "olmo-1b":
            cache = api.init_cache(1, 2048, device=dev)

            def fn():
                return api.prefill(model, cache, toks)
        else:
            def fn():
                return api.logits(model, {"tokens": toks})
        clock = chip_smoke.sm_clock()
        wall_ms = chip_smoke.host_ms(torch, fn, 10)
        launches = {profile_name: api.cfg.n_layers} if kernel == "ssm" else None
        device_ms, named, idle, busy, _ = chip_smoke.device_split(torch, fn, 3, wall_ms,
                                                              (profile_name,), launches)
        print(json.dumps({"label": label, "model": name, "tokens": s, "wall_ms": wall_ms,
                          "device_ms": device_ms, "kernel_ms": named[profile_name],
                          "kernel_busy_ms": busy[profile_name], "idle_share": idle,
                          "clock_before": clock, "clock_after": chip_smoke.sm_clock()}),
              flush=True)
        if kernel == "ssm":
            from repro_torch.kernels import ssm_scan

            inputs, chunk = captured_scan_inputs(torch, api, model, s)
            row = chip_smoke.ssm_row(torch, ssm_scan, inputs, chunk)
            print(json.dumps({"label": label, "case": f"{name} layer 0 inputs T={s}", **row}),
                  flush=True)
            del inputs
        del model, fn
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=sorted(FORWARDS), required=True)
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--label", default="")
    ap.add_argument("--rows", choices=("all", "mma"), default="all")
    ap.add_argument("--cases", default=None)
    args = ap.parse_args()
    only = None if args.cases is None else set(args.cases.split(","))
    sys.path.insert(0, os.path.abspath(args.src))

    import torch

    if not torch.cuda.is_available():
        print("kernel_compare: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    kernel_rows(torch, args.kernel, args.label, args.rows, only)
    if args.rows == "all" and only is None:
        forward_rows(torch, args.kernel, args.label)
    return 0


if __name__ == "__main__":
    sys.exit(main())
