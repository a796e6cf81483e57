#!/usr/bin/env python3
"""Time one checkout's flash-attention or WKV kernel, and the model
forwards that call it, on one CUDA card.

    python3 tools/kernel_compare.py --kernel {flash,wkv} [--src DIR] [--label NAME]

``--src`` is the ``src/`` directory whose ``repro_torch`` is timed (default
this checkout's); its kernels build into that checkout's ``build/kernels/``.

``--kernel flash``: each bf16 row of ``chip_smoke.KERNEL_CASES`` is timed by
``chip_smoke.flash_case``, the kernel phase's own timing; then full-width
olmo-1b (bf16, seeded random weights) prefills 256 tokens and full-width
hymba-1.5b (bf16) runs a 1024-token forward.

``--kernel wkv``: each row of ``chip_smoke.WKV_CASES`` is timed by
``chip_smoke.wkv_case``, the WKV phase's own timing (errors included);
then full-width rwkv6-7b (bf16) runs a 1024-token forward.

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
    "wkv": (("rwkv6-7b", 1024, chip_smoke.WKV_PROFILE_PREFIX),),
}


def kernel_rows(torch, kernel: str, label: str) -> None:
    dev = chip_smoke.DEVICE
    if kernel == "flash":
        from repro_torch.kernels.flash_attention import attention_ref, flash_attention

        gen = torch.Generator(device=dev).manual_seed(0)
        for case in chip_smoke.KERNEL_CASES:
            if case[5] == "bf16":
                row = chip_smoke.flash_case(torch, flash_attention, attention_ref, case, gen)
                print(json.dumps({"label": label, "case": case[0], **row}), flush=True)
        return
    from repro_torch.kernels import rwkv6_wkv

    gen = torch.Generator(device=dev).manual_seed(2)
    for case in chip_smoke.WKV_CASES:
        row = chip_smoke.wkv_case(torch, rwkv6_wkv, case, gen)
        print(json.dumps({"label": label, "case": case[0], **row}), flush=True)


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
        wall_ms = chip_smoke.host_ms(torch, fn, 10)
        device_ms, named, idle, busy = chip_smoke.device_split(torch, fn, 3, wall_ms,
                                                              (profile_name,))
        print(json.dumps({"label": label, "model": name, "tokens": s, "wall_ms": wall_ms,
                          "device_ms": device_ms, "kernel_ms": named[profile_name],
                          "kernel_busy_ms": busy[profile_name], "idle_share": idle}),
              flush=True)
        del model, fn
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=sorted(FORWARDS), required=True)
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))

    import torch

    if not torch.cuda.is_available():
        print("kernel_compare: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    kernel_rows(torch, args.kernel, args.label)
    forward_rows(torch, args.kernel, args.label)
    return 0


if __name__ == "__main__":
    sys.exit(main())
