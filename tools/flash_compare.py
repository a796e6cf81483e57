#!/usr/bin/env python3
"""Time one checkout's flash-attention kernel, and the olmo-1b prefill and
hymba-1.5b forward that call it, on one CUDA card.

    python3 tools/flash_compare.py [--src DIR] [--label NAME]

``--src`` is the ``src/`` directory whose ``repro_torch`` is timed (default
this checkout's); its kernels build into that checkout's ``build/kernels/``.
Each bf16 row of ``chip_smoke.KERNEL_CASES`` is timed by
``chip_smoke.flash_case``, the kernel phase's own timing, and printed as
one JSON object.  Then full-width olmo-1b (bf16, seeded random weights)
prefills 256 tokens and full-width hymba-1.5b (bf16) runs a 1024-token
forward: wall ms per call on the host clock, device ms under
``torch.profiler`` and the flash kernel's part of it.  Compare two
checkouts only within one call, in turns (A, B, B, A).  Exits non-zero
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))

    import torch

    if not torch.cuda.is_available():
        print("flash_compare: no CUDA device is available", file=sys.stderr)
        return 1
    from repro_torch.configs import get_api
    from repro_torch.kernels.flash_attention import attention_ref, flash_attention

    dev = chip_smoke.DEVICE
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    for case in chip_smoke.KERNEL_CASES:
        if case[5] == "bf16":
            row = chip_smoke.flash_case(torch, flash_attention, attention_ref, case, gen)
            print(json.dumps({"label": args.label, "case": case[0], **row}), flush=True)

    for name, s in (("olmo-1b", 256), ("hymba-1.5b", 1024)):
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
        device_ms, named, idle = chip_smoke.device_split(torch, fn, 3, wall_ms,
                                                         ("flash_fwd_kernel",))
        print(json.dumps({"label": args.label, "model": name, "tokens": s, "wall_ms": wall_ms,
                          "device_ms": device_ms, "flash_ms": named["flash_fwd_kernel"],
                          "idle_share": idle}), flush=True)
        del model, fn
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
