#!/usr/bin/env python3
"""Count the profiler windows that record no device time after the sharded
phase, with the world of one's NCCL group shut down at its end or kept.

    python3 tools/profiler_windows.py [--keep-group]

Runs ``chip_smoke.py``'s phases 1, 2 and 16 (the node-sharded step over a
NCCL world of one, its unsharded fused run included), then phase 17 (the
WKV and scan backward rows, whose profile windows follow phase 16 in the
whole run).  Phase 16 ends with ``release_world_of_one``;
``--keep-group`` makes that call do nothing, so the group lives on as it
did before the call existed.  Every window ``chip_smoke.profile_device``
reports as lost (a ``chip_smoke: profile window`` line on stderr) and
every row that lost all its windows (a ``[profile]`` line) is counted,
and the last line is one JSON object with both counts.  Compare the two
settings only within one call.  Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import io
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402


class _Tee(io.TextIOBase):
    """Writes through to ``stream`` and counts the lines that start with
    ``prefix``."""

    def __init__(self, stream, prefix: str):
        self.stream, self.prefix, self.count = stream, prefix, 0

    def write(self, text: str) -> int:
        self.count += sum(line.startswith(self.prefix) for line in text.splitlines())
        return self.stream.write(text)

    def flush(self) -> None:
        self.stream.flush()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--keep-group", action="store_true",
                    help="keep the world-of-one group alive after phase 16")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("profiler_windows: no CUDA device is available", file=sys.stderr)
        return 1
    from repro_torch.launch import mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.keep_group:
        mesh.release_world_of_one = lambda: 0
    chip_smoke.phase_device()
    chip_smoke.phase_build()
    chip_smoke.phase_sharded(torch)
    gc.collect()
    torch.cuda.empty_cache()
    lost = _Tee(sys.stderr, "chip_smoke: profile window")
    rows = _Tee(sys.stdout, "[profile]")
    with contextlib.redirect_stderr(lost), contextlib.redirect_stdout(rows):
        chip_smoke.phase_kernel_backwards(torch)
    print(json.dumps({"teardown": not args.keep_group, "solo_groups_left": len(mesh._SOLO),
                      "lost_windows": lost.count, "rows_all_windows_lost": rows.count}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
