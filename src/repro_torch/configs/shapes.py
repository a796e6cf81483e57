"""The four assigned input shapes + reduced variants for smoke tests.

  train_4k     seq_len=  4,096  global_batch=256   (training)
  prefill_32k  seq_len= 32,768  global_batch= 32   (inference-prefill)
  decode_32k   seq_len= 32,768  global_batch=128   (inference-decode)
  long_500k    seq_len=524,288  global_batch=  1   (long-context-decode)

Decode shapes lower `serve_step` — ONE new token against a KV cache of
seq_len.  Prefill lowers the full forward (no loss/grad).  train_4k lowers
`train_step` (fwd+bwd+optimizer update).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

__all__ = ["InputShape", "SHAPES", "REDUCED_SHAPES"]


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}

# CPU-runnable variants for smoke tests (same kind, tiny extents).
REDUCED_SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k-reduced", 32, 4, "train"),
    "prefill_32k": InputShape("prefill_32k-reduced", 64, 2, "prefill"),
    "decode_32k": InputShape("decode_32k-reduced", 64, 4, "decode"),
    "long_500k": InputShape("long_500k-reduced", 128, 1, "decode"),
}
