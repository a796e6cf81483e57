from repro_torch.kernels.flash_attention.ops import flash_attention, flash_attention_backward
from repro_torch.kernels.flash_attention.ref import (
    attention_backward_ref,
    attention_lse_ref,
    attention_ref,
)

__all__ = [
    "flash_attention",
    "flash_attention_backward",
    "attention_ref",
    "attention_lse_ref",
    "attention_backward_ref",
]
