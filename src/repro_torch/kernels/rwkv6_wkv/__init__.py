from repro_torch.kernels.rwkv6_wkv.ops import wkv, wkv_with_chunk_states
from repro_torch.kernels.rwkv6_wkv.ref import (
    LOG_DECAY_MIN, wkv_chunk_output, wkv_chunk_states, wkv_chunked, wkv_scan_ref,
)

__all__ = [
    "wkv", "wkv_with_chunk_states", "wkv_chunked", "wkv_scan_ref", "wkv_chunk_states",
    "wkv_chunk_output", "LOG_DECAY_MIN",
]
