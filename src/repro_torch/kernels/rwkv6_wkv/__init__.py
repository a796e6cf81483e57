from repro_torch.kernels.rwkv6_wkv.ops import wkv, wkv_backward, wkv_with_chunk_states
from repro_torch.kernels.rwkv6_wkv.ref import (
    BACKWARD_CHUNK, LOG_DECAY_MIN, wkv_backward_chunked, wkv_backward_ref, wkv_chunk_output,
    wkv_chunk_states, wkv_chunked, wkv_scan_ref,
)

__all__ = [
    "wkv", "wkv_backward", "wkv_with_chunk_states", "wkv_chunked", "wkv_scan_ref",
    "wkv_chunk_states", "wkv_chunk_output", "wkv_backward_ref", "wkv_backward_chunked",
    "LOG_DECAY_MIN", "BACKWARD_CHUNK",
]
