from repro_torch.kernels.rwkv6_wkv.ops import wkv
from repro_torch.kernels.rwkv6_wkv.ref import LOG_DECAY_MIN, wkv_chunked, wkv_scan_ref

__all__ = ["wkv", "wkv_chunked", "wkv_scan_ref", "LOG_DECAY_MIN"]
