from repro_torch.kernels.ssm_scan.ops import ssm_scan, ssm_scan_backward
from repro_torch.kernels.ssm_scan.ref import (
    SEGMENT_STEPS, selective_scan_ref, selective_scan_segments, ssm_scan_backward_ref,
)

__all__ = [
    "ssm_scan", "ssm_scan_backward", "selective_scan_ref", "selective_scan_segments",
    "ssm_scan_backward_ref", "SEGMENT_STEPS",
]
