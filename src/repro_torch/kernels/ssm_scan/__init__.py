from repro_torch.kernels.ssm_scan.ops import ssm_scan, ssm_scan_backward, ssm_scan_tile_states
from repro_torch.kernels.ssm_scan.ref import (
    BACKWARD_SEGMENT_STEPS, SEGMENT_STEPS, selective_scan_ref, selective_scan_segments,
    ssm_scan_backward_ref, ssm_scan_backward_segments,
)

__all__ = [
    "ssm_scan", "ssm_scan_backward", "ssm_scan_tile_states", "selective_scan_ref", "selective_scan_segments",
    "ssm_scan_backward_ref", "ssm_scan_backward_segments", "SEGMENT_STEPS",
    "BACKWARD_SEGMENT_STEPS",
]
