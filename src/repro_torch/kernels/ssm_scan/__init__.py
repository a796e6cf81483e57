from repro_torch.kernels.ssm_scan.ops import ssm_scan
from repro_torch.kernels.ssm_scan.ref import (
    SEGMENT_STEPS, selective_scan_ref, selective_scan_segments,
)

__all__ = ["ssm_scan", "selective_scan_ref", "selective_scan_segments", "SEGMENT_STEPS"]
