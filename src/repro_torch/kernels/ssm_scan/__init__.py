from repro_torch.kernels.ssm_scan.ops import ssm_scan
from repro_torch.kernels.ssm_scan.ref import selective_scan_ref

__all__ = ["ssm_scan", "selective_scan_ref"]
