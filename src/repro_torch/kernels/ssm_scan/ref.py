"""Plain PyTorch version of the Mamba selective scan: the kernel's oracle,
its CPU path and the decode step's recurrence.

Per channel d and state n, with A = -exp(log_a):

    h_t[d, n] = exp(dt_t[d] A[d, n]) h_{t-1}[d, n] + dt_t[d] u_t[d] B_t[n]
    y_t[d]    = sum_n C_t[n] h_t[d, n]

Tensors are in the reference's layout: u/dt ``(B, T, D)``, b_t/c_t
``(B, T, N)``, log_a ``(D, N)``, state ``(B, D, N)`` in float32.  The
counterpart of ``repro/models/hymba.py::selective_scan_ref``; it lives here
so that the kernel's wrapper does not import the model.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["selective_scan_ref"]


def selective_scan_ref(
    u: torch.Tensor, dt: torch.Tensor, log_a: torch.Tensor, b_t: torch.Tensor, c_t: torch.Tensor,
    h0: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Step-by-step oracle.  Returns (y (B, T, D) in u's dtype, final state
    (B, D, N) float32)."""
    bsz, t, di = u.shape
    n = b_t.shape[-1]
    a = -torch.exp(log_a.float())
    if h0 is None:
        h = torch.zeros((bsz, di, n), dtype=torch.float32, device=u.device)
    else:
        h = h0.float()
    ys = []
    for i in range(t):
        dt_i = dt[:, i]
        decay = torch.exp(dt_i.float()[..., None] * a[None])
        h = decay * h + (dt_i * u[:, i]).float()[..., None] * b_t[:, i, None, :].float()
        ys.append(torch.einsum("bdn,bn->bd", h, c_t[:, i].float()))
    return torch.stack(ys, dim=1).to(u.dtype), h
