"""Plain PyTorch version of the Mamba selective scan: the kernel's oracle,
its CPU path and the decode step's recurrence.

Per channel d and state n, with A = -exp(log_a):

    h_t[d, n] = exp(dt_t[d] A[d, n]) h_{t-1}[d, n] + dt_t[d] u_t[d] B_t[n]
    y_t[d]    = sum_n C_t[n] h_t[d, n]

Tensors are in the reference's layout: u/dt ``(B, T, D)``, b_t/c_t
``(B, T, N)``, log_a ``(D, N)``, state ``(B, D, N)`` in float32.  The
counterpart of ``repro/models/hymba.py::selective_scan_ref``; it lives here
so that the kernel's wrapper does not import the model.
:func:`selective_scan_segments` is the plain version of the CUDA kernel's
segment structure.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["selective_scan_ref", "selective_scan_segments", "SEGMENT_STEPS"]

SEGMENT_STEPS = 8  # steps per segment in the CUDA kernel (kSeg in csrc/ssm_scan.cu)


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


def selective_scan_segments(
    u: torch.Tensor, dt: torch.Tensor, log_a: torch.Tensor, b_t: torch.Tensor, c_t: torch.Tensor,
    *, seg: int = SEGMENT_STEPS,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The scan as the CUDA kernel decomposes it, in float32.  T is cut into
    segments of ``seg`` steps (the last one zero-padded: dt = 0 leaves h as
    it is); each segment is scanned from h = 0, keeping its per-step decays,
    their product P and its local y; the states entering the segments are
    carried with the reference's combine, h_in[s+1] = P[s] h_in[s] + h[s];
    and y_t = local y_t + C_t (decay_t ... decay_start) h_in.  Returns (y
    (B, T, D), final state (B, D, N), states entering each segment (B, S,
    D, N))."""
    bsz, t, di = u.shape
    n = b_t.shape[-1]
    n_seg = -(-t // seg)
    pad = n_seg * seg - t

    def split(x):
        x = torch.nn.functional.pad(x.float(), (0, 0, 0, pad))
        return x.reshape(bsz, n_seg, seg, x.shape[-1])

    u_s, dt_s, b_s, c_s = split(u), split(dt), split(b_t), split(c_t)
    a = -torch.exp(log_a.float())
    h = torch.zeros((bsz, n_seg, di, n), dtype=torch.float32, device=u.device)
    prod = torch.ones_like(h)
    decays, y_local = [], []
    for j in range(seg):  # every segment at once, from h = 0
        decay = torch.exp(dt_s[:, :, j, :, None] * a)
        prod = prod * decay
        h = decay * h + (dt_s[:, :, j] * u_s[:, :, j])[..., None] * b_s[:, :, j, None, :]
        decays.append(decay)
        y_local.append(torch.einsum("bsdn,bsn->bsd", h, c_s[:, :, j]))
    h_in = [torch.zeros((bsz, di, n), dtype=torch.float32, device=u.device)]
    for s in range(n_seg):  # the carry
        h_in.append(prod[:, s] * h_in[s] + h[:, s])
    final = h_in.pop()
    g = torch.stack(h_in, dim=1)
    ys = []
    for j in range(seg):  # the fix-up through the kept decays
        g = decays[j] * g
        ys.append(y_local[j] + torch.einsum("bsdn,bsn->bsd", g, c_s[:, :, j]))
    y = torch.stack(ys, dim=2).reshape(bsz, n_seg * seg, di)[:, :t]
    return y, final, torch.stack(h_in, dim=1)
