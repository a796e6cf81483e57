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
segment structure, :func:`ssm_scan_backward_segments` that of the backward
kernel's.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = [
    "selective_scan_ref", "selective_scan_segments", "ssm_scan_backward_ref",
    "ssm_scan_backward_segments", "SEGMENT_STEPS", "BACKWARD_SEGMENT_STEPS",
]

SEGMENT_STEPS = 8  # steps per segment in the CUDA kernel (kSeg in csrc/ssm_scan.cu)
# Steps per segment in the backward kernel (kSeg in csrc/ssm_scan_backward.cu).
BACKWARD_SEGMENT_STEPS = 8
# Steps whose states the plain backward keeps at once (see ssm_scan_backward_ref).
BACKWARD_BLOCK = 64


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


def ssm_scan_backward_ref(
    u: torch.Tensor, dt: torch.Tensor, b_t: torch.Tensor, c_t: torch.Tensor,
    log_a: torch.Tensor, dy: torch.Tensor, dh: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of :func:`selective_scan_ref` (from h = 0) as an explicit
    reverse recurrence: the backward kernel's oracle.  With ``a_t =
    exp(dt_t A)``, ``A = -exp(log_a)``, ``x_t = dt_t u_t`` and ``Gh_t =
    dL/dh_t = dy_t (x) C_t + a_{t+1} Gh_{t+1}`` (``dh`` at the end, zero when
    None)::

        dC_t  = sum_d dy_t[d] h_t[d, :]
        dB_t  = sum_d Gh_t[d, :] x_t[d]
        du_t  = dt_t sum_n Gh_t B_t
        ddt_t = u_t sum_n Gh_t B_t + sum_n Gh_t h_{t-1} a_t A
        dlog_a = A sum_{b, t} Gh_t h_{t-1} a_t dt_t

    Returns (du, ddt (B, T, D), db_t, dc_t (B, T, N), dlog_a (D, N)),
    float32.  States are recomputed block by block (``BACKWARD_BLOCK``
    steps)."""
    bsz, t, di = u.shape
    u, dt, bt, ct, dy = u.float(), dt.float(), b_t.float(), c_t.float(), dy.float()
    a = -torch.exp(log_a.float())

    def advance(h, i):
        decay = torch.exp(dt[:, i, :, None] * a)
        return decay * h + (dt[:, i] * u[:, i])[..., None] * bt[:, i, None, :]

    h = torch.zeros((bsz, di, a.shape[1]), dtype=torch.float32, device=u.device)
    entering = []
    for t0 in range(0, t, BACKWARD_BLOCK):
        entering.append(h)
        for i in range(t0, min(t0 + BACKWARD_BLOCK, t)):
            h = advance(h, i)
    g = torch.zeros_like(h) if dh is None else dh.float()   # a_{t+1} Gh_{t+1}
    du, ddt = torch.empty_like(u), torch.empty_like(u)
    db, dc = torch.empty_like(bt), torch.empty_like(ct)
    da = torch.zeros_like(a)
    for blk in reversed(range(len(entering))):
        t0 = blk * BACKWARD_BLOCK
        states = [entering[blk]]                   # states[i - t0] = h_{i-1}
        for i in range(t0, min(t0 + BACKWARD_BLOCK, t)):
            states.append(advance(states[-1], i))
        for i in reversed(range(t0, min(t0 + BACKWARD_BLOCK, t))):
            h_i, h_prev = states[i - t0 + 1], states[i - t0]
            gh = dy[:, i, :, None] * ct[:, i, None, :] + g
            decay = torch.exp(dt[:, i, :, None] * a)
            dc[:, i] = torch.einsum("bd,bdn->bn", dy[:, i], h_i)
            db[:, i] = torch.einsum("bdn,bd->bn", gh, dt[:, i] * u[:, i])
            gb = torch.einsum("bdn,bn->bd", gh, bt[:, i])
            q = gh * h_prev * decay
            du[:, i] = dt[:, i] * gb
            ddt[:, i] = u[:, i] * gb + (q * a).sum(-1)
            da += (q * dt[:, i, :, None]).sum(0)
            g = decay * gh
            states.pop()
    return du, ddt, db, dc, a * da


def ssm_scan_backward_segments(
    u: torch.Tensor, dt: torch.Tensor, b_t: torch.Tensor, c_t: torch.Tensor,
    log_a: torch.Tensor, dy: torch.Tensor, dh: Optional[torch.Tensor] = None,
    *, seg: int = BACKWARD_SEGMENT_STEPS,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of :func:`selective_scan_ref` as the backward kernel
    decomposes it, in float32; the outputs of :func:`ssm_scan_backward_ref`.

    T is cut into segments of ``seg`` steps (the last one zero-padded: dt =
    0 leaves h and the carried gradient as they are).  Both recurrences are
    linear with the same decays, so every segment is first run from zero:
    its decays e_j, its local end state, its decay product P (the running
    product of the e_j, not exp(A sum dt)) and its local left-exit gradient
    gl = sum_j (e_0 ... e_j) dy_j C_j.  The state entering each segment is
    carried forward, h_in[s+1] = P[s] h_in[s] + h[s]; the gradient arriving
    at each segment's right end backward, g_in[s-1] = P[s] g_in[s] + gl[s],
    from the final state's gradient.  Each segment then runs its true states
    forward from h_in through the kept decays, and walks back from g_in
    forming every output of :func:`ssm_scan_backward_ref`."""
    bsz, t, di = u.shape
    n = b_t.shape[-1]
    n_seg = -(-t // seg)
    pad = n_seg * seg - t

    def split(x):
        x = torch.nn.functional.pad(x.float(), (0, 0, 0, pad))
        return x.reshape(bsz, n_seg, seg, x.shape[-1])

    u_s, dt_s, b_s, c_s, dy_s = split(u), split(dt), split(b_t), split(c_t), split(dy)
    x_s = dt_s * u_s
    a = -torch.exp(log_a.float())
    zero = torch.zeros((bsz, n_seg, di, n), dtype=torch.float32, device=u.device)
    decays = [torch.exp(dt_s[:, :, j, :, None] * a) for j in range(seg)]
    h, prod, gl = zero, torch.ones_like(zero), zero
    for j in range(seg):  # every segment from zero at once
        h = decays[j] * h + x_s[:, :, j, :, None] * b_s[:, :, j, None, :]
        prod = prod * decays[j]
        gl = gl + prod * dy_s[:, :, j, :, None] * c_s[:, :, j, None, :]
    h_in = [zero[:, 0]]
    for s in range(n_seg - 1):  # the states' carry, forward
        h_in.append(prod[:, s] * h_in[s] + h[:, s])
    g_in = [zero[:, 0] if dh is None else dh.float()]
    for s in range(n_seg - 1, 0, -1):  # the gradient's carry, backward
        g_in.append(prod[:, s] * g_in[-1] + gl[:, s])
    h_in, g_in = torch.stack(h_in, dim=1), torch.stack(g_in[::-1], dim=1)
    states = [h_in]  # states[j] = h at the segment's step j - 1
    for j in range(seg):
        states.append(decays[j] * states[-1] + x_s[:, :, j, :, None] * b_s[:, :, j, None, :])
    g = g_in
    du, ddt, db, dc = ([None] * seg for _ in range(4))
    da = torch.zeros_like(a)
    for j in reversed(range(seg)):
        gh = dy_s[:, :, j, :, None] * c_s[:, :, j, None, :] + g
        sb = (gh * b_s[:, :, j, None, :]).sum(-1)
        ghe = gh * decays[j] * states[j]
        du[j] = dt_s[:, :, j] * sb
        ddt[j] = u_s[:, :, j] * sb + (ghe * a).sum(-1)
        db[j] = torch.einsum("bsdn,bsd->bsn", gh, x_s[:, :, j])
        dc[j] = torch.einsum("bsd,bsdn->bsn", dy_s[:, :, j], states[j + 1])
        da += (ghe * dt_s[:, :, j, :, None]).sum((0, 1))
        g = decays[j] * gh

    def join(parts):
        return torch.stack(parts, dim=2).reshape(bsz, n_seg * seg, -1)[:, :t]

    return join(du), join(ddt), join(db), join(dc), a * da
