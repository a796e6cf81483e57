"""Plain PyTorch versions of the RWKV6 WKV recurrence: the kernel's oracle and
its CPU path.

Per head, with state S in R^{K x K} and per-channel log-decay lw_t:

    out_t = r_t . (diag(u) k_t^T v_t + S_{t-1})
    S_t   = diag(exp(lw_t)) S_{t-1} + k_t^T v_t

Tensors are in model layout: r/k/v/log_w ``(B, T, H, K)``, u ``(H, K)``
(broadcast over the batch), state ``(B, H, K, K)`` in float32.  These are
the counterparts of ``repro/models/rwkv6.py::wkv_scan_ref`` and
``::wkv_chunked``; they live here so that the kernel's wrapper does not
import the model.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["LOG_DECAY_MIN", "wkv_scan_ref", "wkv_chunked"]

# Per-step log-decay floor (the reference's, with its stability note): it
# bounds the factored chunk form's exponents to chunk * 4.6 / 2 after the
# mid-point normalisation, 73.6 at chunk 32, inside float32.
LOG_DECAY_MIN = -4.6


def _initial_state(r: torch.Tensor, s0: Optional[torch.Tensor]) -> torch.Tensor:
    b, _, h, kk = r.shape
    if s0 is None:
        return torch.zeros((b, h, kk, kk), dtype=torch.float32, device=r.device)
    return s0.float()


def wkv_scan_ref(
    r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, log_w: torch.Tensor, u: torch.Tensor,
    s0: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Step-by-step oracle.  Returns (out (B,T,H,K) in r's dtype, final
    state (B,H,K,K) float32).  Decays are taken as given, unclamped."""
    s = _initial_state(r, s0)
    uf = u.float()[None, :, :, None]
    outs = []
    for t in range(r.shape[1]):
        r_t, k_t, v_t = r[:, t].float(), k[:, t].float(), v[:, t].float()
        kv = k_t[..., :, None] * v_t[..., None, :]                  # (B,H,K,K)
        outs.append(torch.einsum("bhk,bhkv->bhv", r_t, uf * kv + s))
        s = torch.exp(log_w[:, t].float())[..., None] * s + kv
    return torch.stack(outs, dim=1).to(r.dtype), s


def wkv_chunked(
    r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, log_w: torch.Tensor, u: torch.Tensor,
    *, chunk: int = 64, s0: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked-parallel WKV, shapes as in :func:`wkv_scan_ref`.

    Within a chunk, with L_t the inclusive cumulative log-decay,
      scores(t, s) = (r .* exp(L_{t-1} - L_mid)) . (k .* exp(L_mid - L_s)), s < t
      out_t        = scores @ v + (r_t . u . k_t) v_t + (r .* exp(L_{t-1})) S0
      S_end        = exp(L_C) . S0 + (k .* exp(L_C - L))^T v
    with L_mid = L_C / 2, log-decays clamped to [LOG_DECAY_MIN, 0] and T
    padded to whole chunks of ``min(chunk, T)`` with zeros.
    """
    b, t, h, kk = r.shape
    c = min(chunk, t)
    pad = (-t) % c
    nc = (t + pad) // c

    def chunks(x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if pad:
            x = torch.cat([x, x.new_zeros((b, pad, h, kk))], dim=1)
        return x.reshape(b, nc, c, h, kk).permute(1, 0, 3, 2, 4)  # (nc,B,H,C,K)

    rc, kc, vc = chunks(r), chunks(k), chunks(v)
    lw = chunks(log_w).clamp(LOG_DECAY_MIN, 0.0)
    s = _initial_state(r, s0)
    uf = u.float()[None, :, None, :]
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool, device=r.device), diagonal=-1)
    outs = []
    for i in range(nc):
        r_b, k_b, v_b, lw_b = rc[i], kc[i], vc[i], lw[i]          # (B,H,C,K)
        l_inc = torch.cumsum(lw_b, dim=2)
        l_prev = l_inc - lw_b
        l_end = l_inc[:, :, -1:, :]
        l_mid = 0.5 * l_end
        rr = r_b * torch.exp(l_prev - l_mid)
        kn = k_b * torch.exp(l_mid - l_inc)
        scores = torch.einsum("bhtd,bhsd->bhts", rr, kn).masked_fill(~mask, 0.0)
        diag = torch.einsum("bhtd,bhtd->bht", r_b * uf, k_b)
        out = torch.einsum("bhts,bhsv->bhtv", scores, v_b) + diag[..., None] * v_b
        out = out + torch.einsum("bhtd,bhdv->bhtv", rr * torch.exp(l_mid), s)
        k_dec = k_b * torch.exp(l_end - l_inc)
        s = torch.exp(l_end[:, :, 0, :])[..., None] * s + torch.einsum(
            "bhtd,bhtv->bhdv", k_dec, v_b
        )
        outs.append(out)
    out = torch.stack(outs).permute(1, 0, 3, 2, 4).reshape(b, t + pad, h, kk)[:, :t]
    return out.to(r.dtype), s
