"""Gradient noise scale (GNS) estimation in heterogeneous clusters (§4.4, App. B).

The GNS  B_noise = tr(Sigma) / |G|^2  drives adaptive batch sizing
(McCandlish et al. 2018).  With *unequal* local batch sizes b_i the classic
homogeneous estimators are biased / suboptimal; the paper constructs, per
node i,

    G_i = (B |g|^2 - b_i |g_i|^2) / (B - b_i)          (unbiased for |G|^2)
    S_i = b_i B (|g_i|^2 - |g|^2) / (B - b_i)          (unbiased for tr(Sigma))

and combines them with the *minimum-variance unbiased linear* weights of
Theorem 4.1:

    w = 1^T A^{-1} / (1^T A^{-1} 1)

where A_G / A_S are the (scaled) covariance matrices of the local estimators
with closed-form entries:

    a_G(i,i) = (B + 2 b_i) / (B^2 - B b_i)
    a_G(i,j) = (B^2 - b_i^2 - b_j^2) / (B (B - b_i)(B - b_j))
    a_S(i,i) = B b_i / (B - b_i)
    a_S(i,j) = b_i b_j (B - b_i - b_j) / ((B - b_i)(B - b_j))

:func:`local_estimates` works on torch tensors, so it can run beside the
train step on the card; the rest is numpy, for the controller.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "local_estimates",
    "gns_weights",
    "estimate_gns",
    "GNSState",
    "gns_update",
    "homogeneous_gns",
]


def local_estimates(
    local_sqnorms: torch.Tensor,
    global_sqnorm: torch.Tensor,
    batches: torch.Tensor,
    total_batch: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eq. (10): per-node unbiased estimates (G_i, S_i) of |G|^2 and tr(Sigma).

    Args:
      local_sqnorms: ``|g_i|^2`` per node, shape (n,).
      global_sqnorm: ``|g|^2`` of the weighted global gradient, scalar.
      batches: local batch sizes b_i, shape (n,).
      total_batch: B = sum(b_i), scalar.
    """
    b = batches.to(torch.float64) if batches.dtype != torch.float32 else batches
    B = total_batch
    g_i = (B * global_sqnorm - b * local_sqnorms) / (B - b)
    s_i = (b * B) / (B - b) * (local_sqnorms - global_sqnorm)
    return g_i, s_i


def _a_g_matrix(batches: np.ndarray, total_batch: float) -> np.ndarray:
    b = np.asarray(batches, dtype=np.float64)
    B = float(total_batch)
    n = b.size
    bi = b[:, None]
    bj = b[None, :]
    off = (B**2 - bi**2 - bj**2) / (B * (B - bi) * (B - bj))
    diag = (B + 2 * b) / (B**2 - B * b)
    a = off
    a[np.arange(n), np.arange(n)] = diag
    return a


def _a_s_matrix(batches: np.ndarray, total_batch: float) -> np.ndarray:
    b = np.asarray(batches, dtype=np.float64)
    B = float(total_batch)
    n = b.size
    bi = b[:, None]
    bj = b[None, :]
    off = (bi * bj * (B - bi - bj)) / ((B - bi) * (B - bj))
    diag = (B * b) / (B - b)
    a = off
    a[np.arange(n), np.arange(n)] = diag
    return a


def _a_g_matrix_corrected(batches: np.ndarray, total_batch: float) -> np.ndarray:
    """Corrected covariance of G_i (beyond-paper; see DESIGN.md §9 and
    EXPERIMENTS.md).  The paper's Lemma B.5 decomposes |g|^2 into per-node
    squared terms and drops the cross terms g_j . g_l; keeping them yields
    Cov(|g|^2, |g_i|^2) = 4|G|^2 tr(Sigma)/B  (batch-independent), giving

        a'_G(i,i) = 1/(B - b_i)
        a'_G(i,j) = (B - b_i - b_j)/((B - b_i)(B - b_j))

    (common factor 4|G|^2 tr(Sigma) dropped).  Monte-Carlo covariance of the
    estimators matches these entries, not the paper's (tests/test_gns.py)."""
    b = np.asarray(batches, dtype=np.float64)
    B = float(total_batch)
    n = b.size
    bi = b[:, None]
    bj = b[None, :]
    a = (B - bi - bj) / ((B - bi) * (B - bj))
    a[np.arange(n), np.arange(n)] = 1.0 / (B - b)
    return a


def _a_s_matrix_corrected(batches: np.ndarray, total_batch: float) -> np.ndarray:
    """Corrected covariance of S_i: the diagonal agrees with the paper,
    the off-diagonal is *negative*:

        a'_S(i,i) = B b_i / (B - b_i)
        a'_S(i,j) = - B b_i b_j / ((B - b_i)(B - b_j))
    """
    b = np.asarray(batches, dtype=np.float64)
    B = float(total_batch)
    n = b.size
    bi = b[:, None]
    bj = b[None, :]
    a = -(B * bi * bj) / ((B - bi) * (B - bj))
    a[np.arange(n), np.arange(n)] = (B * b) / (B - b)
    return a


def _min_variance_weights(a: np.ndarray) -> np.ndarray:
    """w = 1^T A^-1 / (1^T A^-1 1), robust to singular A.

    The corrected A_S is *exactly* singular for equal batches (rows sum to
    zero: the plain average has zero leading-order variance there), so we
    use lstsq and fall back to equal weights when the normalizer vanishes
    or the solution blows up."""
    n = a.shape[0]
    ones = np.ones(n)
    sol, *_ = np.linalg.lstsq(a, ones, rcond=None)
    denom = ones @ sol
    scale = np.abs(sol).max()
    if (
        not np.isfinite(denom)
        or not np.all(np.isfinite(sol))
        or abs(denom) < 1e-9 * max(scale, 1e-30)
    ):
        return ones / n
    w = sol / denom
    if np.abs(w).max() > 1e4:
        return ones / n
    return w


def gns_weights(
    batches: Sequence[float], total_batch: float, *, corrected: bool = True
) -> Tuple[np.ndarray, np.ndarray]:
    """Theorem 4.1 optimal weights (w_G, w_S) for the local estimators.

    ``corrected=False`` uses the paper's printed A_G/A_S entries verbatim
    (the paper-faithful baseline); ``corrected=True`` (default) uses the
    cross-term-corrected covariances, which empirically achieve the
    minimum-variance property Theorem 4.1 claims (see tests/test_gns.py and
    EXPERIMENTS.md §Reproduction-notes).

    Weights sum to one (unbiasedness); computed in float64 numpy — they only
    change when the batch partition changes, so the controller caches them.
    """
    b = np.asarray(batches, dtype=np.float64)
    if np.any(b <= 0):
        raise ValueError("local batches must be positive")
    if np.any(b >= total_batch):
        raise ValueError("each local batch must be < total batch")
    if corrected:
        # Closed form (beyond-paper; see EXPERIMENTS.md §Reproduction-notes):
        # v_i = B - b_i satisfies  A'_G v = (n-1) 1  and  A'_S v = 0 exactly,
        # so w_i = (B - b_i)/((n-1) B) is the minimum-variance unbiased
        # combination for BOTH estimators — and for S it cancels the
        # leading-order |G|-noise entirely:
        #   S = [sum_i b_i |g_i|^2 - B |g|^2] / (n - 1).
        n = b.size
        w = (total_batch - b) / ((n - 1) * total_batch)
        return w.copy(), w.copy()
    w_g = _min_variance_weights(_a_g_matrix(b, total_batch))
    w_s = _min_variance_weights(_a_s_matrix(b, total_batch))
    return w_g, w_s


def estimate_gns(
    local_sqnorms: Sequence[float],
    global_sqnorm: float,
    batches: Sequence[float],
    *,
    weights: Optional[Tuple[np.ndarray, np.ndarray]] = None,
) -> Tuple[float, float, float]:
    """One-shot heterogeneous GNS estimate.

    Returns ``(B_noise, G, S)`` where G estimates |G|^2 and S estimates
    tr(Sigma).  Individual draws can be negative (the estimators are unbiased,
    not positive); the EMA wrapper below is what production code uses.
    """
    b = np.asarray(batches, dtype=np.float64)
    B = float(b.sum())
    if weights is None:
        weights = gns_weights(b, B)
    w_g, w_s = weights
    sq = np.asarray(local_sqnorms, dtype=np.float64)
    g_i = (B * global_sqnorm - b * sq) / (B - b)
    s_i = (b * B) / (B - b) * (sq - global_sqnorm)
    g = float(np.asarray(w_g) @ g_i)
    s = float(np.asarray(w_s) @ s_i)
    b_noise = s / g if g != 0 else float("inf")
    return b_noise, g, s


def homogeneous_gns(
    local_sqnorms: Sequence[float], global_sqnorm: float, batches: Sequence[float]
) -> Tuple[float, float, float]:
    """Plain-average aggregation (the homogeneous-cluster baseline used by
    AdaptDL/Pollux).  Correct only when all b_i are equal; kept as the
    comparison target for the variance experiments."""
    n = len(local_sqnorms)
    w = np.ones(n) / n
    b = np.asarray(batches, dtype=np.float64)
    B = float(b.sum())
    sq = np.asarray(local_sqnorms, dtype=np.float64)
    g_i = (B * global_sqnorm - b * sq) / (B - b)
    s_i = (b * B) / (B - b) * (sq - global_sqnorm)
    g = float(w @ g_i)
    s = float(w @ s_i)
    return (s / g if g != 0 else float("inf")), g, s


# ---------------------------------------------------------------------------
# Running (EMA) estimator — what the training loop uses
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GNSState:
    """Exponential moving averages of S and G (Pollux-style: smooth the
    numerator and denominator separately, then take the ratio — the ratio of
    EMAs is far less biased than the EMA of ratios)."""

    ema_g: float = 0.0
    ema_s: float = 0.0
    count: int = 0

    @property
    def b_noise(self) -> float:
        if self.count == 0 or self.ema_g <= 0:
            return float("inf")
        return max(self.ema_s / self.ema_g, 0.0)

    def efficiency(self, batch_size: float) -> float:
        """Pollux statistical efficiency at total batch B:
        E(B) = (B_noise + B0) / (B_noise + B) evaluated with B0 -> per-sample
        normalization; we use the standard McCandlish form
        E(B) = 1 / (1 + B_noise / B) — the expected per-sample progress."""
        bn = self.b_noise
        if not np.isfinite(bn):
            return 1.0
        return 1.0 / (1.0 + bn / batch_size)


def gns_update(
    state: GNSState, g: float, s: float, *, decay: float = 0.9
) -> GNSState:
    """Bias-corrected EMA update with one observation of (G, S)."""
    count = state.count + 1
    # Standard Adam-style bias correction via counting.
    ema_g = decay * state.ema_g + (1.0 - decay) * g
    ema_s = decay * state.ema_s + (1.0 - decay) * s
    return GNSState(ema_g=ema_g, ema_s=ema_s, count=count)
