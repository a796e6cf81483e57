"""Weighted gradient aggregation for unequal local batch sizes (§4.3, Eq. 9).

The counterpart of ``repro/core/aggregation.py``.  With heterogeneous local
batches the unbiased aggregate is

    g = sum_i r_i g_i,     r_i = b_i / B,

which gives every sample identical weight.  :func:`ratios`,
:func:`padded_batch_layout` and :func:`sample_weights` are numpy, copied
verbatim.  :func:`guard_weights` runs on torch tensors beside the train
step: a node whose gradient contribution is non-finite or a gross norm
outlier is excluded before it can pollute the update, and the all-valid
branch returns the original weight vector bitwise, so fault-free runs stay
identical.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "ratios",
    "sample_weights",
    "padded_batch_layout",
    "guard_weights",
    "ANOMALY_OUTLIER_FACTOR",
]

# A per-node gradient norm this many times the (finite) median norm counts
# as an anomaly.  Healthy per-node gradients over same-distribution shards
# differ by small factors (batch noise); a poisoned node is off by orders of
# magnitude, so the default leaves a wide safety margin in both directions.
ANOMALY_OUTLIER_FACTOR = 100.0


def ratios(batches: Sequence[int]) -> np.ndarray:
    """r_i = b_i / B."""
    b = np.asarray(batches, dtype=np.float64)
    if np.any(b < 0) or b.sum() <= 0:
        raise ValueError("invalid batch vector")
    return b / b.sum()


def guard_weights(
    sq_norms: torch.Tensor,
    weights: torch.Tensor,
    *,
    outlier_factor: float = ANOMALY_OUTLIER_FACTOR,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Anomaly-guarded Eq. (9) weights from per-node |g_i|^2.

    Returns ``(guarded_weights, valid)`` where ``valid[i]`` is False when
    node i's squared gradient norm is non-finite or exceeds
    ``outlier_factor**2`` times the median of the finite norms.  Invalid
    nodes get weight 0 and the surviving weights are renormalized to sum
    to 1; when *every* node is valid the original ``weights`` vector is
    returned unchanged (bitwise — the no-fault transparency guarantee).
    When every node is invalid all weights are 0: the aggregate vanishes
    and the update is a no-op rather than a poisoned step.

    Stays on the tensors' device: no value goes to the host.  The median
    of an even count averages the two middle values, as ``jnp.nanmedian``
    does (``torch.nanmedian`` would take the lower one).
    """
    sq = torch.as_tensor(sq_norms)
    r = torch.as_tensor(weights, device=sq.device)
    finite = torch.isfinite(sq)
    nan = torch.full_like(sq, float("nan"))
    # Median of the finite norms; NaN when nothing is finite (then the
    # outlier comparison is False and validity reduces to finiteness).
    med = torch.nanquantile(torch.where(finite, sq, nan), 0.5)
    outlier = sq > (outlier_factor ** 2) * torch.clamp(med, min=1e-30)
    valid = finite & ~outlier
    masked = torch.where(valid, r, torch.zeros_like(r))
    total = masked.sum()
    renorm = torch.where(total > 0.0, masked / torch.clamp(total, min=1e-30), masked)
    guarded = torch.where(valid.all(), r, renorm)
    return guarded, valid


def padded_batch_layout(batches: Sequence[int]) -> Tuple[int, np.ndarray]:
    """Given per-node batches, return (b_max, mask) where mask has shape
    (n, b_max) with 1 for real samples and 0 for pads."""
    b = np.asarray(batches, dtype=np.int64)
    b_max = int(b.max())
    n = b.size
    mask = (np.arange(b_max)[None, :] < b[:, None]).astype(np.float32)
    return b_max, mask


def sample_weights(batches: Sequence[int]) -> np.ndarray:
    """Per-sample weights over the padded (n, b_max) layout such that a
    weighted-SUM loss  L = sum_j w_j * l_j  has gradient identical to Eq. (9)
    where each l_j is the per-sample loss.

    Each real sample gets 1/B; pads get 0.  Then
        grad = sum_i sum_{j in node i} (1/B) grad_j
             = sum_i (b_i/B) * (1/b_i) sum_j grad_j = sum_i r_i g_i.
    """
    b = np.asarray(batches, dtype=np.int64)
    total = int(b.sum())
    if total <= 0:
        raise ValueError("empty batch")
    _, mask = padded_batch_layout(batches)
    return mask / float(total)
