"""Heterogeneous gradient-noise-scale estimation demo (§4.4 / Theorem 4.1).

    python examples_torch/gns_heterogeneous.py

Draws synthetic per-node gradients with known |G|^2 and tr(Sigma), then
compares three aggregations of the Eq. (10) local estimators:
  * plain averaging (the homogeneous baseline AdaptDL/Pollux would use),
  * the paper's printed Theorem 4.1 weights,
  * the cross-term-corrected closed form w_i = (B - b_i)/((n-1)B)
    (this repo's correction — zero leading-order variance for tr(Sigma)).
"""
import _common  # noqa: F401  (sys.path bootstrap)

import numpy as np

from repro_torch.core.gns import estimate_gns, gns_weights, homogeneous_gns

BATCHES = [7, 13, 29, 51]
TRIALS = 2000


def main():
    rng = np.random.default_rng(0)
    d, g_norm, sigma = 4000, 10.0, 0.05
    G = rng.normal(size=d)
    G *= g_norm / np.linalg.norm(G)
    B = float(sum(BATCHES))
    true_b_noise = (d * sigma**2) / g_norm**2

    w_corr = gns_weights(BATCHES, B, corrected=True)
    w_paper = gns_weights(BATCHES, B, corrected=False)
    print("corrected weights:", np.round(w_corr[1], 4))
    print("paper weights    :", np.round(w_paper[1], 4))

    rows = {"corrected": [], "paper": [], "average": []}
    for _ in range(TRIALS):
        gi = [G + rng.normal(size=d) * sigma / np.sqrt(b) for b in BATCHES]
        g = sum((b / B) * x for b, x in zip(BATCHES, gi))
        sq = [float(x @ x) for x in gi]
        gsq = float(g @ g)
        rows["corrected"].append(estimate_gns(sq, gsq, BATCHES, weights=w_corr))
        rows["paper"].append(estimate_gns(sq, gsq, BATCHES, weights=w_paper))
        rows["average"].append(homogeneous_gns(sq, gsq, BATCHES))

    print(f"\ntrue: |G|^2={g_norm**2:.2f}  tr(Sigma)={d*sigma**2:.2f}  "
          f"B_noise={true_b_noise:.4f}\n")
    print(f"{'method':10s} {'E[G]':>8s} {'E[S]':>8s} {'var(S)':>10s} {'E[B_noise]':>11s}")
    for name, vals in rows.items():
        arr = np.array([(g, s, bn) for bn, g, s in vals])
        print(f"{name:10s} {arr[:,0].mean():8.3f} {arr[:,1].mean():8.3f} "
              f"{arr[:,1].var():10.4f} {arr[:,2].mean():11.4f}")


if __name__ == "__main__":
    main()
