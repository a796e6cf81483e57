"""The paper's end-to-end scenario: adaptive-batch-size training on a
heterogeneous cluster — Cannikin vs PyTorch-DDP-even vs LB-BSP.

    python examples_torch/hetero_cluster_training.py [--device cpu]

Real training of a reduced OLMo on synthetic data on ``--device`` (default
the CUDA card, where every node step runs the flash-attention kernel's
forward and backward); per-node wall-clock from the calibrated cluster-B
simulator (4x A100 + 4x V100 + 8x RTX6000).  Policies come from the
runtime's shared partition-policy factory
(``repro_torch.runtime.make_partition_policy``).  Prints per-epoch
partitions, OptPerf predictions vs measurements, and the final simulated
time-to-loss comparison (Fig. 7/8 analogue).
"""
import argparse

import _common  # noqa: F401  (sys.path bootstrap)

from repro_torch import resolve_device
from repro_torch.configs import get_api
from repro_torch.core.simulator import SimulatedCluster, cluster_B
from repro_torch.data import SyntheticLM
from repro_torch.optim import constant_schedule, sgd
from repro_torch.runtime import make_partition_policy
from repro_torch.train import HeteroTrainer

TARGET_LOSS = 3.5
REF_BATCH = 64


def build(policy_name: str, device=None):
    api = get_api("olmo-1b", reduced=True)
    profiles, comm = cluster_B()
    sim = SimulatedCluster(profiles, comm, noise=0.01, seed=0)
    data = SyntheticLM(vocab=api.cfg.vocab, seq_len=24, seed=0)
    policy = make_partition_policy(
        policy_name,
        sim.n,
        candidates=[REF_BATCH, REF_BATCH * 2, REF_BATCH * 4],
        ref_batch=REF_BATCH,
    )
    tr = HeteroTrainer(api, sgd(constant_schedule(0.3)), sim, policy, data,
                       steps_per_epoch=4, device=device)
    tr.set_fixed_total(REF_BATCH)
    return tr


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None,
                    help="where the model trains (default: the CUDA card; 'cpu' runs the "
                         "plain PyTorch path)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    wall = {}
    for name in ("cannikin", "even", "lb-bsp"):
        tr = build(name, device)
        print(f"\n=== policy: {name} ===")
        for _ in range(16):
            r = tr.run_epoch()
            pred = "-" if r.predicted_batch_time is None else f"{r.predicted_batch_time*1e3:6.1f}ms"
            print(f"  ep{r.epoch:2d} [{r.phase:9s}] B={r.total_batch:4d} "
                  f"split={list(r.batches)[:4]}... loss={r.mean_loss:.3f} "
                  f"t={r.measured_batch_time*1e3:6.1f}ms pred={pred}")
            if r.mean_loss <= TARGET_LOSS:
                break
        wall[name] = tr.sim_time
        print(f"  simulated wall-clock to loss<={TARGET_LOSS}: {tr.sim_time:.2f}s")

    base = wall["even"]
    print("\n=== time-to-target (normalized to DDP-even) ===")
    for name, t in wall.items():
        print(f"  {name:10s} {t:7.2f}s  ({t/base:5.1%})")


if __name__ == "__main__":
    main()
