"""Training driver CLI.

The counterpart of ``repro/launch/train.py``: the same flags with the same
defaults, and two of the port's own, which the card needs:

* ``--device`` — where real gradients train (default the card; ``cpu``
  must be asked for);
* ``--full-width`` — train the published config in its own dtype
  (``RealBackendConfig(reduced=False)``) instead of the reduced one (both
  run on the card).

Three modes, each supporting ``--backend {real,sim}`` where it applies:

* ``hetero`` (default) — the paper's end-to-end scenario driven through
  the shared ``EpochLoop``: with ``--backend real`` (default), real
  training of a reduced-config model on this host with per-node timing
  supplied by the calibrated heterogeneous-cluster simulator; with
  ``--backend sim``, the identical loop over the timing simulator alone
  (no gradients — losses are NaN, useful for fast policy/timing studies).
  The chosen policy (cannikin / even / lb-bsp / adaptdl) controls the
  batch partition and, for the adaptive policies, the total batch size.

* ``spmd`` — single-process training of a reduced config (the published
  one with ``--full-width``) through ``train/step.py::build_train_step``
  (AdamW, ``--microbatches`` gradient accumulation), one line per step.

* ``trace`` — multi-job cluster churn through the
  ``repro_torch.runtime.ClusterRuntime`` front door: a seeded synthetic trace
  (arrivals, a departure, a node failure) replayed with training epochs
  between events.  ``--backend sim`` (default) compares all three
  allocation policies; ``--backend real`` runs the cannikin policy with
  every job training real gradients (totals clamped to ``--ref-batch``),
  checkpointing to ``--checkpoint-dir`` on preemption.  ``--arrival
  poisson`` / ``--size-dist lognormal`` sample the arrival process and the
  heavy-tailed job-size skew.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b --policy cannikin \
      --cluster B --epochs 12 --steps-per-epoch 8 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --mode spmd --steps 20 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --mode spmd --full-width --steps 3 \
      --seq-len 512 --ref-batch 16 --microbatches 2
  PYTHONPATH=src python -m repro_torch.launch.train --mode trace --trace-jobs 3 \
      --trace-nodes 12 --epochs-per-event 2 --arrival poisson
  PYTHONPATH=src python -m repro_torch.launch.train --mode trace --backend real \
      --trace-jobs 1 --trace-nodes 3 --epochs-per-event 2 --ref-batch 16 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --mode trace --backend real --full-width \
      --trace-jobs 2 --trace-nodes 4 --ref-batch 16 --seq-len 512 --lr 0.01 \
      --steps-per-epoch 2 --epochs-per-event 2
"""
from __future__ import annotations

import argparse
import json
import time
import warnings
from typing import Optional, Sequence


def make_policy(name: str, n_nodes: int, *, candidates, ref_batch: int, adaptive: bool):
    """Deprecated shim — use :func:`repro_torch.runtime.make_partition_policy`
    (the shared factory this now delegates to)."""
    warnings.warn(
        "repro_torch.launch.train.make_policy is deprecated; use "
        "repro_torch.runtime.make_partition_policy instead",
        DeprecationWarning,
        stacklevel=2,
    )
    from repro_torch.runtime import make_partition_policy

    return make_partition_policy(
        name, n_nodes, candidates=candidates, ref_batch=ref_batch, adaptive=adaptive
    )


def hetero_adaptive(backend: str, fixed_batch: bool, batch_policy: Optional[str]) -> bool:
    """Whether a hetero run's controller adapts its total batch.

    GNS-driven selection (the default law, or any policy with ``"gns"`` in
    its requirements) needs gradient telemetry: under ``--backend sim`` the
    tracker would sit at b_noise=inf and "adaptive" selection would
    escalate the total batch on throughput alone, so those stay forced to
    fixed-batch.  Schedule-driven policies (geodamp/padadamp/adadamp) need
    no gradients and run adaptively on either backend.
    """
    from repro_torch.core.batch_policy import policy_requirements

    if fixed_batch:
        return False
    if backend == "real":
        return True
    return batch_policy is not None and "gns" not in policy_requirements(batch_policy)


def run_hetero(args) -> int:
    from repro_torch.core.simulator import SimulatedCluster, cluster_A, cluster_B, cluster_C
    from repro_torch.runtime import EpochLoop, SimBackend, make_partition_policy

    cluster_fn = {"A": cluster_A, "B": cluster_B, "C": cluster_C}[args.cluster]
    profiles, comm = cluster_fn()
    sim = SimulatedCluster(profiles, comm, noise=args.noise, seed=args.seed)

    candidates = [args.ref_batch * m for m in (1, 2, 4, 8)]
    policy = make_partition_policy(
        args.policy,
        sim.n,
        candidates=candidates,
        ref_batch=args.ref_batch,
        adaptive=hetero_adaptive(args.backend, args.fixed_batch, args.batch_policy),
        batch_policy=args.batch_policy,
    )
    if args.backend == "real":
        from repro_torch.configs import get_api
        from repro_torch.data import SyntheticLM
        from repro_torch.optim import constant_schedule, sgd
        from repro_torch.runtime import RealBackend

        api = get_api(args.arch, reduced=not args.full_width)
        data = SyntheticLM(vocab=api.cfg.vocab, seq_len=args.seq_len, seed=args.seed)
        backend = RealBackend(
            api, sgd(constant_schedule(args.lr)), data, cluster=sim, seed=args.seed,
            device=args.device,
        )
    else:
        backend = SimBackend(cluster=sim, noise=args.noise)
    loop = EpochLoop(
        policy, backend,
        steps_per_epoch=args.steps_per_epoch, fixed_total=args.ref_batch,
    )
    print(f"# arch={args.arch} policy={args.policy} cluster={args.cluster} "
          f"nodes={sim.n} backend={args.backend}")
    for _ in range(args.epochs):
        r = loop.run_epoch()
        pred = "-" if r.predicted_batch_time is None else f"{r.predicted_batch_time*1e3:.1f}ms"
        print(
            f"epoch {r.epoch:3d} [{r.phase:9s}] B={r.total_batch:4d} "
            f"split={list(r.batches)} loss={r.mean_loss:.4f} "
            f"batch_time={r.measured_batch_time*1e3:.1f}ms pred={pred} "
            f"sim_total={loop.sim_time:.2f}s",
            flush=True,
        )
        if args.target_loss and r.mean_loss <= args.target_loss:
            print(f"# reached target loss {args.target_loss} at sim time "
                  f"{loop.sim_time:.2f}s")
            break
    if args.out:
        # Keep the historical EpochResult record schema (sim_seconds etc.)
        # that existing consumers of --out parse.
        from repro_torch.train.hetero import EpochResult

        with open(args.out, "w") as f:
            json.dump(
                [EpochResult.from_record(r).__dict__ for r in loop.history],
                f, indent=1, default=str,
            )
    return 0


def run_spmd(args) -> int:
    """``--mode spmd``: the reference's ``run_spmd`` (AdamW at ``--lr``,
    ``SyntheticLM`` batches of ``--ref-batch``), on ``--device``."""
    import torch

    from repro_torch.configs import get_api
    from repro_torch.data import SyntheticLM
    from repro_torch.optim import adamw, constant_schedule
    from repro_torch.train.step import build_train_step

    api = get_api(args.arch, reduced=not args.full_width)
    if api.is_encoder_decoder:
        # The JAX package's run_spmd fails at this key too, in its first step.
        raise KeyError(
            f"audio_embed: --mode spmd trains on SyntheticLM batches (tokens and labels), "
            f"which carry no audio frames for the {args.arch} encoder-decoder"
        )
    params = api.init(args.seed, device=args.device).requires_grad_(True)
    opt = adamw(constant_schedule(args.lr))
    step = build_train_step(api, opt, microbatches=args.microbatches)
    opt_state = opt.init(dict(params.named_parameters()))
    data = SyntheticLM(vocab=api.cfg.vocab, seq_len=args.seq_len, seed=args.seed)
    for i in range(args.steps):
        raw = data.batch(i, args.ref_batch)
        batch = {k: torch.as_tensor(v, device=params.device) for k, v in raw.items()}
        t0 = time.perf_counter()
        params, opt_state, metrics = step(params, opt_state, batch)
        loss = float(metrics["loss"])
        print(f"step {i:4d} loss={loss:.4f} "
              f"({(time.perf_counter()-t0)*1e3:.0f}ms)", flush=True)
    return 0


def run_trace(args) -> int:
    from repro_torch.runtime import (
        RealBackendConfig,
        compare_policies,
        format_batch_policy_summary,
        format_summary,
        make_fault_plan,
        synthetic_trace,
    )

    real = args.backend == "real"
    # --batch-policy switches the comparison axis: one allocation policy,
    # one replay per batch-size adaptation law ("all" = whole registry).
    if args.batch_policy is None:
        batch_policies = None
    elif args.batch_policy == "all":
        batch_policies = ()
    else:
        batch_policies = (args.batch_policy,)
    trace, jobs = synthetic_trace(
        args.trace_jobs,
        args.trace_nodes,
        seed=args.seed,
        arrival=args.arrival,
        size_dist=args.size_dist,
        backend=args.backend,
        # Real gradients on this host: clamp the trace's sampled totals to
        # a CPU-sized batch.
        total_batch=args.ref_batch if real else None,
    )
    faults = make_fault_plan(args.faults, args.trace_nodes, seed=args.seed)
    reports = compare_policies(
        trace,
        args.trace_nodes,
        # Real-backend traces train actual models per job per policy; keep
        # the comparison to the cannikin policy unless simulating.
        policies=("cannikin",) if real else ("cannikin", "static", "fair-share"),
        epochs_per_event=args.epochs_per_event,
        steps=args.steps_per_epoch,
        noise=args.noise,
        seed=args.seed,
        real_backend=RealBackendConfig(
            arch=args.arch, seq_len=args.seq_len, lr=args.lr, device=args.device,
            reduced=not args.full_width,
        ) if real else None,
        checkpoint_dir=args.checkpoint_dir,
        faults=faults,
        invariants=args.invariants,
        batch_policies=batch_policies,
        device=args.device,
    )
    print(f"# trace: {len(trace)} events, jobs={[j.name for j in jobs]}, "
          f"nodes={args.trace_nodes}")
    if faults is not None:
        for line in faults.describe():
            print(f"# inject: {line}")
        for name, rep in reports.items():
            telemetry = rep.runtime.fault_telemetry()
            if telemetry is None:
                continue
            retention = rep.goodput_retention
            note = f" retention={retention:.3f}" if retention is not None else ""
            if args.invariants:
                inv = telemetry.get("invariants", {})
                note += f" invariant_violations={inv.get('violations', 0)}"
            print(f"# {name}: detected={telemetry['detected']} "
                  f"recoveries={telemetry['recoveries']}{note}")
    if batch_policies is not None:
        print(format_batch_policy_summary(reports))
    else:
        print(format_summary(reports))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({name: rep.summary() for name, rep in reports.items()},
                      f, indent=1)
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--mode", default="hetero", choices=["hetero", "spmd", "trace"])
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--policy", default="cannikin",
                    choices=["cannikin", "even", "ddp", "adaptdl", "lb-bsp"])
    ap.add_argument("--cluster", default="B", choices=["A", "B", "C"])
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--steps-per-epoch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=32)
    ap.add_argument("--ref-batch", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=0.3)
    ap.add_argument("--noise", type=float, default=0.01)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fixed-batch", action="store_true")
    ap.add_argument("--batch-policy", default=None,
                    help="total-batch adaptation law from the "
                         "repro_torch.core.batch_policy registry (cannikin-gns, "
                         "adadamp, padadamp, geodamp, fixed); in trace mode "
                         "'all' compares every registered policy on one "
                         "trace; default keeps the historical per-backend "
                         "behaviour")
    ap.add_argument("--target-loss", type=float, default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--backend", default=None, choices=["sim", "real"],
                    help="execution backend (default: real for --mode hetero, "
                         "sim for --mode trace)")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="directory for preemption checkpoints (trace mode)")
    ap.add_argument("--trace-jobs", type=int, default=3)
    ap.add_argument("--trace-nodes", type=int, default=12)
    ap.add_argument("--faults", default="none",
                    choices=["none", "chaos", "chaos-small", "chaos-real"],
                    help="seeded fault plan injected into trace replays "
                         "(chaos-real adds gradient poison / checkpoint "
                         "corruption / solver stalls for real backends)")
    ap.add_argument("--invariants", action="store_true",
                    help="run the debug-mode runtime invariant checker "
                         "after every reconciled event (trace mode)")
    ap.add_argument("--epochs-per-event", type=int, default=2)
    ap.add_argument("--arrival", default="fixed", choices=["fixed", "poisson"])
    ap.add_argument("--size-dist", default="fixed", choices=["fixed", "lognormal"])
    ap.add_argument("--device", default=None,
                    help="where real gradients train (default: the CUDA card; "
                         "'cpu' runs the plain PyTorch path)")
    ap.add_argument("--full-width", action="store_true",
                    help="train the published config in its own dtype instead "
                         "of the reduced one (olmo-1b: bf16 at head dim 128, not "
                         "float32 at 32; the card's flash kernel takes both)")
    args = ap.parse_args(argv)
    if args.backend is None:
        args.backend = "real" if args.mode == "hetero" else "sim"
    if args.batch_policy not in (None, "all"):
        from repro_torch.core.batch_policy import BATCH_POLICIES

        if args.batch_policy not in BATCH_POLICIES:
            ap.error(
                f"--batch-policy {args.batch_policy!r} is not registered "
                f"(choose from {sorted(BATCH_POLICIES)} or 'all')"
            )
    if args.mode == "hetero":
        return run_hetero(args)
    if args.mode == "spmd":
        return run_spmd(args)
    return run_trace(args)


if __name__ == "__main__":
    raise SystemExit(main())
