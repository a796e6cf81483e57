"""Quickstart: train a reduced llama3-family model on synthetic data, then
drive the cluster-runtime front door in ~10 lines.

    python examples_torch/quickstart.py [--device cpu]

Part 1 uses the single-job public API end to end on ``--device`` (default
the CUDA card, where every training step runs the flash-attention
kernel's forward and backward): config -> ModelApi -> train step -> loss
curve -> checkpoint save/restore -> greedy decode with the KV cache.
Part 2 submits two jobs to the event-driven
``repro_torch.runtime.ClusterRuntime`` and lets the Cannikin policy
partition an 8-node heterogeneous cluster between them (on the host).

Each part is a function that takes the model and returns what it prints,
so that a test or a smoke run can drive one part alone.
"""
import argparse
import os
import tempfile

import _common  # noqa: F401  (sys.path bootstrap)

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_api
from repro_torch.data import SyntheticLM
from repro_torch.optim import adamw, cosine_schedule
from repro_torch.train import restore, save
from repro_torch.train.step import build_train_step

STEPS, BATCH, SEQ = 60, 16, 32
DECODE = 16


def train(api, params, data, steps: int = STEPS):
    """AdamW on a cosine schedule over ``steps`` batches of ``data``;
    prints every tenth step and returns each step's (loss, grad_norm)."""
    opt = adamw(cosine_schedule(3e-3, warmup_steps=5, total_steps=STEPS))
    step = build_train_step(api, opt)
    opt_state = opt.init(dict(params.named_parameters()))
    history = []
    for i in range(steps):
        params, opt_state, metrics = step(params, opt_state, data.batch(i, BATCH))
        history.append((float(metrics["loss"]), float(metrics["grad_norm"])))
        if i % 10 == 0:
            print(f"step {i:3d} loss={history[-1][0]:.4f} "
                  f"grad_norm={history[-1][1]:.3f}")
    return history


def checkpoint_round_trip(params) -> float:
    """Save the parameters, restore them into the model and check that every
    tensor came back equal; returns the file's size in MB."""
    before = {k: v.detach().clone() for k, v in params.state_dict().items()}
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "ckpt.npz")
        save(path, params.state_dict())
        params.load_state_dict(restore(path, params.state_dict()))
        size = os.path.getsize(path) / 1e6
    after = params.state_dict()
    assert all(torch.equal(v, after[k]) for k, v in before.items()), "round trip changed"
    print(f"checkpoint round-trip OK ({size:.1f} MB)")
    return size


def greedy_decode(api, params, rule, steps: int = DECODE):
    """Greedy-decode ``steps`` tokens from token 0 through the KV cache;
    returns the tokens and how many transitions follow ``rule``."""
    cache = api.init_cache(batch=1, seq_len=SEQ, device=params.device)
    tok = torch.zeros((1, 1), dtype=torch.int64, device=params.device)
    out = []
    with torch.no_grad():
        for pos in range(steps):
            logits, cache = api.decode_step(params, cache, tok, pos)
            tok = torch.argmax(logits[:, -1:], dim=-1)
            out.append(int(tok[0, 0]))
    print("greedy decode:", out)
    # The synthetic rule is next = rule[prev]; a trained model should follow
    # it for at least a few steps.
    hits = sum(out[i + 1] == int(rule[out[i]]) for i in range(len(out) - 1))
    print(f"rule-following transitions: {hits}/{len(out)-1}")
    return out, hits


def cluster_runtime():
    """Part 2: the multi-job cluster runtime in ~10 lines.  Two jobs arrive
    one after the other; each event incrementally re-partitions the 8-node
    cluster, and advance() steps the running jobs' epoch loops (bootstrap ->
    model fit -> OptPerf partition) on the simulator.  Returns the printed
    lines."""
    from repro_torch.core.scheduler import random_jobs
    from repro_torch.runtime import ClusterRuntime

    rt = ClusterRuntime(8, policy="cannikin")
    for i, job in enumerate(random_jobs(2, 8, seed=0)):
        rt.submit(job, at=float(i))
    rt.run()
    rt.advance(epochs=3, steps=2)
    lines = ["\ncluster runtime:"]
    for h in rt.jobs("running"):
        lines.append(f"  {h.name}: nodes={h.nodes} epochs={h.epochs_run} "
                     f"phase={h.last_plan.phase}")
    lines.append(f"  aggregate goodput={rt.allocation.aggregate_goodput:.1f} "
                 f"(fraction {rt.allocation.aggregate_fraction:.3f})")
    for line in lines:
        print(line)
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None,
                    help="where part 1 trains and decodes (default: the CUDA card; "
                         "'cpu' runs the plain PyTorch path)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    api = get_api("llama3-8b", reduced=True)
    print(f"arch={api.arch_id} (reduced) params={api.param_count():,}")
    params = api.init(0, device=device).requires_grad_(True)
    data = SyntheticLM(vocab=api.cfg.vocab, seq_len=SEQ, seed=0)
    train(api, params, data)
    checkpoint_round_trip(params)
    greedy_decode(api, params, data.rule)
    cluster_runtime()


if __name__ == "__main__":
    main()
