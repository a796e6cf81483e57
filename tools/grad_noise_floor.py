#!/usr/bin/env python3
"""How closely float32 fixes one node's gradient of a full-width model.

Run from the repository root on a machine with one CUDA card::

    python3 tools/grad_noise_floor.py [--arch hymba-1.5b] [--layers 32 16 8]

For each depth it builds the published config in float32 (seeded random
weights, b=2, S=256, ``chip_smoke.node_grad_check``'s tokens) and takes the
gradient of the mean loss through ``train_forward`` with each of these in
the model's ``attend`` / ``scan`` seams:

* ``plain``: the plain versions (``chip_smoke.plain_seams``);
* ``kernels``: the CUDA kernels;
* ``kernel attend`` / ``kernel scan``: one kernel, the other plain;
* ``sdpa attend``: ``scaled_dot_product_attention`` (math backend) for
  the attention, the plain scan;
* ``f64``: attention and scan computed in float64 inside, the rest of
  the model in float32.

It prints, against ``plain`` and against ``f64``, each variant's global
sq-norm relative difference (what ``node_grad_check`` limits), |dg| / |g|
and the worst leaf's max abs difference over max(1, max |g|).  Two right
float32 implementations differ by the function's own float32 noise; a
kernel is suspect where it differs by more than the plain variants do.
rwkv6 (``--arch rwkv6-7b``) has a ``scan`` seam only.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def attend_f64(q, k, v, *, causal=True, window=None):
    """Causal (windowed) attention with scores and softmax in float64."""
    import torch

    b, s, h, d = q.shape
    kv = k.shape[2]
    qd = q.double().reshape(b, s, kv, h // kv, d)
    scores = torch.einsum("bskrd,btkd->bkrst", qd, k.double()) / d ** 0.5
    pos = torch.arange(s, device=q.device)
    ok = pos[None, :] <= pos[:, None]
    if window is not None:
        ok = ok & (pos[None, :] > pos[:, None] - window)
    probs = torch.softmax(scores.masked_fill(~ok, float("-inf")), dim=-1)
    out = torch.einsum("bkrst,btkd->bskrd", probs, v.double())
    return out.reshape(b, s, h, d).to(q.dtype)


def attend_sdpa(q, k, v, *, causal=True, window=None):
    """``scaled_dot_product_attention`` on its math backend (float32)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    if window is not None and window < q.shape[1]:
        raise ValueError("attend_sdpa takes sequences inside the window")
    with sdpa_kernel(SDPBackend.MATH):
        out = F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=True,
            enable_gqa=q.shape[2] != k.shape[2])
    return out.transpose(1, 2)


def scan_f64(u, dt, b_t, c_t, log_a, chunk):
    """The selective scan step by step in float64, results in float32."""
    import torch

    u, dt, b_t, c_t = (x.double() for x in (u, dt, b_t, c_t))
    a = -torch.exp(log_a.double())
    h = torch.zeros((u.shape[0], u.shape[2], a.shape[1]), dtype=torch.float64, device=u.device)
    ys = []
    for i in range(u.shape[1]):
        h = torch.exp(dt[:, i, :, None] * a) * h + (dt[:, i] * u[:, i])[..., None] * b_t[:, i, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, c_t[:, i]))
    return torch.stack(ys, dim=1).float(), h.float()


def variants(family):
    plain = chip_smoke.plain_seams(family)
    if family == "ssm":
        return [("plain", plain), ("kernels", {})]
    return [("plain", plain), ("kernels", {}), ("kernel attend", {"scan": plain["scan"]}),
            ("kernel scan", {"attend": plain["attend"]}),
            ("sdpa attend", {"attend": attend_sdpa, "scan": plain["scan"]}),
            ("f64", {"attend": attend_f64, "scan": scan_f64})]


def run(torch, arch, n_layers):
    from repro_torch.configs import get_api
    from repro_torch.models import common
    from repro_torch.models.registry import build_api

    cfg = dataclasses.replace(get_api(arch).cfg, param_dtype=torch.float32,
                              compute_dtype=torch.float32, n_layers=n_layers)
    model = build_api(arch, cfg).init(0, device="cuda").requires_grad_(True)
    gen = torch.Generator(device="cuda").manual_seed(7)
    tokens = torch.randint(0, cfg.vocab, (2, 257), generator=gen, device="cuda")
    names = [n for n, _ in model.named_parameters()]
    grads = {}
    for name, seams in variants(cfg.family):
        logits = model.train_forward(tokens[:, :-1], **seams)
        loss, w_sum = common.weighted_cross_entropy(logits, tokens[:, 1:])
        grads[name] = torch.autograd.grad(loss / w_sum, list(model.parameters()))
        del logits, loss
    sq = {k: sum(float((g.double() ** 2).sum()) for g in v) for k, v in grads.items()}
    for ref in [r for r in ("plain", "f64") if r in grads]:
        for name, g in grads.items():
            diff = sum(float(((a.double() - b.double()) ** 2).sum())
                       for a, b in zip(g, grads[ref])) ** 0.5
            worst = max(((a - b).abs().max().item() / max(1.0, b.abs().max().item()), n)
                        for n, a, b in zip(names, g, grads[ref]))
            print(f"{arch} {n_layers} layers, {name} vs {ref}: sq-norm rel "
                  f"{abs(sq[name] - sq[ref]) / sq[ref]:.3e}, |dg|/|g| "
                  f"{diff / sq[ref] ** 0.5:.3e}, worst leaf {worst[1]} {worst[0]:.3e}", flush=True)
    del model, grads
    torch.cuda.empty_cache()


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="hymba-1.5b")
    ap.add_argument("--layers", type=int, nargs="+", default=[32, 16, 8])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("grad_noise_floor: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(chip_smoke.phase_device(), flush=True)
    for n_layers in args.layers:
        run(torch, args.arch, n_layers)
    return 0


if __name__ == "__main__":
    sys.exit(main())
