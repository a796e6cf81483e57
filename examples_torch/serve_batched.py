"""Batched serving demo: prefill + decode with KV caches across the model
zoo's serving-relevant families (dense ring-cache, MLA latent cache, RWKV
O(1) state).

Prompt ingestion uses the fused full-sequence prefill where the family
supports it (``api.prefill``: one forward pass fills the KV cache, its
attention through the flash-attention kernel on the card) and the
stepped single-token decode loop otherwise — the same
:func:`repro_torch.serving.engines.prefill_cache` helper the serving
runtime's real engine uses.

    python examples_torch/serve_batched.py [--device cpu]
"""
import argparse
import time

import _common  # noqa: F401  (sys.path bootstrap)

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_api
from repro_torch.serving.engines import prefill_cache

ARCHS = ("llama3-8b", "deepseek-v2-236b", "rwkv6-7b", "hymba-1.5b")


def serve(arch: str, batch: int = 4, prompt_len: int = 24, gen: int = 12, *,
          device=None):
    """Prefill ``batch`` prompts of ``prompt_len`` tokens (drawn from a
    ``torch.Generator`` seeded with 1), then decode ``gen`` tokens greedily;
    print the reference's lines and return the generated tokens, the
    cache's shapes and the prefill mode."""
    device = resolve_device(device)
    api = get_api(arch, reduced=True)
    params = api.init(0, device=device)
    rng = torch.Generator().manual_seed(1)
    prompts = torch.randint(0, api.cfg.vocab, (batch, prompt_len), generator=rng).to(device)

    cache = api.init_cache(batch, prompt_len + gen, device=device)

    t0 = time.perf_counter()
    with torch.no_grad():
        logits, cache = prefill_cache(api, params, cache, prompts)
        t_prefill = time.perf_counter() - t0
        tok = torch.argmax(logits[:, -1:], dim=-1)
        out = [tok]
        for i in range(gen - 1):
            logits, cache = api.decode_step(params, cache, tok, prompt_len + i)
            tok = torch.argmax(logits[:, -1:], dim=-1)
            out.append(tok)
        toks = torch.cat(out, dim=1).cpu()
    dt = time.perf_counter() - t0
    # Sorted by name, as the reference's cache dict comes out of jit.
    cache_desc = {k: tuple(v.shape) for k, v in sorted(cache.items())
                  if isinstance(v, torch.Tensor) and v.ndim > 0}
    mode = "fused" if api.supports_prefill() else "stepped"
    print(f"{arch:18s} batch={batch} gen={gen}  {dt*1e3:7.1f}ms total  "
          f"(prefill {mode} {t_prefill*1e3:.1f}ms)  "
          f"first row: {list(map(int, toks[0]))[:8]}")
    for k, s in list(cache_desc.items())[:3]:
        print(f"{'':20s}cache[{k}] {s}")
    return {"tokens": toks.numpy(), "cache": cache_desc, "mode": mode}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None,
                    help="where the models run (default: the CUDA card; 'cpu' runs the "
                         "plain PyTorch path)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    for arch in ARCHS:
        serve(arch, device=device)


if __name__ == "__main__":
    main()
