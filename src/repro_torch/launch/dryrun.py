"""Dry run of the production meshes: trace every (architecture x input
shape) step on fake tensors over a fake 256- or 512-rank ``DeviceMesh`` and
record memory, op and collective statistics (the counterpart of
``repro/launch/dryrun.py``).

The reference lowers and compiles each step with XLA on 512 placeholder
host devices.  The port has no compiler and no placeholder devices, so:

  * the mesh is a ``DeviceMesh`` named ``("data", "model")`` over the
    first 256 ranks, or ``("pod", "data", "model")`` over all 512, of a
    ``torch.distributed`` fake process group (this process is rank 0);
  * parameters, optimizer moments, batches and caches are DTensors whose
    local shards are fake tensors (``FakeTensorMode``: shapes and dtypes,
    no storage), laid out by the reference's ``MeshRules``
    (``make_rules``);
  * the step runs eagerly, as the card would run it on one rank, under
    :class:`repro_torch.launch.op_stats.OpStatsMode`, whose per-device
    counts stand where the reference's ``analyze_hlo`` does, inside a
    ``sharding_context`` so that the models' ``constrain`` calls pin the
    reference's activation layouts.

On a ``"cuda"`` mesh (``--device cuda``, the default) the local shards
are fake CUDA tensors and the kernels' wrappers take their custom ops'
route, as the card runs them; on a ``"cpu"`` mesh they take the plain
versions, which materialise attention, so the two devices' records
differ wherever attention runs.

``memory`` holds per-device bytes of the local shards:
``argument_size_in_bytes`` (parameters, optimizer state, batch, cache),
``output_size_in_bytes`` (what the step returns, the parameters and
moments it updates in place included), ``alias_size_in_bytes`` (the part
of the output that is an argument updated in place) and
``temp_size_in_bytes`` (the peak of live bytes over the step beyond the
arguments).  XLA's ``generated_code_size_in_bytes`` has no counterpart.

Results are written incrementally to JSON (one file per combo) so reruns
skip finished work:  artifacts/dryrun_torch/<arch>__<shape>__<mesh>.json

``--layers N`` cuts every stack to N layers (the record says so and its
file name ends ``__L<N>``); ``--jobs N`` traces N combinations at once,
each in a process of its own.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all --mesh both
  PYTHONPATH=src python -m repro_torch.launch.dryrun --device cpu --arch llama3-8b \
      --shape train_4k --mesh single
"""
from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import json
import math
import os
import sys
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs import SHAPES, arch_ids, get_api
from repro_torch.launch.mesh import (
    make_production_mesh,
    make_rules,
    mesh_axis_sizes,
    train_microbatches,
)
from repro_torch.launch.op_stats import OpStatsMode
from repro_torch.optim import adamw, constant_schedule
from repro_torch.sharding.context import placements, sharding_context
from repro_torch.train.step import build_train_step

__all__ = ["plan_specs", "build_dryrun", "applicable", "run_one", "main", "local_shape"]

OUT_DIR = "artifacts/dryrun_torch"


def local_shape(mesh, spec, shape) -> Tuple[int, ...]:
    """The shape of one rank's shard of a ``shape`` tensor laid out by
    ``spec`` over ``mesh`` (the rules only shard dims that divide)."""
    local = list(shape)
    for m, p in enumerate(placements(mesh, spec)):
        if p.is_shard():
            local[p.dim] //= mesh.size(m)
    return tuple(local)


def _contiguous_stride(shape) -> Tuple[int, ...]:
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= max(n, 1)
    return tuple(reversed(stride))


def _dtensor(mesh, spec, shape, dtype, device) -> torch.Tensor:
    """A DTensor of global ``shape`` laid out by ``spec``, its local shard
    an uninitialised tensor (fake under ``FakeTensorMode``)."""
    from torch.distributed.tensor import DTensor

    local = torch.empty(local_shape(mesh, spec, shape), dtype=dtype, device=device)
    return DTensor.from_local(local, mesh, placements(mesh, spec), run_check=False,
                              shape=torch.Size(shape), stride=_contiguous_stride(shape))


def _sharded_model(api, mesh, pspecs, device, requires_grad: bool) -> nn.Module:
    """The model with every parameter a DTensor laid out by its spec."""
    model = api._module.MODEL(api.cfg, device=device)
    for name, p in list(model.named_parameters()):
        owner_name, _, leaf = name.rpartition(".")
        owner = model.get_submodule(owner_name) if owner_name else model
        owner._parameters[leaf] = nn.Parameter(
            _dtensor(mesh, pspecs[name], p.shape, p.dtype, device), requires_grad=requires_grad)
    return model


def _batch(mesh, shapes, specs, device) -> Dict[str, torch.Tensor]:
    return {name: _dtensor(mesh, specs[name], shape, dtype, device)
            for name, (shape, dtype) in shapes.items()}


# ---------------------------------------------------------------------------
# step builders per shape kind
# ---------------------------------------------------------------------------


def plan_specs(api, shape, rules) -> Dict[str, Any]:
    """Every spec a combination's step takes, resolved in the reference's
    order (so ``rules.fallback_report()`` after it is the reference's
    before its trace): parameters, then the batch, or the cache and the
    tokens for decode."""
    if shape.kind == "train":
        batch = api.train_batch_specs(shape.global_batch, shape.seq_len)
        return {"params": api.specs(rules), "batch_shapes": batch,
                "batch": api.batch_sharding(rules, batch)}
    if shape.kind == "prefill":
        batch = api.train_batch_specs(shape.global_batch, shape.seq_len)
        batch.pop("labels", None)
        batch.pop("weights", None)
        return {"params": api.specs(rules), "batch_shapes": batch,
                "batch": api.batch_sharding(rules, batch)}
    params = api.specs(rules)
    cache = api.cache_specs(rules, shape.global_batch, shape.seq_len)
    tokens = rules.spec(("batch", None), (shape.global_batch, 1), path="tokens")
    return {"params": params, "cache": cache, "tokens": tokens}


def build_dryrun(api, shape, mesh, rules, *, device) -> Tuple[Callable, Tuple, Dict]:
    """(fn, args, info): the step of ``shape``'s kind and its DTensor
    arguments (made under the active fake mode).  ``info`` names which
    arguments the step updates in place (``aliased``)."""
    plan = plan_specs(api, shape, rules)
    if shape.kind == "train":
        sizes = mesh_axis_sizes(mesh)
        batch_extent = math.prod(sizes[a] for a in rules.batch_axes)
        mb = train_microbatches(api.arch_id, global_batch=shape.global_batch,
                                batch_extent=batch_extent)
        mb_shardings = {
            name: placements(mesh, rules.batch_spec(extra_dims=len(shp) - 1))
            for name, (shp, _) in plan["batch_shapes"].items()
        }
        opt = adamw(constant_schedule(1e-4))
        step = build_train_step(api, opt, microbatches=mb, with_metrics=False,
                                microbatch_shardings=mb_shardings)
        model = _sharded_model(api, mesh, plan["params"], device, requires_grad=True)
        opt_state = opt.init(dict(model.named_parameters()))
        batch = _batch(mesh, plan["batch_shapes"], plan["batch"], device)
        aliased = list(model.parameters()) + list(opt_state.m.values()) + list(
            opt_state.v.values())
        return step, (model, opt_state, batch), {"aliased": aliased, "microbatches": mb}

    if shape.kind == "prefill":
        model = _sharded_model(api, mesh, plan["params"], device, requires_grad=False)
        batch = _batch(mesh, plan["batch_shapes"], plan["batch"], device)

        @torch.no_grad()
        def fn(params, batch):
            logits = api.logits(params, batch)
            return logits[:, -1]  # next-token distribution

        return fn, (model, batch), {"aliased": []}

    # decode: one token against a cache of seq_len at its last position
    model = _sharded_model(api, mesh, plan["params"], device, requires_grad=False)
    shapes = api.init_cache(shape.global_batch, shape.seq_len, device="meta")
    cache: Dict[str, Any] = {
        name: (_dtensor(mesh, plan["cache"][name], x.shape, x.dtype, device)
               if isinstance(x, torch.Tensor) else x)
        for name, x in shapes.items()
    }
    tokens = _dtensor(mesh, plan["tokens"], (shape.global_batch, 1), torch.int32, device)
    pos = shape.seq_len - 1

    @torch.no_grad()
    def fn(params, cache, tokens):
        return api.decode_step(params, cache, tokens, pos)

    aliased = [x for x in cache.values() if isinstance(x, torch.Tensor)]
    return fn, (model, cache, tokens), {"aliased": aliased}


def _tensor_leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, nn.Module):
        return list(tree.parameters())
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensor_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensor_leaves(v)]
    return []


def _local_bytes(tensors) -> int:
    from torch.distributed.tensor import DTensor

    seen, total = set(), 0
    for t in tensors:
        local = t._local_tensor if isinstance(t, DTensor) else t
        key = id(local)
        if key not in seen:
            seen.add(key)
            total += local.numel() * local.element_size()
    return total


def trace_step(api, shape, mesh, rules, *, device) -> Dict[str, Any]:
    """Build and run one combination's step on fake tensors under an
    :class:`OpStatsMode`: its memory and op statistics."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication

    with FakeTensorMode(), implicit_replication(), sharding_context(mesh, rules):
        fn, args, info = build_dryrun(api, shape, mesh, rules, device=device)
        arg_tensors = _tensor_leaves(args)
        mode = OpStatsMode()
        with mode:
            arg_bytes = mode.track(arg_tensors)
            out = fn(*args)
        out_tensors = _tensor_leaves(out)
        aliased = {id(t) for t in info["aliased"]}
        memory = {
            "argument_size_in_bytes": arg_bytes,
            "output_size_in_bytes": _local_bytes(out_tensors),
            "temp_size_in_bytes": mode.peak_bytes - arg_bytes,
            "alias_size_in_bytes": _local_bytes(t for t in out_tensors if id(t) in aliased),
        }
    return {"memory": memory, "stats": mode.stats, "microbatches": info.get("microbatches")}


# ---------------------------------------------------------------------------


def applicable(api, shape) -> bool:
    if shape.name == "long_500k" and not api.supports_long_context():
        return False
    return True


def cut_depth(api, layers: int):
    """``api`` with every layer stack cut to ``layers`` (whisper's encoder
    and decoder each)."""
    cfg = api.cfg
    fields = {f.name for f in dataclasses.fields(cfg)}
    cut = {name: min(getattr(cfg, name), layers)
           for name in ("n_layers", "n_enc_layers", "n_dec_layers") if name in fields}
    return dataclasses.replace(api, cfg=dataclasses.replace(cfg, **cut))


def run_one(arch_id: str, shape_name: str, mesh_kind: str, outdir: str, *, force=False,
            device: str = "cuda", layers: Optional[int] = None) -> Dict:
    suffix = "" if layers is None else f"__L{layers}"
    outpath = os.path.join(outdir, f"{arch_id}__{shape_name}__{mesh_kind}{suffix}.json")
    if os.path.exists(outpath) and not force:
        with open(outpath) as f:
            return json.load(f)
    shape = SHAPES[shape_name]
    api = get_api(arch_id)
    record: Dict[str, Any] = {
        "arch": arch_id,
        "shape": shape_name,
        "mesh": mesh_kind,
        "kind": shape.kind,
        "device": device,
        "param_count": api.param_count(),
    }
    if layers is not None:
        api = cut_depth(api, layers)
        record.update(layers=layers, traced_param_count=api.param_count())
    if not applicable(api, shape):
        record["status"] = "skipped"
        record["reason"] = "long_500k requires sub-quadratic decode (DESIGN.md §5)"
        _write(outpath, record)
        return record

    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"), device_type=device)
    rules = make_rules(mesh, arch_id, kind=shape.kind, global_batch=shape.global_batch)
    t0 = time.time()
    try:
        traced = trace_step(api, shape, mesh, rules, device=device)
        stats = traced["stats"]
        record.update(
            status="ok",
            trace_seconds=round(time.time() - t0, 2),
            n_devices=mesh.size(),
            microbatches=traced["microbatches"],
            memory=traced["memory"],
            cost_raw={"flops": stats.flops, "bytes accessed": stats.bytes_accessed},
            collectives_raw={
                "bytes_by_kind": dict(stats.collective_by_kind),
                "count_by_kind": dict(stats.collective_counts),
                "total_bytes": stats.collective_bytes,
            },
            hlo=stats.as_dict(),
            fallbacks=rules.fallback_report(),
        )
    except Exception as e:
        record.update(status="error", error=f"{type(e).__name__}: {e}",
                      traceback=traceback.format_exc()[-4000:])
    _write(outpath, record)
    return record


def _write(path: str, record: Dict) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(record, f, indent=1, default=str)


def _report(rec: Dict) -> str:
    status = rec["status"]
    extra = ""
    if status == "ok":
        flops = rec["hlo"].get("matmul_flops", 0)
        cb = rec["hlo"].get("collective_bytes", 0)
        extra = f"trace={rec['trace_seconds']}s flops/dev={flops:.3g} coll={cb/1e6:.1f}MB"
    elif status == "error":
        extra = rec["error"][:160]
    return f"[{status:7s}] {rec['arch']:18s} {rec['shape']:12s} {rec['mesh']:6s} {extra}"


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--layers", type=int, default=None,
                    help="cut every layer stack to this depth")
    ap.add_argument("--jobs", type=int, default=1,
                    help="combinations traced at once, each in a process of its own")
    args = ap.parse_args(argv)

    archs = arch_ids() if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    combos = [(a, s, m) for a in archs for s in shapes for m in meshes]
    if args.jobs > 1:  # the longest first: train steps, the larger mesh, more parameters
        combos.sort(key=lambda c: (SHAPES[c[1]].kind != "train", c[2] != "multi",
                                   -get_api(c[0]).param_count()))
    kw = dict(force=args.force, device=args.device, layers=args.layers)

    failures = 0
    if args.jobs <= 1:
        records = (run_one(*c, args.out, **kw) for c in combos)
    else:
        import multiprocessing

        pool = concurrent.futures.ProcessPoolExecutor(
            max_workers=args.jobs, mp_context=multiprocessing.get_context("spawn"))
        futures = [pool.submit(run_one, *c, args.out, **kw) for c in combos]
        records = (f.result() for f in concurrent.futures.as_completed(futures))
    for rec in records:
        failures += rec["status"] == "error"
        print(_report(rec), flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
