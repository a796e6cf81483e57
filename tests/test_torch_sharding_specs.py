"""The dry run's layouts against the reference's: for every architecture at
its published config, both production meshes and every input shape, the
port's parameter specs (by state_dict name, the stacked layer dim
dropped), cache specs, batch specs and shapes, and the fallback reports
equal the reference's.  Also ``constrain``'s contract and how a dim split
over two mesh axes is laid out.

Neither side needs devices: the reference's ``make_rules`` reads a mesh's
axis names and device-array shape, the port's its dim names and sizes.
"""
import types

import numpy as np
import pytest

pytest.importorskip("torch")
import torch  # noqa: E402

from repro.configs import SHAPES as REF_SHAPES  # noqa: E402
from repro.configs import arch_ids  # noqa: E402
from repro.configs import get_api as ref_get_api  # noqa: E402
from repro.launch.mesh import make_rules as ref_make_rules  # noqa: E402
from repro_torch.configs import SHAPES, get_api  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_rules  # noqa: E402
from repro_torch.sharding.context import (  # noqa: E402
    active_rules,
    constrain,
    placements,
    sharding_context,
)
from repro_torch.sharding.rules import MeshRules  # noqa: E402

torch.set_num_threads(1)

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


class _PortMesh:
    """What the port's ``make_rules`` reads of a ``DeviceMesh``."""

    def __init__(self, shape, names):
        self.mesh_dim_names, self._shape = names, shape

    def size(self, i=None):
        return self._shape[i] if i is not None else int(np.prod(self._shape))


def _rules(arch, shape_name, mesh_kind):
    shape, names = MESHES[mesh_kind]
    kind, batch = SHAPES[shape_name].kind, SHAPES[shape_name].global_batch
    ref_mesh = types.SimpleNamespace(axis_names=names, devices=np.empty(shape))
    return (ref_make_rules(ref_mesh, arch, kind=kind, global_batch=batch),
            make_rules(_PortMesh(shape, names), arch, kind=kind, global_batch=batch))


def _depths(schema):
    """Each layer stack's depth, from its leaves' leading dim."""
    def first(node):
        return node if hasattr(node, "shape") else first(next(iter(node.values())))

    return {k: first(v).shape[0] for k, v in schema.items()
            if k == "layers" or k.endswith("_layers")}


def _by_state_dict_name(tree, depths):
    """The reference's spec tree by the port's state_dict names: each
    stack's leaf once per layer, its leading (layer) entry dropped."""
    out = {}

    def flat(node, prefix):
        for key in sorted(node):
            sub = node[key]
            if isinstance(sub, dict):
                yield from flat(sub, f"{prefix}{key}.")
            else:
                yield f"{prefix}{key}", sub

    for key in sorted(tree):
        if key == "layers" or key.endswith("_layers"):
            for name, spec in flat(tree[key], ""):
                for i in range(depths[key]):
                    out[f"{key}.{i}.{name}"] = tuple(spec)[1:]
        elif isinstance(tree[key], dict):
            out.update((name, tuple(spec)) for name, spec in flat(tree[key], f"{key}."))
        else:
            out[key] = tuple(tree[key])
    return out


def _reference_plan(api, shape, rules):
    """The specs the reference's ``build_dryrun`` resolves, in its order."""
    kind = shape.kind
    if kind in ("train", "prefill"):
        batch = api.train_batch_specs(shape.global_batch, shape.seq_len)
        if kind == "prefill":
            batch.pop("labels", None)
            batch.pop("weights", None)
        params = api.specs(rules)
        return {"params": params, "batch": api.batch_sharding(rules, batch),
                "batch_shapes": {k: (tuple(v.shape), str(v.dtype)) for k, v in batch.items()}}
    params = api.specs(rules)
    cache = api.cache_specs(rules, shape.global_batch, shape.seq_len)
    tokens = rules.spec(("batch", None), (shape.global_batch, 1), path="tokens")
    return {"params": params, "cache": cache, "tokens": tokens}


@pytest.mark.parametrize("mesh_kind", sorted(MESHES))
@pytest.mark.parametrize("shape_name", sorted(REF_SHAPES))
@pytest.mark.parametrize("arch", arch_ids())
def test_specs_equal_reference(arch, shape_name, mesh_kind):
    ref_rules, rules = _rules(arch, shape_name, mesh_kind)
    ref_api, api = ref_get_api(arch), get_api(arch)
    shape = SHAPES[shape_name]
    ref = _reference_plan(ref_api, REF_SHAPES[shape_name], ref_rules)
    port = dryrun.plan_specs(api, shape, rules)
    assert port["params"] == _by_state_dict_name(ref["params"], _depths(api.schema()))
    if shape.kind == "decode":
        assert port["cache"] == {k: tuple(v) for k, v in ref["cache"].items()}
        assert port["tokens"] == tuple(ref["tokens"])
    else:
        assert port["batch"] == {k: tuple(v) for k, v in ref["batch"].items()}
        assert {k: (shp, str(dt).replace("torch.", ""))
                for k, (shp, dt) in port["batch_shapes"].items()} == ref["batch_shapes"]
    assert rules.fallback_report() == ref_rules.fallback_report()


def test_supports_long_context_equal_reference():
    assert {a: get_api(a).supports_long_context() for a in arch_ids()} == {
        a: ref_get_api(a).supports_long_context() for a in arch_ids()}


def test_cache_logical_axes_equal_reference():
    for a in arch_ids():
        assert get_api(a).cache_logical_axes() == ref_get_api(a).cache_logical_axes()


def test_train_batch_encoder_decoder_ratio():
    """The encoder-decoder's text is max(seq // 4, 8) tokens against seq
    frames, as in the reference."""
    specs = get_api("whisper-large-v3").train_batch_specs(4, 20)
    assert specs["audio_embed"][0] == (4, 20, 1280) and specs["tokens"][0] == (4, 8)


def test_constrain_noop_without_context():
    assert active_rules() is None
    x = torch.ones(4, 8)
    assert constrain(x, ("batch", None)) is x


def test_constrain_rank_mismatch_and_plain_tensor_under_context():
    rules = MeshRules(mesh_axes={"data": 16, "model": 16}, batch_axes=("data",))
    x = torch.ones(4, 8)
    with sharding_context(None, rules):
        assert active_rules() is rules
        with pytest.raises(ValueError):
            constrain(x, ("batch",))
        assert constrain(x, ("batch", None)) is x  # a plain tensor takes no layout
    assert active_rules() is None


def test_double_sharded_dim_is_major_to_minor():
    """A dim on ("pod", "data") of the (2, 16, 16) mesh: the rank at mesh
    coordinate (p, d, m) holds rows block p * 16 + d, as PartitionSpec's
    major-to-minor order has it."""
    from torch.distributed.tensor._utils import _compute_local_shape_and_global_offset

    mesh = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"),
                                 size=lambda i: (2, 16, 16)[i])
    pl = placements(mesh, (("pod", "data"), "model"))
    for coord in ((0, 0, 0), (1, 3, 5), (0, 15, 15), (1, 15, 2)):
        shape, offset = _compute_local_shape_and_global_offset(
            (256, 4096), (2, 16, 16), list(coord), pl)
        assert shape == (8, 256)
        assert offset == ((coord[0] * 16 + coord[1]) * 8, coord[2] * 256)
    assert dryrun.local_shape(mesh, (("pod", "data"), "model"), (256, 4096)) == (8, 256)
    with pytest.raises(ValueError):
        placements(mesh, (("data", "pod"),))


def test_one_rank_mesh_dims_replicate():
    """A mesh dim of one rank splits nothing, so a one-rank mesh lays every
    tensor out whole (the one-device check's trace takes the plain paths)."""
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"), size=lambda i: 1)
    assert all(p.is_replicate() for p in placements(mesh, ("data", "model")))


@pytest.mark.parametrize("arch", arch_ids())
def test_init_from_schema_matches_reference_shapes(arch):
    """``init_from_schema`` under ``FakeTensorMode`` gives every leaf of
    the reference's parameter tree its shape and dtype, with no storage."""
    import jax
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

    from repro_torch.models.common import init_from_schema

    api, ref_api = get_api(arch), ref_get_api(arch)
    want = jax.eval_shape(lambda: ref_api.init(jax.random.PRNGKey(0)))
    with FakeTensorMode():
        got = init_from_schema(api.schema(), api.cfg.param_dtype)

    def flat(tree, prefix=""):
        for key in sorted(tree):
            if isinstance(tree[key], dict):
                yield from flat(tree[key], f"{prefix}{key}/")
            else:
                yield f"{prefix}{key}", tree[key]

    got, want = dict(flat(got)), dict(flat(want))
    assert sorted(got) == sorted(want)
    for name, x in got.items():
        assert isinstance(x, FakeTensor)
        assert tuple(x.shape) == tuple(want[name].shape)
        assert str(x.dtype).replace("torch.", "") == str(want[name].dtype)
