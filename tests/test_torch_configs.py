"""The port's configs vs the JAX package's.

Every ported config's ``config()`` and ``reduced()`` equal the
reference's field by field (dtype fields by name: ``jnp.bfloat16`` is
``torch.bfloat16``; the reference's attention switches ``kv_chunk`` and
``use_kernel`` have no counterpart); ``ARCHS`` holds every one of the reference's ids in its
order (``UNPORTED`` is empty since whisper's encoder-decoder came); ``SHAPES`` and
``REDUCED_SHAPES`` are the reference's.  The config-only dense ports (internlm2-20b, minitron-4b,
chameleon-34b) run their reduced forwards and fused prefills in float32
variants against the reference, from the same weights (drawn with numpy
at the reference's init scales, ``tests/_torch_numpy_init.py``), at the
dense tolerance (logits within 1e-4).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.models.registry import build_api as jax_build_api  # noqa: E402
from _torch_numpy_init import numpy_params  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.bridge import state_dict_from_tree  # noqa: E402
from repro_torch.models.registry import build_api  # noqa: E402

pytestmark = pytest.mark.slow  # JAX-compiling; excluded from the fast lane

UNPORTED = ()
LOGIT_ATOL = 1e-4
DENSE_PORTS = ["internlm2-20b", "minitron-4b", "chameleon-34b"]


# The reference's switches for its own attention: the jnp attention's KV
# chunk and the Pallas-or-jnp choice.  The port's flash kernel tiles its
# own and a CUDA tensor always takes the kernel, so its configs lack them.
REFERENCE_ONLY = {"kv_chunk", "use_kernel"}


def _fields(cfg, names=None):
    out = {}
    for f in dataclasses.fields(cfg):
        if names is not None and f.name not in names:
            continue
        v = getattr(cfg, f.name)
        if f.name.endswith("dtype"):
            v = str(v).replace("torch.", "") if isinstance(v, torch.dtype) else jnp.dtype(v).name
        out[f.name] = v
    return out


def test_archs_are_the_reference_ids_but_the_unported():
    want = [a for a in jax_configs.ARCHS if a not in UNPORTED]
    assert list(configs.ARCHS) == configs.arch_ids() == want
    assert len(want) == len(jax_configs.ARCHS) - len(UNPORTED) == 10
    assert "deepseek-v2-236b" in configs.ARCHS and "whisper-large-v3" in configs.ARCHS


@pytest.mark.parametrize("arch", [a for a in jax_configs.ARCHS if a not in UNPORTED])
@pytest.mark.parametrize("reduced", [False, True], ids=["published", "reduced"])
def test_config_fields_equal_reference(arch, reduced):
    jmod, pmod = jax_configs.ARCHS[arch], configs.ARCHS[arch]
    jcfg = jmod.reduced() if reduced else jmod.config()
    pcfg = pmod.reduced() if reduced else pmod.config()
    assert type(pcfg).__name__ == type(jcfg).__name__
    names = {f.name for f in dataclasses.fields(pcfg)}
    assert {f.name for f in dataclasses.fields(jcfg)} - names <= REFERENCE_ONLY
    assert _fields(pcfg) == _fields(jcfg, names)
    assert pcfg.family == jcfg.family
    api, japi = configs.get_api(arch, reduced=reduced), jax_configs.get_api(arch, reduced=reduced)
    assert api.param_count() == japi.param_count()


def test_shapes_equal_reference():
    for mine, ref in ((configs.SHAPES, jax_configs.SHAPES),
                      (configs.REDUCED_SHAPES, jax_configs.REDUCED_SHAPES)):
        assert list(mine) == list(ref)
        for key in ref:
            assert dataclasses.asdict(mine[key]) == dataclasses.asdict(ref[key])
            assert mine[key].is_decode == ref[key].is_decode
    assert configs.InputShape("x", 1, 1, "decode").is_decode


@pytest.fixture
def _cpu_settings():
    """TF32 off, and one CPU thread: the small ops run faster on one
    thread than on threads contending with the suite's other workers."""
    torch.backends.cuda.matmul.allow_tf32 = False
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.usefixtures("_cpu_settings")
@pytest.mark.parametrize("arch", DENSE_PORTS)
def test_reduced_dense_forward_and_prefill_match_reference(arch):
    jax_api = jax_configs.get_api(arch, reduced=True)
    api = configs.get_api(arch, reduced=True)
    jax_api = jax_build_api(arch, dataclasses.replace(
        jax_api.cfg, param_dtype=jnp.float32, compute_dtype=jnp.float32))
    api = build_api(arch, dataclasses.replace(
        api.cfg, param_dtype=torch.float32, compute_dtype=torch.float32))
    tree = numpy_params(jax_api, seed=0)
    model = api.load(state_dict_from_tree(tree), device="cpu")
    toks = np.random.default_rng(3).integers(0, api.cfg.vocab, (2, 24), dtype=np.int32)
    # The reference's forward and prefill in one program (one compile).
    want, (jl, _) = jax.jit(lambda p, t: (
        jax_api.logits(p, {"tokens": t}), jax_api.prefill(p, jax_api.init_cache(2, 32), t)))(
            jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(toks))
    got = api.logits(model, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_ATOL, rtol=0)
    pl, pcache = api.prefill(model, api.init_cache(2, 32, device="cpu"), torch.from_numpy(toks))
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=LOGIT_ATOL, rtol=0)
    assert pcache["pos"] == 24
