"""Shared by the ``test_torch_examples_*.py`` files: load an example script
of ``examples/`` (the JAX package's) or ``examples_torch/`` (the port's)
by path, run a script's ``main`` and keep what it printed, and give the
port's ``ModelApi.init`` the reference's weights.

Both folders hold a ``_common.py`` that puts ``src`` on ``sys.path``;
whichever loads first serves both, since both do the same.
"""
import contextlib
import dataclasses
import functools
import importlib.util
import io
import pathlib
import sys

import numpy as np
import pytest
import torch

import jax
import repro.models.registry as ref_registry
import repro_torch.models.registry as port_registry
from repro.configs import get_api as ref_get_api
from repro_torch.bridge import state_dict_from_tree
from repro_torch.configs import get_api as port_get_api

ROOT = pathlib.Path(__file__).resolve().parents[1]


def load(folder, name):
    """The module ``<folder>/<name>.py``, imported under its own name."""
    path = ROOT / folder / f"{name}.py"
    if str(path.parent) not in sys.path:
        sys.path.insert(0, str(path.parent))  # for the scripts' ``import _common``
    mod_name = f"{folder}__{name}"
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def printed(fn, *args, argv=None, **kw):
    """``(fn(*args, **kw), its standard output)``; with ``argv``, ``sys.argv``
    is ``[script] + argv`` during the call (the reference's ``main``s parse
    it)."""
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        if argv is not None:
            mp.setattr(sys, "argv", ["script"] + list(argv))
        with contextlib.redirect_stdout(out):
            result = fn(*args, **kw)
    return result, out.getvalue()


@functools.lru_cache(maxsize=None)
def prng_tree(arch, seed=0):
    """The reference's reduced ``arch`` weights from ``PRNGKey(seed)``, as
    numpy (drawn once per process; callers only read them)."""
    tree = ref_get_api(arch, reduced=True).init(jax.random.PRNGKey(seed))
    return jax.tree_util.tree_map(np.asarray, tree)


@contextlib.contextmanager
def bridged_port_init(tree_for=prng_tree):
    """Within the block, the port's ``ModelApi.init(seed)`` loads
    ``tree_for(arch_id, seed)`` (the reference's weights), bridged."""
    init = port_registry.ModelApi.init

    def bridged(self, seed=0, *, device=None):
        model = init(self, seed, device=device)
        model.load_state_dict(state_dict_from_tree(tree_for(self.arch_id, seed)))
        return model

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_registry.ModelApi, "init", bridged)
        yield


@contextlib.contextmanager
def reference_init(tree_for):
    """Within the block, the reference's ``ModelApi.init`` returns
    ``tree_for(arch_id, 0)`` (whatever key it is given)."""
    import jax.numpy as jnp

    def init(self, rng):
        return jax.tree_util.tree_map(jnp.asarray, tree_for(self.arch_id, 0))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_registry.ModelApi, "init", init)
        yield


@contextlib.contextmanager
def one_thread():
    """Torch on one thread: the suite's workers share the machine, and one
    thread keeps each CPU sum in one order."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def float32_api(arch, torch_side):
    """The reduced ``arch`` of the port (``torch_side``) or the reference,
    in float32: reduced llama3-8b, deepseek-v2-236b, rwkv6-7b and
    hymba-1.5b are bf16 in both packages, and two bf16 implementations
    round their sums apart, so greedy tokens part within a few steps."""
    import jax.numpy as jnp

    if torch_side:
        api, dtype, registry = port_get_api(arch, reduced=True), torch.float32, port_registry
    else:
        api, dtype, registry = ref_get_api(arch, reduced=True), jnp.float32, ref_registry
    cfg = dataclasses.replace(api.cfg, param_dtype=dtype, compute_dtype=dtype)
    return registry.build_api(arch, cfg)


@contextlib.contextmanager
def float32_configs(ref_module, port_module):
    """Within the block, the two scripts' ``get_api(arch, reduced=True)``
    builds :func:`float32_api`."""
    with pytest.MonkeyPatch.context() as mp:
        for mod, torch_side in ((ref_module, False), (port_module, True)):
            mp.setattr(mod, "get_api",
                       lambda arch, reduced=False, _t=torch_side: float32_api(arch, _t))
        yield
