"""Reference-layout parameter trees drawn with numpy.

``numpy_params(jax_api, seed)`` draws every leaf of a JAX-package model's
schema at the scales of the reference's ``common.init_from_schema``
(fan-in scaled normals, 0.02 embeddings, zeros, ones) from a seeded numpy
generator, as float32 arrays in the reference's tree.  The parity tests
bridge such a tree into both packages.  The reference's own ``init``
runs ``jax.random`` eagerly, which compiles one threefry program per leaf
shape: seconds per model, and several times that when six test workers
share the machine.
"""
import dataclasses
import math

import numpy as np

import jax
import jax.numpy as jnp
from repro.models.common import Param
from repro.models.registry import ModelApi


def _leaf(rng, p):
    if p.init == "zeros":
        return np.zeros(p.shape, np.float32)
    if p.init == "ones":
        return np.ones(p.shape, np.float32)
    if p.init == "embed":
        scale = p.scale if p.scale is not None else 0.02
    elif p.init == "normal":
        fan_in = int(np.prod(p.shape[:-1])) if len(p.shape) > 1 else p.shape[0]
        scale = p.scale if p.scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
    else:
        raise ValueError(f"unknown init {p.init!r}")
    return (rng.standard_normal(p.shape) * scale).astype(np.float32)


def numpy_params(jax_api, seed=0):
    """A float32 numpy tree in ``jax_api``'s schema, drawn from ``seed``."""
    rng = np.random.default_rng(seed)

    def draw(node):
        if isinstance(node, Param):
            return _leaf(rng, node)
        return {k: draw(v) for k, v in node.items()}

    return draw(jax_api.schema())


@dataclasses.dataclass
class NumpyInitApi(ModelApi):
    """The reference's ``ModelApi`` whose ``init`` returns ``numpy_params``
    of seed 0 as JAX arrays (whatever key it is given): the starting
    weights of a reference trainer built around it."""

    def init(self, rng):
        return jax.tree_util.tree_map(jnp.asarray, numpy_params(self, 0))

    @classmethod
    def of(cls, jax_api):
        return cls(**{f.name: getattr(jax_api, f.name) for f in dataclasses.fields(jax_api)})
