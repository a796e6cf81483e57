"""The port's MoE layer (``moe_apply``) vs the JAX package's, float32 on the CPU.

The same seeded numpy weights and inputs go to the reference's
``repro.models.moe.moe_apply`` and to the port's.  The reference runs op
by op on the capacity path (``jax.disable_jit``, as the model files run its
forwards), so that its ``drop_frac`` rounds as the port's does (a compiled
``1 - mean(keep)`` is one multiply-add, and ``jnp.mean`` compiled on its
own multiplies by 1/n), and compiled on the decode path, whose drop fraction is the constant 0.  Inputs avoid top-k ties: the router's logits come from continuous
random draws, and every case asserts a gap of at least 1e-5 between the
k-th and the (k+1)-th routing probability of every token (the two
packages' float32 probabilities differ by ~1e-8), so both pick the same
experts.

* The capacity path at ``capacity_factor`` 1.25 with a router skewed
  toward expert 0, so that routings are dropped: the keep mask and the
  destinations ``==`` the reference's dispatch (its lines
  ``moe.py:141-147``, restated below as the oracle), outputs within 1e-5 x
  max(1, max |ref|), ``lb_loss`` and ``z_loss`` within 1e-6 relative,
  ``drop_frac`` ``==``.
* The decode path (t * k <= ``DECODE_GATHER_MAX``), which the port runs
  grouped by expert: the same tolerances.
* The shared expert (``n_shared_experts``) on both paths.
* ``capacity`` ``==`` over a grid of token counts.
* The gradient of a scalar of the output and the aux losses with respect
  to x, the router and the expert weights against ``jax.grad``: every
  leaf within 1e-4 x max(1, max |g|).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import moe as jax_moe  # noqa: E402
from repro_torch.models import moe  # noqa: E402

pytestmark = pytest.mark.slow  # JAX-compiling; excluded from the fast lane

OUT_REL = 1e-5    # x max(1, max |ref|)
LOSS_RTOL = 1e-6
GRAD_REL = 1e-4   # x max(1, max |g|), per leaf
TIE_GAP = 1e-5  # the packages' float32 probabilities differ by ~1e-8
E, K, D, F = 4, 2, 48, 64

# name: (B, S, capacity_factor, n_shared_experts, router skew)
CASES = {
    "capacity-drops": (2, 24, 1.25, 0, 1.5),
    "capacity-dropless": (2, 24, 8.0, 0, 0.0),
    "capacity-shared": (2, 24, 1.25, 2, 2.5),
    "decode-16": (2, 4, 1.25, 0, 0.0),
    "decode-1": (1, 1, 1.25, 0, 0.0),
    "decode-shared": (4, 1, 1.25, 1, 0.0),
}


def _cfgs(cf, shared):
    kw = dict(n_experts=E, top_k=K, d_model=D, d_ff=F, capacity_factor=cf,
              n_shared_experts=shared)
    return jax_moe.MoEConfig(**kw), moe.MoEConfig(**kw)


def _case(name):
    """Seeded numpy weights (reference layout) and input for one case."""
    b, s, cf, shared, skew = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    jcfg, cfg = _cfgs(cf, shared)
    lp = {
        "router": rng.normal(0, 0.3, (D, E)).astype(np.float32),
        "w_gate": rng.normal(0, D ** -0.5, (E, D, F)).astype(np.float32),
        "w_up": rng.normal(0, D ** -0.5, (E, D, F)).astype(np.float32),
        "w_down": rng.normal(0, F ** -0.5, (E, F, D)).astype(np.float32),
    }
    x = rng.normal(0, 1, (b, s, D)).astype(np.float32)
    # Skew: the input's mean direction routes to expert 0, which then
    # takes more than its capacity.
    lp["router"][:, 0] += skew * np.sign(x.reshape(-1, D).mean(0)) / np.sqrt(D)
    if shared:
        fs = F * shared
        lp["shared"] = {
            "w_gate": rng.normal(0, D ** -0.5, (D, fs)).astype(np.float32),
            "w_up": rng.normal(0, D ** -0.5, (D, fs)).astype(np.float32),
            "w_down": rng.normal(0, fs ** -0.5, (fs, D)).astype(np.float32),
        }
    return jcfg, cfg, lp, x


def _torch_tree(tree, grad=False):
    if isinstance(tree, dict):
        return {k: _torch_tree(v, grad) for k, v in tree.items()}
    return torch.tensor(tree, requires_grad=grad)


def _assert_no_ties(lp, x):
    probs = jax.nn.softmax(x.reshape(-1, D) @ lp["router"], axis=-1)
    top = np.sort(np.asarray(probs), axis=-1)[:, ::-1]
    assert (top[:, K - 1] - top[:, K]).min() > TIE_GAP, "inputs must avoid top-k ties"


def _reference_dispatch(lp, x, jcfg):
    """The reference's dispatch, ``moe.py:141-147``, on its own routing."""
    xf = jnp.asarray(x.reshape(-1, D))
    probs = jax.nn.softmax(xf @ jnp.asarray(lp["router"]), axis=-1)
    _, expert_idx = jax.lax.top_k(probs, jcfg.top_k)
    cap = jax_moe.capacity(jcfg, xf.shape[0])
    flat_e = expert_idx.reshape(-1)
    onehot = jax.nn.one_hot(flat_e, jcfg.n_experts, dtype=jnp.int32)
    pos_in_e = jnp.cumsum(onehot, axis=0) - onehot
    pos_in_e = jnp.take_along_axis(pos_in_e, flat_e[:, None], axis=1)[:, 0]
    keep = pos_in_e < cap
    dest = jnp.where(keep, flat_e * cap + pos_in_e, jcfg.n_experts * cap)
    return np.asarray(expert_idx), np.asarray(keep), np.asarray(dest), cap


def _scalar_jax(jcfg, cot):
    def f(lp, x):
        out, st = jax_moe.moe_apply(lp, x, jcfg)
        return jnp.sum(out * cot) + 0.01 * st["lb_loss"] + 1e-3 * st["z_loss"]
    return f


def _scalar_torch(cfg, cot):
    def f(lp, x):
        out, st = moe.moe_apply(lp, x, cfg)
        return torch.sum(out * cot) + 0.01 * st["lb_loss"] + 1e-3 * st["z_loss"]
    return f


GRAD_CASES = ["capacity-drops", "capacity-shared", "decode-16", "decode-shared"]


@pytest.fixture(scope="module")
def reference():
    """Every case's reference results, computed once: outputs and stats,
    the capacity cases' dispatch, and the gradients of the scalar for
    ``GRAD_CASES``."""
    out = {}
    for name in CASES:
        jcfg, _, lp, x = _case(name)
        jlp, jx = jax.tree_util.tree_map(jnp.asarray, lp), jnp.asarray(x)
        cot = np.random.default_rng(7).normal(0, 1, x.shape).astype(np.float32)
        grad = jax.grad(_scalar_jax(jcfg, jnp.asarray(cot)), argnums=(0, 1))
        capacity_path = name.startswith("capacity")
        with_grad = name in GRAD_CASES
        if capacity_path:
            with jax.disable_jit():
                y, st = jax_moe.moe_apply(jlp, jx, jcfg)
            g = jax.jit(grad)(jlp, jx) if with_grad else None
        else:  # one program: the forward and, where asked, the gradient
            (y, st), g = jax.jit(lambda p, v: (
                jax_moe.moe_apply(p, v, jcfg), grad(p, v) if with_grad else None))(jlp, jx)
        out[name] = {
            "y": np.asarray(y),
            "stats": {k: np.asarray(v) for k, v in st.items()},
            "dispatch": _reference_dispatch(lp, x, jcfg) if capacity_path else None,
            "cot": cot,
            "grads": None if g is None else (jax.tree_util.tree_map(np.asarray, g[0]),
                                             np.asarray(g[1])),
        }
    return out


@pytest.fixture(scope="module", autouse=True)
def _cpu_settings():
    """TF32 off, and one CPU thread for the module: the small ops run
    faster on one thread than on threads contending with the suite's
    other workers."""
    torch.backends.cuda.matmul.allow_tf32 = False
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("name", list(CASES))
def test_moe_apply_matches_reference(reference, name):
    jcfg, cfg, lp, x = _case(name)
    _assert_no_ties(lp, x)
    ref = reference[name]
    t = x.shape[0] * x.shape[1]
    assert (t * K <= moe.DECODE_GATHER_MAX) == name.startswith("decode")
    with torch.no_grad():
        y, st = moe.moe_apply(_torch_tree(lp), torch.from_numpy(x), cfg)
    tol = OUT_REL * max(1.0, float(np.abs(ref["y"]).max()))
    np.testing.assert_allclose(y.numpy(), ref["y"], atol=tol, rtol=0)
    for key in ("lb_loss", "z_loss"):
        np.testing.assert_allclose(float(st[key]), float(ref["stats"][key]), rtol=LOSS_RTOL,
                                   atol=0 if float(ref["stats"][key]) else 1e-30, err_msg=key)
    assert float(st["drop_frac"]) == float(ref["stats"]["drop_frac"])
    if name == "capacity-drops":
        assert float(st["drop_frac"]) > 0, "the case must drop routings"


@pytest.mark.parametrize("name", [n for n in CASES if n.startswith("capacity")])
def test_dispatch_keeps_and_drops_the_reference_routings(reference, name):
    """The port's ``dispatch`` on the port's routing: the same experts, the
    same keep mask and the same destination slots as the reference's."""
    _, cfg, lp, x = _case(name)
    expert_idx, keep, dest, cap = reference[name]["dispatch"]
    xf = torch.from_numpy(x.reshape(-1, D))
    probs = torch.softmax(xf @ torch.from_numpy(lp["router"]), dim=-1)
    _, idx = torch.topk(probs, K, dim=-1)
    assert np.array_equal(idx.numpy(), expert_idx)
    assert moe.capacity(cfg, xf.shape[0]) == cap
    pkeep, pdest = moe.dispatch(idx, E, cap)
    assert np.array_equal(pkeep.numpy(), keep)
    assert np.array_equal(pdest.numpy(), dest)
    assert (not keep.all()) == (name != "capacity-dropless")


def test_capacity_matches_reference():
    for cf in (1.0, 1.25, 2.0, 4.0, 8.0):
        jcfg, cfg = _cfgs(cf, 0)
        for top_k, n_experts in ((2, 8), (6, 160), (2, 4)):
            jc = jax_moe.MoEConfig(n_experts, top_k, D, F, capacity_factor=cf)
            pc = moe.MoEConfig(n_experts, top_k, D, F, capacity_factor=cf)
            for n in (1, 2, 7, 16, 33, 100, 128, 1000, 4096, 20480, 32768, 65536):
                assert moe.capacity(pc, n) == jax_moe.capacity(jc, n), (cf, top_k, n_experts, n)


@pytest.mark.parametrize("name", GRAD_CASES)
def test_gradient_matches_jax_grad(reference, name):
    """d/d(x, router, expert weights[, shared]) of sum(out * c) + 0.01 lb +
    1e-3 z against ``jax.grad`` of the reference's."""
    _, cfg, lp, x = _case(name)
    ref = reference[name]
    tlp = _torch_tree(lp, grad=True)
    tx = torch.tensor(x, requires_grad=True)
    scalar = _scalar_torch(cfg, torch.from_numpy(ref["cot"]))(tlp, tx)
    leaves = {"x": tx, **{k: v for k, v in tlp.items() if k != "shared"}}
    leaves.update({f"shared.{k}": v for k, v in tlp.get("shared", {}).items()})
    grads = dict(zip(leaves, torch.autograd.grad(scalar, list(leaves.values()))))
    glp, gx = ref["grads"]
    want = {"x": gx, **{k: v for k, v in glp.items() if k != "shared"}}
    want.update({f"shared.{k}": v for k, v in glp.get("shared", {}).items()})
    assert set(grads) == set(want)
    for leaf, w in want.items():
        tol = GRAD_REL * max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(grads[leaf].numpy(), w, atol=tol, rtol=0, err_msg=leaf)
