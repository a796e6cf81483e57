"""The port's whisper encoder-decoder vs the JAX package's, from identical
weights.

Reduced whisper-large-v3 (2 encoder + 2 decoder layers, d_model 128, 4
heads of 32, ``enc_frames`` 64) in float32 variants on both sides (the
reduced config is bfloat16), weights drawn with numpy at the reference's
init scales in the reference's tree (``tests/_torch_numpy_init.py``)
crossing through :mod:`repro_torch.bridge`, TF32 off, one CPU thread.
The audio has 48 frames, not ``enc_frames``, so ``prime_cache`` must take
the encoder output's length.  The reference's values are computed once,
in module fixtures.  Tolerances:

* ``encode`` within 1e-5; ``ModelApi.logits`` within 1e-4;
* ``prime_cache``'s ``cross_k`` and ``cross_v`` within 1e-5;
* the stepped ``decode_step`` logits against the reference's stepped
  decode within 1e-4 at every step (the self cache within 1e-5), and the
  port's forward against its own stepped decode within 1e-4;
* ``ModelApi.loss`` with per-sample weights within 1e-5 relative, and its
  gradient against ``jax.grad`` of the reference's, every leaf within 1e-4
  x max(1, max |g|), with and without remat;
* one ``build_train_step`` SGD step at ``microbatches`` 1 and 2 against
  the reference's step: parameters within 1e-5;
* ``param_count`` and ``active_param_count`` ``==`` at the reduced and the
  published configs (schema only); the bridge's names, loaded strictly.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_api as jax_get_api  # noqa: E402
from repro.models import whisper as jax_whisper  # noqa: E402
from repro.models.registry import build_api as jax_build_api  # noqa: E402
from repro.optim import constant_schedule as jax_constant, sgd as jax_sgd  # noqa: E402
from repro.train.step import build_train_step as jax_build_train_step  # noqa: E402
from _torch_numpy_init import numpy_params  # noqa: E402
from repro_torch.bridge import state_dict_from_tree  # noqa: E402
from repro_torch.configs import get_api  # noqa: E402
from repro_torch.kernels.flash_attention import attention_ref  # noqa: E402
from repro_torch.models.registry import build_api  # noqa: E402
from repro_torch.optim import constant_schedule, sgd  # noqa: E402
from repro_torch.train.step import build_train_step  # noqa: E402

pytestmark = pytest.mark.slow  # JAX-compiling; excluded from the fast lane

ARCH = "whisper-large-v3"
ENC_ATOL = 1e-5
LOGIT_ATOL = 1e-4
CACHE_ATOL = 1e-5
LOSS_REL = 1e-5
GRAD_REL = 1e-4  # x max(1, max |g|), per leaf
STEP_ATOL = 1e-5
B, S_ENC, S = 2, 48, 12
LR = 0.5


def _f32_pair(**overrides):
    jax_api = jax_get_api(ARCH, reduced=True)
    port_api = get_api(ARCH, reduced=True)
    jcfg = dataclasses.replace(
        jax_api.cfg, param_dtype=jnp.float32, compute_dtype=jnp.float32, **overrides)
    pcfg = dataclasses.replace(
        port_api.cfg, param_dtype=torch.float32, compute_dtype=torch.float32, **overrides)
    return jax_build_api(ARCH, jcfg), build_api(ARCH, pcfg)


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


@pytest.fixture(scope="module")
def weights():
    tree = numpy_params(_f32_pair()[0], seed=0)
    return jax.tree_util.tree_map(jnp.asarray, tree), tree


def _models(weights, **overrides):
    params, tree = weights
    jax_api, api = _f32_pair(**overrides)
    return jax_api, params, api, api.load(state_dict_from_tree(tree), device="cpu")


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(1)
    return {"audio_embed": rng.standard_normal((B, S_ENC, 128)).astype(np.float32),
            "tokens": rng.integers(0, 512, (B, S)).astype(np.int32)}


@pytest.fixture(scope="module")
def reference(weights, inputs):
    """The reference's encoder output, logits, primed cache and stepped
    decode (logits at every step, the final self cache)."""
    jax_api, params, _, _ = _models(weights)
    cfg = jax_api.cfg
    audio, toks = jnp.asarray(inputs["audio_embed"]), jnp.asarray(inputs["tokens"])
    enc = jax.jit(functools.partial(jax_whisper.encode, cfg=cfg))(params, audio_embed=audio)
    logits = jax.jit(jax_api.logits)(params, {"audio_embed": audio, "tokens": toks})
    cache = jax_whisper.prime_cache(params, cfg, jax_api.init_cache(B, S), enc)
    primed = {k: np.asarray(cache[k]) for k in ("cross_k", "cross_v")}
    step = jax.jit(jax_api.decode_step)
    rows = []
    for p in range(S):
        lg, cache = step(params, cache, toks[:, p:p + 1], jnp.int32(p))
        rows.append(np.asarray(lg))
    return dict(enc=np.array(enc), logits=np.asarray(logits), primed=primed,
                stepped=rows, self_cache={k: np.asarray(cache[k]) for k in ("k", "v")},
                init_shapes={k: np.shape(v) for k, v in jax_api.init_cache(B, S).items()})


def test_encode_matches_reference(weights, inputs, reference):
    _, _, _, model = _models(weights)
    enc = model.encode(torch.from_numpy(inputs["audio_embed"]))
    assert enc.shape == (B, S_ENC, 128) and enc.dtype == torch.float32
    np.testing.assert_allclose(enc.numpy(), reference["enc"], atol=ENC_ATOL, rtol=0)


def test_logits_match_reference(weights, inputs, reference):
    _, _, api, model = _models(weights)
    assert api.is_encoder_decoder and not api.has_moe_stats
    logits = api.logits(model, inputs)
    assert logits.shape == (B, S, 512) and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), reference["logits"], atol=LOGIT_ATOL, rtol=0)
    direct = model(torch.from_numpy(inputs["audio_embed"]), torch.from_numpy(inputs["tokens"]))
    assert torch.equal(direct, logits)


def test_prime_cache_takes_the_encoder_output_whole(weights, inputs, reference):
    """The cross K/V replace the cache's, at the encoder output's length
    (48 frames, not ``enc_frames`` 64), in the cache's dtype."""
    _, _, api, model = _models(weights)
    cache = api.init_cache(B, S, device="cpu")
    assert {k: tuple(v.shape) for k, v in cache.items() if k != "pos"} == {
        k: tuple(v) for k, v in reference["init_shapes"].items() if k != "pos"}
    assert cache["cross_k"].shape[2] == api.cfg.enc_frames == 64
    enc = torch.from_numpy(reference["enc"])
    primed = model.prime_cache(cache, enc)
    assert primed is cache and cache["pos"] == 0
    for key in ("cross_k", "cross_v"):
        assert cache[key].shape == (2, B, S_ENC, 4, 32) and cache[key].dtype == torch.float32
        np.testing.assert_allclose(cache[key].numpy(), reference["primed"][key],
                                   atol=CACHE_ATOL, rtol=0, err_msg=key)
    bf16 = model.prime_cache(api.init_cache(B, S, torch.bfloat16, device="cpu"), enc)
    assert bf16["cross_v"].dtype == torch.bfloat16


def _stepped(api, model, enc, tokens):
    cache = model.prime_cache(api.init_cache(B, S, device="cpu"), enc)
    rows = []
    for p in range(tokens.shape[1]):
        lg, cache = api.decode_step(model, cache, torch.from_numpy(tokens[:, p:p + 1]), p)
        rows.append(lg)
    return rows, cache


def test_stepped_decode_matches_reference(weights, inputs, reference):
    _, _, api, model = _models(weights)
    rows, cache = _stepped(api, model, torch.from_numpy(reference["enc"]), inputs["tokens"])
    for p, (got, want) in enumerate(zip(rows, reference["stepped"])):
        assert got.shape == (B, 1, 512)
        np.testing.assert_allclose(got.numpy(), want, atol=LOGIT_ATOL, rtol=0,
                                   err_msg=f"step {p}")
    assert cache["pos"] == S
    for key in ("k", "v"):
        np.testing.assert_allclose(cache[key].numpy(), reference["self_cache"][key],
                                   atol=CACHE_ATOL, rtol=0, err_msg=key)


def test_forward_matches_its_own_stepped_decode(weights, inputs):
    """The full forward (three flash-entry attentions) and the decode
    stepped over the primed cache compute one function; no fused
    prefill."""
    _, _, api, model = _models(weights)
    logits = api.logits(model, inputs)
    enc = model.encode(torch.from_numpy(inputs["audio_embed"]))
    rows, cache = _stepped(api, model, enc, inputs["tokens"])
    np.testing.assert_allclose(torch.cat(rows, dim=1).numpy(), logits.numpy(),
                               atol=LOGIT_ATOL, rtol=0)
    assert not api.supports_prefill()
    with pytest.raises(IndexError):
        api.decode_step(model, cache, torch.from_numpy(inputs["tokens"][:, :1]), S)


def _batch(inputs):
    rng = np.random.default_rng(5)
    return {**inputs, "labels": rng.integers(0, 512, (B, S)).astype(np.int32),
            "weights": np.asarray([1.0, 0.5], np.float32)}


@pytest.fixture(scope="module")
def loss_case(weights, inputs):
    """The reference's loss and gradient (computed once)."""
    jax_api, params, _, _ = _models(weights)
    batch = _batch(inputs)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jax_api.loss(p, jbatch), has_aux=True))(params)
    want = state_dict_from_tree(jax.tree_util.tree_map(np.asarray, jgrads))
    return batch, float(jloss), {k: float(v) for k, v in jaux.items()}, want


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_loss_and_gradient_match_reference(weights, loss_case, remat):
    batch, jloss, jaux, want = loss_case
    _, _, api, model = _models(weights, remat=remat)
    model.requires_grad_(True)
    loss, aux = api.loss(model, batch)
    assert set(aux) == set(jaux) == {"ce_loss"}
    np.testing.assert_allclose(float(loss.detach()), jloss, rtol=LOSS_REL)
    names = [n for n, _ in model.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(loss, list(model.parameters()))))
    assert set(names) == set(want)
    for name in names:
        w = want[name].numpy()
        tol = GRAD_REL * max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(grads[name].numpy(), w, atol=tol, rtol=0, err_msg=name)


def test_attend_seams_take_the_plain_attention(weights, loss_case):
    """``train_forward``'s three seams replace the flash calls: the
    encoder's (S_enc x S_enc), the decoder's (S x S) and the cross (S x
    S_enc) attention; plain attentions through them give the same logits."""
    batch = loss_case[0]
    _, _, api, model = _models(weights)
    shapes = {"enc": [], "self": [], "cross": []}

    def plain(name, causal):
        def attend(q, k, v):
            shapes[name].append((q.shape[1], k.shape[1], v.shape[-1]))
            return attention_ref(q, k, v, causal=causal)
        return attend

    with torch.no_grad():
        default = model.train_forward(batch["audio_embed"], batch["tokens"])
        seam = model.train_forward(batch["audio_embed"], batch["tokens"],
                                   enc_attend=plain("enc", False),
                                   self_attend=plain("self", True),
                                   cross_attend=plain("cross", False))
    assert shapes == {"enc": [(S_ENC, S_ENC, 32)] * 2, "self": [(S, S, 32)] * 2,
                      "cross": [(S, S_ENC, 32)] * 2}
    assert torch.equal(default, seam)


@pytest.fixture(scope="module")
def step_case(weights, inputs):
    """The reference's SGD step (no momentum, no clipping) at microbatches
    1 and 2 (computed once)."""
    jax_api, params, _, _ = _models(weights)
    batch = _batch(inputs)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    opt = jax_sgd(jax_constant(LR), momentum=0.0, max_grad_norm=None)
    out = {}
    for mb in (1, 2):
        step = jax.jit(jax_build_train_step(jax_api, opt, microbatches=mb))
        p, _, m = step(params, opt.init(params), jbatch)
        out[mb] = (state_dict_from_tree(jax.tree_util.tree_map(np.asarray, p)),
                   {k: float(v) for k, v in m.items()})
    return batch, out


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference(weights, step_case, microbatches):
    """``build_train_step`` splits ``audio_embed`` into microbatches with
    the tokens, as the reference's step does."""
    batch, out = step_case
    _, _, api, model = _models(weights)
    model.requires_grad_(True)
    opt = sgd(constant_schedule(LR), momentum=0.0, max_grad_norm=None)
    step = build_train_step(api, opt, microbatches=microbatches)
    params, _, metrics = step(model, opt.init(dict(model.named_parameters())),
                              {k: torch.from_numpy(v) for k, v in batch.items()})
    want_params, want = out[microbatches]
    assert sorted(metrics) == sorted(want)
    assert float(metrics["loss"]) == pytest.approx(want["loss"], rel=LOSS_REL)
    for name, p in params.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want_params[name].numpy(),
                                   atol=STEP_ATOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "published"])
def test_param_counts_match_reference(reduced):
    jax_api, api = jax_get_api(ARCH, reduced=reduced), get_api(ARCH, reduced=reduced)
    assert api.param_count() == jax_api.param_count()
    assert api.active_param_count() == jax_api.active_param_count() == api.param_count()
    if not reduced:
        assert 1.53e9 < api.param_count() < 1.54e9


def test_bridge_round_trip_is_strict(weights):
    _, tree = weights
    _, _, _, model = _models(weights)
    sd = state_dict_from_tree(tree)
    assert set(model.state_dict()) == set(sd)
    assert all(torch.equal(model.state_dict()[k], v) for k, v in sd.items())
    assert model.enc_layers[1].attn["wq"].shape == (128, 4, 32)
    assert model.dec_layers[0].cross_attn["wo"].shape == (4, 32, 128)
    assert model.dec_layers[1].cross_norm_b.shape == (128,)
    assert len(model.enc_layers) == len(model.dec_layers) == 2
    assert {k.split(".")[0] for k in sd} == {
        "embed", "enc_layers", "dec_layers", "enc_norm_w", "enc_norm_b", "dec_norm_w",
        "dec_norm_b"}
    with pytest.raises(RuntimeError):
        model.load_state_dict({k: v for k, v in sd.items() if k != "dec_layers.1.mlp.w_in"})
