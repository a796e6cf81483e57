"""The bf16 flash kernels read q/k/v (and, in the backward, dO) through TMA
tensor maps; the main paths must hand them tensors that TMA can read.

On the CPU the port's wrapper takes the plain version, so the layout rule
(``tma_layout_error``) is checked here on the q/k/v that reduced olmo-1b
(forward, fused prefill and the training forward) and 4-layer hymba-1.5b (a
windowed and a global layer) produce in bf16 at head dim 64, and on the dO
that autograd hands the training path's attention.  A layout change on a
main path then fails here before it raises (q, k, v) or copies (dO) on the
card.  Imports torch only.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_api  # noqa: E402
from repro_torch.kernels.flash_attention import attention_ref  # noqa: E402
from repro_torch.kernels.flash_attention.ops import tma_layout_error  # noqa: E402
from repro_torch.models import dense, hymba  # noqa: E402
from repro_torch.models.registry import build_api  # noqa: E402


def _bf16_api(arch, **overrides):
    api = get_api(arch, reduced=True)
    cfg = dataclasses.replace(api.cfg, head_dim=64, param_dtype=torch.bfloat16,
                              compute_dtype=torch.bfloat16, **overrides)
    return build_api(arch, cfg)


def _record(monkeypatch, module):
    """Replace ``module.flash_attention`` with the plain version, keeping
    every (q, k, v) it is handed."""
    seen = []

    def recording(q, k, v, **kw):
        seen.append((q, k, v))
        return attention_ref(q, k, v, **kw)

    monkeypatch.setattr(module, "flash_attention", recording)
    return seen


def _assert_readable(seen, n_calls):
    assert len(seen) == n_calls
    for q, k, v in seen:
        for x in (q, k, v):
            assert x.dtype == torch.bfloat16
            err = tma_layout_error(x.shape, x.stride(), x.dtype, x.data_ptr() % 16)
            assert err is None, f"{tuple(x.shape)} strides {x.stride()}: {err}"


def test_dense_forward_and_prefill_layouts_are_tma_readable(monkeypatch):
    api = _bf16_api("olmo-1b")
    model = api.init(0, device="cpu")
    seen = _record(monkeypatch, dense)
    tokens = torch.randint(0, api.cfg.vocab, (2, 40), generator=torch.Generator().manual_seed(0))
    model(tokens)
    api.prefill(model, api.init_cache(2, 64, device="cpu"), tokens)
    _assert_readable(seen, 2 * api.cfg.n_layers)


def test_dense_training_layouts_and_output_gradient_are_tma_readable(monkeypatch):
    """The training forward (remat on: each layer's forward runs again in
    the backward pass) and the dO of every layer's attention output,
    recorded by a tensor hook."""
    api = _bf16_api("olmo-1b", remat=True)
    model = api.init(0, device="cpu").requires_grad_(True)
    seen, grads = [], []

    def recording(q, k, v, **kw):
        seen.append((q, k, v))
        out = attention_ref(q, k, v, **kw)
        if out.requires_grad:
            out.register_hook(grads.append)
        return out

    monkeypatch.setattr(dense, "flash_attention", recording)
    tokens = torch.randint(0, api.cfg.vocab, (2, 40), generator=torch.Generator().manual_seed(0))
    model.train_forward(tokens).float().square().mean().backward()
    _assert_readable(seen, 2 * api.cfg.n_layers)
    assert len(grads) == api.cfg.n_layers
    for do, (q, _, _) in zip(grads, seen):
        assert do.dtype == torch.bfloat16 and do.shape == q.shape
        err = tma_layout_error(do.shape, do.stride(), do.dtype, do.data_ptr() % 16)
        assert err is None, f"dO strides {do.stride()}: {err}"


def test_hymba_forward_layouts_are_tma_readable(monkeypatch):
    api = _bf16_api("hymba-1.5b", n_layers=4)
    model = api.init(0, device="cpu")
    seen = _record(monkeypatch, hymba)
    tokens = torch.randint(0, api.cfg.vocab, (1, 40), generator=torch.Generator().manual_seed(0))
    model(tokens)
    _assert_readable(seen, api.cfg.n_layers)


@pytest.mark.parametrize("view, reason", [
    (lambda buf: buf[..., 1:], "base address"),                 # one element off the start
    (lambda buf: buf[..., :64], "stride"),                      # rows 65 elements apart
])
def test_misaligned_views_fail_the_rule(view, reason):
    buf = torch.zeros(1, 8, 4, 65, dtype=torch.bfloat16)
    x = view(buf)
    err = tma_layout_error(x.shape, x.stride(), x.dtype, x.data_ptr() % 16)
    assert err is not None and reason in err


def test_rule_ignores_the_stride_of_a_size_one_dim():
    x = torch.zeros(1, 8, 4, 64, dtype=torch.bfloat16)
    assert tma_layout_error((1, 8, 4, 64), (3, 256, 64, 1), x.dtype, 0) is None
    assert tma_layout_error((2, 8, 4, 64), (3, 256, 64, 1), x.dtype, 0) is not None
    assert tma_layout_error(x.shape, (2048, 256, 64, 2), x.dtype, 0) is not None


def test_entry_args_block_matches_the_c_struct():
    """ops.py packs the C entry's arguments into one block; its size is the
    one the source's static_assert holds ``EntryArgs`` to."""
    import re

    from repro_torch.kernels.flash_attention import ops

    match = re.search(r"static_assert\(sizeof\(EntryArgs\) == (\d+)", ops.SOURCE.read_text())
    assert match and ops._ENTRY_ARGS.size == int(match.group(1))


def test_backward_entry_args_block_matches_the_c_struct():
    """The same for the backward's ``BwdEntryArgs``."""
    import re

    from repro_torch.kernels.flash_attention import ops

    match = re.search(r"static_assert\(sizeof\(BwdEntryArgs\) == (\d+)", ops.SOURCE.read_text())
    assert match and ops._BWD_ARGS.size == int(match.group(1))
