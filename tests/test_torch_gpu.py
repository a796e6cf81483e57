"""The port's CUDA kernel on the card, against its plain version.

Every test here needs a CUDA card and skips without one; on the card run
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py``.
Imports torch only, so it runs where JAX is not installed.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import attention_ref, flash_attention  # noqa: E402

pytestmark = pytest.mark.gpu

# Tolerances: float32 differs from the plain version by sum order only;
# bfloat16 adds one rounding of the output (2^-8 relative).
ATOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}

CASES = [
    # b, s, t, h, kv, causal, window, kv_len
    (1, 128, 128, 16, 16, True, None, None),
    (2, 100, 100, 4, 4, True, None, None),     # ragged S, T
    (1, 300, 300, 8, 2, True, 64, None),       # GQA + window
    (2, 64, 192, 4, 4, False, None, None),     # non-causal, cross lengths
    (1, 128, 200, 4, 2, False, None, 150),     # kv_len mask
]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,t,h,kv,causal,window,kv_len", CASES)
def test_kernel_matches_plain_version(cuda_device, dtype, b, s, t, h, kv, causal, window, kv_len):
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((b, s, h, 128), dtype=np.float32))
    k = torch.from_numpy(rng.standard_normal((b, t, kv, 128), dtype=np.float32))
    v = torch.from_numpy(rng.standard_normal((b, t, kv, 128), dtype=np.float32))
    q, k, v = (x.to(cuda_device, dtype) for x in (q, k, v))
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, window=window, kv_len=kv_len)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = attention_ref(q, k, v, causal=causal, window=window, kv_len=kv_len)
    assert got.dtype == dtype and got.shape == q.shape
    assert (got.float() - want.float()).abs().max().item() <= ATOL[dtype]


def test_kernel_reads_strided_inputs(cuda_device):
    """q/k/v as views into a fused (B, S, 3, H, D) buffer: read in place."""
    qkv = torch.randn(1, 96, 3, 4, 128, device=cuda_device)
    q, k, v = qkv.unbind(dim=2)
    got = flash_attention(q, k, v)
    want = attention_ref(q, k, v)
    assert (got - want).abs().max().item() <= ATOL[torch.float32]


@pytest.mark.parametrize("d, dtype", [(64, torch.float32), (128, torch.float16)])
def test_kernel_rejects_what_it_does_not_take(cuda_device, d, dtype):
    q = torch.zeros(1, 8, 2, d, device=cuda_device, dtype=dtype)
    with pytest.raises(ValueError):
        flash_attention(q, q, q)
