"""``make_kv_cache`` follows the port's device rule: the card unless the
caller asks for the CPU.  Imports torch only."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.models.common import make_kv_cache  # noqa: E402


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        cache = make_kv_cache(2, 1, 8, 2, 16)
        assert cache["k"].device.type == "cuda" and cache["v"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_kv_cache(2, 1, 8, 2, 16)


def test_cpu_when_asked():
    cache = make_kv_cache(2, 3, 8, 2, 16, dtype=torch.float32, device="cpu")
    assert cache["pos"] == 0
    for key in ("k", "v"):
        x = cache[key]
        assert x.device.type == "cpu" and x.dtype == torch.float32
        assert x.shape == (2, 3, 8, 2, 16) and not x.any()
