"""Model zoo (PyTorch): the dense, rwkv6 and hybrid (hymba) families so far."""
from repro_torch.models.registry import ModelApi, build_api

__all__ = ["ModelApi", "build_api"]
