"""Model zoo (PyTorch): the dense and rwkv6 families so far."""
from repro_torch.models.registry import ModelApi, build_api

__all__ = ["ModelApi", "build_api"]
