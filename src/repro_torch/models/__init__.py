"""Model zoo (PyTorch): the dense family so far."""
from repro_torch.models.registry import ModelApi, build_api

__all__ = ["ModelApi", "build_api"]
