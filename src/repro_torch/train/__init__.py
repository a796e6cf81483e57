from repro_torch.train.checkpoint import restore, save
from repro_torch.train.hetero import EpochResult, HeteroTrainer
from repro_torch.train.step import build_prefill_step, build_serve_step, build_train_step

__all__ = [
    "build_train_step",
    "build_serve_step",
    "build_prefill_step",
    "HeteroTrainer",
    "EpochResult",
    "save",
    "restore",
]
