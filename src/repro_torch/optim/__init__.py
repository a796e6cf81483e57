from repro_torch.optim.optimizers import (
    AdamWState,
    Optimizer,
    SGDState,
    adamw,
    clip_by_global_norm,
    constant_schedule,
    cosine_schedule,
    global_norm,
    sgd,
)

__all__ = [
    "Optimizer",
    "SGDState",
    "AdamWState",
    "adamw",
    "sgd",
    "cosine_schedule",
    "constant_schedule",
    "global_norm",
    "clip_by_global_norm",
]
