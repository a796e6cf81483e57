"""olmo-1b [dense] — 16L d_model=2048 16H (MHA kv=16) d_ff=8192 vocab=50304,
non-parametric LayerNorm [arXiv:2402.00838]."""
import torch

from repro_torch.models.dense import DenseConfig

ARCH_ID = "olmo-1b"


def config() -> DenseConfig:
    return DenseConfig(
        name=ARCH_ID,
        n_layers=16,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=8192,
        vocab=50304,
        head_dim=128,
        rope_theta=10000.0,
        act="swiglu",
        norm="nonparam_ln",
        decode_window=8192,
    )


def reduced() -> DenseConfig:
    return DenseConfig(
        name=ARCH_ID + "-reduced",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        d_ff=256,
        vocab=512,
        head_dim=32,
        norm="nonparam_ln",
        decode_window=64,
        remat=False,
        # float32, as in the reference: the reduced config is the
        # numerics-equivalence vehicle.
        param_dtype=torch.float32,
        compute_dtype=torch.float32,
    )
