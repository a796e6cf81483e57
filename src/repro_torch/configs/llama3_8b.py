"""llama3-8b [dense] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256, rope theta 5e5, 128k vocab [arXiv:2407.21783]."""
from repro_torch.models.dense import DenseConfig

ARCH_ID = "llama3-8b"


def config() -> DenseConfig:
    return DenseConfig(
        name=ARCH_ID,
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        vocab=128256,
        head_dim=128,
        rope_theta=500000.0,
        act="swiglu",
        norm="rmsnorm",
        decode_window=8192,
    )


def reduced() -> DenseConfig:
    return DenseConfig(
        name=ARCH_ID + "-reduced",
        n_layers=2,
        d_model=256,
        n_heads=8,
        n_kv_heads=2,
        d_ff=512,
        vocab=512,
        head_dim=32,
        rope_theta=500000.0,
        decode_window=64,
        remat=False,
    )
