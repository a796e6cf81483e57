"""internlm2-20b [dense] — 48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92544 [arXiv:2403.17297]."""
from repro_torch.models.dense import DenseConfig

ARCH_ID = "internlm2-20b"


def config() -> DenseConfig:
    return DenseConfig(
        name=ARCH_ID,
        n_layers=48,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_ff=16384,
        vocab=92544,
        head_dim=128,
        rope_theta=1000000.0,
        act="swiglu",
        norm="rmsnorm",
        decode_window=8192,
    )


def reduced() -> DenseConfig:
    return DenseConfig(
        name=ARCH_ID + "-reduced",
        n_layers=2,
        d_model=192,
        n_heads=6,
        n_kv_heads=2,
        d_ff=384,
        vocab=512,
        head_dim=32,
        decode_window=64,
        remat=False,
    )
