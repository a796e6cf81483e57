"""minitron-4b [dense] — 32L d_model=3072 24H (GQA kv=8) d_ff=9216
vocab=256000, squared-ReLU MLP (Nemotron lineage), pruned nemotron
[arXiv:2407.14679].

Note: 24 query heads are not divisible by the 16-way model axis — the
sharding rules replicate the head dim and keep TP on the (divisible) FFN and
vocab dims (DESIGN.md §5, recorded by MeshRules.fallbacks).
"""
from repro_torch.models.dense import DenseConfig

ARCH_ID = "minitron-4b"


def config() -> DenseConfig:
    return DenseConfig(
        name=ARCH_ID,
        n_layers=32,
        d_model=3072,
        n_heads=24,
        n_kv_heads=8,
        d_ff=9216,
        vocab=256000,
        head_dim=128,
        rope_theta=10000.0,
        act="relu2",
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
        act="relu2",
        decode_window=64,
        remat=False,
    )
