"""mixtral-8x7b [moe] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336 (per
expert) vocab=32000, 8 experts top-2, sliding-window attention
[arXiv:2401.04088]."""
from repro_torch.models.moe import MixtralConfig

ARCH_ID = "mixtral-8x7b"


def config() -> MixtralConfig:
    return MixtralConfig(
        name=ARCH_ID,
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        vocab=32000,
        n_experts=8,
        top_k=2,
        head_dim=128,
        rope_theta=1000000.0,
        window=4096,
        decode_window=4096,
    )


def reduced() -> MixtralConfig:
    return MixtralConfig(
        name=ARCH_ID + "-reduced",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        d_ff=256,
        vocab=512,
        n_experts=4,
        top_k=2,
        head_dim=32,
        window=32,
        decode_window=32,
        capacity_factor=8.0,  # dropless at smoke scale: decode == forward
        remat=False,
    )
