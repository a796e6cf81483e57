"""hymba-1.5b [hybrid] — 32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, ssm_state=16 — parallel attention + Mamba heads
[arXiv:2411.13676].

Sliding-window attention (1024) in every layer except the first, middle
and last; Mamba heads of d_inner 3200 beside it in every layer.  Meta
tokens are supported by the module and set to 0 here, as in the
reference.
"""
from repro_torch.models.hymba import HymbaConfig

ARCH_ID = "hymba-1.5b"


def config() -> HymbaConfig:
    return HymbaConfig(
        name=ARCH_ID,
        n_layers=32,
        d_model=1600,
        n_heads=25,
        n_kv_heads=5,
        d_ff=5504,
        vocab=32001,
        head_dim=64,
        ssm_state=16,
        conv_kernel=4,
        window=1024,
        n_meta_tokens=0,
        ssm_chunk=128,  # the selective-scan kernel's time tile
    )


def reduced() -> HymbaConfig:
    return HymbaConfig(
        name=ARCH_ID + "-reduced",
        n_layers=2,
        d_model=128,
        n_heads=5,
        n_kv_heads=1,
        d_ff=256,
        vocab=512,
        head_dim=16,
        ssm_state=8,
        d_inner=128,
        conv_kernel=4,
        window=16,
        ssm_chunk=8,
        remat=False,
    )
