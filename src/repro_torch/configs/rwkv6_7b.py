"""rwkv6-7b [ssm] — Finch — 32L d_model=4096 (attention-free) d_ff=14336
vocab=65536, data-dependent decay [arXiv:2404.05892].

64 WKV heads of size 64; O(1) decode state (per-head 64x64 matrix + shift
registers).
"""
from repro_torch.models.rwkv6 import RWKV6Config

ARCH_ID = "rwkv6-7b"


def config() -> RWKV6Config:
    return RWKV6Config(
        name=ARCH_ID,
        n_layers=32,
        d_model=4096,
        d_ff=14336,
        vocab=65536,
        head_size=64,
        decay_lora=64,
        wkv_chunk=32,
    )


def reduced() -> RWKV6Config:
    return RWKV6Config(
        name=ARCH_ID + "-reduced",
        n_layers=2,
        d_model=128,
        d_ff=256,
        vocab=512,
        head_size=32,
        decay_lora=16,
        wkv_chunk=16,
        remat=False,
    )
