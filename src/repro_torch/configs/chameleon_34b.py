"""chameleon-34b [vlm] — 48L d_model=8192 64H (GQA kv=8) d_ff=22016
vocab=65536, early-fusion, VQ image tokens [arXiv:2405.09818].

Early fusion means the backbone is a plain token transformer over a unified
text + VQ-image-code vocabulary; the VQ image tokenizer is the stub per the
assignment (tokens arrive pre-quantized).  QK-norm per the source paper.
"""
from repro_torch.models.dense import DenseConfig

ARCH_ID = "chameleon-34b"


def config() -> DenseConfig:
    return DenseConfig(
        name=ARCH_ID,
        n_layers=48,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=22016,
        vocab=65536,
        head_dim=128,
        rope_theta=10000.0,
        act="swiglu",
        norm="rmsnorm",
        qk_norm=True,
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
        qk_norm=True,
        decode_window=64,
        remat=False,
    )
