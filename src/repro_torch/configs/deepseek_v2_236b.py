"""deepseek-v2-236b [moe] — 60L d_model=5120 128H d_ff=1536 (per routed
expert) vocab=102400; MLA kv_lora=512; 2 shared + 160 routed experts, top-6
[arXiv:2405.04434].

Layer 0 is a dense SwiGLU FFN (hidden 12288) per the source paper; the
remaining 59 layers are MoE.  Decode uses the absorbed MLA form against the
576-value-per-token latent cache.
"""
from repro_torch.models.deepseek import DeepSeekConfig

ARCH_ID = "deepseek-v2-236b"


def config() -> DeepSeekConfig:
    return DeepSeekConfig(
        name=ARCH_ID,
        n_layers=60,
        d_model=5120,
        n_heads=128,
        d_ff_expert=1536,
        d_ff_dense=12288,
        vocab=102400,
        n_experts=160,
        top_k=6,
        n_shared_experts=2,
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_dim=128,
        qk_rope_dim=64,
        v_head_dim=128,
    )


def reduced() -> DeepSeekConfig:
    return DeepSeekConfig(
        name=ARCH_ID + "-reduced",
        n_layers=2,
        d_model=128,
        n_heads=4,
        d_ff_expert=64,
        d_ff_dense=256,
        vocab=512,
        n_experts=4,
        top_k=2,
        n_shared_experts=1,
        q_lora_rank=48,
        kv_lora_rank=32,
        qk_nope_dim=32,
        qk_rope_dim=16,
        v_head_dim=32,
        capacity_factor=8.0,  # dropless at smoke scale: decode == forward
        remat=False,
    )
