"""whisper-large-v3 [audio] — 32L (encoder + decoder) d_model=1280 20H (MHA)
d_ff=5120 vocab=51866 — enc-dec, conv frontend STUB [arXiv:2212.04356].

The batch supplies post-conv frame embeddings ``audio_embed`` (B, S_enc,
d_model); the decoder consumes text tokens.  Encoder self-attention and
cross-attention are non-causal (cross: S_text queries against S_enc
frames), decoder self-attention causal; all three run through the flash
kernel at head dim 64 (the reduced config's head dim 32 runs on the card in
float32 only).
"""
from repro_torch.models.whisper import WhisperConfig

ARCH_ID = "whisper-large-v3"


def config() -> WhisperConfig:
    return WhisperConfig(
        name=ARCH_ID,
        n_enc_layers=32,
        n_dec_layers=32,
        d_model=1280,
        n_heads=20,
        d_ff=5120,
        vocab=51866,
        head_dim=64,
        enc_frames=1500,
    )


def reduced() -> WhisperConfig:
    return WhisperConfig(
        name=ARCH_ID + "-reduced",
        n_enc_layers=2,
        n_dec_layers=2,
        d_model=128,
        n_heads=4,
        d_ff=256,
        vocab=512,
        head_dim=32,
        enc_frames=64,
        remat=False,
    )
