"""whisper-large-v3 [audio]: encoder-decoder, conv frontend STUB.

32L(+32 enc) d_model=1280 20H (kv=20) d_ff=5120 vocab=51866; the mel/conv
frontend is a stub — input_specs() provides 1500 precomputed frame
embeddings. Decoder self-attn uses RoPE here (adaptation; whisper uses
learned absolute embeddings — noted in DESIGN.md). [arXiv:2212.04356]
"""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-large-v3", family="audio",
        num_layers=32, d_model=1280, num_heads=20, num_kv_heads=20,
        d_ff=5120, vocab_size=51866,
        encoder_layers=32, encoder_seq=1500, encoder_heads=20,
        norm="layernorm", act="gelu", glu=False, qkv_bias=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-smoke", family="audio",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=256,
        encoder_layers=2, encoder_seq=24, encoder_heads=4,
        norm="layernorm", act="gelu", glu=False, qkv_bias=True,
    )
