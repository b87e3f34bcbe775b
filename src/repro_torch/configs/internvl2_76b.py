"""internvl2-76b [vlm]: InternViT frontend STUB + LLM backbone.

80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256; the batch provides
256 precomputed patch embeddings per image. [arXiv:2404.16821]
"""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-76b", family="vlm",
        num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8,
        d_ff=28672, vocab_size=128256, vision_patches=256,
        rope_theta=500000.0, norm="rmsnorm", act="silu", glu=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-smoke", family="vlm",
        num_layers=2, d_model=64, num_heads=8, num_kv_heads=2,
        d_ff=128, vocab_size=256, vision_patches=8,
        norm="rmsnorm", act="silu", glu=True,
    )
