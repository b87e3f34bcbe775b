"""llama3-8b [dense]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256, rope theta 500k. [arXiv:2407.21783]"""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama3-8b", family="dense",
        num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
        d_ff=14336, vocab_size=128256, rope_theta=500000.0,
        norm="rmsnorm", act="silu", glu=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama3-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=8, num_kv_heads=2,
        d_ff=128, vocab_size=256, rope_theta=500000.0,
        norm="rmsnorm", act="silu", glu=True,
    )
