"""starcoder2-15b [dense]: 40L d_model=6144 48H (GQA kv=4) d_ff=24576
vocab=49152, RoPE, plain-MLP GeLU. [arXiv:2402.19173]"""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-15b", family="dense",
        num_layers=40, d_model=6144, num_heads=48, num_kv_heads=4,
        d_ff=24576, vocab_size=49152, qkv_bias=True,
        norm="layernorm", act="gelu", glu=False,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=8, num_kv_heads=2,
        d_ff=128, vocab_size=256, qkv_bias=True,
        norm="layernorm", act="gelu", glu=False,
    )
