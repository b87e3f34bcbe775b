"""rwkv6-1.6b [ssm]: Finch — attention-free, data-dependent decay.

24L d_model=2048 d_ff=7168 vocab=65536, head_dim 64. [arXiv:2404.05892]
"""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-1.6b", family="ssm",
        num_layers=24, d_model=2048, num_heads=32, num_kv_heads=32,
        d_ff=7168, vocab_size=65536, rwkv_head_dim=64,
        block_pattern=("rwkv6",),
        norm="layernorm", act="gelu", glu=False,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-smoke", family="ssm",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=256, rwkv_head_dim=16,
        block_pattern=("rwkv6",),
        norm="layernorm", act="gelu", glu=False,
    )
