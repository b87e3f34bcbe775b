"""recurrentgemma-9b [hybrid]: RG-LRU + local attention, 1:2 pattern.

38L d_model=4096 16H (MQA kv=1) d_ff=12288 vocab=256000, window 2048.
[arXiv:2402.19427]
"""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b", family="hybrid",
        num_layers=38, d_model=4096, num_heads=16, num_kv_heads=1,
        d_ff=12288, vocab_size=256000, head_dim=256,
        window=2048, block_pattern=("rglru", "rglru", "attn"),
        norm="rmsnorm", act="gelu", glu=True, rope_theta=10000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-smoke", family="hybrid",
        num_layers=5, d_model=64, num_heads=4, num_kv_heads=1,
        d_ff=128, vocab_size=256, head_dim=16,
        window=16, block_pattern=("rglru", "rglru", "attn"),
        norm="rmsnorm", act="gelu", glu=True,
    )
