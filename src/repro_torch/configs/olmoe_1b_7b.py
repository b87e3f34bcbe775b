"""olmoe-1b-7b [moe]: 16L d_model=2048 16H (kv=16), 64 experts top-8,
expert d_ff=1024, vocab=50304. [arXiv:2409.02060]"""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="olmoe-1b-7b", family="moe",
        num_layers=16, d_model=2048, num_heads=16, num_kv_heads=16,
        d_ff=1024, vocab_size=50304,
        num_experts=64, top_k=8, capacity_factor=1.25,
        norm="rmsnorm", act="silu", glu=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="olmoe-smoke", family="moe",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=64, vocab_size=256,
        num_experts=8, top_k=4, capacity_factor=1.25,
        norm="rmsnorm", act="silu", glu=True,
    )
