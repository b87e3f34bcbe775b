"""stablelm-12b [dense]: 40L d_model=5120 32H (GQA kv=8) d_ff=13824
vocab=100352. [hf:stabilityai/stablelm-2-12b]"""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="stablelm-12b", family="dense",
        num_layers=40, d_model=5120, num_heads=32, num_kv_heads=8,
        d_ff=13824, vocab_size=100352,
        norm="layernorm", act="silu", glu=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="stablelm-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=8, num_kv_heads=2,
        d_ff=128, vocab_size=256,
        norm="layernorm", act="silu", glu=True,
    )
