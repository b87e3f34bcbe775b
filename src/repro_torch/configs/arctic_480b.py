"""arctic-480b [moe]: 35L d_model=7168 56H (GQA kv=8), 128 experts top-2
plus a dense residual FFN, expert d_ff=4864, vocab=32000.
[hf:Snowflake/snowflake-arctic-base]"""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="arctic-480b", family="moe",
        num_layers=35, d_model=7168, num_heads=56, num_kv_heads=8,
        d_ff=4864, vocab_size=32000,
        num_experts=128, top_k=2, capacity_factor=1.25, dense_residual=True,
        norm="rmsnorm", act="silu", glu=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="arctic-smoke", family="moe",
        num_layers=2, d_model=64, num_heads=8, num_kv_heads=2,
        d_ff=96, vocab_size=256,
        num_experts=8, top_k=2, capacity_factor=1.25, dense_residual=True,
        norm="rmsnorm", act="silu", glu=True,
    )
