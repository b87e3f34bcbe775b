"""qwen1.5-32b [dense]: 64L d_model=5120 40H (kv=40) d_ff=27392
vocab=152064, QKV bias, float8_e4m3fn KV cache. [hf:Qwen/Qwen1.5-*]"""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-32b", family="dense",
        num_layers=64, d_model=5120, num_heads=40, num_kv_heads=40,
        d_ff=27392, vocab_size=152064, qkv_bias=True,
        norm="rmsnorm", act="silu", glu=True,
        # MHA (40 KV heads) makes a large cache: stored as fp8, as the
        # reference stores it (half the bf16 bytes)
        kv_dtype="float8_e4m3fn",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=160, vocab_size=256, qkv_bias=True,
        norm="rmsnorm", act="silu", glu=True,
    )
