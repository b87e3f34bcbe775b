"""Model configuration: one dataclass describes every architecture of the
repository (a copy of the reference's ``models/config.py``).

``block_pattern`` cycles over the layer stack (e.g. RecurrentGemma's
("rglru", "rglru", "attn")); uniform stacks use a single-element pattern.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None    # default d_model // num_heads

    # attention
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    window: Optional[int] = None      # sliding-window for local-attn blocks
    block_pattern: Tuple[str, ...] = ("attn",)   # attn | rglru | rwkv6

    # MoE
    num_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    dense_residual: bool = False      # Arctic: dense FFN in parallel w/ MoE

    # encoder-decoder (whisper)
    encoder_layers: int = 0
    encoder_seq: int = 0              # frontend-stub frames (1500 for whisper)
    encoder_heads: int = 0

    # VLM (internvl)
    vision_patches: int = 0           # frontend-stub patch embeddings

    # rwkv6
    rwkv_head_dim: int = 64

    # norms / activations / embeddings
    norm: str = "rmsnorm"             # rmsnorm | layernorm
    act: str = "silu"                 # silu | gelu
    glu: bool = True                  # gated FFN (SwiGLU-style)
    tied_embeddings: bool = False

    dtype: str = "bfloat16"
    # KV-cache storage dtype; float8_e4m3fn halves decode cache bytes for
    # archs whose bf16 cache exceeds HBM (qwen1.5-32b at decode_32k)
    kv_dtype: str = "bfloat16"

    # ---- derived ----
    @property
    def hd(self) -> int:
        return (self.head_dim if self.head_dim is not None
                else self.d_model // self.num_heads)

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    def layer_kind(self, i: int) -> str:
        return self.block_pattern[i % len(self.block_pattern)]

    @property
    def pattern_period(self) -> int:
        return len(self.block_pattern)

    @property
    def attn_layers(self) -> Tuple[int, ...]:
        return tuple(i for i in range(self.num_layers) if self.layer_kind(i) == "attn")

    @property
    def sub_quadratic(self) -> bool:
        """Can decode with O(1)-or-window state (long_500k eligibility)."""
        kinds = {self.layer_kind(i) for i in range(self.num_layers)}
        if kinds <= {"rglru", "rwkv6"}:
            return True
        return ("attn" in kinds and self.window is not None
                and kinds <= {"attn", "rglru", "rwkv6"})

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d, ff, V, L = self.d_model, self.d_ff, self.vocab_size, self.num_layers
        hd, H, Hkv = self.hd, self.num_heads, self.num_kv_heads
        n = V * d * (1 if self.tied_embeddings else 2)
        per_attn = d * hd * (H + 2 * Hkv) + H * hd * d
        ffn_mult = 3 if self.glu else 2
        per_dense_ffn = ffn_mult * d * ff
        total = n
        for i in range(L):
            kind = self.layer_kind(i)
            if kind == "attn":
                total += per_attn
            elif kind == "rglru":
                total += 2 * d * d + 4 * d          # in/out proj + gates
            elif kind == "rwkv6":
                total += 4 * d * d + 2 * d
            if self.num_experts:
                total += self.num_experts * ffn_mult * d * ff + d * self.num_experts
                if self.dense_residual:
                    total += per_dense_ffn
            else:
                total += per_dense_ffn
        if self.is_encdec:
            per_enc = per_attn + per_dense_ffn
            total += self.encoder_layers * per_enc
            total += L * per_attn                    # cross attention
        return int(total)

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k of num_experts)."""
        if not self.num_experts:
            return self.param_count()
        d, ff, L = self.d_model, self.d_ff, self.num_layers
        ffn_mult = 3 if self.glu else 2
        inactive = (self.num_experts - self.top_k) * ffn_mult * d * ff * L
        return int(self.param_count() - inactive)
