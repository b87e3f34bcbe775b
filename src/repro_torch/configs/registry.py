"""Architecture registry of the port, and the assigned input shapes.

``ARCHS`` lists the architectures the port can run: the recurrent and
hybrid ones (``rwkv6-1.6b``, ``recurrentgemma-9b``), the dense ones
(``llama3-8b``, ``stablelm-12b``, ``starcoder2-15b``, and ``qwen1.5-32b``
with its ``float8_e4m3fn`` KV cache) and the MoE ones (``olmoe-1b-7b``,
``arctic-480b`` with its dense residual FFN) and the encoder-decoder
``whisper-large-v3`` (its frontend a stub, as in the reference: prefill
takes precomputed frame embeddings) and the vision-language
``internvl2-76b`` (its vision frontend a stub too: patch embeddings go in
front of the tokens). ``NOT_PORTED`` maps any reference architecture the
port lacks to the ROADMAP item that brings it; it is empty.

Shapes (per the assignment):
  train_4k     seq 4,096   global_batch 256   (training)
  prefill_32k  seq 32,768  global_batch 32    (inference-prefill)
  decode_32k   seq 32,768  global_batch 128   (one token, KV cache=seq)
  long_500k    seq 524,288 global_batch 1     (long-context decode;
               sub-quadratic archs only)
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from ..models.config import ModelConfig
from . import (arctic_480b, internvl2_76b, llama3_8b, olmoe_1b_7b,
               qwen1_5_32b, recurrentgemma_9b, rwkv6_1_6b, stablelm_12b,
               starcoder2_15b, whisper_large_v3)

_MODULES = {
    "llama3-8b": llama3_8b,
    "recurrentgemma-9b": recurrentgemma_9b,
    "rwkv6-1.6b": rwkv6_1_6b,
    "stablelm-12b": stablelm_12b,
    "starcoder2-15b": starcoder2_15b,
    "qwen1.5-32b": qwen1_5_32b,
    "olmoe-1b-7b": olmoe_1b_7b,
    "arctic-480b": arctic_480b,
    "whisper-large-v3": whisper_large_v3,
    "internvl2-76b": internvl2_76b,
}

#: the reference's other architectures -> the ROADMAP item that ports them
NOT_PORTED: Dict[str, str] = {}

ARCHS = tuple(_MODULES)


def _module(arch: str):
    if arch in _MODULES:
        return _MODULES[arch]
    if arch in NOT_PORTED:
        raise NotImplementedError(
            f"architecture {arch!r} is not ported to repro_torch yet; it "
            f"comes with {NOT_PORTED[arch]}")
    raise KeyError(f"unknown architecture {arch!r}; the port has {ARCHS}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).config()


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    def scaled(self, seq: int, batch: int) -> "ShapeSpec":
        return dataclasses.replace(self, seq_len=seq, global_batch=batch)


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def cell_applicable(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """long_500k needs sub-quadratic decode (SSM / hybrid-with-window)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("full-attention arch: 512k-token KV decode is "
                       "quadratic-cost/unbounded-cache; skipped per "
                       "assignment rules (DESIGN.md §4)")
    return True, ""
