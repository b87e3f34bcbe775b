"""Meta-tensor stand-ins for every model input (no allocation).

Port of the reference's ``launch/specs.py``: ``input_specs(model, shape)``
returns what each traced step consumes, as tensors on the ``meta`` device
with the reference's shapes and dtypes (int32 ``tokens``, ``labels``,
``token`` and ``pos``, float32 ``loss_mask``, bf16 ``patches`` and
``frames``); the port's steps take them as they are (``loss_fn``,
``prefill`` and ``decode_step`` cast their tokens with ``.long()``).
Modality frontends are stubs, so the vision and audio configs receive
precomputed patch or frame embeddings. The decode cache is
``Model.init_cache`` of a model built on ``meta``.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..configs.registry import ShapeSpec
from ..models.config import ModelConfig
from ..models.model import Model

META = torch.device("meta")


def _spec(shape, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def _mod_inputs(cfg: ModelConfig, b: int) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    if cfg.vision_patches:
        out["patches"] = _spec((b, cfg.vision_patches, cfg.d_model),
                               torch.bfloat16)
    if cfg.is_encdec:
        out["frames"] = _spec((b, cfg.encoder_seq, cfg.d_model),
                              torch.bfloat16)
    return out


def train_batch_specs(cfg: ModelConfig,
                      shape: ShapeSpec) -> Dict[str, torch.Tensor]:
    b, s = shape.global_batch, shape.seq_len
    return {
        "tokens": _spec((b, s), torch.int32),
        "labels": _spec((b, s), torch.int32),
        "loss_mask": _spec((b, s), torch.float32),
        **_mod_inputs(cfg, b),
    }


def prefill_specs(cfg: ModelConfig,
                  shape: ShapeSpec) -> Dict[str, torch.Tensor]:
    b, s = shape.global_batch, shape.seq_len
    return {"tokens": _spec((b, s), torch.int32), **_mod_inputs(cfg, b)}


def decode_specs(model: Model, shape: ShapeSpec) -> Dict[str, Any]:
    """One decode step: new token + position + the full KV/state cache
    (``model.init_cache`` of a model on ``meta``: no allocation)."""
    if model.device.type != "meta":
        raise ValueError(f"decode_specs needs a model on meta, got "
                         f"{model.device}")
    b, s = shape.global_batch, shape.seq_len
    return {
        "token": _spec((b,), torch.int32),
        "pos": _spec((), torch.int32),
        "cache": model.init_cache(b, s),
    }


def input_specs(model: Model, shape: ShapeSpec) -> Dict[str, Any]:
    if shape.kind == "train":
        return train_batch_specs(model.cfg, shape)
    if shape.kind == "prefill":
        return prefill_specs(model.cfg, shape)
    return decode_specs(model, shape)
