"""Inference engine: batched prefill + greedy decode over a Model.

Port of the reference's ``serving/engine.py``: the executor for one
serving replica. Requests are left-padded with token 0 to a rectangular
batch, prefilled together and decoded greedily (``torch.argmax``, the
first maximum, as ``jnp.argmax``) for the longest request's token count.
Everything runs under ``torch.inference_mode()`` on the model's device;
the generated tokens stay there until the batch ends. Prefill and decode
are timed by the host clock, each ending in ``torch.cuda.synchronize()``
on the card.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List

import numpy as np
import torch

from ..models.model import Model


@dataclasses.dataclass
class Request:
    rid: int
    tokens: np.ndarray           # [prompt_len] int32
    max_new_tokens: int

    @property
    def prompt_len(self) -> int:
        return int(self.tokens.shape[0])


@dataclasses.dataclass
class Completion:
    rid: int
    tokens: np.ndarray
    prefill_s: float
    decode_s: float


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class InferenceEngine:
    """Greedy-decode engine with a fixed-size KV cache."""

    def __init__(self, model: Model, cache_len: int = 256):
        self.model = model
        self.cache_len = cache_len

    def generate_batch(self, requests: List[Request]) -> List[Completion]:
        """Pads requests to a rectangular batch; greedy decode."""
        if not requests:
            return []
        model, dev = self.model, self.model.device
        b = len(requests)
        plens = [r.prompt_len for r in requests]
        pmax = max(plens)
        toks = np.zeros((b, pmax), np.int32)
        for i, r in enumerate(requests):
            toks[i, pmax - r.prompt_len:] = r.tokens   # left-pad
        n_new = max(r.max_new_tokens for r in requests)
        with torch.inference_mode():
            t0 = time.perf_counter()
            logits, cache = model.prefill(torch.from_numpy(toks).to(dev),
                                          cache_len=self.cache_len)
            _sync(dev)
            prefill_s = time.perf_counter() - t0
            out = torch.zeros((b, n_new), dtype=torch.int32, device=dev)
            t0 = time.perf_counter()
            tok = torch.argmax(logits, -1).to(torch.int32)
            for i in range(n_new):
                out[:, i] = tok
                logits, cache = model.decode_step(cache, tok, pmax + i)
                tok = torch.argmax(logits, -1).to(torch.int32)
            _sync(dev)
            decode_s = time.perf_counter() - t0
        out_np = out.cpu().numpy()
        return [Completion(r.rid, out_np[i, :r.max_new_tokens],
                           prefill_s, decode_s)
                for i, r in enumerate(requests)]
