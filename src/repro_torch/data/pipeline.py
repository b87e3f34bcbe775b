"""Deterministic synthetic data pipeline (token LM + modality stubs).

Port of the reference's ``data/pipeline.py``, numpy only: the same draws
in the same order, so a batch is the reference's bit for bit (patches and
frames included). Seeded, stateless indexing (batch i is a pure function
of (seed, i)) so a restarted job resumes mid-epoch with no skew.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np

from ..models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    seed: int = 0
    # zipf-ish synthetic token distribution; loss curves behave sanely
    zipf_a: float = 1.2


class SyntheticLM:
    """Deterministic LM batches: tokens [B, S], labels, loss_mask (and a
    vision config's ``patches`` [B, P, d], an encoder-decoder's ``frames``
    [B, Se, d], float32 N(0, 0.02))."""

    def __init__(self, cfg: ModelConfig, dcfg: DataConfig):
        self.cfg = cfg
        self.dcfg = dcfg
        rng = np.random.default_rng(dcfg.seed)
        # fixed rank-correlated markov-ish table => learnable structure
        v = cfg.vocab_size
        self._freq = 1.0 / np.power(np.arange(1, v + 1), dcfg.zipf_a)
        self._freq /= self._freq.sum()
        self._shift = int(rng.integers(1, max(v - 1, 2)))

    def batch(self, index: int) -> Dict[str, np.ndarray]:
        d, c = self.dcfg, self.cfg
        rng = np.random.default_rng((d.seed, index))
        b, s = d.global_batch, d.seq_len
        base = rng.choice(c.vocab_size, size=(b, s), p=self._freq)
        # inject predictable structure: odd positions follow prev + shift
        nxt = (base + self._shift) % c.vocab_size
        toks = np.where(np.arange(s)[None, :] % 2 == 1,
                        np.roll(nxt, 1, axis=1), base).astype(np.int32)
        labels = np.concatenate([toks[:, 1:], toks[:, :1]], axis=1)
        mask = np.ones((b, s), np.float32)
        mask[:, -1] = 0.0
        out = {"tokens": toks, "labels": labels.astype(np.int32),
               "loss_mask": mask}
        if c.vision_patches:
            out["patches"] = rng.normal(
                0, 0.02, (b, c.vision_patches, c.d_model)).astype(np.float32)
        if c.is_encdec:
            out["frames"] = rng.normal(
                0, 0.02, (b, c.encoder_seq, c.d_model)).astype(np.float32)
        return out

    def iterate(self, start: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        i = start
        while True:
            yield self.batch(i)
            i += 1
