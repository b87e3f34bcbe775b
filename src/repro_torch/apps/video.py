"""Video Processing application (Fig. 1): EF -> {DO, RI} -> ME.

A traffic-surveillance pipeline: extractFrames pulls one key frame per
second, detectObject runs a small conv detector over the frames,
rescaleImage halves the resolution, merger zips the detector output with
the rescaled frames. Synthetic BDD100K-like clips: duration < 10 s.

Tensors keep the reference's NHWC layout at the stage boundaries; the
detector converts to NCHW for ``conv2d`` and pads as XLA's ``"SAME"``
does. Its weights are the reference's (``jax.random.PRNGKey(7)``), carried
as data in ``detector_w7.npz`` (HWIO, float32).
"""
from __future__ import annotations

from pathlib import Path
from typing import Any, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.dag import video_app
from ..core.precision import ieee_float32
from ..core.vectorsim import resolve_device
from .base import AppSpec

_FPS = 8  # decoded frame rate of the synthetic clips
DETECTOR_WEIGHTS = Path(__file__).resolve().parent / "detector_w7.npz"


def _ef_stage(ins: List[Any]):
    """extractFrames: temporal smoothing (decode proxy) + 1 key frame/s."""
    vid = ins[0].to(torch.float32)              # [T, H, W, 3]
    smooth = (0.5 * vid + 0.25 * torch.roll(vid, 1, 0)
              + 0.25 * torch.roll(vid, -1, 0))
    frames = smooth[::_FPS]                      # [dur, H, W, 3]
    return frames.to(torch.uint8)


def load_detector_weights(device=None) -> Tuple[torch.Tensor, ...]:
    """The detector's three convolution weights as OIHW float32 tensors on
    ``device`` (the file holds them in the reference's HWIO layout)."""
    dev = resolve_device(device)
    with np.load(DETECTOR_WEIGHTS) as z:
        return tuple(torch.from_numpy(z[k]).permute(3, 2, 0, 1)
                     .contiguous().to(dev) for k in ("w1", "w2", "w3"))


def _same_pads(n: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's ``"SAME"`` padding of one spatial dim: (low, high)."""
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def _conv_same(x: torch.Tensor, w: torch.Tensor, stride: int):
    """NCHW ``x`` with OIHW ``w`` under XLA's ``"SAME"`` padding (for an
    even input and stride 2 that is (0, 1), not ``conv2d``'s (1, 1))."""
    top, bottom = _same_pads(x.shape[2], w.shape[2], stride)
    left, right = _same_pads(x.shape[3], w.shape[3], stride)
    x = F.pad(x, (left, right, top, bottom))
    return F.conv2d(x, w, stride=stride)


def _make_detector(device):
    w1, w2, w3 = load_detector_weights(device)

    def detect(ins: List[Any]):
        frames = ins[0].to(torch.float32) / 255.0  # [F, H, W, 3]
        x = frames.permute(0, 3, 1, 2)            # NCHW
        with ieee_float32():
            h = torch.relu(_conv_same(x, w1, 2))
            h = torch.relu(_conv_same(h, w2, 2))
            h = torch.relu(_conv_same(h, w3, 2))
        # box/score head: global pool -> 16 "detections" per frame
        pooled = h.mean(dim=(2, 3))              # [F, 16]
        boxes = torch.stack([pooled, pooled ** 2, torch.sqrt(torch.abs(pooled)),
                             torch.tanh(pooled)], dim=-1)  # [F, 16, 4]
        return boxes.to(torch.float32)
    return detect


def _ri_stage(ins: List[Any]):
    """rescaleImage: 2x average-pool downscale, zipped."""
    frames = ins[0].to(torch.float32)            # [F, H, W, 3]
    f, h, w, c = frames.shape
    small = frames.reshape(f, h // 2, 2, w // 2, 2, c).mean(dim=(2, 4))
    return small.to(torch.uint8)


def _me_stage(ins: List[Any]):
    """merger: bundle detections + rescaled frames into one archive."""
    boxes, frames = ins[0], ins[1]
    blob = torch.cat([boxes.reshape(-1),
                      frames.to(torch.float32).reshape(-1)])
    return blob[:: max(blob.shape[0] // 4096, 1)]  # archive manifest digest


def make_spec(scale: float = 1.0, replicas: int = 2,
              device=None) -> AppSpec:
    dev = resolve_device(device)
    res = max(int(96 * scale) // 4 * 4, 16)

    def make_job(rng: np.random.Generator) -> Tuple[Any, np.ndarray]:
        dur = int(rng.integers(3, 11))           # <10 s clips
        t = dur * _FPS
        vid = rng.integers(0, 256, (t, res, res, 3), dtype=np.uint8)
        filesize = float(vid.nbytes) * 0.12      # H.264-ish compression
        return torch.from_numpy(vid).to(dev), np.array([filesize, float(dur)])

    return AppSpec(
        dag=video_app(replicas=replicas),
        make_job=make_job,
        stage_fns=(_ef_stage, _make_detector(dev), _ri_stage, _me_stage),
        # EF@1024MB, DO@3008MB, RI@1024MB, ME@512MB Lambda configs vs
        # 0.5/1.0/0.2/0.2 private CPUs (Sec. V-A.2)
        public_speed=(1.3, 1.8, 2.2, 1.5),
        zip_factor=(0.7, 1.0, 0.8, 0.9),
        time_scale=20.0,
        device=dev,
    )
