"""Image Processing application (I/O heavy): Rotate -> Resize -> Compress.

Rotate: bilinear rotation onto the enlarged bounding canvas (output size
similar but non-identical to the input). Resize: bilinear to 200x200 —
uniform pixel count but *content-dependent encoded bytes* downstream.
Compress: 8x8 block-DCT quantization; output bytes = packed nonzero
coefficients (jpeg-like), so the output-size prediction models genuinely
matter for this app (Sec. V-A).

Resize repeats ``jax.image.resize(..., "bilinear")`` with its default
antialiasing: the triangle-kernel weight matrices are built in numpy in
float32 exactly as JAX builds them, then applied on the device with two
products. Resize's products and Compress's DCT run in IEEE float32
(TF32 off on the card), as the reference's.
"""
from __future__ import annotations

import math
from typing import Any, List, Tuple

import numpy as np
import torch

from ..core.dag import image_app
from ..core.precision import ieee_float32
from ..core.vectorsim import resolve_device
from .base import AppSpec

_ANGLE = math.radians(15.0)
_TARGET = 200  # paper: resize to 200x200
_F32 = np.float32


def _rotate_stage(ins: List[Any]):
    img = ins[0].to(torch.float32)              # [H, W, 3]
    dev = img.device
    h, w = img.shape[:2]
    c, s = math.cos(_ANGLE), math.sin(_ANGLE)
    H2 = int(abs(h * c) + abs(w * s)) + 1
    W2 = int(abs(w * c) + abs(h * s)) + 1
    yy, xx = torch.meshgrid(torch.arange(H2, dtype=torch.float32, device=dev),
                            torch.arange(W2, dtype=torch.float32, device=dev),
                            indexing="ij")
    cy, cx = (H2 - 1) / 2.0, (W2 - 1) / 2.0
    oy, ox = (h - 1) / 2.0, (w - 1) / 2.0
    ysrc = (yy - cy) * c + (xx - cx) * s + oy
    xsrc = -(yy - cy) * s + (xx - cx) * c + ox
    y0 = torch.clamp(torch.floor(ysrc).to(torch.int32), 0, h - 2)
    x0 = torch.clamp(torch.floor(xsrc).to(torch.int32), 0, w - 2)
    fy = torch.clamp(ysrc - y0, 0.0, 1.0)[..., None]
    fx = torch.clamp(xsrc - x0, 0.0, 1.0)[..., None]
    y0, x0 = y0.long(), x0.long()

    def g(dy, dx):
        return img[y0 + dy, x0 + dx]
    out = ((1 - fy) * (1 - fx) * g(0, 0) + (1 - fy) * fx * g(0, 1)
           + fy * (1 - fx) * g(1, 0) + fy * fx * g(1, 1))
    inside = ((ysrc >= 0) & (ysrc <= h - 1) & (xsrc >= 0) & (xsrc <= w - 1))
    return (out * inside[..., None]).to(torch.uint8)


def resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_in, n_out] float32 weights of an antialiased bilinear resize
    along one dim, computed as ``jax.image.resize`` computes them
    (``compute_weight_mat`` with the triangle kernel, scale n_out/n_in, no
    translation)."""
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = _F32(max(inv_scale, 1.0))
    sample_f = ((np.arange(n_out, dtype=_F32) + _F32(0.5)) * _F32(inv_scale)
                - _F32(0.0) - _F32(0.5))
    x = np.abs(sample_f[None, :] - np.arange(n_in, dtype=_F32)[:, None]
               ) / kernel_scale
    weights = np.maximum(_F32(0), _F32(1) - np.abs(x))
    total = weights.sum(axis=0, keepdims=True, dtype=_F32)
    weights = np.where(np.abs(total) > 1000.0 * float(np.finfo(_F32).eps),
                       weights / np.where(total != 0, total, _F32(1)),
                       _F32(0))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return np.where(inside[None, :], weights, _F32(0)).astype(_F32)


@ieee_float32()
def _resize_stage(ins: List[Any]):
    img = ins[0].to(torch.float32)               # [H, W, 3]
    h, w, c = img.shape
    wy = torch.from_numpy(resize_weights(h, _TARGET)).to(img.device)
    wx = torch.from_numpy(resize_weights(w, _TARGET)).to(img.device)
    # contract rows, then columns: [T, W*3] -> [T, 3, W] @ [W, T]
    t = (wy.T @ img.reshape(h, w * c)).reshape(_TARGET, w, c)
    out = (t.permute(0, 2, 1) @ wx).permute(0, 2, 1)
    return out.to(torch.uint8)


def _dct_matrix(n: int = 8) -> np.ndarray:
    k = np.arange(n)
    d = np.sqrt(2.0 / n) * np.cos(np.pi * (2 * k[None, :] + 1) * k[:, None] / (2 * n))
    d[0] /= np.sqrt(2.0)
    return d.astype(_F32)


_DCT = _dct_matrix()
# luminance-style quantization table scaled flat for simplicity
_QTAB = (np.full((8, 8), 24.0)
         + 4.0 * np.add.outer(np.arange(8), np.arange(8))).astype(_F32)


@ieee_float32()
def _compress_stage(ins: List[Any]):
    img = ins[0].to(torch.float32) - 128.0       # [200, 200, 3]
    dev = img.device
    hb, wb = img.shape[0] // 8, img.shape[1] // 8
    blocks = img[:hb * 8, :wb * 8].reshape(hb, 8, wb, 8, 3).permute(0, 2, 4, 1, 3)
    dct = torch.from_numpy(_DCT).to(dev)
    coeffs = torch.einsum("ij,bwcjk,lk->bwcil", dct, blocks, dct)
    q = torch.round(coeffs / torch.from_numpy(_QTAB).to(dev))
    nnz = int(torch.count_nonzero(q))           # entropy-coded payload proxy
    return q.to(torch.int32), float(nnz * 2 + 1024)


def make_spec(scale: float = 1.0, replicas: int = 2,
              device=None) -> AppSpec:
    dev = resolve_device(device)
    lo = max(int(300 * scale), 32)
    hi = max(int(1200 * scale), lo + 32)

    bucket = max((hi - lo) // 8, 8)  # coarse dim buckets, as the reference

    def make_job(rng: np.random.Generator) -> Tuple[Any, np.ndarray]:
        h = int(rng.integers(lo, hi + 1)) // bucket * bucket
        w = int(rng.integers(lo, hi + 1)) // bucket * bucket
        # Image-of-Groups-like: smooth background + textured foreground
        base = rng.integers(0, 256, (h // 8 + 1, w // 8 + 1, 3))
        img = np.kron(base, np.ones((8, 8, 1)))[:h, :w]
        img = (img + rng.normal(0, 12, (h, w, 3))).clip(0, 255).astype(np.uint8)
        # features: encoded bytes, pixel count, perimeter (rotate canvas cost)
        return torch.from_numpy(img).to(dev), np.array(
            [float(img.nbytes) * 0.25, float(h * w), float(h + w)])

    return AppSpec(
        dag=image_app(replicas=replicas),
        make_job=make_job,
        stage_fns=(_rotate_stage, _resize_stage, _compress_stage),
        # 0.2 private CPUs vs 2048MB Lambda: public much faster, but
        # latencies are small so startup dominates (high-variance regime)
        public_speed=(2.5, 2.5, 2.5),
        public_startup_s=0.060,
        public_jitter=0.15,
        zip_factor=(0.9, 0.95, 1.0),
        time_scale=25.0,
        device=dev,
    )
