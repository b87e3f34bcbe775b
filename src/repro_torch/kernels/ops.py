"""Checked public wrappers over the port's kernels.

A wrapper takes the plain version (:mod:`.ref`) only for tensors on the
CPU. For CUDA tensors it launches the hand-written kernel or raises; it
never falls back. Each wrapper counts its kernel launches in a plain
integer attribute (``acd_evict.launches``), so a run can show that its
main path went through the kernel.
"""
from __future__ import annotations

import torch

from . import acd_sweep
from .ref import acd_evict_plain

_FLOATS = (torch.float64, torch.float32)


def _check_acd(P, thresh, mask) -> None:
    for name, x in (("P", P), ("thresh", thresh), ("mask", mask)):
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"acd_evict: {name} must be a torch.Tensor")
        if x.dim() != 2:
            raise ValueError(f"acd_evict: {name} must be 2-D [B, J], "
                             f"got shape {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"acd_evict: {name} must be contiguous")
    if not (P.shape == thresh.shape == mask.shape):
        raise ValueError(
            f"acd_evict: shapes differ: P {tuple(P.shape)}, thresh "
            f"{tuple(thresh.shape)}, mask {tuple(mask.shape)}")
    if not (P.device == thresh.device == mask.device):
        raise ValueError(
            f"acd_evict: devices differ: P {P.device}, thresh "
            f"{thresh.device}, mask {mask.device}")
    if P.dtype not in _FLOATS or thresh.dtype != P.dtype:
        raise TypeError(
            f"acd_evict: P and thresh must both be float64 or both "
            f"float32, got {P.dtype} and {thresh.dtype}")
    if mask.dtype != torch.bool:
        raise TypeError(f"acd_evict: mask must be bool, got {mask.dtype}")


def acd_evict(P: torch.Tensor, thresh: torch.Tensor,
              mask: torch.Tensor) -> torch.Tensor:
    """Greedy ACD evict mask per queue row: [B, J] ``P``, ``thresh``
    (float64 or float32, the same for both) and bool ``mask`` -> [B, J]
    bool. CPU tensors run :func:`.ref.acd_evict_plain`; CUDA tensors run
    the CUDA kernel (``csrc/acd_evict.cu``)."""
    _check_acd(P, thresh, mask)
    if P.device.type == "cpu":
        return acd_evict_plain(P, thresh, mask)
    if P.device.type != "cuda":
        raise ValueError(f"acd_evict: no kernel for device {P.device}")
    out = torch.empty(P.shape, dtype=torch.bool, device=P.device)
    acd_sweep.launch(P, thresh, mask, out)
    acd_evict.launches += 1
    return out


acd_evict.launches = 0


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    acd_evict.launches = 0


def launch_counts() -> dict:
    """Kernel name -> launches since the last reset."""
    return {"acd_evict": acd_evict.launches}
