"""Plain PyTorch versions of the port's kernels (the correctness ground
truth on any device).

Each function repeats its kernel's arithmetic op for op with ordinary
tensor operations. The wrappers in :mod:`.ops` call them for tensors on
the CPU; ``chip_smoke.py`` holds each CUDA kernel against them on the card.
They are no yardstick of speed.
"""
from __future__ import annotations

import torch


def acd_evict_plain(P: torch.Tensor, thresh: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """Greedy ACD evict set per queue row (plain version of ``acd_evict``).

    Left-to-right loop over the J columns of [B, J] rows, carrying the
    running *kept* demand sum per row: a masked job evicts iff the kept
    prefix ahead of it exceeds its threshold, else its demand joins the
    prefix. The sum's dtype follows ``P``. Equals the DES's iterated
    remove-first-violator-and-resweep fixpoint (removing the first
    violator never changes earlier prefix sums).
    """
    s = torch.zeros(P.shape[:-1], dtype=P.dtype, device=P.device)
    zero = torch.zeros((), dtype=P.dtype, device=P.device)
    out = torch.empty(mask.shape, dtype=torch.bool, device=mask.device)
    for i in range(P.shape[-1]):
        m = mask[..., i]
        ev = m & (s > thresh[..., i])
        out[..., i] = ev
        s = s + torch.where(m & ~ev, P[..., i], zero)
    return out
