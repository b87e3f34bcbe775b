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


def fifo_dispatch_plain(order: torch.Tensor, n_pub: torch.Tensor,
                        ready: torch.Tensor,
                        dur: torch.Tensor, selc: torch.Tensor,
                        occ: torch.Tensor, seg: torch.Tensor,
                        capped: torch.Tensor, wu: torch.Tensor,
                        sclk0: torch.Tensor, sidle0: torch.Tensor,
                        keep_alive: float, cold: bool = False):
    """Capped FIFO public-dispatch chain (plain version of ``fifo_dispatch``).

    Row ``b`` visits jobs ``order[b, :n_pub[b]]`` (the public jobs, in the
    DES's event order). Each job takes every provider's earliest-free slot
    of the [P, C] clock pool (first index on ties), waits ``max(0, clock -
    ready)`` on capped providers, is cold when the slot sat idle past
    ``keep_alive`` (or was never used: idle ``-inf``) under ``cold``,
    prices ``occ * (wait + cold * wu)`` into the provider argmin (first
    index on ties), starts at ``(ready + wait) + cold * wu`` and ends after
    ``dur``; a capped provider's chosen slot then advances its clock and
    idle stamp to the end. Jobs the chain does not visit keep zeros.

    ``order`` [B, J] int (the caller puts the public jobs first),
    ``n_pub`` [B] int,
    ``ready``/``dur``/``selc``/``occ`` [B, P, J] float, ``seg`` [B, P, J]
    int, ``capped`` [P] bool, ``wu`` [P] float, ``sclk0``/``sidle0``
    [B, P, C] float. Returns (prov, seg, wait, cold, start, end, extra),
    each [B, J]: int32, int32, float, bool, float, float, float. The rows
    advance together, one chain step at a time; a row past its ``n_pub``
    writes nothing.
    """
    B, P, J = ready.shape
    dev, f = ready.device, ready.dtype
    sclk, sidle = sclk0.clone(), sidle0.clone()
    prov_o = torch.zeros((B, J), dtype=torch.int32, device=dev)
    seg_o = torch.zeros((B, J), dtype=torch.int32, device=dev)
    wait_o = torch.zeros((B, J), dtype=f, device=dev)
    cold_o = torch.zeros((B, J), dtype=torch.bool, device=dev)
    start_o = torch.zeros((B, J), dtype=f, device=dev)
    end_o = torch.zeros((B, J), dtype=f, device=dev)
    extra_o = torch.zeros((B, J), dtype=f, device=dev)
    zero = torch.zeros((), dtype=f, device=dev)
    ka = torch.tensor(keep_alive, dtype=f, device=dev)
    rows = torch.arange(B, device=dev)
    n_pub = n_pub.to(torch.int64)
    n_max = int(n_pub.max()) if B else 0
    for i in range(n_max):
        act = i < n_pub                                        # [B]
        j = order[:, i].to(torch.int64)                        # [B]
        jp = j[:, None, None].expand(B, P, 1)

        def col(x):                                            # [B, P]
            return x.gather(2, jp)[:, :, 0]

        ready_p = col(ready)
        si = torch.argmin(sclk, dim=2)                         # [B, P]
        sc_sel = sclk.gather(2, si[:, :, None])[:, :, 0]
        wait_p = torch.where(capped, torch.maximum(zero, sc_sel - ready_p),
                             zero)
        if cold:
            idle_sel = sidle.gather(2, si[:, :, None])[:, :, 0]
            cold_p = capped & ((ready_p + wait_p - idle_sel > ka)
                               | torch.isneginf(idle_sel))
        else:
            cold_p = torch.zeros((B, P), dtype=torch.bool, device=dev)
        cw_p = cold_p.to(f) * wu
        pen = col(occ) * (wait_p + cw_p)
        prov = torch.argmin(col(selc) + pen, dim=1)            # [B]

        def at(x):                                             # [B]
            return x.gather(1, prov[:, None])[:, 0]

        start = at(ready_p) + at(wait_p) + at(cw_p)
        end = start + at(col(dur))
        b, jj = rows[act], j[act]
        prov_o[b, jj] = prov[act].to(torch.int32)
        seg_o[b, jj] = at(col(seg))[act].to(torch.int32)
        wait_o[b, jj] = at(wait_p)[act]
        cold_o[b, jj] = at(cold_p)[act]
        start_o[b, jj] = start[act]
        end_o[b, jj] = end[act]
        extra_o[b, jj] = at(pen)[act]
        upd = act & capped[prov]
        bu, pu = rows[upd], prov[upd]
        su = si[bu, pu]
        sclk[bu, pu, su] = end[upd]
        sidle[bu, pu, su] = end[upd]
    return prov_o, seg_o, wait_o, cold_o, start_o, end_o, extra_o


def matmul_plain(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x`` [M, K] @ ``y`` [K, N] with float32 accumulation, returned in
    ``x.dtype`` (plain version of ``matmul``)."""
    return (x.float() @ y.float()).to(x.dtype)
