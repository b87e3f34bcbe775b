"""Plain PyTorch versions of the port's kernels (the correctness ground
truth on any device), and the recurrences of the model stack's blocks.

Each function repeats its kernel's arithmetic op for op with ordinary
tensor operations. The wrappers in :mod:`.ops` call them for tensors on
the CPU; ``chip_smoke.py`` holds each CUDA kernel against them on the card.
They are no yardstick of speed.
"""
from __future__ import annotations

from typing import Optional, Tuple

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


#: rows of each float32 product in :func:`matmul_plain`
PLAIN_ROWS = 64


def matmul_plain(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x`` [M, K] @ ``y`` [K, N] with float32 accumulation, returned in
    ``x.dtype`` (plain version of ``matmul``). Its rows do not depend on how
    many rows come with them, as the kernel's do not: y is widened once,
    and every row goes through a [PLAIN_ROWS, K] @ [K, N] product of the
    same shape (zero rows pad the last), where a single product of all M
    rows lets the library's choice of algorithm, which follows M, change
    each row's summation."""
    xf, yf = x.float(), y.float()
    M = xf.shape[0]
    if M == 0:
        return xf.new_zeros((0, yf.shape[1])).to(x.dtype)
    pad = -M % PLAIN_ROWS
    if pad:
        xf = torch.cat([xf, xf.new_zeros((pad, xf.shape[1]))])
    out = torch.cat([rows @ yf for rows in xf.split(PLAIN_ROWS)])
    return out[:M].to(x.dtype)


def rglru_plain(x: torch.Tensor, a: torch.Tensor,
                h0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RG-LRU linear recurrence (plain version of ``rglru``; the reference's
    ``ref.rglru_ref``):

        h_t = a_t * h_{t-1} + sqrt(max(1 - a_t^2, 0)) * x_t

    ``x``, ``a`` [B, T, D] (``a`` in (0, 1)), optional ``h0`` [B, D].
    Inputs go to float32; returns (y [B, T, D] in ``x.dtype``, h_T [B, D]
    float32). A loop over time of elementwise float32 operations, each
    rounded on its own (the kernel computes the same, built without
    fused multiply-adds)."""
    x32, a32 = x.float(), a.float()
    g = torch.sqrt(torch.clamp_min(1.0 - a32 * a32, 0.0)) * x32
    h = (torch.zeros_like(x32[:, 0]) if h0 is None
         else h0.float().clone())
    ys = torch.empty_like(x32)
    for t in range(x32.shape[1]):
        h = a32[:, t] * h + g[:, t]
        ys[:, t] = h
    return ys.to(x.dtype), h


def rwkv6_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                w: torch.Tensor, u: torch.Tensor,
                s0: Optional[torch.Tensor] = None, term_sums: bool = False
                ) -> Tuple[torch.Tensor, ...]:
    """RWKV-6 (Finch) WKV recurrence with data-dependent decay (plain
    version of ``rwkv6``; the reference's ``ref.rwkv6_ref``).

    ``r``, ``k``, ``w`` [B, H, T, Dk], ``v`` [B, H, T, Dv], ``u`` [H, Dk],
    optional ``s0`` [B, H, Dk, Dv]; per (b, h), with state S [Dk, Dv]:

        o_t = sum_k r_t[k] * (S[k, :] + u[k] * k_t[k] * v_t)
        S   = w_t[:, None] * S + k_t^T v_t            (w_t in (0, 1))

    Inputs go to float32; returns (o [B, H, T, Dv] in ``v.dtype``, S_T
    [B, H, Dk, Dv] float32). The state update is elementwise, so the
    kernel's S_T equals this one bit for bit; ``o`` sums over k in
    another order than the kernel's. With ``term_sums`` it also returns
    sum_k |r_t[k] (S[k, j] + u[k] k_t[k] v_t[j])| for every o_t[j]
    (float32): the scale of o's rounding. Two summation orders of Dk terms
    differ by at most 2 (Dk - 1) 2^-24 times it, the bound the kernel's
    checks hold o to."""
    r32, k32, v32, w32 = (t.float() for t in (r, k, v, w))
    b, h, t_len, dk = r32.shape
    dv = v32.shape[-1]
    S = (torch.zeros((b, h, dk, dv), dtype=torch.float32, device=r.device)
         if s0 is None else s0.float().clone())
    uu = u.float()[None, :, :, None]                      # [1, H, Dk, 1]
    o = torch.empty((b, h, t_len, dv), dtype=torch.float32, device=r.device)
    sums = torch.empty_like(o) if term_sums else None
    for t in range(t_len):
        kv = k32[:, :, t, :, None] * v32[:, :, t, None, :]  # [B, H, Dk, Dv]
        terms = (S + uu * kv) * r32[:, :, t, :, None]
        o[:, :, t] = terms.sum(-2)
        if term_sums:
            sums[:, :, t] = terms.abs().sum(-2)
        S = w32[:, :, t, :, None] * S + kv
    if term_sums:
        return o.to(v.dtype), S, sums
    return o.to(v.dtype), S


#: the TPU attention kernels' logit for a masked (query, key) pair
MASKED_LOGIT = -0.7 * torch.finfo(torch.float32).max


def _masked_softmax_product(s: torch.Tensor, mask: torch.Tensor,
                            v: torch.Tensor) -> torch.Tensor:
    """sum_k softmax(s)[..., k] v[k] over the live keys of ``mask`` (float32
    scores ``s`` [..., Sq, Sk], ``v`` [..., Sk, D] float32); a row with no
    live key gives zeros."""
    s = torch.where(mask, s, MASKED_LOGIT)
    m = s.amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    denom = p.sum(-1, keepdim=True)
    return (p @ v) / torch.where(denom == 0.0, 1.0, denom)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True,
                          window: Optional[int] = None) -> torch.Tensor:
    """Prefill attention (plain version of ``flash_attention``; the TPU
    kernel's function). ``q`` [B, Hq, Sq, D], ``k``/``v`` [B, Hkv, Sk, D];
    query head h reads KV head ``h // (Hq / Hkv)``. Query i sits at
    position ``Sk - Sq + i`` (right-aligned); key j is live iff ``j <=
    qpos`` under ``causal`` and ``j > qpos - window`` under a window.
    Scores ``(q . k) * D^-0.5`` in float32; masked logits are
    :data:`MASKED_LOGIT` and weigh nothing; a row with no live key gives
    zeros. Returns [B, Hq, Sq, D] in ``q.dtype``."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = hq // hkv
    qg = q.float().reshape(b, hkv, g, sq, d)
    kf = k.float()[:, :, None]                            # [B, Hkv, 1, Sk, D]
    s = (qg @ kf.transpose(-1, -2)) * (d ** -0.5)         # [B, Hkv, G, Sq, Sk]
    qpos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & (kpos > qpos - window)
    out = _masked_softmax_product(s, mask, v.float()[:, :, None])
    return out.reshape(b, hq, sq, d).to(q.dtype)


def flash_decode_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       length: Optional[torch.Tensor] = None,
                       end: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One-token attention over a KV cache (plain version of
    ``flash_decode``; the TPU kernel's function). ``q`` [B, Hq, D],
    ``k``/``v`` [B, Hkv, S, D], ``length`` [B] int (all S when ``None``):
    row b has n = min(max(length[b], 0), S) live keys, cache slots 0 .. n-1
    (the TPU kernel's mask ``j < min(length[b], S)``), or with ``end`` [B]
    int the positions max(end[b] - n, 0) .. end[b] - 1, position P at slot
    P % S (a rolled cache). Scores in float32 scaled after the dot; a row
    with n = 0 gives zeros (the reference's oracle gives NaN there).
    Returns [B, Hq, D] in ``q.dtype``."""
    b, hq, d = q.shape
    hkv, s_len = k.shape[1], k.shape[2]
    g = hq // hkv
    qg = q.float().reshape(b, hkv, g, 1, d)
    kf = k.float()[:, :, None]                            # [B, Hkv, 1, S, D]
    s = (qg @ kf.transpose(-1, -2)) * (d ** -0.5)         # [B, Hkv, G, 1, S]
    slot = torch.arange(s_len, device=q.device)
    n = (torch.full((b,), s_len, device=q.device) if length is None
         else length.to(q.device).long().clamp(0, s_len))
    hi = n if end is None else end.to(q.device).long()
    # slot j holds position hi - 1 - back, back its distance from the newest
    back = torch.remainder(hi[:, None] - 1 - slot[None, :], max(s_len, 1))
    mask = back < torch.minimum(n, hi.clamp_min(0))[:, None]
    out = _masked_softmax_product(s, mask[:, None, None, None, :],
                                  v.float()[:, :, None])
    return out.reshape(b, hq, d).to(q.dtype)
