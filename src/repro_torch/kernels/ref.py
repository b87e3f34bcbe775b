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


def fifo_uncapped_offer(ready: torch.Tensor, dur: torch.Tensor,
                        selc: torch.Tensor, occ: torch.Tensor,
                        wu: torch.Tensor
                        ) -> Tuple[torch.Tensor, ...]:
    """What the CUDA kernel's worker warps precompute for every (row,
    provider, job) of an uncapped provider, off the chain
    (``csrc/fifo_dispatch.cu``): its key, penalty, start and end, which do
    not depend on the slot pool, by :func:`fifo_dispatch_plain`'s own
    expressions with the wait 0.0 and the cold flag false, so that the
    chain only selects among them. ``ready``/``dur``/``selc``/``occ`` [B,
    P, J], ``wu`` [P]; returns (key, pen, start, end), each [B, P, J].
    cw = 0.0 * wu is NaN for an infinite wu, and so are the penalty, key,
    start and end it enters, as in the chain."""
    w = torch.zeros((), dtype=ready.dtype, device=ready.device)
    cw = 0.0 * wu[:, None]                                  # [P, 1]
    pen = occ * (w + cw)
    start = (ready + w) + cw
    return selc + pen, pen, start, start + dur


#: rows of each float32 product in :func:`matmul_plain`
PLAIN_ROWS = 64


def matmul_plain(x: torch.Tensor, y: torch.Tensor,
                 out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x`` [M, K] @ ``y`` [K, N] with float32 accumulation, returned in
    ``out_dtype`` (``x.dtype`` by default; float32: the sums unrounded)
    (plain version of ``matmul``). Its rows do not depend on how
    many rows come with them, as the kernel's do not: y is widened once,
    and every row goes through a [PLAIN_ROWS, K] @ [K, N] product of the
    same shape (zero rows pad the last), where a single product of all M
    rows lets the library's choice of algorithm, which follows M, change
    each row's summation."""
    xf, yf = x.float(), y.float()
    M = xf.shape[0]
    dt = out_dtype or x.dtype
    if M == 0:
        return xf.new_zeros((0, yf.shape[1])).to(dt)
    pad = -M % PLAIN_ROWS
    if pad:
        xf = torch.cat([xf, xf.new_zeros((pad, xf.shape[1]))])
    out = torch.cat([rows @ yf for rows in xf.split(PLAIN_ROWS)])
    return out[:M].to(dt)


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


def rglru_backward_plain(x: torch.Tensor, a: torch.Tensor, y: torch.Tensor,
                         dy: torch.Tensor, h0: Optional[torch.Tensor] = None,
                         dhT: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients of :func:`rglru_plain` (plain version of ``rglru_bwd``):
    ``y`` is its output (float32, so ``y[:, t - 1]`` is h_{t-1}), ``dy``
    the gradient of y and ``dhT`` of h_T (zeros when ``None``). A loop in
    reverse time over elementwise float32 operations, each rounded on its
    own, with the carry c = dh_T:

        g_t  = dy_t + c
        dx_t = g_t * s_t                    s_t = sqrt(max(1 - a_t^2, 0))
        da_t = g_t * h_{t-1} + (-(((g_t * x_t) * (0.5 / s_t)) * tie_t))
                               * (2 * a_t)
        c    = a_t * g_t

    tie_t is the gradient XLA gives ``max(v, 0)`` at v = 1 - a_t^2: 1 for
    v > 0, 0.5 at v = 0 and 0 below. These are the operations of XLA's
    autodiff of the reference's ``rglru_ref`` in its order, so at a_t = 1
    exactly (s_t = 0) dx_t is 0 and da_t is -inf * sign(g_t x_t), or NaN
    where g_t x_t = 0, as ``jax.grad`` gives. Returns (dx, da in the
    inputs' dtypes, dh0 float32)."""
    x32, a32, y32, dy32 = x.float(), a.float(), y.float(), dy.float()
    v = 1.0 - a32 * a32
    s = torch.sqrt(torch.clamp_min(v, 0.0))
    tie = torch.where(v > 0, 1.0, torch.where(v == 0, 0.5, 0.0))
    # a 0-dim divisor: ``0.5 / s`` would take torch's ``reciprocal(s) * 0.5``
    half_over_s = torch.full((), 0.5, device=s.device) / s
    two_a = 2.0 * a32
    dx, da = torch.empty_like(x32), torch.empty_like(a32)
    c = (torch.zeros_like(x32[:, 0]) if dhT is None
         else dhT.float().clone())
    zero = torch.zeros_like(c)
    for t in reversed(range(x32.shape[1])):
        g = dy32[:, t] + c
        hp = y32[:, t - 1] if t else (zero if h0 is None else h0.float())
        dx[:, t] = g * s[:, t]
        dv = ((g * x32[:, t]) * half_over_s[:, t]) * tie[:, t]
        da[:, t] = g * hp + (-dv) * two_a[:, t]
        c = a32[:, t] * g
    return dx.to(x.dtype), da.to(a.dtype), c


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


def rwkv6_backward_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         w: torch.Tensor, u: torch.Tensor, do: torch.Tensor,
                         s0: Optional[torch.Tensor] = None,
                         dsT: Optional[torch.Tensor] = None,
                         term_sums: bool = False) -> Tuple[torch.Tensor, ...]:
    """Gradients of :func:`rwkv6_plain` (plain version of ``rwkv6_bwd``) at
    ``do`` (the gradient of o) and ``dsT`` (of S_T; zeros when ``None``).
    The states S_{t-1} are recomputed forward from ``s0``, as the forward
    computes them (bit for bit the forward's: the update is elementwise),
    never inverted (w_t is exactly 0 in float32 for decay logits past
    ~8.6). Then, per (b, h), with dS = dS_T, in reverse time:

        dr_t[i] = sum_j ((S_{t-1}[i, j] + u[i] (k_t[i] v_t[j])) do_t[j])
        dkv     = dS + (r_t[i] u[i]) do_t[j]                  [Dk, Dv]
        dk_t[i] = sum_j dkv[i, j] v_t[j]
        dv_t[j] = sum_i dkv[i, j] k_t[i]
        dw_t[i] = sum_j dS[i, j] S_{t-1}[i, j]
        du[i]  += (r_t[i] k_t[i]) (sum_j do_t[j] v_t[j])       (t descending)
        dS      = w_t[i] dS + r_t[i] do_t[j]

    and ds0 = dS after t = 1; du's per-(b, h) sums add over b in
    ascending order. Every term and dS is computed with the kernel's
    rounded operations, so only the orders of the sums differ from the
    kernel's (``csrc/rwkv6_bwd.cu`` states its). Returns (dr, dk, dv in
    the dtype of r, k, v; dw, du, ds0 float32); with ``term_sums`` also
    the sums of the terms' magnitudes of dr, dk, dv, dw and du (float32,
    each of its output's shape): the scale of each sum's rounding."""
    r32, k32, v32, w32, do32 = (t.float() for t in (r, k, v, w, do))
    b, h, t_len, dk_ = r32.shape
    dv_ = v32.shape[-1]
    dev = r.device
    uu = u.float()[None, :, :, None]                      # [1, H, Dk, 1]
    S = (torch.zeros((b, h, dk_, dv_), dtype=torch.float32, device=dev)
         if s0 is None else s0.float().clone())
    states = []
    for t in range(t_len):
        states.append(S)
        kv = k32[:, :, t, :, None] * v32[:, :, t, None, :]
        S = w32[:, :, t, :, None] * S + kv
    dS = (torch.zeros((b, h, dk_, dv_), dtype=torch.float32, device=dev)
          if dsT is None else dsT.float().clone())
    dr, dk, dw = (torch.empty_like(r32) for _ in range(3))
    dv = torch.empty_like(v32)
    du = torch.zeros((b, h, dk_), dtype=torch.float32, device=dev)
    sums = ([torch.empty_like(x) for x in (dr, dk, dv, dw)]
            + [torch.zeros_like(du)] if term_sums else None)
    for t in reversed(range(t_len)):
        Sp = states[t]
        rt, kt, wt = (x[:, :, t, :, None] for x in (r32, k32, w32))
        vt, dot = v32[:, :, t, None, :], do32[:, :, t, None, :]
        kv = kt * vt
        t_r = (Sp + uu * kv) * dot
        dkv = dS + (rt * uu) * dot
        t_k, t_v, t_w = dkv * vt, dkv * kt, dS * Sp
        dr[:, :, t], dk[:, :, t] = t_r.sum(-1), t_k.sum(-1)
        dv[:, :, t], dw[:, :, t] = t_v.sum(-2), t_w.sum(-1)
        rk = r32[:, :, t] * k32[:, :, t]
        dov = do32[:, :, t] * v32[:, :, t]
        du = du + rk * dov.sum(-1, keepdim=True)
        if term_sums:
            for out, x, dim in zip(sums, (t_r, t_k, t_v, t_w), (-1, -1, -2,
                                                                 -1)):
                out[:, :, t] = x.abs().sum(dim)
            sums[4] = sums[4] + rk.abs() * dov.abs().sum(-1, keepdim=True)
        dS = wt * dS + rt * dot
    du_sum = du[0]
    for i in range(1, b):                     # over b in ascending order
        du_sum = du_sum + du[i]
    out = (dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype), dw, du_sum, dS)
    if term_sums:
        du_abs = sums[4][0]
        for i in range(1, b):
            du_abs = du_abs + sums[4][i]
        return out + (tuple(sums[:4]) + (du_abs,),)
    return out


def sum_order_bound(sums: torch.Tensor, n: int,
                    got: Optional[torch.Tensor] = None,
                    want: Optional[torch.Tensor] = None) -> torch.Tensor:
    """How far two float32 sums of the same ``n`` terms, taken in two
    orders, may lie apart: 2 (n - 1) 2^-24 times ``sums``, the sum of the
    terms' magnitudes; where ``got`` is bf16, plus one bf16 ulp of the
    larger of |got| and |want| (each rounds its float32 sum to bf16)."""
    bound = 2 * (n - 1) * 2.0 ** -24 * sums.float()
    if got is not None and got.dtype == torch.bfloat16:
        _, e = torch.frexp(torch.maximum(got.float().abs(),
                                         want.float().abs()))
        bound = bound + torch.ldexp(torch.ones_like(bound), e - 8)
    return bound


#: row groups of the CUDA kernel's sum over k (``kGroups`` in
#: ``csrc/rwkv6.cu``): group q holds the Dk / 4 consecutive rows from
#: q * Dk / 4
RWKV_GROUPS = 4


def rwkv6_ordered(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  w: torch.Tensor, u: torch.Tensor,
                  s0: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`rwkv6_plain` with o summed over k in the CUDA kernel's fixed
    order (``csrc/rwkv6.cu``): the rows fall into ``RWKV_GROUPS`` groups
    of Dk / 4 consecutive rows; group q adds its terms for its rows in
    ascending order to a float32 sum that starts at 0.0, and the group
    sums p0..p3 add as (p0 + p1) + (p2 + p3). Each addition is one float32
    operation, so this gives the kernel's o bit for bit on any device; S_T
    is the plain version's. Same arguments and returns as
    :func:`rwkv6_plain`."""
    r32, k32, v32, w32 = (t.float() for t in (r, k, v, w))
    b, h, t_len, dk = r32.shape
    dv = v32.shape[-1]
    S = (torch.zeros((b, h, dk, dv), dtype=torch.float32, device=r.device)
         if s0 is None else s0.float().clone())
    uu = u.float()[None, :, :, None]                      # [1, H, Dk, 1]
    o = torch.empty((b, h, t_len, dv), dtype=torch.float32, device=r.device)
    for t in range(t_len):
        kv = k32[:, :, t, :, None] * v32[:, :, t, None, :]  # [B, H, Dk, Dv]
        terms = (S + uu * kv) * r32[:, :, t, :, None]
        # row q * Dk / 4 + i sits at [q, i]
        groups = terms.reshape(b, h, RWKV_GROUPS, dk // RWKV_GROUPS, dv)
        p = torch.zeros((b, h, RWKV_GROUPS, dv), dtype=torch.float32,
                        device=r.device)
        for i in range(dk // RWKV_GROUPS):
            p = p + groups[:, :, :, i]
        o[:, :, t] = (p[:, :, 0] + p[:, :, 1]) + (p[:, :, 2] + p[:, :, 3])
        S = w32[:, :, t, :, None] * S + kv
    return o.to(v.dtype), S


#: columns of the CUDA backward's tiles, and rows of dv's (``kTile`` in
#: ``csrc/rwkv6_bwd.cu``)
RWKV_BWD_TILE = 4


def _tile_chain(x: torch.Tensor) -> torch.Tensor:
    """The sums over the last dimension of ``x`` (a multiple of
    ``RWKV_BWD_TILE`` long) in the backward kernel's order: each tile of
    four adds its terms in ascending order from the first, and the tiles'
    sums add in ascending order from tile 0."""
    t = x.reshape(*x.shape[:-1], -1, RWKV_BWD_TILE)
    p = t[..., 0]
    for c in range(1, RWKV_BWD_TILE):
        p = p + t[..., c]
    acc = p[..., 0]
    for i in range(1, p.shape[-1]):
        acc = acc + p[..., i]
    return acc


def rwkv6_backward_ordered(r: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, w: torch.Tensor, u: torch.Tensor,
                           do: torch.Tensor,
                           s0: Optional[torch.Tensor] = None,
                           dsT: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, ...]:
    """:func:`rwkv6_backward_plain` with every sum in the CUDA kernel's
    fixed order (``csrc/rwkv6_bwd.cu``): Dv padded with zero columns to a
    multiple of four as the kernel pads it (v, do, s0 and dS_T); dr, dk,
    dw summed over j and dv over i by :func:`_tile_chain`; sum_j do_t[j]
    v_t[j] over the Dv columns in ascending j from the first term; du from
    0.0 with t descending, its per-(b, h) sums over b in ascending order.
    Each operation is one rounded float32 operation, so this gives the
    kernel's six outputs bit for bit on any device. Same arguments and
    returns as :func:`rwkv6_backward_plain` (no ``term_sums``)."""
    r32, k32, v32, w32, do32 = (t.float() for t in (r, k, v, w, do))
    b, h, t_len, dk_ = r32.shape
    dv_ = v32.shape[-1]
    pad = -(-dv_ // RWKV_BWD_TILE) * RWKV_BWD_TILE - dv_
    dev = r.device

    def wide(x):
        return torch.nn.functional.pad(x, (0, pad))

    v4, do4 = wide(v32), wide(do32)
    uu = u.float()[None, :, :, None]                      # [1, H, Dk, 1]
    S = (torch.zeros((b, h, dk_, dv_ + pad), dtype=torch.float32,
                     device=dev) if s0 is None else wide(s0.float()))
    states = []
    for t in range(t_len):
        states.append(S)
        kv = k32[:, :, t, :, None] * v4[:, :, t, None, :]
        S = w32[:, :, t, :, None] * S + kv
    dS = (torch.zeros((b, h, dk_, dv_ + pad), dtype=torch.float32,
                      device=dev) if dsT is None else wide(dsT.float()))
    dov = do32 * v32                                      # [B, H, T, Dv]
    dot = dov[..., 0]
    for j in range(1, dv_):
        dot = dot + dov[..., j]
    rows = torch.empty((3, b, h, t_len, dk_), dtype=torch.float32, device=dev)
    dv = torch.empty((b, h, t_len, dv_ + pad), dtype=torch.float32,
                     device=dev)
    du = torch.zeros((b, h, dk_), dtype=torch.float32, device=dev)
    for t in reversed(range(t_len)):
        Sp = states[t]
        rt, kt, wt = (x[:, :, t, :, None] for x in (r32, k32, w32))
        vt, dot_t = v4[:, :, t, None, :], do4[:, :, t, None, :]
        kv = kt * vt
        t_r = (Sp + uu * kv) * dot_t
        dkv = dS + (rt * uu) * dot_t
        rows[:, :, :, t] = _tile_chain(torch.stack((t_r, dkv * vt, dS * Sp)))
        dv[:, :, t] = _tile_chain((dkv * kt).transpose(-1, -2))
        du = du + (r32[:, :, t] * k32[:, :, t]) * dot[:, :, t, None]
        dS = wt * dS + rt * dot_t
    du_sum = du[0]
    for i in range(1, b):                     # over b in ascending order
        du_sum = du_sum + du[i]
    return (rows[0].to(r.dtype), rows[1].to(k.dtype),
            dv[..., :dv_].to(v.dtype), rows[2], du_sum,
            dS[..., :dv_].contiguous())


#: the TPU attention kernels' logit for a masked (query, key) pair
MASKED_LOGIT = -0.7 * torch.finfo(torch.float32).max
#: key positions per online-softmax step of the bf16 attention kernels
#: (``kTile`` in ``csrc/attention_mma.cuh``): tiles start at multiples of
#: it in key position
ATTN_TILE = 64
#: key positions per chunk (``kChunk``): a query row's running state is
#: closed into a partial every ATTN_CHUNK positions, and the partials are
#: merged in ascending chunk order
ATTN_CHUNK = 256


def _tile_sum(p: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim (ATTN_TILE keys) in the kernels' fixed order
    over the mma C-fragment layout: lane t of a quad holds columns 8j + 2t
    + e and adds them as a tree, (e = 0) + (e = 1) for each j, then
    neighbouring j in pairs until one is left; then the quad adds (t0 +
    t1) + (t2 + t3). Returns [..., 1]."""
    x = p.unflatten(-1, (ATTN_TILE // 8, 4, 2))           # [..., j, t, e]
    u = x[..., 0] + x[..., 1]                             # [..., j, t]
    while u.shape[-2] > 1:
        u = u[..., 0::2, :] + u[..., 1::2, :]
    s = u[..., 0, :]                                      # [..., t]
    return ((s[..., 0] + s[..., 1]) + (s[..., 2] + s[..., 3]))[..., None]


def _empty_state(rows: torch.Tensor):
    """(m, l, acc) of no key yet for query rows [..., R, D]."""
    m = torch.full(rows.shape[:-1] + (1,), MASKED_LOGIT,
                   dtype=torch.float32, device=rows.device)
    return m, torch.zeros_like(m), torch.zeros_like(rows)


def _tile_step(state, qb, kt, vt, live, scale):
    """One online-softmax step over a key tile: ``qb`` [..., R, D] query
    rows, ``kt``/``vt`` [..., T, D] (broadcast over the row blocks),
    ``live`` [..., R, T]. The kernels' order: scores scaled after the dot,
    the masked max, p = exp(s - m_new), the tile's sum of p, then acc *
    alpha plus p @ v. A tile without a live key leaves the state as it
    is."""
    m, l, acc = state
    s = torch.where(live, (qb @ kt.transpose(-1, -2)) * scale, MASKED_LOGIT)
    m_new = torch.maximum(m, s.amax(-1, keepdim=True))
    p = torch.where(live, torch.exp(s - m_new), 0.0)
    alpha = torch.exp(m - m_new)
    return m_new, alpha * l + _tile_sum(p), acc * alpha + p @ vt


def _merge(total, part):
    """Fold a chunk's partial into the running total: m = max(m, m_c);
    l and acc as x * exp(m_old - m) + x_c * exp(m_c - m). A chunk without
    a live key is an exact no-op."""
    m, l, acc = total
    mc, lc, accc = part
    mn = torch.maximum(m, mc)
    e1, e2 = torch.exp(m - mn), torch.exp(mc - mn)
    return mn, l * e1 + lc * e2, acc * e1 + accc * e2


def _finish(state):
    _, l, acc = state
    return acc / torch.where(l == 0.0, 1.0, l)


def _row_blocks(x: torch.Tensor) -> torch.Tensor:
    """[..., rows, D] -> [..., ceil(rows / PLAIN_ROWS), PLAIN_ROWS, D],
    zero rows padding the last block."""
    rows = x.shape[-2]
    pad = -rows % PLAIN_ROWS
    if pad:
        x = torch.cat([x, x.new_zeros(x.shape[:-2] + (pad, x.shape[-1]))],
                      -2)
    return x.unflatten(-2, (-1, PLAIN_ROWS))


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
    zeros. Returns [B, Hq, Sq, D] in ``q.dtype``.

    The bf16 kernels' order for a query row, in float32 with p unrounded:
    key tiles of ATTN_TILE positions at multiples of it, an online softmax
    over them, a partial closed every ATTN_CHUNK positions and merged in
    chunk order (:func:`_tile_step`, :func:`_merge`). Every product is a
    [PLAIN_ROWS, D] block of query rows against one key tile, so a row's
    result depends neither on Sq nor on the rows beside it, and equals
    :func:`flash_decode_plain` of the same row bit for bit."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = hq // hkv
    dev = q.device
    if q.numel() == 0:
        return torch.zeros_like(q)
    # rows (head of the group, query) of each KV head, in blocks
    qb = _row_blocks(q.float().reshape(b, hkv, g * sq, d))
    r = torch.arange(qb.shape[-3] * PLAIN_ROWS, device=dev)
    real = (r < g * sq).view(-1, PLAIN_ROWS, 1)          # [nblk, R, 1]
    qpos = (r % sq + (sk - sq)).view(-1, PLAIN_ROWS, 1)
    pad = -sk % ATTN_TILE
    kf, vf = k.float(), v.float()
    if pad:
        zeros = kf.new_zeros((b, hkv, pad, d))
        kf, vf = torch.cat([kf, zeros], 2), torch.cat([vf, zeros], 2)
    scale = d ** -0.5
    # skip the keys before the first row's window: no row sees them
    k_lo = max(0, sk - sq - window + 1) if window is not None else 0
    total = _empty_state(qb)
    for c0 in range((k_lo // ATTN_CHUNK) * ATTN_CHUNK, sk, ATTN_CHUNK):
        part = _empty_state(qb)
        for j0 in range(max(c0, (k_lo // ATTN_TILE) * ATTN_TILE),
                        min(c0 + ATTN_CHUNK, sk), ATTN_TILE):
            kpos = torch.arange(j0, j0 + ATTN_TILE, device=dev)
            live = real & (kpos < sk)
            if causal:
                live = live & (kpos <= qpos)
            if window is not None:
                live = live & (kpos > qpos - window)
            kt = kf[:, :, None, j0:j0 + ATTN_TILE]
            vt = vf[:, :, None, j0:j0 + ATTN_TILE]
            part = _tile_step(part, qb, kt, vt, live, scale)
        total = _merge(total, part)
    out = _finish(total).flatten(-3, -2)[..., :g * sq, :]
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
    P % S (a rolled cache). ``k``/``v`` may be ``float8_e4m3fn`` caches
    under a bf16 or float32 q: they widen to float32 exactly and nothing
    else is rounded (the TPU kernel's ``astype(float32)``), so the result
    equals the one on ``k``/``v`` widened first. Scores in float32 scaled
    after the dot; a row with n = 0 gives zeros (the reference's oracle
    gives NaN there). Returns [B, Hq, D] in ``q.dtype``.

    :func:`flash_attention_plain`'s order on the key positions: the chunks
    of ATTN_CHUNK positions from the one holding the first live key, each
    in ATTN_TILE-key tiles (keys outside the live range weigh nothing and
    read as zeros), merged in chunk order; the G query heads of a KV head
    are rows of one [PLAIN_ROWS, D] block."""
    b, hq, d = q.shape
    hkv, s_len = k.shape[1], k.shape[2]
    g = hq // hkv
    dev = q.device
    qb = _row_blocks(q.float().reshape(b, hkv, g, d))    # [B, Hkv, 1, R, D]
    n = (torch.full((b,), s_len, device=dev) if length is None
         else length.to(dev).long().clamp(0, s_len))
    hi = n if end is None else end.to(dev).long()
    lo = (hi - n).clamp_min(0)
    n_live = (hi - lo).clamp_min(0)
    base = torch.div(lo, ATTN_CHUNK, rounding_mode="floor") * ATTN_CHUNK
    span = torch.where(n_live > 0, hi - base, 0)
    n_tiles = -(-int(span.max()) // ATTN_TILE) if b else 0
    kf, vf = k.float(), v.float()
    rows = torch.arange(b, device=dev)[:, None]
    scale = d ** -0.5
    total = part = _empty_state(qb)
    for i in range(n_tiles):
        j = i * ATTN_TILE
        if j % ATTN_CHUNK == 0:
            part = _empty_state(qb)
        pos = base[:, None] + j + torch.arange(ATTN_TILE, device=dev)
        live = (pos >= lo[:, None]) & (pos < hi[:, None])      # [B, T]
        slot = torch.remainder(pos, max(s_len, 1))
        kt = torch.where(live[:, None, :, None],
                         kf[rows, :, slot].transpose(1, 2), 0.0)
        vt = torch.where(live[:, None, :, None],
                         vf[rows, :, slot].transpose(1, 2), 0.0)
        part = _tile_step(part, qb, kt[:, :, None], vt[:, :, None],
                          live[:, None, None, None, :], scale)
        if (j + ATTN_TILE) % ATTN_CHUNK == 0 or i == n_tiles - 1:
            total = _merge(total, part)
    out = _finish(total)[:, :, 0, :g]
    return out.reshape(b, hq, d).to(q.dtype)


def decode_local_chunks(S: int, L: int) -> int:
    """Partials a rank keeps a query row for a decode against its ``L`` of
    ``S`` cache slots (``flash_decode_partial_plain``): the chunks whose
    live keys can meet its slots. Where S and L are multiples of
    ATTN_CHUNK every chunk lies on one rank, and a rank's L / ATTN_CHUNK
    slot chunks meet at most one chunk each, but one: the chunk of the
    first live key and that of the last can share a slot chunk in a
    rolled cache. Otherwise the live keys on a rank's slots are at most
    two runs (the cache wraps once), each meeting at most ceil(run /
    ATTN_CHUNK) + 1 chunks."""
    if S <= 0 or L <= 0:
        return 0
    if S % ATTN_CHUNK == 0 and L % ATTN_CHUNK == 0:
        return L // ATTN_CHUNK + 1
    return min((S + ATTN_CHUNK - 2) // ATTN_CHUNK + 1,
               -(-L // ATTN_CHUNK) + 3)


def decode_pieces(length: Optional[torch.Tensor],
                  end: Optional[torch.Tensor], S: int, L: int,
                  offsets) -> int:
    """The partials that hold live keys in a decode against a cache of S
    slots cut into runs of L: for each run that starts at one of
    ``offsets``, the chunks of each row's live range (``length``/``end``
    as :func:`flash_decode_plain` takes them) that meet its slots, summed
    over the rows and runs. This is what a rank's partial writes beyond
    its empty entries, and what the merge reads (where S and L are
    multiples of ATTN_CHUNK, the live chunks a row, each on one rank);
    ``meta`` rows count as full caches."""
    rows = 1
    if length is not None and length.device.type == "meta":
        rows, length, end = length.shape[0], None, None
    b = 1 if length is None else length.shape[0]
    lo, hi = _live_bounds(length, end, b, S, "cpu" if length is None
                          else length.device)
    count = torch.where(hi > lo, torch.div(hi - 1, ATTN_CHUNK,
                                           rounding_mode="floor")
                        - torch.div(lo, ATTN_CHUNK, rounding_mode="floor")
                        + 1, 0)
    _, p0, p1 = _chunk_runs(lo, hi, int(count.max()) if b else 0)
    return rows * sum(int(_meets(p0, p1, S, off, L).sum())
                      for off in offsets)


def _chunk_runs(lo: torch.Tensor, hi: torch.Tensor, n_chunks: int):
    """(first chunk [B], live positions [p0, p1) of each row's chunk c <
    n_chunks [B, n_chunks] each): chunk c of a row is the c-th
    ATTN_CHUNK-aligned chunk from the one holding its first live key."""
    first = torch.div(lo, ATTN_CHUNK, rounding_mode="floor")
    c = torch.arange(n_chunks, device=lo.device)
    start = (first[:, None] + c) * ATTN_CHUNK
    p0 = torch.maximum(lo[:, None], start)
    p1 = torch.minimum(hi[:, None], start + ATTN_CHUNK)
    return first, p0, p1


def _meets(p0: torch.Tensor, p1: torch.Tensor, S: int, off: int,
           L: int) -> torch.Tensor:
    """Whether the live positions [p0, p1) (at most S of them) hold one at
    a slot ``off`` .. ``off + L - 1`` (position P at slot P % S)."""
    a = torch.remainder(p0, max(S, 1))
    b = a + (p1 - p0)
    return (p1 > p0) & (
        (torch.maximum(a, torch.full_like(a, off))
         < torch.minimum(b, torch.full_like(b, off + L)))
        | (torch.maximum(a, torch.full_like(a, off + S))
           < torch.minimum(b, torch.full_like(b, off + L + S))))


def _live_bounds(length, end, b, S, dev):
    n = (torch.full((b,), S, device=dev) if length is None
         else length.to(dev).long().clamp(0, S))
    hi = n if end is None else end.to(dev).long()
    lo = (hi - n).clamp_min(0)
    return lo, hi


def flash_decode_partial_plain(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor,
                               length: Optional[torch.Tensor],
                               end: Optional[torch.Tensor], off: int,
                               S: int) -> torch.Tensor:
    """This rank's part of :func:`flash_decode_plain` against a cache cut
    along its slots (plain version of ``flash_decode_partial``): ``k``/
    ``v`` [B, Hkv, L, D] are slots ``off`` .. ``off + L - 1`` of an
    S-slot cache, ``length``/``end`` the whole cache's (as
    :func:`flash_decode_plain` takes them). For each query row, the
    chunks whose live keys meet these slots, in chunk order, give one
    float32 partial each (running max m, sum l and unnormalised D
    outputs), computed as the whole-cache version computes its chunk with
    the keys on other slots weighing nothing; a row keeps
    :func:`decode_local_chunks` (S, L) entries, the unused ones empty
    (m = MASKED_LOGIT, l = 0, acc = 0). Returns them packed, [m | l |
    acc] over [B, Hq, entries (, D)], float32: what
    :func:`flash_decode_merge_plain` takes from every rank."""
    b, hq, d = q.shape
    hkv, L = k.shape[1], k.shape[2]
    g = hq // hkv
    dev = q.device
    K = decode_local_chunks(S, L)
    qb = _row_blocks(q.float().reshape(b, hkv, g, d))    # [B, Hkv, 1, R, D]
    R = qb.shape[-2]
    pm = torch.full((b, hkv, 1, R, 1, K), MASKED_LOGIT, device=dev)
    pl = torch.zeros((b, hkv, 1, R, 1, K), device=dev)
    pa = torch.zeros((b, hkv, 1, R, d, K), device=dev)
    lo, hi = _live_bounds(length, end, b, S, dev)
    n_live = (hi - lo).clamp_min(0)
    base = torch.div(lo, ATTN_CHUNK, rounding_mode="floor") * ATTN_CHUNK
    span = torch.where(n_live > 0, hi - base, 0)
    n_tiles = -(-int(span.max()) // ATTN_TILE) if b else 0
    n_chunks = -(-n_tiles * ATTN_TILE // ATTN_CHUNK)
    _, p0, p1 = _chunk_runs(lo, hi, n_chunks)
    mine = _meets(p0, p1, S, off, L)                     # [B, n_chunks]
    entry = torch.where(mine, torch.cumsum(mine.long(), 1) - 1, -1)
    kf, vf = k.float(), v.float()
    rows = torch.arange(b, device=dev)[:, None]
    scale = d ** -0.5
    part = _empty_state(qb)
    for i in range(n_tiles):
        j = i * ATTN_TILE
        if j % ATTN_CHUNK == 0:
            part = _empty_state(qb)
        pos = base[:, None] + j + torch.arange(ATTN_TILE, device=dev)
        slot = torch.remainder(pos, max(S, 1)) - off
        here = (slot >= 0) & (slot < L)
        live = (pos >= lo[:, None]) & (pos < hi[:, None]) & here  # [B, T]
        slot = torch.where(here, slot, 0)
        kt = torch.where(live[:, None, :, None],
                         kf[rows, :, slot].transpose(1, 2), 0.0)
        vt = torch.where(live[:, None, :, None],
                         vf[rows, :, slot].transpose(1, 2), 0.0)
        if bool(live.any()):   # a tile without a live key is a no-op
            part = _tile_step(part, qb, kt[:, :, None], vt[:, :, None],
                              live[:, None, None, None, :], scale)
        if (j + ATTN_TILE) % ATTN_CHUNK == 0 or i == n_tiles - 1:
            e = entry[:, j // ATTN_CHUNK]
            bi = torch.nonzero(e >= 0).flatten()   # rows keeping the chunk
            for dst, src in zip((pm, pl, pa), part):
                dst[bi, ..., e[bi]] = src[bi]
    parts = [t.reshape(b, hkv, R, -1, K)[:, :, :g].reshape(b, hq, -1, K)
             .transpose(-1, -2) for t in (pm, pl, pa)]
    return torch.cat([parts[0].reshape(-1), parts[1].reshape(-1),
                      parts[2].reshape(-1)])


def flash_decode_merge_plain(parts: torch.Tensor, q: torch.Tensor,
                             length: Optional[torch.Tensor],
                             end: Optional[torch.Tensor], S: int, L: int,
                             hkv: int) -> torch.Tensor:
    """The attention of q [B, Hq, D] over a cache of S slots cut into runs
    of L along them, from every rank's :func:`flash_decode_partial_plain`
    (``parts`` [m, n], rank order; rank r held slots r L .. r L + L - 1):
    each row's chunks merged in chunk order from the empty state, and the
    pieces of one chunk in rank order, over :func:`flash_decode_plain`'s
    row blocks of the ``hkv`` KV heads (plain version of
    ``flash_decode_merge``) -> [B, Hq, D] in q's dtype. Where S and L are
    multiples of ATTN_CHUNK each chunk is one rank's whole chunk, so this
    is :func:`flash_decode_plain` of the whole cache bit for bit; else a
    chunk split between ranks sums its pieces' exponentials in another
    order than the whole chunk's online softmax (a few float32 roundings
    a chunk)."""
    b, hq, d = q.shape
    m = parts.shape[0]
    K = decode_local_chunks(S, L)
    dev = q.device
    # the partials as flash_decode_plain's row blocks: [m, B, Hkv, 1, R,
    # (1 | D), K], the G query heads of a KV head padded to R rows
    g = hq // hkv
    qb = _row_blocks(q.float().reshape(b, hkv, g, d))
    R = qb.shape[-2]
    n = b * hq * K

    def blocks(t, w):
        t = t.reshape(m, b, hkv, g, K, w).movedim(4, -1)
        pad = t.new_zeros((m, b, hkv, R - g, w, K))
        return torch.cat([t, pad], 3)[:, :, :, None]

    pm = blocks(parts[:, :n], 1)
    pl = blocks(parts[:, n:2 * n], 1)
    pa = blocks(parts[:, 2 * n:], d)
    lo, hi = _live_bounds(length, end, b, S, dev)
    n_live = (hi - lo).clamp_min(0)
    first = torch.div(lo, ATTN_CHUNK, rounding_mode="floor")
    count = torch.where(n_live > 0, torch.div(
        hi - 1, ATTN_CHUNK, rounding_mode="floor") - first + 1, 0)
    n_chunks = int(count.max()) if b else 0
    _, p0, p1 = _chunk_runs(lo, hi, n_chunks)
    mine = [_meets(p0, p1, S, r * L, L) for r in range(m)]
    entry = [torch.cumsum(x.long(), 1) - 1 for x in mine]
    idx = torch.arange(b, device=dev)
    total = _empty_state(qb)
    for c in range(n_chunks):
        for r in range(m):
            e = entry[r][:, c].clamp_min(0)
            part = tuple(t[r][idx, ..., e] for t in (pm, pl, pa))
            merged = _merge(total, part)
            keep = mine[r][:, c].view(b, 1, 1, 1, 1)
            total = tuple(torch.where(keep, x, t)
                          for x, t in zip(merged, total))
    out = _finish(total)[:, :, 0, :g]
    return out.reshape(b, hq, d).to(q.dtype)

