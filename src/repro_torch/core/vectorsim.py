"""Batched scenario-sweep engine for Alg. 1 in PyTorch (``engine="vector"``).

The discrete-event reference in :mod:`.simulator` replays one (app, order,
C_max, latency-draw) point at a time; every headline figure of the paper is
a *grid* of such points. This module runs the same algorithm — capacity
prefix initialization offload, per-stage priority queues, the adaptive ACD
kept-prefix sweep, replica occupancy, transfer latencies and Eqn.-1 cost —
over a whole scenario grid at once: :func:`simulate_scenarios` for one
application's grid, :func:`sweep_scenarios` for a whole figure across
applications.

Engine structure
----------------
Influence in the platform model is strictly feed-forward: events at stage
``k`` are shaped by upstream completions and by stage ``k``'s own replica
occupancy, never by downstream stages. The engine therefore simulates the
stages **in topological order**, each to completion. Every tensor carries
the scenario axis as its leading dimension ``B``; a stage's event loop is
a Python loop whose body commits, for every scenario in lockstep, the
whole event batch at the scenario's current instant:

* the ACD eviction cascade in one call of the ``acd_evict`` kernel (the
  greedy kept-prefix recurrence, sequential within a queue row), through
  :func:`repro_torch.kernels.ops.acd_evict` — the CUDA kernel on the
  card, its plain PyTorch version on the CPU;
* the same-instant dispatch batch: queue rank ``r`` takes the ``r``-th
  lowest free replica, through a one-hot ``[J, I]`` match matrix (one
  value plus exact zeros per product, so the float64 ``bmm`` is exact);
* a speculative arrival fast-forward that rewinds when the sweep at the
  jump target is dirty.

A finished scenario's body is a fixed point (an empty queue commits
nothing), so the loop runs until every scenario is done, capped at
``4 * J + 16`` body steps per stage. Forced-public jobs (initialization
offload and eviction cascades) never enter a queue: their start/end times
are closed forms of their arrival times, as are cost and completion.

DAG structure, replica pools (a masked ``[M, I_max]`` speed matrix), the
provider portfolio (segment-indexed ``[P, S, J, M]`` billing and selection
matrices) and the release stream are all per-scenario *data*, so several
applications, deadline grids, replica and straggler axes and price traces
share one batched run. Stages are topologically relabelled and short DAGs
padded with inert stages.

Exactness
---------
Everything runs in float64 and keeps the reference engine's association
of every float expression. Float prefix sums never run as parallel scans:
the ACD recurrence lives in the kernel, the initialization-offload prefix
runs on the host in numpy, and the scalar totals reduce on the host in
:func:`_finalize`. Sorts are stable and argmins take the first index.

Not in this engine yet (they raise ``NotImplementedError``): fault
injection, concurrency caps, cold starts, pool traces, job paging
(``chunk_jobs``), trace-derived ``workload`` specs, egress lookahead,
``init_window`` and externally supplied offload plans. The DES in
:mod:`.simulator` covers all of them.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .arrivals import ArrivalsLike, resolve_release
from .coldstart import (as_coldstart, as_pool_trace, norm_concurrency,
                        validate_load_kwargs)
from .cost import (CostModel, EGRESS_GB_PER_S, LAMBDA_COST, PriceTrace,
                   ProviderPortfolio, as_portfolio)
from .dag import AppDAG
from .greedy import init_offload_torch
from .priority import ORDERS
from ..kernels import ops as _kernel_ops

#: Inner-loop implementations of this engine. "kernel" is the batched
#: body with the ACD sweep in the ``acd_evict`` kernel (the reference's
#: "pallas" structure); the reference's "loop" and "scan" twins are not
#: ported yet.
ENGINE_IMPLS = ("kernel",)

#: Unported options -> the later slice of the port that brings them.
_UNPORTED = {
    "faults": "the faults slice",
    "retry": "the faults slice",
    "concurrency": "the caps and cold-starts slice (with fifo_dispatch)",
    "coldstart": "the caps and cold-starts slice (with fifo_dispatch)",
    "pool_trace": "the caps and cold-starts slice (with fifo_dispatch)",
    "chunk_jobs": "the paging and workloads slice",
    "workload": "the paging and workloads slice",
    "egress_lookahead": "the scenario-axes slice",
    "init_window": "the scenario-axes slice",
    "offload_mask": "the scenario-axes slice",
    "init_phase": "the scenario-axes slice (per-task flags)",
    "adaptive": "the scenario-axes slice (per-task flags)",
}


def _reject_unported(where: str = "", **kw) -> None:
    """Raise ``NotImplementedError`` for every option in ``kw`` that is set
    (anything but ``None``/``False``), naming the slice that brings it."""
    for name, value in kw.items():
        if value is None or value is False:
            continue
        pre = f"{where}: " if where else ""
        raise NotImplementedError(
            f"{pre}{name}= is not ported to the PyTorch engine yet; it "
            f"comes with {_UNPORTED[name]}")


def resolve_device(device=None) -> torch.device:
    """The engine's device: ``cuda`` unless the caller names another.

    Raises when CUDA is asked for (explicitly or by default) and no GPU is
    present: the engine never continues quietly on the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default and no GPU is available; "
            "pass device='cpu' to run on the CPU")
    return dev


def resolve_engine_impl(impl: Optional[str] = None) -> str:
    """Resolve an ``engine_impl=`` argument (``None`` = "kernel")."""
    eff = "kernel" if impl is None else impl
    if eff not in ENGINE_IMPLS:
        raise ValueError(
            f"unknown engine_impl {eff!r}: expected one of {ENGINE_IMPLS}")
    return eff


@dataclasses.dataclass
class VectorSimResult:
    """Batched twin of :class:`.simulator.SimResult`; axis 0 is scenarios.

    ``orders``/``c_max``/``batch_idx`` record the scenario grid: scenario
    ``s`` ran priority order ``orders[s]`` with deadline ``c_max[s]`` on
    latency-draw ``batch_idx[s]`` of the supplied pred/act batch.
    """

    makespan: np.ndarray            # [S]
    cost_usd: np.ndarray            # [S]
    public_mask: np.ndarray         # [S, J, M]
    start: np.ndarray               # [S, J, M]
    end: np.ndarray                 # [S, J, M]
    completion: np.ndarray          # [S, J]
    n_offloaded_stages: np.ndarray  # [S]
    n_init_offloaded_jobs: np.ndarray  # [S]
    per_stage_offloads: np.ndarray  # [S, M]
    provider: np.ndarray            # [S, J, M] int: -1 private, else index
    deadline: np.ndarray            # [S]
    orders: Tuple[str, ...]         # [S]
    c_max: np.ndarray               # [S]
    batch_idx: np.ndarray           # [S]
    release: Optional[np.ndarray] = None  # [S, J] job release times (None=batch)
    replica: Optional[np.ndarray] = None  # [S, J, M] int: private replica, -1 = public
    replicas: Optional[np.ndarray] = None  # [S, M] per-scenario replica counts
    segment: Optional[np.ndarray] = None  # [S, J, M] int: price segment, -1 = private
    trace_idx: Optional[np.ndarray] = None  # [S] index into the price_traces axis
    attempts: Optional[np.ndarray] = None  # [S, J, M] int: public attempts made
    failed: Optional[np.ndarray] = None    # [S, J, M] int: failed attempts
    abandoned: Optional[np.ndarray] = None  # [S, J] bool: recovery impossible
    fault_idx: Optional[np.ndarray] = None  # [S] index into the faults axis
    queue_wait: Optional[np.ndarray] = None  # [S, J, M] capped-slot FIFO wait
    cold: Optional[np.ndarray] = None       # [S, J, M] bool: paid a cold start

    @property
    def num_scenarios(self) -> int:
        return int(self.makespan.shape[0])

    @property
    def offload_fraction(self) -> np.ndarray:
        return self.public_mask.mean(axis=(1, 2))

    def scenario(self, s: int):
        """Slice scenario ``s`` into a plain :class:`SimResult`."""
        from .simulator import SimResult
        return SimResult(
            makespan=float(self.makespan[s]),
            cost_usd=float(self.cost_usd[s]),
            public_mask=self.public_mask[s],
            start=self.start[s], end=self.end[s],
            completion=self.completion[s],
            n_offloaded_stages=int(self.n_offloaded_stages[s]),
            n_init_offloaded_jobs=int(self.n_init_offloaded_jobs[s]),
            per_stage_offloads=self.per_stage_offloads[s],
            deadline=float(self.deadline[s]),
            provider=self.provider[s],
            release=None if self.release is None else self.release[s],
            replica=None if self.replica is None else self.replica[s],
            segment=None if self.segment is None else self.segment[s],
            attempts=None if self.attempts is None else self.attempts[s],
            failed=None if self.failed is None else self.failed[s],
            abandoned=None if self.abandoned is None else self.abandoned[s],
            queue_wait=None if self.queue_wait is None
            else self.queue_wait[s],
            cold=None if self.cold is None else self.cold[s])


# -- the engine -------------------------------------------------------------

def _inverse_perm(perm: torch.Tensor) -> torch.Tensor:
    """Row-wise inverse of a batch of permutations [B, J]."""
    iota = torch.arange(perm.shape[1], device=perm.device).expand_as(perm)
    return torch.empty_like(perm).scatter_(1, perm, iota)


def _gather_ps(x_ps: torch.Tensor, prov: torch.Tensor,
               seg: torch.Tensor) -> torch.Tensor:
    """x_ps[b, prov[b, j], seg[b, j]] for [B, P, S] data and [B, J] indices."""
    S = x_ps.shape[2]
    return x_ps.reshape(x_ps.shape[0], -1).gather(1, prov * S + seg)


def _run_stage(a, elig, speed_k, clock0_k, acd_k, P_k, rem_k, dur_k,
               keys_k, deadline, t0: float, adaptive: bool,
               trips: List[int]):
    """Run one stage's event loop for every scenario in lockstep.

    ``a`` [B, J] per-job arrival times, ``elig`` [B, J] queue membership,
    ``speed_k``/``clock0_k`` [B, I] the replica pool (inf = absent slot)
    and its starting clocks, ``acd_k`` [B] whether the stage runs the ACD
    sweep, ``P_k``/``rem_k``/``dur_k``/``keys_k`` [B, J] predicted demand,
    critical-path remainder, actual duration and priority key,
    ``deadline`` [B, J] absolute deadlines.

    Returns (times, replica) in job coordinates: ``times`` holds the
    dispatch instant of private jobs and ``-(eviction instant) - 1`` of
    evicted ones (NaN = never exited; this encoding needs ``t0 >= 0``).
    Appends the number of body steps to ``trips``.
    """
    B, J = P_k.shape
    dev = P_k.device
    inf = torch.tensor(float("inf"), dtype=torch.float64, device=dev)
    zero = torch.zeros((), dtype=torch.float64, device=dev)
    # queue coordinates: stable sort by stage key, ties by job id
    perm = torch.argsort(keys_k, dim=1, stable=True)
    inv = _inverse_perm(perm)
    P_q = P_k.gather(1, perm)
    rem_q = rem_k.gather(1, perm)
    dur_q = dur_k.gather(1, perm)
    a_q = a.gather(1, perm)
    elig_q = elig.gather(1, perm)
    dl_q = deadline.gather(1, perm)
    # arrival stream in time order; ineligible jobs never arrive.
    # arr_rank[p] = arrival index of queue position p, so the queue is
    # derived each step as (arr_rank < ap) & ~exited
    a_elig = torch.where(elig_q, a_q, inf)
    arr_order = torch.argsort(a_elig, dim=1, stable=True)
    arr_t = torch.cat([a_elig.gather(1, arr_order),
                       torch.full((B, 1), float("inf"), dtype=torch.float64,
                                  device=dev)], dim=1)
    arr_rank = _inverse_perm(arr_order)
    n_arr = elig_q.sum(1)
    ap = (elig_q & (a_q <= t0)).sum(1)  # t0 batch (source stages)
    # I_k is derived from the pool: count of present (finite) slots
    present = torch.isfinite(speed_k)
    I_k = present.sum(1).to(torch.float64)[:, None]
    slack_c = I_k * dl_q
    # thresh(t) = base_c - I_k * t: two separate ops, never fused
    base_c = slack_c - I_k * rem_q
    I_max = speed_k.shape[1]
    iota_I = torch.arange(I_max, device=dev)
    # payload of the rank->slot match product: (slot index + 1, speed);
    # absent slots never match, so their inf speed sanitizes to 0
    pay_s = torch.stack([(iota_I + 1).to(torch.float64).expand(B, I_max),
                         torch.where(present, speed_k, zero)], dim=2)
    acd_m = acd_k[:, None]
    svr = torch.where(present, clock0_k, inf)
    times = torch.full((B, J), float("nan"), dtype=torch.float64, device=dev)
    rep = torch.full((B, J), -1, dtype=torch.int32, device=dev)
    t = torch.full((B,), float(t0), dtype=torch.float64, device=dev)
    clean = torch.zeros(B, dtype=torch.bool, device=dev)
    nq = ap > 0
    cap = 4 * J + 16
    step = 0
    while step < cap and bool(((ap < n_arr) | nq).any()):
        step += 1
        exited = ~torch.isnan(times)
        done = (ap >= n_arr) & ~nq
        t_arr = arr_t.gather(1, ap[:, None])[:, 0]
        # "t if any replica is free, else the next completion": free slots
        # clamp to t, busy slots keep their clock, absent slots stay inf
        td_core = torch.maximum(svr, t[:, None]).amin(1)
        # empty-queue fast-forward to the next completion when nothing
        # can dispatch before it
        td = torch.where(nq, td_core,
                         torch.where((td_core <= t) | (t_arr > td_core),
                                     inf, td_core))
        advance = clean & ~done
        is_arr = advance & (t_arr <= td)
        # speculative fast-forward: admit every arrival in (t, td] and jump
        # to td; a dirty sweep at td rewinds to the one-instant step at t_arr
        ap_td = (arr_t <= td[:, None]).sum(1)
        ap_arr = (arr_t <= t_arr[:, None]).sum(1)
        spec = is_arr & torch.isfinite(td)
        t_new = torch.where(advance,
                            torch.where(spec, td, torch.minimum(t_arr, td)),
                            t)
        ap = torch.where(is_arr, torch.where(spec, ap_td, ap_arr), ap)
        q1 = (arr_rank < ap[:, None]) & ~exited
        if adaptive:
            thresh = base_c - I_k * t_new[:, None]
            # the whole greedy evict set in one kernel call, so the cascade
            # is always complete this step
            evict_now = _kernel_ops.acd_evict(P_q, thresh, q1 & acd_m)
            has_viol = evict_now.any(1)
            dirty = spec & (t_arr < t_new) & has_viol
            evict_now = evict_now & ~dirty[:, None]
            t_new = torch.where(dirty, t_arr, t_new)
            ap = torch.where(dirty, ap_arr, ap)
        else:
            evict_now = torch.zeros_like(q1)
        q2 = q1 & ~evict_now
        free_new = svr <= t_new[:, None]
        # queue rank r pairs with the r-th lowest free replica (integer
        # prefix counts are exact anywhere)
        free_i = free_new.to(torch.int64)
        free_rank = torch.cumsum(free_i, 1) - free_i
        q2i = q2.to(torch.int64)
        qrank = torch.cumsum(q2i, 1) - q2i
        match = free_new[:, None, :] & (qrank[:, :, None]
                                        == free_rank[:, None, :])  # [B, J, I]
        mf = match.to(torch.float64)
        mj = torch.bmm(mf, pay_s)                                  # [B, J, 2]
        slot1_j = mj[:, :, 0]
        slot_j = (slot1_j - 1.0).to(torch.int32)
        speed_j = mj[:, :, 1]
        disp0 = q2 & (slot1_j > 0)
        svr_new_j = t_new[:, None] + dur_q * speed_j
        stuck = disp0 & (svr_new_j <= t_new[:, None])
        fs = torch.where(stuck, qrank, J)
        first_stuck = fs.amin(1)
        if adaptive:
            # a rewound step commits nothing; the next step redoes t_arr
            first_stuck = torch.where(dirty, -1, first_stuck)
            has2 = first_stuck < 0
        else:
            has2 = torch.zeros_like(clean)
        disp = disp0 & (qrank <= first_stuck[:, None])
        times = torch.where(evict_now, -t_new[:, None] - 1.0,
                            torch.where(disp, t_new[:, None], times))
        rep = torch.where(disp, slot_j, rep)
        # commit the batch to the slot rows through the transposed match
        # product (at most one dispatched job per slot: exact)
        slot_val = torch.bmm(torch.where(disp, svr_new_j, zero)[:, None, :],
                             mf)[:, 0, :]                          # [B, I]
        n_free = free_i.sum(1)
        n_q2 = q2i.sum(1)
        n_disp = torch.minimum(torch.minimum(first_stuck + 1, n_free), n_q2)
        taken = free_new & (free_rank < n_disp[:, None])
        svr = torch.where(taken, slot_val, svr)
        nq = n_q2 > n_disp
        clean = ~has2
        t = t_new
    trips.append(step)
    return times.gather(1, inv), rep.gather(1, inv)


def _run_engine(a: Dict[str, torch.Tensor], include_transfers: bool,
                init_mode: int, adaptive: bool, t0: float,
                trips: List[int]) -> Dict[str, torch.Tensor]:
    """Run every scenario of one shape family; ``a`` holds the [B, ...]
    engine tensors built by :meth:`_Task.engine_args` (stages in topological
    order, padded to the family's stage count)."""
    P_pred, act_priv = a["P_pred"], a["act_priv"]
    pub_a, up_a, down_a, dgb_pred = (a["pub_a"], a["up_a"], a["down_a"],
                                     a["dgb_pred"])
    cost_ps, sel_ps = a["cost_ps"], a["sel_ps"]
    lat_ps, eg_ps, edges_ps = a["lat_ps"], a["eg_ps"], a["edges_ps"]
    A, desc, sink, pinned, inert = (a["A"], a["desc"], a["sink"],
                                    a["pinned"], a["inert"])
    speed, clock0 = a["speed"], a["clock0"]
    deadline, release = a["deadline"], a["release"]
    B, J, M = P_pred.shape
    P = sel_ps.shape[1]
    dev = P_pred.device
    f64 = torch.float64
    inf = torch.tensor(float("inf"), dtype=f64, device=dev)
    zero = torch.zeros((), dtype=f64, device=dev)

    # per-stage critical-path remainder (reverse index order = reverse
    # topological order; edges go low -> high)
    rem_l: List[Optional[torch.Tensor]] = [None] * M
    for k in reversed(range(M)):
        best = torch.zeros((B, J), dtype=f64, device=dev)
        for v in range(k + 1, M):
            best = torch.maximum(best,
                                 torch.where(A[:, k, v, None], rem_l[v], zero))
        rem_l[k] = P_pred[:, :, k] + best

    if init_mode == 1:
        # whole-job predicted demand, summed over stages left to right
        c_tot = P_pred[:, :, 0]
        for k in range(1, M):
            c_tot = c_tot + P_pred[:, :, k]
        init_elig = a["init_elig"]
        off = init_offload_torch(torch.where(init_elig, c_tot, zero),
                                 a["job_keys"], a["capacity"]) & init_elig
    else:
        off = torch.zeros((B, J), dtype=torch.bool, device=dev)

    start_l: List[torch.Tensor] = []
    end_l: List[torch.Tensor] = []
    loc_l: List[torch.Tensor] = []
    evict_l: List[torch.Tensor] = []
    prov_l: List[torch.Tensor] = []
    seg_l: List[torch.Tensor] = []
    rep_l: List[torch.Tensor] = []
    down_l: List[torch.Tensor] = []
    cost_l: List[torch.Tensor] = []
    xeg_j = torch.zeros((B, J), dtype=f64, device=dev)
    iota_P = torch.arange(P, device=dev)
    for k in range(M):
        # source stages arrive at the job's release time; downstream stages
        # whenever their predecessors finish
        arr = torch.full((B, J), float("-inf"), dtype=f64, device=dev)
        for u in range(k):
            arr = torch.maximum(arr, torch.where(A[:, u, k, None], end_l[u],
                                                 -inf))
        has_pred = (A[:, :k, k].any(1) if k
                    else torch.zeros(B, dtype=torch.bool, device=dev))
        arr = torch.where(has_pred[:, None], arr, release)
        # forced public at entry: init offload + upstream eviction cascades
        # (constraint (12)); privacy-pinned stages never leave
        forced_k = off
        for u in range(k):
            forced_k = forced_k | (desc[:, u, k, None] & evict_l[u])
        forced_k = forced_k & ~pinned[:, k, None]
        elig = ~forced_k & ~inert[:, k, None]
        times_j, rep_j = _run_stage(
            arr, elig, speed[:, k], clock0[:, k], ~pinned[:, k],
            P_pred[:, :, k], rem_l[k], act_priv[:, :, k],
            a["stage_keys"][:, :, k], deadline, t0, adaptive, trips)
        evicted = times_j < -0.5  # NaN (never exited) compares False
        locpub = forced_k | evicted
        # decision-epoch pricing: the offload epoch is the arrival time when
        # forced public, the eviction instant when ACD-evicted
        tau = torch.where(forced_k, arr, -times_j - 1.0)
        seg_pj = torch.clamp(
            (edges_ps[:, :, :, None] <= tau[:, None, None, :]).sum(2) - 1,
            min=0)                                               # [B, P, J]
        selc = sel_ps[..., k].gather(2, seg_pj[:, :, None, :])[:, :, 0, :]
        if include_transfers:
            # provider-affinity penalty, one predecessor at a time in
            # ascending topological order (the DES's association)
            for u in range(k):
                pen_u = torch.where(
                    A[:, u, k, None] & loc_l[u],
                    _gather_ps(eg_ps, prov_l[u], seg_l[u]) * dgb_pred[:, :, u],
                    zero)
                selc = selc + torch.where(
                    iota_P[None, :, None] != prov_l[u][:, None, :],
                    pen_u[:, None, :], zero)
        pidx_k = torch.argmin(selc, dim=1)                       # [B, J]
        seg_k = seg_pj.gather(1, pidx_k[:, None, :])[:, 0, :]
        lm = _gather_ps(lat_ps, pidx_k, seg_k)
        cost_l.append(cost_ps[..., k].reshape(B, -1, J).gather(
            1, (pidx_k * sel_ps.shape[2] + seg_k)[:, None, :])[:, 0, :])
        down_l.append(down_a[:, :, k] * lm)
        # upload needed iff some input of stage k lives in private storage
        # (or the stage reads the original private input); an edge whose
        # endpoints run public on different providers pays the upstream
        # provider's egress on the un-multiplied edge volume
        if include_transfers:
            needs_up = torch.zeros((B, J), dtype=torch.bool, device=dev)
            for u in range(k):
                needs_up = needs_up | (A[:, u, k, None] & ~loc_l[u])
                moved = (A[:, u, k, None] & loc_l[u] & locpub
                         & (prov_l[u] != pidx_k))
                rate_u = _gather_ps(eg_ps, prov_l[u], seg_l[u])
                xeg_j = xeg_j + torch.where(
                    moved, rate_u * (down_a[:, :, u] * EGRESS_GB_PER_S), zero)
            needs_up = torch.where(has_pred[:, None], needs_up, True)
            upk = torch.where(needs_up, up_a[:, :, k] * lm, zero)
        else:
            upk = torch.zeros((B, J), dtype=f64, device=dev)
        start = torch.where(locpub, tau + upk, times_j)
        # private durations run on the assigned replica's speed
        priv_dur = act_priv[:, :, k] * speed[:, k].gather(
            1, torch.clamp(rep_j, min=0).to(torch.int64))
        end = start + torch.where(locpub, pub_a[:, :, k] * lm, priv_dur)
        start_l.append(start)
        end_l.append(end)
        loc_l.append(locpub)
        evict_l.append(evicted)
        prov_l.append(pidx_k)
        seg_l.append(seg_k)
        rep_l.append(torch.where(locpub, -1, rep_j))

    start = torch.stack(start_l, dim=2)
    end = torch.stack(end_l, dim=2)
    locpub = torch.stack(loc_l, dim=2)
    prov_m = torch.stack(prov_l, dim=2)
    seg_m = torch.stack(seg_l, dim=2)
    # job completion: results back in private storage (sink download)
    fin = end
    if include_transfers:
        fin = fin + torch.where(locpub, torch.stack(down_l, dim=2), zero)
    completion = torch.where(sink[:, None, :], fin, -inf).amax(2)
    # per-job cost: stage billing summed left to right over stages, then
    # the cross-provider egress; scalar totals reduce on the host
    cost_j = torch.where(loc_l[0], cost_l[0], zero)
    for k in range(1, M):
        cost_j = cost_j + torch.where(loc_l[k], cost_l[k], zero)
    cost_j = cost_j + xeg_j
    return dict(cost_j=cost_j, init_off=off,
                public_mask=locpub, start=start, end=end,
                completion=completion,
                provider=torch.where(locpub, prov_m, -1),
                replica=torch.stack(rep_l, dim=2),
                segment=torch.where(locpub, seg_m, -1),
                attempts=locpub.to(torch.int64),
                failed=torch.zeros((B, J, M), dtype=torch.int64, device=dev),
                abandoned=torch.zeros((B, J), dtype=torch.bool, device=dev),
                queue_wait=torch.zeros((B, J, M), dtype=f64, device=dev),
                cold=torch.zeros((B, J, M), dtype=torch.bool, device=dev))


# -- host-side preparation ---------------------------------------------------

def _norm_batch(d: Dict[str, np.ndarray], B: int) -> Dict[str, np.ndarray]:
    """Broadcast [J,M] matrices to [B,J,M] (no copy via broadcast_to)."""
    out = {}
    for key, v in d.items():
        v = np.asarray(v, dtype=np.float64)
        if v.ndim == 2:
            v = np.broadcast_to(v, (B,) + v.shape)
        elif v.ndim != 3 or v.shape[0] != B:
            raise ValueError(f"{key}: expected [J,M] or [{B},J,M], got {v.shape}")
        out[key] = v
    return out


def _validate_workload_axes(pred: Dict[str, np.ndarray],
                            act: Dict[str, np.ndarray],
                            where: str = "") -> None:
    """Check every pred/act matrix against pred['P_private'] up front.

    Mismatched job/stage/batch axes raise a :class:`ValueError` that names
    the offending entry (e.g. ``act['P_public']``) and the axis that
    disagrees, instead of a shape error surfacing from deep inside the
    batched engine.
    """
    pre = f"{where}: " if where else ""
    if "P_private" not in pred:
        raise ValueError(f"{pre}pred is missing 'P_private'")
    ref = np.asarray(pred["P_private"])
    if ref.ndim not in (2, 3):
        raise ValueError(
            f"{pre}pred['P_private']: expected [J, M] or [B, J, M], "
            f"got shape {ref.shape}")
    jm = ref.shape[-2:]
    batch_owner, batch = ("pred['P_private']", ref.shape[0]) \
        if ref.ndim == 3 else (None, None)
    for dname, d in (("pred", pred), ("act", act)):
        for key, v in d.items():
            v = np.asarray(v)
            name = f"{dname}['{key}']"
            if v.ndim not in (2, 3):
                raise ValueError(f"{pre}{name}: expected [J, M] or "
                                 f"[B, J, M], got shape {v.shape}")
            if v.shape[-2:] != jm:
                raise ValueError(
                    f"{pre}{name}: job/stage axes {v.shape[-2:]} do not "
                    f"match pred['P_private'] {jm}")
            if v.ndim == 3:
                if batch is None:
                    batch_owner, batch = name, v.shape[0]
                elif v.shape[0] != batch:
                    raise ValueError(
                        f"{pre}{name}: latency-draw batch axis "
                        f"{v.shape[0]} does not match {batch_owner} "
                        f"batch axis {batch}")


def _norm_replica_axis(replicas, dag: AppDAG,
                       where: str = "") -> List[np.ndarray]:
    """``replicas=`` axis -> list of per-stage count vectors [M] (ints).

    ``None`` is the one-point axis at the DAG's own replica counts.
    """
    pre = f"{where}: " if where else ""
    if replicas is None:
        return [np.asarray(dag.replicas, dtype=np.int64)]
    replicas = list(replicas)  # materialize one-shot iterators
    if not replicas:
        raise ValueError(f"{pre}replicas axis is empty")
    out = []
    for i, cfg in enumerate(replicas):
        v = np.asarray(cfg)
        if v.ndim != 1 or v.shape[0] != dag.num_stages:
            raise ValueError(
                f"{pre}replicas[{i}]: expected {dag.num_stages} per-stage "
                f"counts (M={dag.num_stages}), got shape {v.shape}")
        vf = v.astype(np.float64)
        if (vf % 1 != 0).any() or (vf < 1).any():
            raise ValueError(
                f"{pre}replicas[{i}]: counts must be integers >= 1, "
                f"got {v.tolist()}")
        out.append(vf.astype(np.int64))
    return out


def _norm_speed_axis(replica_speeds, M: int, I_max: int,
                     where: str = "") -> List[np.ndarray]:
    """``replica_speeds=`` axis -> list of [M, I_max] slowdown matrices.

    Each config is either a ``{(stage, replica): factor}`` dict (the DES's
    ``replica_slowdown`` format) or an array ``[M, I]``; entries are
    multiplicative slowdowns (1.0 = healthy), missing entries default to
    healthy, and entries for absent replica slots are ignored exactly as
    the DES ignores them. ``None`` is the one-point healthy axis.
    """
    pre = f"{where}: " if where else ""
    if replica_speeds is None:
        return [np.ones((M, I_max))]
    cfgs = list(replica_speeds)
    if not cfgs:
        raise ValueError(f"{pre}replica_speeds axis is empty")
    out = []
    for g, cfg in enumerate(cfgs):
        sp = np.ones((M, I_max))
        if cfg is None:
            pass
        elif isinstance(cfg, dict):
            # every entry is validated — including ones for slots absent
            # at this I_max, so acceptance never depends on the sweep's
            # replica bound (the engines must reject inputs identically)
            for key, f in cfg.items():
                try:
                    k, r = (int(key[0]), int(key[1]))
                except (TypeError, ValueError, IndexError):
                    raise ValueError(
                        f"{pre}replica_speeds[{g}]: keys must be "
                        f"(stage, replica) pairs, got {key!r}") from None
                if not 0 <= k < M:
                    raise ValueError(
                        f"{pre}replica_speeds[{g}]: stage {k} out of "
                        f"range for M={M}")
                try:
                    fv = float(f)
                except (TypeError, ValueError):
                    raise ValueError(
                        f"{pre}replica_speeds[{g}]: factor for "
                        f"({k}, {r}) must be a number, got {f!r}") from None
                if not (np.isfinite(fv) and fv > 0):
                    raise ValueError(
                        f"{pre}replica_speeds[{g}]: factors must be "
                        f"finite and > 0")
                if r < 0:
                    raise ValueError(
                        f"{pre}replica_speeds[{g}]: replica index {r} "
                        f"is negative")
                if r >= I_max:
                    continue  # slot absent in every config: a no-op
                sp[k, r] = fv
        else:
            arr = np.asarray(cfg, dtype=np.float64)
            if arr.ndim != 2 or arr.shape[0] != M:
                raise ValueError(
                    f"{pre}replica_speeds[{g}]: expected [M={M}, I] "
                    f"factors, got shape {arr.shape}")
            if not (np.isfinite(arr) & (arr > 0)).all():
                raise ValueError(
                    f"{pre}replica_speeds[{g}]: factors must be "
                    f"finite and > 0")
            w = min(arr.shape[1], I_max)
            sp[:, :w] = arr[:, :w]
        out.append(sp)
    return out


def _norm_trace_axis(price_traces, base: ProviderPortfolio,
                     where: str = "") -> List[ProviderPortfolio]:
    """``price_traces=`` axis -> list of portfolio variants.

    Each entry is a pricing of the *same* providers: a full
    :class:`ProviderPortfolio` (same provider count as ``base``), a
    sequence of per-provider :class:`PriceTrace` (applied to ``base``'s
    providers in order), a single :class:`PriceTrace` (applied to every
    provider), or ``None`` (``base`` unchanged). ``None`` as the whole
    axis is the one-point axis at ``base``.
    """
    pre = f"{where}: " if where else ""
    if price_traces is None:
        return [base]
    cfgs = list(price_traces)
    if not cfgs:
        raise ValueError(f"{pre}price_traces axis is empty")
    out = []
    for i, cfg in enumerate(cfgs):
        if cfg is None:
            out.append(base)
            continue
        if isinstance(cfg, ProviderPortfolio):
            if cfg.num_providers != base.num_providers:
                raise ValueError(
                    f"{pre}price_traces[{i}]: portfolio has "
                    f"{cfg.num_providers} providers, the sweep's base "
                    f"portfolio has {base.num_providers} (one shape "
                    f"family needs a fixed provider count)")
            out.append(cfg)
            continue
        if isinstance(cfg, PriceTrace):
            cfg = [cfg] * base.num_providers
        try:
            traces = list(cfg)
        except TypeError:
            raise ValueError(
                f"{pre}price_traces[{i}]: expected a ProviderPortfolio, "
                f"a PriceTrace, a sequence of PriceTrace, or None — got "
                f"{type(cfg).__name__}") from None
        if len(traces) != base.num_providers or not all(
                isinstance(t, PriceTrace) for t in traces):
            raise ValueError(
                f"{pre}price_traces[{i}]: expected {base.num_providers} "
                f"PriceTrace entries (one per provider), got "
                f"{[type(t).__name__ for t in traces]}")
        out.append(ProviderPortfolio(tuple(
            p.with_trace(t) for p, t in zip(base.providers, traces))))
    return out


def _max_segment_bound(trace_cfgs: List[ProviderPortfolio]) -> int:
    """S: the segment bound of one task's normalized price-trace axis."""
    return max(pf.num_segments for pf in trace_cfgs)


def _max_replica_bound(dag: AppDAG, repl_cfgs) -> int:
    """I_max contribution of one task: its largest replica count.

    ``repl_cfgs`` is a *normalized* axis (:func:`_norm_replica_axis`
    output) or ``None`` for the one-point axis at the DAG's own counts.
    """
    if repl_cfgs is None:
        return max([1] + [int(r) for r in dag.replicas])
    return max([1] + [int(v.max()) for v in repl_cfgs if v.size])


class _Task:
    """One application's scenario grid, topologically relabelled and padded
    to the sweep's common (M_pad, I_max) shape family. Host-side numpy."""

    def __init__(self, dag: AppDAG, pred, act, c_max_grid, orders,
                 cost_model, t0, M_pad: int, I_max: int,
                 portfolio: Optional[ProviderPortfolio] = None,
                 include_transfers: bool = True,
                 arrivals: ArrivalsLike = None,
                 replicas=None, replica_speeds=None,
                 price_traces=None, S_seg: Optional[int] = None,
                 where: str = ""):
        from .simulator import _with_transfer_defaults

        act = act if act is not None else pred
        _validate_workload_axes(pred, act, where)
        pred = _with_transfer_defaults(pred)
        act = _with_transfer_defaults(act)
        B = max([v.shape[0] if np.asarray(v).ndim == 3 else 1
                 for v in list(pred.values()) + list(act.values())] or [1])
        pred = _norm_batch(pred, B)
        act = _norm_batch(act, B)
        self.dag = dag
        J, M = pred["P_private"].shape[1:]
        if M != dag.num_stages:
            raise ValueError(f"pred has {M} stages, dag has {dag.num_stages}")
        self.J, self.M = int(J), int(M)
        self.M_pad = M_pad
        self.I_max = int(I_max)
        orders = tuple(orders)
        repl_cfgs = _norm_replica_axis(replicas, dag, where)
        speed_cfgs = _norm_speed_axis(replica_speeds, self.M, self.I_max,
                                      where)
        pf = as_portfolio(portfolio, cost_model)
        trace_cfgs = [pf] if price_traces is None else list(price_traces)
        self.n_segments = (_max_segment_bound(trace_cfgs) if S_seg is None
                           else int(S_seg))
        self.grid = [(b, o, float(c), r, g, tr)
                     for b in range(B) for o in orders for c in c_max_grid
                     for r in range(len(repl_cfgs))
                     for g in range(len(speed_cfgs))
                     for tr in range(len(trace_cfgs))]
        self.S = len(self.grid)
        self.orders_out = tuple(o for (_, o, _, _, _, _) in self.grid)
        self.c_max_out = np.array([c for (_, _, c, _, _, _) in self.grid])
        self.batch_out = np.array([b for (b, _, _, _, _, _) in self.grid])
        self.repl_out = np.stack([repl_cfgs[r]
                                  for (_, _, _, r, _, _) in self.grid])
        self.trace_out = np.array([tr for (_, _, _, _, _, tr) in self.grid])
        self.t0 = float(t0)
        # exogenous release stream (None = batch at t0); per-job absolute
        # deadlines are release + C_max
        self.release = resolve_release(arrivals, self.J, self.t0)
        rel = (np.full(self.J, self.t0) if self.release is None
               else self.release)

        # topological stage relabelling: edges go low -> high afterwards
        topo = list(dag.topo_order())
        self.inv_topo = np.argsort(np.array(topo))
        mem = dag.mem_mb

        def pad_cols(v):  # [., M] -> [., M_pad], stages in topo order
            out = np.zeros(v.shape[:-1] + (M_pad,), dtype=np.float64)
            out[..., :M] = v[..., topo]
            return out

        # priority keys + provider selection/billing: identical numpy math
        # to the DES preamble (keys see the trace prices at plan time t0)
        self.n_providers = pf.num_providers
        S_seg = self.n_segments
        sinkm = dag.is_sink if include_transfers else None
        uniq: Dict[Tuple[int, str, int],
                   Tuple[np.ndarray, np.ndarray]] = {}
        sel_bt: Dict[Tuple[int, int], np.ndarray] = {}
        cost_bt: Dict[Tuple[int, int], np.ndarray] = {}
        iota_P = np.arange(self.n_providers)
        for b in sorted({b for (b, _, _, _, _, _) in self.grid}):
            down_pred = pred["download"][b] if include_transfers else None
            down_act = act["download"][b] if include_transfers else None
            for tr, tpf in enumerate(trace_cfgs):
                sel_bt[(b, tr)] = tpf.np_selection_costs_seg(
                    pred["P_public"][b], mem, down_pred, sinkm,
                    require=~dag.must_private_mask,
                    num_segments=S_seg)                 # [P, S_seg, J, M]
                cost_bt[(b, tr)] = tpf.np_stage_costs_seg(
                    act["P_public"][b], mem, down_act, sinkm,
                    num_segments=S_seg)                 # [P, S_seg, J, M]
                seg0 = tpf.segments_at(self.t0)
                H = np.min(sel_bt[(b, tr)][iota_P, seg0], axis=0)
                for o in dict.fromkeys(orders):
                    key_fn = ORDERS[o]
                    uniq[(b, o, tr)] = (
                        np.stack([key_fn(pred["P_private"][b], H, k)
                                  for k in range(M)], axis=1),
                        key_fn(pred["P_private"][b], H, None))
        stage_keys = np.stack([uniq[(b, o, tr)][0]
                               for (b, o, _, _, _, tr) in self.grid])
        job_keys = np.stack([uniq[(b, o, tr)][1]
                             for (b, o, _, _, _, tr) in self.grid])
        bsel = self.batch_out
        sel_p = np.stack([sel_bt[(b, tr)]
                          for (b, _, _, _, _, tr) in self.grid])
        cost_p = np.stack([cost_bt[(b, tr)]
                           for (b, _, _, _, _, tr) in self.grid])
        lat_by_tr = [tpf.latency_mults_seg(S_seg) for tpf in trace_cfgs]
        eg_by_tr = [tpf.egress_seg(S_seg) for tpf in trace_cfgs]
        edges_by_tr = [tpf.segment_edges(S_seg) for tpf in trace_cfgs]
        pub_a = act["P_public"][bsel]
        up_a = act["upload"][bsel]
        down_a = act["download"][bsel]
        dgb_pred = pred["download"][bsel] * EGRESS_GB_PER_S

        # structure as data, in relabelled indices, padded with inert stages
        A = np.zeros((M_pad, M_pad), dtype=bool)
        desc = np.zeros((M_pad, M_pad), dtype=bool)
        pos = {s: i for i, s in enumerate(topo)}
        for (u, v) in dag.edges:
            A[pos[u], pos[v]] = True
        dm = dag.descendant_masks
        for u in range(M):
            for v in range(M):
                if dm[u, v]:
                    desc[pos[u], pos[v]] = True
        sink = np.zeros(M_pad, dtype=bool)
        sink[[pos[s] for s in dag.sink_ids]] = True
        pinned = np.ones(M_pad, dtype=bool)  # inert pad stages: pinned
        pinned[:M] = dag.must_private_mask[topo]
        inert = np.ones(M_pad, dtype=bool)
        inert[:M] = False

        # per-(config, grid) replica pools as [M_pad, I_max] speed
        # matrices: finite entry = present replica with that slowdown,
        # inf = absent slot; inert pad stages keep one healthy slot
        def speed_matrix(rv: np.ndarray, sg: np.ndarray) -> np.ndarray:
            sp = np.full((M_pad, self.I_max), np.inf)
            sp[M:, 0] = 1.0
            cnt = np.maximum(rv, 1)
            for i, s in enumerate(topo):
                sp[i, :cnt[s]] = sg[s, :cnt[s]]
            return sp

        sp_by_rg = {(r, g): speed_matrix(repl_cfgs[r], speed_cfgs[g])
                    for r in range(len(repl_cfgs))
                    for g in range(len(speed_cfgs))}
        speed = np.stack([sp_by_rg[(r, g)]
                          for (_, _, _, r, g, _) in self.grid])
        # capacity T_max = sum_k I_k * C_max follows the scenario's own
        # replica config (raw counts, as in the DES's t_max)
        capacity = np.array([float(repl_cfgs[r].sum()) * c
                             for (_, _, c, r, _, _) in self.grid])
        S = self.S
        self.args = dict(
            P_pred=pad_cols(pred["P_private"][bsel]),
            act_priv=pad_cols(act["P_private"][bsel]),
            pub_a=pad_cols(pub_a),
            up_a=pad_cols(up_a),
            down_a=pad_cols(down_a),
            dgb_pred=pad_cols(dgb_pred),
            cost_ps=pad_cols(cost_p),
            sel_ps=pad_cols(sel_p),
            lat_ps=np.stack([lat_by_tr[tr]
                             for (_, _, _, _, _, tr) in self.grid]),
            eg_ps=np.stack([eg_by_tr[tr]
                            for (_, _, _, _, _, tr) in self.grid]),
            edges_ps=np.stack([edges_by_tr[tr]
                               for (_, _, _, _, _, tr) in self.grid]),
            stage_keys=pad_cols(stage_keys),
            job_keys=job_keys,
            deadline=rel[None, :] + self.c_max_out[:, None],
            capacity=capacity,
            release=np.broadcast_to(rel, (S, self.J)),
            init_elig=np.ones((S, self.J), dtype=bool),
            A=np.broadcast_to(A, (S,) + A.shape),
            desc=np.broadcast_to(desc, (S,) + desc.shape),
            sink=np.broadcast_to(sink, (S,) + sink.shape),
            pinned=np.broadcast_to(pinned, (S,) + pinned.shape),
            inert=np.broadcast_to(inert, (S,) + inert.shape),
            speed=speed,
            clock0=np.full((S, M_pad, self.I_max), self.t0))

    def pack(self, out: Dict[str, np.ndarray]) -> VectorSimResult:
        """Slice this task's scenarios out of a (possibly concatenated)
        engine output and undo the topological stage relabelling."""
        inv = self.inv_topo
        return VectorSimResult(
            makespan=out["makespan"], cost_usd=out["cost_usd"],
            public_mask=out["public_mask"][:, :, inv],
            start=out["start"][:, :, inv], end=out["end"][:, :, inv],
            completion=out["completion"],
            n_offloaded_stages=out["n_offloaded_stages"],
            n_init_offloaded_jobs=out["n_init_offloaded_jobs"],
            per_stage_offloads=out["per_stage_offloads"][:, inv],
            provider=out["provider"][:, :, inv],
            deadline=self.c_max_out.copy(), orders=self.orders_out,
            c_max=self.c_max_out, batch_idx=self.batch_out,
            release=None if self.release is None
            else np.broadcast_to(self.release, (self.S, self.J)).copy(),
            replica=out["replica"][:, :, inv],
            replicas=self.repl_out.copy(),
            segment=out["segment"][:, :, inv],
            trace_idx=self.trace_out.copy(),
            attempts=out["attempts"][:, :, inv],
            failed=out["failed"][:, :, inv],
            abandoned=out["abandoned"],
            fault_idx=np.zeros(self.S, dtype=np.int64),
            queue_wait=out["queue_wait"][:, :, inv],
            cold=out["cold"][:, :, inv])


def _to_device(args: Dict[str, np.ndarray],
               device: torch.device) -> Dict[str, torch.Tensor]:
    """Move engine args to ``device``: bool stays bool, floats are float64."""
    out = {}
    for name, x in args.items():
        x = np.ascontiguousarray(x, dtype=bool if x.dtype == bool
                                 else np.float64)
        out[name] = torch.from_numpy(x).to(device)
    return out


def _finalize(task: _Task, out: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Host-side canonical reductions of the engine's per-job outputs.

    Scalar fields (makespan, cost_usd, the offload counters) reduce over
    the canonical job order in numpy, never as a parallel device sum.
    """
    out["makespan"] = out["completion"].max(axis=1) - task.t0
    locpub = out["public_mask"]
    out["cost_usd"] = out.pop("cost_j").sum(axis=1)
    out["n_offloaded_stages"] = locpub.sum(axis=(1, 2))
    out["n_init_offloaded_jobs"] = out.pop("init_off").sum(axis=1)
    out["per_stage_offloads"] = locpub.sum(axis=1)
    return out


#: most recent sweep's wall-time split (host prep, engine, finalize), the
#: body steps each stage's event loop took per engine call, and the device;
#: observability for ``chip_smoke.py``, not part of the result API
_LAST_RUN_STATS: Dict[str, object] = {}


def simulate_scenarios(
    dag: AppDAG,
    pred: Dict[str, np.ndarray],
    act: Optional[Dict[str, np.ndarray]] = None,
    c_max_grid: Sequence[float] = (60.0,),
    orders: Sequence[str] = ("spt",),
    cost_model: CostModel = LAMBDA_COST,
    include_transfers: bool = True,
    init_phase: bool = True,
    adaptive: bool = True,
    t0: float = 0.0,
    engine: str = "vector",
    portfolio: Optional[ProviderPortfolio] = None,
    arrivals: ArrivalsLike = None,
    replicas=None,
    replica_speeds=None,
    price_traces=None,
    faults=None,
    retry=None,
    init_window: Optional[float] = None,
    chunk_jobs: Optional[int] = None,
    egress_lookahead: bool = False,
    workload=None,
    concurrency=None,
    coldstart=None,
    pool_trace=None,
    engine_impl: Optional[str] = None,
    offload_mask: Optional[np.ndarray] = None,
    device=None,
) -> VectorSimResult:
    """Run Alg. 1 over a whole scenario grid in one batched call.

    ``pred``/``act`` values are [J, M] (shared) or [B, J, M] (a batch of
    latency draws); the scenario axis enumerates ``batch x orders x
    c_max_grid x replicas x replica_speeds x price_traces`` in C order.
    ``portfolio`` generalizes the public cloud to N providers,
    ``arrivals`` injects an exogenous release stream shared by every
    scenario (``None`` is the batch at ``t0``), ``replicas`` is an
    autoscaling axis of per-stage count vectors, ``replica_speeds`` a
    straggler axis of ``{(stage, replica): factor}`` dicts or [M, I]
    arrays, and ``price_traces`` a pricing axis of portfolio variants.

    ``engine="vector"`` (the default) runs the batched torch engine on
    ``device`` (``"cuda"`` unless given; a CPU run must pass
    ``device="cpu"``). ``engine="des"`` replays the grid serially through
    the reference simulator (:func:`.simulator.simulate`), which also
    accepts the per-call options this engine does not port yet
    (``init_window``, ``chunk_jobs``, ``egress_lookahead``,
    ``concurrency``, ``coldstart``, ``pool_trace``, ``offload_mask``);
    the vector engine raises ``NotImplementedError`` for them. The
    ``faults`` axis (with ``retry``) and ``workload`` specs raise in
    both engines.
    """
    from .simulator import _with_transfer_defaults, simulate

    resolve_engine_impl(engine_impl)  # fail fast on bad impl, any engine
    _reject_unported(workload=workload, faults=faults, retry=retry)
    if engine == "des":
        # same load-config validation as the reference's grid path (the
        # replicas-axis x pool_trace exclusion is a grid-level check)
        validate_load_kwargs(
            np.isfinite(norm_concurrency(
                concurrency, as_portfolio(portfolio, cost_model))).any(),
            as_coldstart(coldstart), as_pool_trace(pool_trace),
            faulty=False, chunk_jobs=chunk_jobs,
            replicas_axis=replicas is not None)
        act_d = act if act is not None else pred
        _validate_workload_axes(pred, act_d)
        pred_d = _with_transfer_defaults(pred)
        act_d = _with_transfer_defaults(act_d)
        B = max([v.shape[0] if np.asarray(v).ndim == 3 else 1
                 for v in list(pred_d.values()) + list(act_d.values())]
                or [1])
        pred_d = _norm_batch(pred_d, B)
        act_d = _norm_batch(act_d, B)
        J = pred_d["P_private"].shape[1]
        release = resolve_release(arrivals, J, t0)
        repl_cfgs = _norm_replica_axis(replicas, dag)
        I_max = _max_replica_bound(dag,
                                   None if replicas is None else repl_cfgs)
        speed_cfgs = _norm_speed_axis(replica_speeds, dag.num_stages, I_max)
        trace_cfgs = _norm_trace_axis(price_traces,
                                      as_portfolio(portfolio, cost_model))
        dags = [dag if replicas is None else dag.with_replicas(cfg)
                for cfg in repl_cfgs]
        slow = [{(k, i): float(sp[k, i])
                 for k in range(dag.num_stages) for i in range(I_max)
                 if sp[k, i] != 1.0} or None
                for sp in speed_cfgs]
        grid = [(b, o, float(c), r, g, tr)
                for b in range(B) for o in orders for c in c_max_grid
                for r in range(len(repl_cfgs))
                for g in range(len(speed_cfgs))
                for tr in range(len(trace_cfgs))]
        sims = [simulate(dags[r], {k: v[b] for k, v in pred_d.items()},
                         {k: v[b] for k, v in act_d.items()},
                         c_max=c, order=o, cost_model=cost_model,
                         include_transfers=include_transfers,
                         init_phase=init_phase, adaptive=adaptive, t0=t0,
                         portfolio=trace_cfgs[tr], arrivals=release,
                         replica_slowdown=slow[g],
                         init_window=init_window,
                         chunk_jobs=chunk_jobs,
                         egress_lookahead=egress_lookahead,
                         concurrency=concurrency, coldstart=coldstart,
                         pool_trace=pool_trace, offload_mask=offload_mask)
                for (b, o, c, r, g, tr) in grid]
        return VectorSimResult(
            makespan=np.array([r.makespan for r in sims]),
            cost_usd=np.array([r.cost_usd for r in sims]),
            public_mask=np.stack([r.public_mask for r in sims]),
            start=np.stack([r.start for r in sims]),
            end=np.stack([r.end for r in sims]),
            completion=np.stack([r.completion for r in sims]),
            n_offloaded_stages=np.array([r.n_offloaded_stages for r in sims]),
            n_init_offloaded_jobs=np.array(
                [r.n_init_offloaded_jobs for r in sims]),
            per_stage_offloads=np.stack([r.per_stage_offloads for r in sims]),
            provider=np.stack([r.provider for r in sims]),
            deadline=np.array([r.deadline for r in sims]),
            orders=tuple(o for (_, o, _, _, _, _) in grid),
            c_max=np.array([c for (_, _, c, _, _, _) in grid]),
            batch_idx=np.array([b for (b, _, _, _, _, _) in grid]),
            release=None if release is None
            else np.broadcast_to(release, (len(grid), J)).copy(),
            replica=np.stack([r.replica for r in sims]),
            replicas=np.stack(
                [repl_cfgs[r] for (_, _, _, r, _, _) in grid]),
            segment=np.stack([r.segment for r in sims]),
            trace_idx=np.array([tr for (_, _, _, _, _, tr) in grid]),
            attempts=np.stack([r.attempts for r in sims]),
            failed=np.stack([r.failed for r in sims]),
            abandoned=np.stack([r.abandoned for r in sims]),
            fault_idx=np.zeros(len(grid), dtype=np.int64),
            queue_wait=np.stack([r.queue_wait for r in sims]),
            cold=np.stack([r.cold for r in sims]))
    if engine != "vector":
        raise ValueError(f"unknown engine {engine!r}")
    _reject_unported(init_window=init_window, chunk_jobs=chunk_jobs,
                     egress_lookahead=egress_lookahead,
                     concurrency=concurrency, coldstart=coldstart,
                     pool_trace=pool_trace, offload_mask=offload_mask)
    return sweep_scenarios(
        [dict(dag=dag, pred=pred, act=act, c_max_grid=c_max_grid,
              orders=orders, arrivals=arrivals, replicas=replicas,
              replica_speeds=replica_speeds, price_traces=price_traces)],
        cost_model=cost_model, include_transfers=include_transfers,
        init_phase=init_phase, adaptive=adaptive, t0=t0,
        portfolio=portfolio, engine_impl=engine_impl, device=device)[0]


_TASK_KEYS = {"dag", "pred", "act", "c_max_grid", "orders", "arrivals",
              "replicas", "replica_speeds", "price_traces", "name"}


def sweep_scenarios(
    tasks: Sequence[Dict],
    cost_model: CostModel = LAMBDA_COST,
    include_transfers: bool = True,
    init_phase: bool = True,
    adaptive: bool = True,
    t0: float = 0.0,
    engine: str = "vector",
    portfolio: Optional[ProviderPortfolio] = None,
    engine_impl: Optional[str] = None,
    device=None,
    **unported,
) -> List[VectorSimResult]:
    """Run several scenario grids — e.g. a whole Fig.-4 figure, one task per
    application — as one batched sweep.

    Each task is a dict with keys ``dag``, ``pred``, optional ``act``,
    ``c_max_grid``, ``orders``, ``arrivals``, ``replicas``,
    ``replica_speeds`` and ``price_traces`` (the axes of
    :func:`simulate_scenarios`); results come back in task order. Every
    task pads to the sweep's common stage count (inert stages), replica
    bound (absent slots) and segment bound (segments that never
    activate); tasks with a common job count run as one batched engine
    call on ``device`` (``"cuda"`` unless given). ``engine="des"`` replays
    each task through :func:`simulate_scenarios` with ``engine="des"``.
    Options this engine does not port yet raise ``NotImplementedError``.
    """
    _reject_unported(**{k: v for k, v in unported.items()
                        if k in _UNPORTED})
    extra = set(unported) - set(_UNPORTED)
    if extra:
        raise TypeError(f"sweep_scenarios: unexpected keyword(s) "
                        f"{sorted(extra)}")
    for i, t in enumerate(tasks):
        # a per-task flag is unported whatever its value: False would
        # otherwise be dropped silently
        _reject_unported(where=f"tasks[{i}]",
                         **{k: True for k in t
                            if k in _UNPORTED and t[k] is not None})
        bad = set(t) - _TASK_KEYS - set(_UNPORTED)
        if bad:
            raise ValueError(f"tasks[{i}]: unknown task keys {sorted(bad)}")
    if engine == "des":
        return [simulate_scenarios(
            t["dag"], t.get("pred"), t.get("act"),
            t.get("c_max_grid", (60.0,)), t.get("orders", ("spt",)),
            cost_model=cost_model, include_transfers=include_transfers,
            init_phase=init_phase, adaptive=adaptive, t0=t0, engine="des",
            portfolio=portfolio, arrivals=t.get("arrivals"),
            replicas=t.get("replicas"),
            replica_speeds=t.get("replica_speeds"),
            price_traces=t.get("price_traces"))
            for t in tasks]
    if engine != "vector":
        raise ValueError(f"unknown engine {engine!r}")
    if t0 < 0:
        # the engine sign-encodes eviction times as -t - 1, so the clock
        # must stay non-negative (the DES has no such restriction)
        raise ValueError("engine='vector' requires t0 >= 0")
    impl = resolve_engine_impl(engine_impl)
    dev = resolve_device(device)
    _LAST_RUN_STATS.clear()
    t_prep = time.perf_counter()
    M_pad = max(t["dag"].num_stages for t in tasks)
    base_pf = as_portfolio(portfolio, cost_model)
    tasks = [dict(t) for t in tasks]
    for i, t in enumerate(tasks):
        if t.get("replicas") is not None:
            t["replicas"] = _norm_replica_axis(t["replicas"], t["dag"],
                                               where=f"tasks[{i}]")
        t["price_traces"] = _norm_trace_axis(t.get("price_traces"), base_pf,
                                             where=f"tasks[{i}]")
    I_max = max(_max_replica_bound(t["dag"], t.get("replicas"))
                for t in tasks)
    S_seg = max(_max_segment_bound(t["price_traces"]) for t in tasks)
    prepped = [_Task(t["dag"], t["pred"], t.get("act"),
                     t.get("c_max_grid", (60.0,)),
                     t.get("orders", ("spt",)), cost_model, t0, M_pad,
                     I_max=I_max, portfolio=portfolio,
                     include_transfers=bool(include_transfers),
                     arrivals=t.get("arrivals"),
                     replicas=t.get("replicas"),
                     replica_speeds=t.get("replica_speeds"),
                     price_traces=t["price_traces"], S_seg=S_seg,
                     where=f"tasks[{i}]")
               for i, t in enumerate(tasks)]
    _LAST_RUN_STATS.update(prep_s=time.perf_counter() - t_prep, impl=impl,
                           device=str(dev), engine_s=0.0, finalize_s=0.0,
                           trips=[])

    results: List[Optional[VectorSimResult]] = [None] * len(prepped)
    # tasks of one job count share a shape family and run as one call
    # (the scenario lanes are independent, so the split is result-
    # invariant); empty tasks need no engine at all
    groups: Dict[int, List[int]] = {}
    for i, p in enumerate(prepped):
        if p.J == 0:
            results[i] = _empty_result(p)
        else:
            groups.setdefault(p.J, []).append(i)
    init_mode = 1 if init_phase else 0
    for grp in groups.values():
        ps = [prepped[i] for i in grp]
        t_run = time.perf_counter()
        fused = {name: np.concatenate([p.args[name] for p in ps])
                 for name in ps[0].args}
        trips: List[int] = []
        with torch.no_grad():
            out_t = _run_engine(_to_device(fused, dev),
                                bool(include_transfers), init_mode,
                                bool(adaptive), float(t0), trips)
            out = {k: v.cpu().numpy() for k, v in out_t.items()}
        t_done = time.perf_counter()
        lo = 0
        for i, p in zip(grp, ps):
            sub = {k: v[lo:lo + p.S] for k, v in out.items()}
            results[i] = p.pack(_finalize(p, sub))
            lo += p.S
        _LAST_RUN_STATS["engine_s"] += t_done - t_run
        _LAST_RUN_STATS["finalize_s"] += time.perf_counter() - t_done
        _LAST_RUN_STATS["trips"].append(trips)
    return results


def _empty_result(p: _Task) -> VectorSimResult:
    """The result of a task with no jobs."""
    z2, z3 = np.zeros((p.S, 0)), np.zeros((p.S, 0, p.M))
    return VectorSimResult(
        makespan=np.zeros(p.S), cost_usd=np.zeros(p.S),
        public_mask=np.zeros((p.S, 0, p.M), dtype=bool),
        start=z3, end=z3, completion=z2,
        n_offloaded_stages=np.zeros(p.S, dtype=np.int64),
        n_init_offloaded_jobs=np.zeros(p.S, dtype=np.int64),
        per_stage_offloads=np.zeros((p.S, p.M), dtype=np.int64),
        provider=np.full((p.S, 0, p.M), -1, dtype=np.int64),
        deadline=p.c_max_out.copy(), orders=p.orders_out,
        c_max=p.c_max_out, batch_idx=p.batch_out,
        release=None if p.release is None else np.zeros((p.S, 0)),
        replica=np.full((p.S, 0, p.M), -1, dtype=np.int64),
        replicas=p.repl_out.copy(),
        segment=np.full((p.S, 0, p.M), -1, dtype=np.int64),
        trace_idx=p.trace_out.copy(),
        attempts=np.zeros((p.S, 0, p.M), dtype=np.int64),
        failed=np.zeros((p.S, 0, p.M), dtype=np.int64),
        abandoned=np.zeros((p.S, 0), dtype=bool),
        fault_idx=np.zeros(p.S, dtype=np.int64),
        queue_wait=np.zeros((p.S, 0, p.M)),
        cold=np.zeros((p.S, 0, p.M), dtype=bool))
