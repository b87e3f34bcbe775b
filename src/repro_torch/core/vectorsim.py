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
a Python loop whose body steps every scenario in lockstep. The body has
three bit-exact implementations, the reference's twins
(``engine_impl=``, :data:`ENGINE_IMPLS`):

* ``"kernel"`` (the default; the reference's ``"pallas"``) commits the
  whole event batch at each scenario's current instant: the ACD eviction
  cascade in one call of the ``acd_evict`` kernel (the greedy kept-prefix
  recurrence, sequential within a queue row), through
  :func:`repro_torch.kernels.ops.acd_evict` — the CUDA kernel on the
  card, its plain PyTorch version on the CPU; the same-instant dispatch
  batch, queue rank ``r`` taking the ``r``-th lowest free replica through
  a one-hot ``[J, I]`` match matrix (one value plus exact zeros per
  product, so the float64 ``bmm`` is exact); and a speculative arrival
  fast-forward that rewinds when the sweep at the jump target is dirty.
* ``"scan"`` is the same batched body with the cascade written in array
  operations: each step evicts the certain set (every violator that still
  violates with the earlier violators' demand taken out) and defers the
  dispatch batch one step while a violator survives the round.
* ``"loop"`` commits one queue exit per scenario a step (the first
  violator, else the queue head onto the lowest free replica).

A finished scenario's body is a fixed point (an empty queue commits
nothing), so the loop runs until every scenario is done, capped at
``4 * J + 16`` body steps per stage. The twins run no kernel: under caps
their dispatch chain is their own lockstep loop over chain positions,
where ``"kernel"`` launches ``fifo_dispatch``. Forced-public jobs
(initialization offload and eviction cascades) never enter a queue: their
start/end times are closed forms of their arrival times, as are cost and
completion.

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
the ACD recurrence lives in the kernel; the twins' two demand prefixes
(the queue's and the violators') run on the host through
:func:`_acd_twin` — ``torch.cumsum`` on CPU tensors sums a row left to
right, while on CUDA it is a block scan, so a sweep on the card copies
the operands down and the masks back once a body step; the
initialization-offload prefix runs on the host in numpy, and the scalar
totals reduce on the host in :func:`_finalize`. Integer rank prefixes
are exact anywhere and stay on the device. Sorts are stable, argmins and
argmaxes take the first index.

:func:`sweep_scenarios` memoizes its host preparation (the normalized
:class:`_Task` bundles, never a device tensor) for up to
``_PREP_CACHE_MAX`` recent grids, keyed by a structural fingerprint of
its inputs (:func:`_prep_fp`).

Load-dependent latency (:mod:`.coldstart`) grows the same body:
concurrency caps replay each stage's public dispatches through per-
provider FIFO slot pools in one call of the ``fifo_dispatch`` kernel (the
chain is sequential within a scenario row); cold starts carry per-slot
idle stamps through the private event loop; a pool trace masks each
private slot by its [on, off) window.

The reference engine's other options run here too: a fault axis (an
unrolled attempt chain per offloaded stage), job paging (``chunk_jobs``:
release-ordered pages with the per-replica clocks carried across them
and a safety check that grows a page whose work overlaps the next
page's releases), trace-derived ``workload`` specs, the
``egress_lookahead`` placement term, ``init_window``, externally
supplied offload plans and per-task ``init_phase``/``adaptive`` flags.
"""
from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .arrivals import ArrivalsLike, resolve_release
from .coldstart import (as_coldstart, as_pool_trace, norm_concurrency,
                        validate_load_kwargs)
from .cost import (CostModel, EGRESS_GB_PER_S, LAMBDA_COST, PriceTrace,
                   ProviderPortfolio, as_portfolio)
from .dag import AppDAG
from .faults import RetryPolicy, max_outage_slots, normalize_fault_axis
from .greedy import init_offload_torch
from .priority import ORDERS
from ..kernels import ops as _kernel_ops

#: Inner-loop implementations of this engine, bit-exact twins:
#:   "loop"   — one queue exit per scenario a body step
#:   "scan"   — the batched body, the ACD cascade's certain set in array
#:              operations
#:   "kernel" — the batched body through the ``acd_evict`` and
#:              ``fifo_dispatch`` kernels (the reference's "pallas")
#: "kernel" is the default on every device: on the card it is the path
#: that runs the two hand-written kernels, and the twins, which run none,
#: are the equivalence twins they are held against. Only an explicit
#: ``engine_impl=`` picks a twin; no environment variable does.
ENGINE_IMPLS = ("loop", "scan", "kernel")


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
    """Resolve an ``engine_impl=`` argument: ``None`` is "kernel"."""
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


def _acd_round(contrib: torch.Tensor, thresh: torch.Tensor,
               m: torch.Tensor, certain: bool) -> torch.Tensor:
    """The twins' ACD sweep over CPU queue rows [B, J]: ``contrib`` the
    queued jobs' demand (0.0 elsewhere), ``thresh`` the thresholds, ``m``
    the jobs the sweep may evict. ``torch.cumsum`` of a CPU row sums left
    to right, as the DES does. Returns [1, B, J] violators (``certain``
    False, the loop twin), or [2, B, J] the certain set and the violators
    that survive it (the scan twin)."""
    prefix_excl = torch.cumsum(contrib, 1) - contrib
    viol = m & (prefix_excl > thresh)
    if not certain:
        return viol[None]
    # a violator that still violates with every earlier violator's demand
    # taken out is in the final evict set; the first one always is
    vc = torch.where(viol, contrib, torch.zeros((), dtype=contrib.dtype))
    vprev = torch.cumsum(vc, 1) - vc
    evict_now = viol & (prefix_excl - vprev > thresh)
    return torch.stack([evict_now, viol & ~evict_now])


def _acd_twin(P_q: torch.Tensor, q1: torch.Tensor, m: torch.Tensor,
              thresh: torch.Tensor, certain: bool) -> torch.Tensor:
    """:func:`_acd_round` for rows on any device. On CUDA, where
    ``torch.cumsum`` is a block scan, the operands go to the host as one
    float64 block and the masks come back as one: the prefixes stay
    sequential."""
    contrib = torch.where(q1, P_q, torch.zeros((), dtype=P_q.dtype,
                                               device=P_q.device))
    if contrib.device.type == "cpu":
        return _acd_round(contrib, thresh, m, certain)
    host = torch.stack([contrib, thresh, m.to(contrib.dtype)]).cpu()
    return _acd_round(host[0], host[1], host[2] > 0.5,
                      certain).to(contrib.device)


def _run_stage(a, elig, speed_k, clock0_k, acd_k, P_k, rem_k, dur_k,
               keys_k, deadline, t0: float, adaptive: bool,
               trips: List[int], off_k=None, csd=None,
               impl: str = "kernel"):
    """Run one stage's event loop for every scenario in lockstep.

    ``a`` [B, J] per-job arrival times, ``elig`` [B, J] queue membership,
    ``speed_k``/``clock0_k`` [B, I] the replica pool (inf = absent slot)
    and its starting clocks, ``acd_k`` [B] whether the stage runs the ACD
    sweep, ``P_k``/``rem_k``/``dur_k``/``keys_k`` [B, J] predicted demand,
    critical-path remainder, actual duration and priority key,
    ``deadline`` [B, J] absolute deadlines.

    ``off_k`` [B, I] (pool traces) holds each slot's turn-off instant: a
    slot takes dispatches only while ``t < off``, but a retired slot's
    completion still counts as a sweep instant. ``csd`` (cold starts) is
    the private ``(warm_up, keep_alive, scale_to_zero)``: a dispatch onto
    a slot idle longer than the keep-alive window (or never used, under
    scale-to-zero) pays the warm-up before its run, unscaled by the slot's
    speed.

    Returns (times, replica, clocks, cold): ``times`` holds, in job
    coordinates, the dispatch instant of private jobs and ``-(eviction
    instant) - 1`` of evicted ones (NaN = never exited; this encoding
    needs ``t0 >= 0``), ``replica`` the slot each private job took,
    ``clocks`` [B, I] each slot's final busy-until instant (the carry
    between pages), ``cold`` whether a private dispatch paid the warm-up
    (all False without ``csd``). Appends the number of body steps to
    ``trips``. ``impl`` picks the body (:data:`ENGINE_IMPLS`).
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
    if csd is not None:
        wu_priv, ka, s2z = csd
        # idle-since per slot: the turn-on instant (clock0 covers late
        # pool slots), -inf = never used under scale-to-zero
        idle = (torch.full_like(clock0_k, float("-inf")) if s2z
                else clock0_k.clone())
        coldq = torch.zeros((B, J), dtype=torch.bool, device=dev)
    times = torch.full((B, J), float("nan"), dtype=torch.float64, device=dev)
    rep = torch.full((B, J), -1, dtype=torch.int32, device=dev)
    t = torch.full((B,), float(t0), dtype=torch.float64, device=dev)
    clean = torch.zeros(B, dtype=torch.bool, device=dev)
    nq = ap > 0
    cap = 4 * J + 16
    step = 0
    if impl == "loop":
        # the "loop" twin: one event a body step per scenario row. A row
        # admits the arrivals tied at its next instant, sweeps the ACD
        # prefix, then evicts its first violator or, with none, dispatches
        # its queue head onto the lowest free slot: at most one queue
        # exit, written through a one-hot select. ``clean`` holds time at
        # the instant until a sweep finds no violator.
        iota_J = torch.arange(J, device=dev)
        no_viol = torch.zeros(B, dtype=torch.bool, device=dev)
        while step < cap:
            exited = ~torch.isnan(times)
            nq = ((arr_rank < ap[:, None]) & ~exited).any(1)
            # the loop guard reduces the queue again every step
            if not bool(((ap < n_arr) | nq).any()):
                break
            step += 1
            done = (ap >= n_arr) & ~nq
            t_arr = arr_t.gather(1, ap[:, None])[:, 0]
            # next event: the arrival, or a dispatch opportunity (t while a
            # slot is free, else the earliest completion)
            tc = t[:, None]
            next_comp = torch.where(svr > tc, svr, inf).amin(1)
            if off_k is not None:
                free_t = ((svr <= tc) & (tc < off_k)).any(1)
            else:
                free_t = (svr <= tc).any(1)
            td = torch.where(nq, torch.where(free_t, t, next_comp), inf)
            advance = clean & ~done
            is_arr = advance & (t_arr <= td)
            t_new = torch.where(advance, torch.minimum(t_arr, td), t)
            ap = torch.where(is_arr, (arr_t <= t_new[:, None]).sum(1), ap)
            q1 = (arr_rank < ap[:, None]) & ~exited
            # the first violator if any, else the queue head, by one priority
            # argmax (the first index wins)
            prio = q1.to(torch.int32)
            if adaptive:
                thresh = base_c - I_k * t_new[:, None]
                viol = _acd_twin(P_q, q1, q1 & acd_m, thresh, certain=False)[0]
                has_viol = viol.any(1)
                prio = prio + 2 * viol.to(torch.int32)
            else:
                has_viol = no_viol
            pos_x = torch.argmax(prio, dim=1)
            tn = t_new[:, None]
            free_new = svr <= tn
            if off_k is not None:
                free_new = free_new & (tn < off_k)
            do_disp = ~has_viol & ~done & (nq | is_arr) & free_new.any(1)
            sidx = torch.argmax(free_new.to(torch.int32), dim=1)  # lowest free
            hit = iota_J == torch.where(has_viol | do_disp, pos_x, J)[:, None]
            times = torch.where(hit, torch.where(has_viol, -t_new - 1.0,
                                                 t_new)[:, None], times)
            disp_j = hit & do_disp[:, None]
            rep = torch.where(disp_j, sidx.to(torch.int32)[:, None], rep)
            # the dispatched job runs dur * the chosen slot's speed
            dur_x = dur_q.gather(1, pos_x[:, None])[:, 0]
            speed_x = speed_k.gather(1, sidx[:, None])[:, 0]
            slot = do_disp[:, None] & (iota_I == sidx[:, None])
            if csd is not None:
                wu_priv, ka, _ = csd
                idle_x = idle.gather(1, sidx[:, None])[:, 0]
                is_cold = do_disp & ((t_new - idle_x > ka)
                                     | torch.isneginf(idle_x))
                svr_new = ((t_new + torch.where(is_cold, wu_priv, zero))
                           + dur_x * speed_x)
                coldq = torch.where(disp_j, is_cold[:, None], coldq)
                idle = torch.where(slot, svr_new[:, None], idle)
            else:
                svr_new = t_new + dur_x * speed_x
            svr = torch.where(slot, svr_new[:, None], svr)
            clean = ~has_viol
            t = t_new
        return _stage_out(times, rep, svr,
                          coldq if csd is not None else None, inv, step,
                          trips)
    while step < cap and bool(((ap < n_arr) | nq).any()):
        step += 1
        exited = ~torch.isnan(times)
        done = (ap >= n_arr) & ~nq
        t_arr = arr_t.gather(1, ap[:, None])[:, 0]
        # "t if any replica is free, else the next completion": free slots
        # clamp to t, busy slots keep their clock, absent slots stay inf
        # (a retired pool slot offers no dispatch, but its completion
        # still sweeps)
        tc = t[:, None]
        if off_k is not None:
            td_core = torch.where((svr <= tc) & (tc < off_k), tc,
                                  torch.where(svr > tc, svr, inf)).amin(1)
        else:
            td_core = torch.maximum(svr, tc).amin(1)
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
        leftover = None
        if adaptive:
            thresh = base_c - I_k * t_new[:, None]
            if impl == "kernel":
                # the whole greedy evict set in one kernel call, so the
                # cascade is always complete this step
                evict_now = _kernel_ops.acd_evict(P_q, thresh, q1 & acd_m)
            else:
                # the certain set; a violator surviving the round defers
                # the dispatch batch one step (the re-sweep at the same
                # instant sees the smaller prefix: same exits, same times)
                evict_now, leftover = _acd_twin(P_q, q1, q1 & acd_m, thresh,
                                                certain=True)
            has_viol = evict_now.any(1)
            dirty = spec & (t_arr < t_new) & has_viol
            evict_now = evict_now & ~dirty[:, None]
            t_new = torch.where(dirty, t_arr, t_new)
            ap = torch.where(dirty, ap_arr, ap)
        else:
            evict_now = torch.zeros_like(q1)
        q2 = q1 & ~evict_now
        free_new = svr <= t_new[:, None]
        if off_k is not None:
            free_new = free_new & (t_new[:, None] < off_k)
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
        if csd is not None:
            # per-slot coldness first, carried to the job row through the
            # match product (one 1.0 or exact 0.0 per row)
            cold_i = ((t_new[:, None] - idle > ka)
                      | torch.isneginf(idle)).to(torch.float64)
            is_cold_j = disp0 & (torch.bmm(mf, cold_i[:, :, None])[:, :, 0]
                                 > 0.5)
            wu_eff_j = torch.where(is_cold_j, wu_priv, zero)
            svr_new_j = (t_new[:, None] + wu_eff_j) + dur_q * speed_j
        else:
            svr_new_j = t_new[:, None] + dur_q * speed_j
        stuck = disp0 & (svr_new_j <= t_new[:, None])
        fs = torch.where(stuck, qrank, J)
        if leftover is not None:
            # -1: an incomplete cascade commits no dispatch this step
            fs = torch.where(leftover, -1, fs)
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
        if csd is not None:
            coldq = torch.where(disp, is_cold_j, coldq)
            idle = torch.where(taken, slot_val, idle)
        nq = n_q2 > n_disp
        clean = ~has2
        t = t_new
    return _stage_out(times, rep, svr, coldq if csd is not None else None,
                      inv, step, trips)


def _stage_out(times, rep, svr, coldq, inv, step: int, trips: List[int]):
    """A stage loop's result in job coordinates; records its body steps."""
    trips.append(step)
    cold_j = (coldq.gather(1, inv) if coldq is not None
              else torch.zeros_like(times, dtype=torch.bool))
    return times.gather(1, inv), rep.gather(1, inv), svr, cold_j


def _lexsort(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """Row-wise ``jnp.lexsort`` of [B, J] keys: the last key is the primary
    one, ties fall through to the earlier keys and then to the column
    index. Stable argsorts from the least significant key up, each
    gathered through the permutation so far."""
    perm = torch.argsort(keys[0], dim=1, stable=True)
    for key in keys[1:]:
        perm = perm.gather(1, torch.argsort(key.gather(1, perm), dim=1,
                                            stable=True))
    return perm


def _run_engine(a: Dict[str, torch.Tensor], include_transfers: bool,
                init_mode: int, adaptive: bool, t0: float,
                trips: List[int],
                load: Optional["_LoadConfig"] = None,
                lookahead: bool = False,
                impl: str = "kernel") -> Dict[str, torch.Tensor]:
    """Run every scenario of one shape family; ``a`` holds the [B, ...]
    engine tensors built by :class:`_Task` (stages in topological order,
    padded to the family's stage count).

    ``init_mode`` 0 runs no initialization offload, 1 resolves the
    capacity-prefix rule over the jobs ``init_elig`` admits, and 2 takes
    ``init_elig`` as the resolved plan (an ``offload_mask``, or a page of
    the plan resolved over the whole job axis). ``load`` carries the call's concurrency caps, cold-start
    model and pool-trace flag (``None`` when none is set); ``a`` then also
    holds the occupancy rates ``occ`` under caps and the slot turn-off
    instants ``off_pool`` under a pool trace. With a fault axis ``a``
    holds the grids ``fail_g``/``delay_g`` [B, J, M, A], the outage
    windows ``outw`` [B, P, W, 2] and the per-scenario ``kill_frac``,
    ``okill`` and ``fb_on``; each offloaded stage then runs an attempt
    chain of A slots (:func:`_attempt_chain`). ``lookahead`` adds the
    one-edge downstream egress term to the placement argmin. ``impl``
    picks the stage body and the capped dispatch chain
    (:data:`ENGINE_IMPLS`).

    Besides the result fields, returns ``qexit`` [B, J, M] (each stage's
    sign-encoded queue exits, for the pager's safety check) and
    ``clocks`` [B, M, I] (each stage's final slot clocks, the pager's
    carry).
    """
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
    P, S_seg = sel_ps.shape[1], sel_ps.shape[2]
    dev = P_pred.device
    f64 = torch.float64
    inf = torch.tensor(float("inf"), dtype=f64, device=dev)
    nan = torch.tensor(float("nan"), dtype=f64, device=dev)
    zero = torch.zeros((), dtype=f64, device=dev)
    faulty = "fail_g" in a
    capped = load is not None and load.capped
    cold = load is not None and load.cold
    csd = (load.warm_up_s, load.keep_alive_s, load.scale_to_zero) \
        if cold else None
    if capped:
        capped_p = torch.from_numpy(np.isfinite(load.caps)).to(dev)
        wu_p = torch.from_numpy(load.provider_warm_ups).to(dev)
        # slot c of provider p exists iff c < its cap; uncapped providers
        # keep all-inf slots (their argmin is 0, their wait forced to 0)
        present = np.isfinite(load.caps)[:, None] & (
            np.arange(load.C)[None, :] < load.caps[:, None])
        sclk0 = torch.from_numpy(np.where(present, t0, np.inf)).to(dev)
        if cold:
            sidle0 = torch.from_numpy(np.where(
                present, -np.inf if load.scale_to_zero else t0,
                np.inf)).to(dev)
        else:
            sidle0 = sclk0
        sclk0 = sclk0.expand(B, P, load.C).contiguous()
        sidle0 = sidle0.expand(B, P, load.C).contiguous()
        iota_J = torch.arange(J, device=dev).expand(B, J)

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
        # jobs outside init_elig (init_window) bring no demand and are
        # never marked
        off = _init_offload(P_pred, a["job_keys"], a["capacity"],
                            a["init_elig"])
    elif init_mode == 2:
        off = a["init_elig"]
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
    qwait_l: List[torch.Tensor] = []
    coldm_l: List[torch.Tensor] = []
    qexit_l: List[torch.Tensor] = []
    clocks_l: List[torch.Tensor] = []
    att_l: List[torch.Tensor] = []
    failc_l: List[torch.Tensor] = []
    xeg_j = torch.zeros((B, J), dtype=f64, device=dev)
    # lost work of failed attempts and abandonment, per job (faults only)
    lost_j = torch.zeros((B, J), dtype=f64, device=dev)
    ab_j = torch.zeros((B, J), dtype=torch.bool, device=dev)
    iota_P = torch.arange(P, device=dev)
    for k in range(M):
        # source stages arrive at the job's release time; downstream stages
        # whenever their predecessors finish (an abandoned predecessor's
        # +inf end makes the job dead here)
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
        if faulty:
            # dead jobs (abandoned upstream) never enter a queue
            elig = elig & torch.isfinite(arr)
        times_j, rep_j, svr_k, coldq = _run_stage(
            arr, elig, speed[:, k], clock0[:, k], ~pinned[:, k],
            P_pred[:, :, k], rem_l[k], act_priv[:, :, k],
            a["stage_keys"][:, :, k], deadline, t0, adaptive, trips,
            off_k=a["off_pool"][:, k] if load is not None and load.pooled
            else None, csd=csd, impl=impl)
        qexit_l.append(times_j)
        clocks_l.append(svr_k)
        evicted = times_j < -0.5  # NaN (never exited) compares False
        locpub = forced_k | evicted
        # decision-epoch pricing: the offload epoch is the arrival time when
        # forced public, the eviction instant when ACD-evicted
        tau = torch.where(forced_k, arr, -times_j - 1.0)

        def placement_at(tq, k=k):
            """[B, P, J] selection costs and active segments at epochs
            ``tq``: the provider-affinity penalty one predecessor at a
            time in ascending topological order, then (lookahead) one
            successor term at a time in ascending order, as the DES sums
            them."""
            seg_pj = torch.clamp(
                (edges_ps[:, :, :, None] <= tq[:, None, None, :]).sum(2) - 1,
                min=0)                                           # [B, P, J]
            s = sel_ps[..., k].gather(2, seg_pj[:, :, None, :])[:, :, 0, :]
            if include_transfers:
                for u in range(k):
                    pen_u = torch.where(
                        A[:, u, k, None] & loc_l[u],
                        _gather_ps(eg_ps, prov_l[u], seg_l[u])
                        * dgb_pred[:, :, u], zero)
                    s = s + torch.where(
                        iota_P[None, :, None] != prov_l[u][:, None, :],
                        pen_u[:, None, :], zero)
                if lookahead:
                    # placing stage k on a candidate commits its successor
                    # edges to the candidate's egress rate at the epoch's
                    # segment
                    eg_cand = eg_ps.gather(2, seg_pj)            # [B, P, J]
                    for v in range(k + 1, M):
                        s = s + torch.where(
                            (A[:, k, v] & ~pinned[:, v])[:, None, None],
                            eg_cand * dgb_pred[:, :, k][:, None, :], zero)
            return s, seg_pj

        # upload needed iff some input of stage k lives in private storage
        # (or the stage reads the original private input)
        needs_up = None
        if include_transfers:
            needs_up = torch.zeros((B, J), dtype=torch.bool, device=dev)
            for u in range(k):
                needs_up = needs_up | (A[:, u, k, None] & ~loc_l[u])
            needs_up = torch.where(has_pred[:, None], needs_up, True)
        # private durations run on the assigned replica's speed
        priv_dur = act_priv[:, :, k] * speed[:, k].gather(
            1, torch.clamp(rep_j, min=0).to(torch.int64))
        if faulty:
            (start, end, succ, pidx_k, seg_k, lm, cost_k, att_cnt,
             fail_cnt, ab, lost_j) = _attempt_chain(
                a, k, arr, locpub, tau, times_j, priv_dur, needs_up,
                placement_at, lost_j)
            ab_j = ab_j | ab
            att_l.append(att_cnt)
            failc_l.append(fail_cnt)
            # the stage's public set is its successful placements: they
            # alone bill, move edges and feed the next stages
            locpub = succ
            cost_l.append(cost_k)
        else:
            selc, seg_pj = placement_at(tau)
            if capped:
                # concurrency caps: the stage's public dispatches replay
                # in the DES's event order (offload epoch; forced jobs by
                # job id before evicted ones by queue rank on ties; public
                # jobs first but under "loop", so the chain can stop at
                # n_pub), each taking every provider's earliest free FIFO
                # slot: one fifo_dispatch call for all B rows, or the
                # twins' own lockstep chain
                lm_pj = lat_ps.gather(2, seg_pj)                 # [B, P, J]
                occ_pj = a["occ"][..., k].gather(2, seg_pj)
                up_raw = (torch.where(needs_up, up_a[:, :, k], zero)
                          if include_transfers else
                          torch.zeros((B, J), dtype=f64, device=dev))
                ready_pj = tau[:, None, :] + up_raw[:, None, :] * lm_pj
                dur_pj = pub_a[:, :, k][:, None, :] * lm_pj
                qrank = _inverse_perm(torch.argsort(
                    a["stage_keys"][:, :, k], dim=1, stable=True))
                keys = (torch.where(forced_k, iota_J, qrank),
                        (~forced_k).to(torch.int64),
                        torch.where(locpub, tau, inf))
                if impl != "loop":
                    keys += ((~locpub).to(torch.int64),)
                order_j = _lexsort(keys)
                n_pub = locpub.sum(1)
                ka = load.keep_alive_s if cold else 0.0
                if impl == "kernel":
                    (pidx_k, seg_k, wait_f, coldpub_f, start_pub, end_pub,
                     extra_f) = _kernel_ops.fifo_dispatch(
                        order_j.to(torch.int32), n_pub.to(torch.int32),
                        ready_pj, dur_pj, selc.contiguous(), occ_pj,
                        seg_pj.to(torch.int32), capped_p, wu_p, sclk0,
                        sidle0, ka, cold=cold)
                    pidx_k = pidx_k.to(torch.int64)
                    seg_k = seg_k.to(torch.int64)
                else:
                    # "loop" walks all J positions, "scan" stops at the
                    # largest n_pub (a row past its own meets only
                    # private jobs, which write nothing)
                    (pidx_k, seg_k, wait_f, coldpub_f, start_pub, end_pub,
                     extra_f) = _slot_chain(
                        order_j, J if impl == "loop" else int(n_pub.max()),
                        locpub, ready_pj, dur_pj, selc, occ_pj, seg_pj,
                        capped_p, wu_p, sclk0, sidle0, ka, cold)
            else:
                pidx_k = torch.argmin(selc, dim=1)               # [B, J]
                seg_k = seg_pj.gather(1, pidx_k[:, None, :])[:, 0, :]
            lm = _gather_ps(lat_ps, pidx_k, seg_k)
            cost_k = cost_ps[..., k].reshape(B, -1, J).gather(
                1, (pidx_k * S_seg + seg_k)[:, None, :])[:, 0, :]
            # billed cost and occupancy extra add as one value per (job,
            # stage)
            cost_l.append(cost_k + extra_f if capped else cost_k)
            # private dispatches pay the warm-up the event loop recorded
            # (additive, after the dispatch instant)
            start_priv = (times_j + coldq.to(f64) * load.warm_up_s if cold
                          else times_j)
            if capped:
                start = torch.where(locpub, start_pub, start_priv)
                end = torch.where(locpub, end_pub, start_priv + priv_dur)
                qwait_l.append(wait_f)
                coldm_l.append(coldpub_f | coldq)
            else:
                # an uncapped provider is an unbounded warm fleet
                upk = (torch.where(needs_up, up_a[:, :, k] * lm, zero)
                       if include_transfers else
                       torch.zeros((B, J), dtype=f64, device=dev))
                start = torch.where(locpub, tau + upk, start_priv)
                end = start + torch.where(locpub, pub_a[:, :, k] * lm,
                                          priv_dur)
        if not capped:
            qwait_l.append(torch.zeros((B, J), dtype=f64, device=dev))
            coldm_l.append(coldq)
        down_l.append(down_a[:, :, k] * lm)
        # an edge whose endpoints run public on different providers pays
        # the upstream provider's egress on the un-multiplied edge volume
        if include_transfers:
            for u in range(k):
                moved = (A[:, u, k, None] & loc_l[u] & locpub
                         & (prov_l[u] != pidx_k))
                rate_u = _gather_ps(eg_ps, prov_l[u], seg_l[u])
                xeg_j = xeg_j + torch.where(
                    moved, rate_u * (down_a[:, :, u] * EGRESS_GB_PER_S), zero)
        start_l.append(start)
        end_l.append(end)
        loc_l.append(locpub)
        evict_l.append(evicted)
        prov_l.append(pidx_k)
        seg_l.append(seg_k)
        rep_l.append(torch.where(forced_k | evicted, -1, rep_j))

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
    # the cross-provider egress and (faults) the lost work; scalar totals
    # reduce on the host, over the assembled job axis of a paged run too
    cost_j = torch.where(loc_l[0], cost_l[0], zero)
    for k in range(1, M):
        cost_j = cost_j + torch.where(loc_l[k], cost_l[k], zero)
    cost_j = cost_j + xeg_j
    out = dict(cost_j=cost_j, init_off=off,
               qexit=torch.stack(qexit_l, dim=2),
               clocks=torch.stack(clocks_l, dim=1),
               public_mask=locpub, start=start, end=end,
               completion=completion,
               provider=torch.where(locpub, prov_m, -1),
               replica=torch.stack(rep_l, dim=2),
               segment=torch.where(locpub, seg_m, -1),
               attempts=locpub.to(torch.int64),
               failed=torch.zeros((B, J, M), dtype=torch.int64, device=dev),
               abandoned=ab_j,
               queue_wait=torch.stack(qwait_l, dim=2),
               cold=torch.stack(coldm_l, dim=2))
    if faulty:
        # abandoned jobs never complete: NaN completion, NaN stage ends
        out.update(cost_j=cost_j + lost_j,
                   end=torch.where(torch.isinf(end), nan, end),
                   completion=torch.where(ab_j, nan, completion),
                   attempts=torch.stack(att_l, dim=2),
                   failed=torch.stack(failc_l, dim=2))
    return out


def _slot_chain(order, n_steps: int, locpub, ready, dur, selc, occ, seg,
                capped, wu, sclk0, sidle0, keep_alive: float, cold: bool):
    """The twins' capped FIFO public-dispatch chain: chain positions
    ``0 .. n_steps - 1`` of ``order`` [B, J], all B rows in lockstep.

    At each position the row's job takes every provider's earliest-free
    slot of its [P, C] clock pool (first index on ties), waits ``max(0,
    clock - ready)`` on a capped provider, is cold when that slot sat idle
    past ``keep_alive`` (or was never used) under ``cold``, prices
    ``occ * (wait + cold * wu)`` into the provider argmin (first index on
    ties), starts at ``(ready + wait) + cold * wu`` and ends ``dur``
    later; a capped provider's slot then advances its clock and idle stamp
    to the end. A private job's position writes nothing. ``ready``,
    ``dur``, ``selc``, ``occ`` and ``seg`` are [B, P, J], ``capped`` and
    ``wu`` [P], ``sclk0``/``sidle0`` [B, P, C]. Returns (provider,
    segment, wait, cold, start, end, occupancy extra), each [B, J], zeros
    where no position wrote."""
    B, P, J = ready.shape
    dev, f64 = ready.device, ready.dtype
    zero = torch.zeros((), dtype=f64, device=dev)
    iota_J = torch.arange(J, device=dev)
    iota_P = torch.arange(P, device=dev)[None, :, None]
    iota_C = torch.arange(sclk0.shape[2], device=dev)[None, None, :]
    sclk, sidle = sclk0, sidle0
    prov_o = torch.zeros((B, J), dtype=torch.int64, device=dev)
    seg_o = torch.zeros_like(prov_o)
    cold_o = torch.zeros((B, J), dtype=torch.bool, device=dev)
    wait_o = torch.zeros((B, J), dtype=f64, device=dev)
    start_o, end_o, extra_o = (torch.zeros_like(wait_o) for _ in range(3))
    for i in range(n_steps):
        j = order[:, i]
        pub = locpub.gather(1, j[:, None])[:, 0]
        jp = j[:, None, None].expand(B, P, 1)

        def col(x):                                      # [B, P] at job j
            return x.gather(2, jp)[:, :, 0]

        ready_p = col(ready)
        si = torch.argmin(sclk, dim=2)                   # [B, P]
        sc_sel = sclk.gather(2, si[:, :, None])[:, :, 0]
        wait_p = torch.where(capped, torch.maximum(zero, sc_sel - ready_p),
                             zero)
        if cold:
            idle_sel = sidle.gather(2, si[:, :, None])[:, :, 0]
            cold_p = capped & ((ready_p + wait_p - idle_sel > keep_alive)
                               | torch.isneginf(idle_sel))
        else:
            cold_p = torch.zeros((B, P), dtype=torch.bool, device=dev)
        cw_p = cold_p.to(f64) * wu
        pen = col(occ) * (wait_p + cw_p)
        prov = torch.argmin(col(selc) + pen, dim=1)      # [B]

        def at(x):                                       # [B] at prov
            return x.gather(1, prov[:, None])[:, 0]

        start = at(ready_p) + at(wait_p) + at(cw_p)
        end = start + at(col(dur))
        hit = pub[:, None] & (iota_J == j[:, None])
        prov_o = torch.where(hit, prov[:, None], prov_o)
        seg_o = torch.where(hit, at(col(seg))[:, None], seg_o)
        wait_o = torch.where(hit, at(wait_p)[:, None], wait_o)
        cold_o = torch.where(hit, at(cold_p)[:, None], cold_o)
        start_o = torch.where(hit, start[:, None], start_o)
        end_o = torch.where(hit, end[:, None], end_o)
        extra_o = torch.where(hit, at(pen)[:, None], extra_o)
        cell = ((pub & capped[prov])[:, None, None]
                & (iota_P == prov[:, None, None])
                & (iota_C == at(si)[:, None, None]))
        sclk = torch.where(cell, end[:, None, None], sclk)
        sidle = torch.where(cell, end[:, None, None], sidle)
    return prov_o, seg_o, wait_o, cold_o, start_o, end_o, extra_o


def _init_offload(P_pred, job_keys, capacity, init_elig):
    """The capacity-prefix initialization offload [B, J] over the jobs
    ``init_elig`` admits: whole-job predicted demand summed over stages
    left to right, the prefix taken on the host (:func:`init_offload_torch`).
    The engine (``init_mode=1``) and the pager's plan run this one
    function, so a paged run resolves the monolithic run's mask."""
    zero = torch.zeros((), dtype=P_pred.dtype, device=P_pred.device)
    c_tot = P_pred[:, :, 0]
    for k in range(1, P_pred.shape[2]):
        c_tot = c_tot + P_pred[:, :, k]
    return init_offload_torch(torch.where(init_elig, c_tot, zero), job_keys,
                              capacity) & init_elig


def _attempt_chain(a, k: int, arr, locpub, tau, times_j, priv_dur,
                   needs_up, placement_at, lost_j):
    """Stage ``k``'s offloaded jobs under the fault axis: the reference's
    unrolled attempt chain, as the DES's retry events replay it.

    Attempt ``ai`` re-runs the placement argmin at its own epoch over the
    providers that are feasible, not inside an outage window and not yet
    failed for this (job, stage); a grid draw fails at ``kill_frac`` of
    the duration, an outage window opening inside the run reclaims it at
    the window's start (``okill``); lost work bills pro rata into
    ``lost_j``; a terminal failure falls back to a dedicated private slot
    by the deadline (``fb_on``) or abandons the job. A zero grid reuses
    the fault-free expressions term for term.

    Returns (start, end, succ, provider, segment, latency multiplier,
    billed cost, attempts, failures, abandoned, lost_j), each [B, J].
    """
    fail_k = a["fail_g"][:, :, k, :]                         # [B, J, A]
    delay_k = a["delay_g"][:, :, k, :]
    outw = a["outw"]                                         # [B, P, W, 2]
    lat_ps, cost_ps, pub_a = a["lat_ps"], a["cost_ps"], a["pub_a"]
    act_priv, deadline = a["act_priv"], a["deadline"]
    B, J = tau.shape
    P, S_seg = a["sel_ps"].shape[1], a["sel_ps"].shape[2]
    A_att, W = fail_k.shape[2], outw.shape[2]
    dev, f64 = tau.device, torch.float64
    inf = torch.tensor(float("inf"), dtype=f64, device=dev)
    nan = torch.tensor(float("nan"), dtype=f64, device=dev)
    zero = torch.zeros((), dtype=f64, device=dev)
    iota_P = torch.arange(P, device=dev)
    kill = a["kill_frac"][:, None]
    alive = torch.isfinite(arr)

    def masked_placement(tq, mask_pj):
        s, seg_pj = placement_at(tq)
        out_pj = ((outw[:, :, :, 0, None] <= tq[:, None, None, :])
                  & (tq[:, None, None, :] < outw[:, :, :, 1, None])).any(2)
        s = (s + torch.where(out_pj, inf, zero)
             + torch.where(mask_pj, inf, zero))
        return s, seg_pj

    def at(x_pj, p):  # x_pj[b, p[b, j], j]
        return x_pj.gather(1, p[:, None, :])[:, 0, :]

    mask_pj = torch.zeros((B, P, J), dtype=torch.bool, device=dev)
    selc_cur, seg_cur = masked_placement(tau, mask_pj)
    feas0 = torch.isfinite(selc_cur).any(1)
    chain = alive & locpub
    nf0 = chain & ~feas0   # nothing dispatchable at the epoch
    pending = chain & feas0
    # inputs are staged once, before the first attempt; the upload carries
    # the first attempt's provider multiplier
    p0 = torch.argmin(selc_cur, dim=1)
    lm0 = _gather_ps(lat_ps, p0, at(seg_cur, p0))
    upk = (torch.where(needs_up, a["up_a"][:, :, k] * lm0, zero)
           if needs_up is not None
           else torch.zeros((B, J), dtype=f64, device=dev))
    t_att, up_cur = tau, upk
    succ = torch.zeros((B, J), dtype=torch.bool, device=dev)
    term = torch.zeros_like(succ)
    p_fin = torch.zeros((B, J), dtype=torch.int64, device=dev)
    seg_fin = torch.zeros_like(p_fin)
    e_fin = torch.zeros((B, J), dtype=f64, device=dev)
    lm_fin = torch.ones((B, J), dtype=f64, device=dev)
    t_res = torch.zeros_like(e_fin)
    cost_k = torch.zeros_like(e_fin)
    att_cnt = torch.zeros_like(p_fin)
    fail_cnt = torch.zeros_like(p_fin)
    for ai in range(A_att):
        p_a = torch.argmin(selc_cur, dim=1)                  # [B, J]
        sg_a = at(seg_cur, p_a)
        lm_a = _gather_ps(lat_ps, p_a, sg_a)
        dur_a = pub_a[:, :, k] * lm_a
        s_a = t_att + up_cur
        e_a = s_a + dur_a
        billed = cost_ps[..., k].reshape(B, -1, J).gather(
            1, (p_a * S_seg + sg_a)[:, None, :])[:, 0, :]
        t_gf = torch.where(fail_k[:, :, ai], s_a + kill * dur_a, inf)
        if W > 0:
            w_st = outw[:, :, :, 0].gather(
                1, p_a[:, :, None].expand(B, J, W))          # [B, J, W]
            cand = torch.where((w_st > s_a[:, :, None])
                               & (w_st < e_a[:, :, None]), w_st, inf)
            t_kl = torch.where(a["okill"][:, None], cand.amin(2), inf)
        else:
            t_kl = torch.full((B, J), float("inf"), dtype=f64, device=dev)
        t_f = torch.minimum(t_gf, t_kl)
        failed_now = pending & torch.isfinite(t_f)
        ok = pending & ~torch.isfinite(t_f)
        att_cnt = att_cnt + pending.to(torch.int64)
        fail_cnt = fail_cnt + failed_now.to(torch.int64)
        succ = succ | ok
        p_fin = torch.where(ok, p_a, p_fin)
        seg_fin = torch.where(ok, sg_a, seg_fin)
        e_fin = torch.where(ok, e_a, e_fin)
        lm_fin = torch.where(ok, lm_a, lm_fin)
        cost_k = cost_k + torch.where(ok, billed, zero)
        frac = torch.where(dur_a > 0.0, (t_f - s_a) / dur_a, zero)
        lost_j = lost_j + torch.where(failed_now, billed * frac, zero)
        mask_pj = mask_pj | (failed_now[:, None, :]
                             & (iota_P[None, :, None] == p_a[:, None, :]))
        if ai + 1 < A_att:
            t_next = t_f + delay_k[:, :, ai + 1]
            selc_n, seg_n = masked_placement(t_next, mask_pj)
            feas_n = torch.isfinite(selc_n).any(1)
            retry = failed_now & (t_next <= deadline) & feas_n
            term_now = failed_now & ~retry
            pending = retry
            t_att = torch.where(retry, t_next, t_att)
            up_cur = torch.where(retry, zero, up_cur)
            selc_cur = torch.where(retry[:, None, :], selc_n, selc_cur)
            seg_cur = torch.where(retry[:, None, :], seg_n, seg_cur)
        else:
            term_now = failed_now
            pending = torch.zeros_like(pending)
        term = term | term_now
        t_res = torch.where(term_now, t_f, t_res)

    term_all = term | nf0
    t_res = torch.where(nf0, tau, t_res)
    fb = term_all & a["fb_on"][:, None] & (t_res <= deadline)
    ab = term_all & ~fb
    # fallback = dedicated nominal-speed private slot at t_res; abandoned
    # stages never end (+inf) and their descendants inherit the +inf
    # arrival
    end_pub = torch.where(succ, e_fin,
                          torch.where(fb, t_res + act_priv[:, :, k], inf))
    start_pub = torch.where(fb, t_res, torch.where(nf0, tau, tau + upk))
    start = torch.where(~alive, nan,
                        torch.where(locpub, start_pub, times_j))
    end = torch.where(~alive, inf,
                      torch.where(locpub, end_pub, times_j + priv_dur))
    return (start, end, succ, p_fin, seg_fin, lm_fin, cost_k, att_cnt,
            fail_cnt, ab, lost_j)


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


@dataclasses.dataclass(frozen=True)
class _LoadConfig:
    """One call's load-dependent latency (:mod:`.coldstart`), shared by
    every scenario: ``caps`` [P] per-provider concurrency caps (inf =
    unbounded) and ``C`` the widest finite one, the public warm-ups
    ``provider_warm_ups`` [P], the private ``warm_up_s``, the
    ``keep_alive_s`` window and ``scale_to_zero``; ``capped``/``cold``/
    ``pooled`` say which of caps, cold starts and a pool trace are set."""

    capped: bool
    cold: bool
    pooled: bool
    C: int
    caps: np.ndarray
    provider_warm_ups: np.ndarray
    warm_up_s: float
    keep_alive_s: float
    scale_to_zero: bool


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
                 faults=None, retry=None, init_window=None, W: int = 0,
                 caps=None, coldstart=None, pool=None,
                 offload_mask=None, init_override=None,
                 adaptive_override=None, where: str = ""):
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
        # fault axis: a normalized list of FaultModel (every entry padded
        # to the sweep's attempt budget) or None, the fault-free axis
        fault_cfgs = [None] if faults is None else list(faults)
        self.faulty = faults is not None
        self.grid = [(b, o, float(c), r, g, tr, f)
                     for b in range(B) for o in orders for c in c_max_grid
                     for r in range(len(repl_cfgs))
                     for g in range(len(speed_cfgs))
                     for tr in range(len(trace_cfgs))
                     for f in range(len(fault_cfgs))]
        self.S = len(self.grid)
        self.orders_out = tuple(o for (_, o, _, _, _, _, _) in self.grid)
        self.c_max_out = np.array([c for (_, _, c, _, _, _, _) in self.grid])
        self.batch_out = np.array([b for (b, _, _, _, _, _, _) in self.grid])
        self.repl_out = np.stack([repl_cfgs[r]
                                  for (_, _, _, r, _, _, _) in self.grid])
        self.trace_out = np.array(
            [tr for (_, _, _, _, _, tr, _) in self.grid])
        self.fault_out = np.array(
            [f for (_, _, _, _, _, _, f) in self.grid])
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
        for b in sorted({b for (b, _, _, _, _, _, _) in self.grid}):
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
                               for (b, o, _, _, _, tr, _) in self.grid])
        job_keys = np.stack([uniq[(b, o, tr)][1]
                             for (b, o, _, _, _, tr, _) in self.grid])
        bsel = self.batch_out
        sel_p = np.stack([sel_bt[(b, tr)]
                          for (b, _, _, _, _, tr, _) in self.grid])
        cost_p = np.stack([cost_bt[(b, tr)]
                           for (b, _, _, _, _, tr, _) in self.grid])
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
                          for (_, _, _, r, g, _, _) in self.grid])
        # capacity T_max = sum_k I_k * C_max follows the scenario's own
        # replica config (raw counts, as in the DES's t_max)
        capacity = np.array([float(repl_cfgs[r].sum()) * c
                             for (_, _, c, r, _, _, _) in self.grid])
        S = self.S

        # per-task scheduling-flag overrides (None = the sweep's
        # init_phase/adaptive): a policy comparison mixes e.g. an
        # ACD-adaptive task and a fixed-placement baseline in one sweep
        self.init_override = (None if init_override is None
                              else bool(init_override))
        self.adaptive_override = (None if adaptive_override is None
                                  else bool(adaptive_override))
        # an externally decided offload plan ([J] bool) replaces the
        # capacity-prefix rule and rides init_elig into the init_mode=2
        # engine path (the one pages of a resolved plan take)
        pre = f"{where}: " if where else ""
        if offload_mask is not None:
            if init_window is not None:
                raise ValueError(f"{pre}offload_mask and init_window are "
                                 f"mutually exclusive")
            offload_mask = np.asarray(offload_mask, dtype=bool)
            if offload_mask.shape != (self.J,):
                raise ValueError(
                    f"{pre}offload_mask must have shape ({self.J},), got "
                    f"{offload_mask.shape}")
            init_elig = offload_mask
        else:
            # windowed init offload: only jobs released within the window
            # compete for the capacity budget
            init_elig = (np.ones(self.J, dtype=bool) if init_window is None
                         else rel <= self.t0 + float(init_window))
        self.mask = offload_mask

        # load-dependent latency (caps, cold starts, pool traces): per-call
        # configs shared by every scenario; caps read occupancy rates per
        # price trace, a pool trace its slot windows in this task's stage
        # order
        capped = caps is not None
        cold = coldstart is not None
        pooled = pool is not None
        clock0 = np.full((S, M_pad, self.I_max), self.t0)
        load_args: Dict[str, np.ndarray] = {}
        self.load: Optional[_LoadConfig] = None
        if capped:
            occ_by_tr = [tpf.np_occupancy_rates_seg(mem, num_segments=S_seg)
                         for tpf in trace_cfgs]       # [P, S_seg, M] each

            def pad_occ(o):
                out = np.zeros(o.shape[:2] + (M_pad,))
                out[:, :, :M] = o[:, :, topo]
                return out

            load_args["occ"] = np.stack([pad_occ(occ_by_tr[tr])
                                         for (_, _, _, _, _, tr, _)
                                         in self.grid])
        if pooled:
            on_w, off_w = pool
            w = off_w.shape[1]
            off_pad = np.full((M_pad, self.I_max), np.inf)
            off_pad[:M, :w] = off_w[topo, :]
            load_args["off_pool"] = np.broadcast_to(
                off_pad, (S, M_pad, self.I_max))
            # late pool slots enter busy until their turn-on instant (the
            # DES's pool-on event); never-on slots are absent from the
            # speed matrix anyway
            clk = np.full((M_pad, self.I_max), self.t0)
            with np.errstate(invalid="ignore"):
                clk[:M, :w] = np.where(
                    np.isfinite(on_w[topo, :]),
                    np.maximum(self.t0, on_w[topo, :]), self.t0)
            clock0 = np.broadcast_to(clk, (S, M_pad, self.I_max)).copy()
        if capped or cold or pooled:
            cs = coldstart
            caps_eff = (np.asarray(caps, dtype=np.float64) if capped
                        else np.full(self.n_providers, np.inf))
            self.load = _LoadConfig(
                capped=capped, cold=cold, pooled=pooled,
                C=(int(caps_eff[np.isfinite(caps_eff)].max()) if capped
                   else 0),
                caps=caps_eff,
                provider_warm_ups=(cs.provider_warm_ups(self.n_providers)
                                   if cold else np.zeros(self.n_providers)),
                warm_up_s=cs.warm_up_s if cold else 0.0,
                keep_alive_s=cs.keep_alive_s if cold else np.inf,
                scale_to_zero=bool(cold and cs.scale_to_zero))
        fault_args: Dict[str, np.ndarray] = {}
        if self.faulty:
            rt = retry if retry is not None else RetryPolicy()
            fo = self.fault_out

            def pad_stage_mid(v, fill):
                # [S, J, M, A] -> [S, J, M_pad, A], stages in topo order
                out = np.full(v.shape[:2] + (M_pad,) + v.shape[3:], fill,
                              dtype=v.dtype)
                out[:, :, :M] = v[:, :, topo]
                return out

            fault_args = dict(
                fail_g=pad_stage_mid(np.stack(
                    [cfg.fail for cfg in fault_cfgs])[fo], False),
                delay_g=pad_stage_mid(np.stack(
                    [rt.delays(cfg.jitter) for cfg in fault_cfgs])[fo], 0.0),
                outw=np.stack([cfg.outage_windows(self.n_providers,
                                                  num_slots=int(W))
                               for cfg in fault_cfgs])[fo],
                kill_frac=np.array([cfg.kill_frac
                                    for cfg in fault_cfgs])[fo],
                okill=np.array([cfg.outage_kills for cfg in fault_cfgs],
                               dtype=bool)[fo],
                fb_on=np.full(S, bool(rt.private_fallback)))
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
                             for (_, _, _, _, _, tr, _) in self.grid]),
            eg_ps=np.stack([eg_by_tr[tr]
                            for (_, _, _, _, _, tr, _) in self.grid]),
            edges_ps=np.stack([edges_by_tr[tr]
                               for (_, _, _, _, _, tr, _) in self.grid]),
            stage_keys=pad_cols(stage_keys),
            job_keys=job_keys,
            deadline=rel[None, :] + self.c_max_out[:, None],
            capacity=capacity,
            release=np.broadcast_to(rel, (S, self.J)),
            init_elig=np.broadcast_to(init_elig, (S, self.J)),
            A=np.broadcast_to(A, (S,) + A.shape),
            desc=np.broadcast_to(desc, (S,) + desc.shape),
            sink=np.broadcast_to(sink, (S,) + sink.shape),
            pinned=np.broadcast_to(pinned, (S,) + pinned.shape),
            inert=np.broadcast_to(inert, (S,) + inert.shape),
            speed=speed,
            clock0=clock0,
            **load_args, **fault_args)

    #: engine args with a job axis (name -> axis), sliced by the pager
    _PAGE_J_AXES = dict(P_pred=1, act_priv=1, pub_a=1, up_a=1, down_a=1,
                        dgb_pred=1, cost_ps=3, sel_ps=3, stage_keys=1,
                        job_keys=1, deadline=1, release=1, init_elig=1,
                        fail_g=1, delay_g=1)

    def eff_modes(self, init_phase: bool, adaptive: bool) -> Tuple[int, bool]:
        """(engine init_mode, adaptive) for this task under the sweep's
        defaults: per-task overrides win, and an offload mask runs the
        precomputed-plan path (``init_mode=2``)."""
        ip = init_phase if self.init_override is None else self.init_override
        ad = adaptive if self.adaptive_override is None \
            else self.adaptive_override
        mode = 2 if self.mask is not None else (1 if ip else 0)
        return mode, bool(ad)

    def page_args(self, idx: np.ndarray, init_mask: np.ndarray,
                  clocks: np.ndarray) -> Dict[str, np.ndarray]:
        """One page of jobs (ascending job ids ``idx``) out of the full
        args: ``init_mask`` [S, n] is the page's slice of the plan
        resolved over the whole job axis (the ``init_mode=2`` path's
        ``init_elig``), ``clocks`` [S, M_pad, I_max] the slot clocks the
        previous pages left. Pages are not padded: the engine has no
        compile cache to key on a page size."""
        out = {name: (v if name not in self._PAGE_J_AXES
                      else np.take(v, idx, axis=self._PAGE_J_AXES[name]))
               for name, v in self.args.items()}
        out["init_elig"] = init_mask
        out["clock0"] = clocks
        return out

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
            c_max=self.c_max_out.copy(), batch_idx=self.batch_out.copy(),
            release=None if self.release is None
            else np.broadcast_to(self.release, (self.S, self.J)).copy(),
            replica=out["replica"][:, :, inv],
            replicas=self.repl_out.copy(),
            segment=out["segment"][:, :, inv],
            trace_idx=self.trace_out.copy(),
            attempts=out["attempts"][:, :, inv],
            failed=out["failed"][:, :, inv],
            abandoned=out["abandoned"],
            fault_idx=self.fault_out.copy(),
            queue_wait=out["queue_wait"][:, :, inv],
            cold=out["cold"][:, :, inv])


def _to_device(args: Dict[str, np.ndarray],
               device: torch.device) -> Dict[str, torch.Tensor]:
    """Move engine args to ``device``: bool stays bool, floats are float64."""
    out = {}
    for name, x in args.items():
        x = np.ascontiguousarray(x, dtype=bool if x.dtype == bool
                                 else np.float64)
        if not x.flags.writeable:  # a broadcast view: torch needs a copy
            x = x.copy()
        out[name] = torch.from_numpy(x).to(device)
    return out


def _finalize(task: _Task, out: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Host-side canonical reductions of the engine's per-job outputs.

    Scalar fields (makespan, cost_usd, the offload counters) reduce over
    the canonical job order in numpy, never as a parallel device sum, so a
    paged run, which assembles the very same per-job arrays page by page,
    sums the same floats in the same order as a monolithic one. Under
    faults the makespan spans the jobs that were not abandoned.
    """
    comp = out["completion"]
    if task.faulty:
        ok = ~out["abandoned"]
        safe = np.where(ok, np.where(np.isnan(comp), -np.inf, comp),
                        -np.inf)
        out["makespan"] = np.where(ok.any(axis=1),
                                   safe.max(axis=1) - task.t0, 0.0)
    else:
        out["makespan"] = comp.max(axis=1) - task.t0
    locpub = out["public_mask"]
    out["cost_usd"] = out.pop("cost_j").sum(axis=1)
    out["n_offloaded_stages"] = locpub.sum(axis=(1, 2))
    out["n_init_offloaded_jobs"] = out.pop("init_off").sum(axis=1)
    out["per_stage_offloads"] = locpub.sum(axis=1)
    out.pop("qexit", None)
    out.pop("clocks", None)
    return out


#: most recent sweep's wall-time split (host prep, of it the ``_Task``
#: constructors ``plan_s``, 0 on a prep-cache hit; engine; finalize), the
#: body steps each stage's event loop took per engine call, the engine
#: impl and the device; observability for ``chip_smoke.py``, not part of
#: the result API
_LAST_RUN_STATS: Dict[str, object] = {}

#: most recent paged run's committed pages and safety retries (the
#: reference's counters, for the streaming tests and chip_smoke)
_LAST_PAGE_STATS: Dict[str, int] = {}


def _split_devices(dev: torch.device, S: int) -> List[torch.device]:
    """The devices one engine call's ``S`` scenarios run on: every CUDA
    device when the engine runs on CUDA and ``S`` > 1 (the reference's
    ``pmap`` over the local devices, ``n_dev`` at its
    ``core/vectorsim.py:2095``), else ``dev`` alone."""
    if dev.type == "cuda" and S > 1 and torch.cuda.device_count() > 1:
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def _dispatch(run, args: Dict[str, np.ndarray], S: int,
              devices: Sequence[torch.device]) -> Dict[str, np.ndarray]:
    """``run(args, device)`` over the scenario axis of ``args`` (every
    array's leading dim, ``S`` long) split across ``devices``, its numpy
    outputs joined on the host in scenario order.

    The reference's split (``core/vectorsim.py:1915-1941``): scenario ``s``
    goes to shard ``k`` by the strided interleave ``perm`` (which balances
    heterogeneous grids across the shards, each running its event loop in
    lockstep), ``S`` padded to a multiple of the shard count by repeating
    the first scenarios, and ``pos`` (the first place of each scenario)
    reads the outputs back. Each shard runs on its own device from a
    thread of its own (on a CUDA device, on a stream of its own): the
    engine's host loop releases the interpreter lock in every launch and
    copy. Scenarios never interact, so the result is the one-device run's
    bit for bit. One device: ``run(args, devices[0])``."""
    n_dev = len(devices)
    if n_dev <= 1:
        return run(args, devices[0])
    pad = (-S) % n_dev
    sel = np.arange(S + pad) % S
    perm = sel.reshape(-1, n_dev).T.reshape(-1)
    per = perm.shape[0] // n_dev

    def shard(k: int) -> Dict[str, np.ndarray]:
        part = {name: x[perm[k * per:(k + 1) * per]]
                for name, x in args.items()}
        dev = devices[k]
        if dev.type != "cuda":
            return run(part, dev)
        with torch.cuda.device(dev), torch.cuda.stream(
                torch.cuda.Stream(dev)):
            return run(part, dev)

    with ThreadPoolExecutor(n_dev) as pool:
        outs = [f.result() for f in [pool.submit(shard, k)
                                     for k in range(n_dev)]]
    # position of each original scenario in the shard-major output
    # (padding repeats a few scenarios; any occurrence works)
    pos = np.empty(S, dtype=np.int64)
    pos[perm] = np.arange(perm.shape[0])
    return {k: np.concatenate([o[k] for o in outs])[pos] for k in outs[0]}


def _engine_call(task: _Task, args: Dict[str, np.ndarray], dev,
                 include_transfers: bool, init_mode: int, adaptive: bool,
                 lookahead: bool, impl: str,
                 devices: Optional[Sequence[torch.device]] = None
                 ) -> Dict[str, np.ndarray]:
    """One engine call with body ``impl``, its scenarios split across
    ``devices`` (by default :func:`_split_devices` of ``dev``); each
    stage's body steps (the most any shard took) join
    ``_LAST_RUN_STATS["trips"]``."""
    S = int(next(iter(args.values())).shape[0])
    shard_trips: List[List[int]] = []

    def run(part: Dict[str, np.ndarray], d: torch.device):
        trips: List[int] = []
        with torch.no_grad():
            out_t = _run_engine(_to_device(part, d), include_transfers,
                                init_mode, adaptive, task.t0, trips,
                                load=task.load, lookahead=lookahead,
                                impl=impl)
            out = {k: v.cpu().numpy() for k, v in out_t.items()}
        shard_trips.append(trips)
        return out

    out = _dispatch(run, args, S, devices or _split_devices(dev, S))
    _LAST_RUN_STATS["trips"].append(
        [max(t) for t in zip(*shard_trips)] if len(shard_trips) > 1
        else shard_trips[0])
    return out


def _host_init_offload(task: _Task) -> np.ndarray:
    """The capacity-prefix init-offload mask [S, J] over the whole job
    axis, resolved on the host by the engine's own function
    (:func:`_init_offload`), so a paged run starts from the monolithic
    run's plan."""
    a = _to_device({k: task.args[k] for k in ("P_pred", "job_keys",
                                               "capacity", "init_elig")},
                   torch.device("cpu"))
    return _init_offload(a["P_pred"], a["job_keys"], a["capacity"],
                         a["init_elig"]).numpy()


def _run_paged(task: _Task, dev, include_transfers: bool, init_mode: int,
               adaptive: bool, lookahead: bool, chunk: int,
               impl: str) -> Dict[str, np.ndarray]:
    """Page the job axis through engine calls of about ``chunk`` jobs.

    Jobs page in release order (whole tied-release groups per page, page
    members in ascending job order); each page starts from the previous
    pages' final slot clocks. The decomposition is checked, not assumed:
    if a committed job's queue exit (dispatch or eviction instant, at any
    stage) lands at or after the next page's first release, the two pages
    could have shared a stage queue, and the page grows to the stream's
    next quiet point and runs again (a saturated page is the monolithic
    run, so the fallback is always exact). The initialization offload, a
    rule over the whole job axis, resolves on the host before any page.
    """
    S, J = task.S, task.J
    rel = task.release
    order = np.argsort(rel, kind="stable")
    rel_sorted = rel[order]
    if init_mode == 2:
        off_full = np.broadcast_to(task.mask, (S, J)).copy()
    elif init_mode == 1:
        off_full = _host_init_offload(task)
    else:
        off_full = np.zeros((S, J), dtype=bool)
    page_mode = 2 if init_mode else 0
    bufs: Optional[Dict[str, np.ndarray]] = None
    clocks = task.args["clock0"]
    pos, size = 0, int(chunk)
    n_pages = n_retries = 0
    while pos < J:
        end = min(pos + size, J)
        # never split a tied-release group across pages: an epoch's jobs
        # admit together before the sweep
        while end < J and rel_sorted[end] == rel_sorted[end - 1]:
            end += 1
        idx = np.sort(order[pos:end])
        T_next = rel_sorted[end] if end < J else np.inf
        out = _engine_call(task, task.page_args(idx, off_full[:, idx],
                                                clocks),
                           dev, include_transfers, page_mode, adaptive,
                           lookahead, impl)
        qx = out["qexit"]
        with np.errstate(invalid="ignore"):
            exit_t = np.where(qx < -0.5, -qx - 1.0, qx)
            unsafe = bool(np.any(exit_t >= T_next))  # NaN compares False
        if unsafe and end < J:
            # grow the page to the next quiet point: every job released
            # before the latest in-page queue exit shares the page
            t_quiet = float(np.nanmax(exit_t))
            size = int(np.searchsorted(rel_sorted, t_quiet,
                                       side="right")) - pos
            n_retries += 1
            continue
        if bufs is None:
            bufs = {name: np.empty((S, J) + v.shape[2:], dtype=v.dtype)
                    for name, v in out.items() if name != "clocks"}
        for name, v in out.items():
            if name != "clocks":
                bufs[name][:, idx] = v
        clocks = out["clocks"]
        pos, size = end, int(chunk)
        n_pages += 1
    assert bufs is not None
    _LAST_PAGE_STATS.update(pages=n_pages, retries=n_retries)
    return bufs


def _is_paged(task: _Task, chunk_jobs: Optional[int]) -> bool:
    """Whether ``chunk_jobs`` pages this task: a release stream longer
    than one page (a batch at ``t0`` always runs whole)."""
    return (chunk_jobs is not None and task.release is not None
            and int(chunk_jobs) < task.J)


def simulate_scenarios(
    dag: AppDAG,
    pred: Optional[Dict[str, np.ndarray]],
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
    c_max_grid x replicas x replica_speeds x price_traces x faults`` in C
    order. ``portfolio`` generalizes the public cloud to N providers,
    ``arrivals`` injects an exogenous release stream shared by every
    scenario (``None`` is the batch at ``t0``), ``replicas`` is an
    autoscaling axis of per-stage count vectors, ``replica_speeds`` a
    straggler axis of ``{(stage, replica): factor}`` dicts or [M, I]
    arrays, and ``price_traces`` a pricing axis of portfolio variants.

    ``faults`` is a reliability axis (:class:`.faults.FaultModel` entries,
    scalar failure rates drawn at seed = their axis index, or ``None``
    entries; a bare model or rate is a one-point axis) recovered under
    ``retry`` (a :class:`.faults.RetryPolicy`, the default one when
    omitted): each offloaded stage runs a bounded attempt chain.
    ``init_window`` restricts the initialization offload to jobs released
    within that many seconds of ``t0``. ``offload_mask`` ([J] bool) is an
    externally decided plan replacing the capacity-prefix rule (not with
    ``init_window``). ``egress_lookahead`` adds the one-edge downstream
    egress term to the placement argmin.

    ``chunk_jobs`` pages a release stream's job axis through engine
    calls of about that many jobs, the slot clocks carried across pages
    and every page checked against the next page's releases (a page
    whose work overlaps them grows): the result equals the monolithic
    run's. ``workload`` is a :mod:`.workloads` spec (e.g.
    ``"azure:day=tue,scale=1e5"``) deriving ``pred``/``act`` and the
    release stream from the committed trace sample; pass ``pred=None``
    with it.

    ``concurrency``/``coldstart``/``pool_trace`` add load-dependent
    latency (:mod:`.coldstart`): per-provider concurrency caps with FIFO
    queueing (the capped dispatch chain runs in the ``fifo_dispatch``
    kernel), a keep-alive/cold-start model, and time-varying private pool
    sizes. They are per-call configs shared by every scenario of the
    grid, identical in both engines; degenerate values (no finite cap, a
    zero-penalty model, a constant pool) give the plain schedule bit for
    bit. They cannot combine with ``faults``, ``chunk_jobs``, or (for
    ``pool_trace``) a ``replicas`` axis.

    ``engine="vector"`` (the default) runs the batched torch engine on
    ``device`` (``"cuda"`` unless given; a CPU run must pass
    ``device="cpu"``) with the inner loop ``engine_impl`` (one of
    :data:`ENGINE_IMPLS`; :func:`resolve_engine_impl` resolves ``None``),
    every impl giving the same result. ``engine="des"`` replays the grid
    serially through the discrete-event simulator
    (:func:`.simulator.simulate`), with the same result layout.
    """
    from .simulator import _with_transfer_defaults, simulate
    from .workloads import resolve_workload

    resolve_engine_impl(engine_impl)  # fail fast on bad impl, any engine
    if workload is not None:
        if pred is not None:
            raise ValueError("pass either pred or workload=, not both")
        pred, act, wl_release = resolve_workload(workload, dag, t0)
        if arrivals is None:
            arrivals = wl_release
    if engine == "des":
        # the load-config checks of both engines (the replicas-axis x
        # pool_trace exclusion is a grid-level check)
        validate_load_kwargs(
            np.isfinite(norm_concurrency(
                concurrency, as_portfolio(portfolio, cost_model))).any(),
            as_coldstart(coldstart), as_pool_trace(pool_trace),
            faulty=faults is not None, chunk_jobs=chunk_jobs,
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
        retry_eff = retry if faults is None else (retry or RetryPolicy())
        fault_cfgs = normalize_fault_axis(faults, J, dag.num_stages,
                                          retry_eff) or [None]
        grid = [(b, o, float(c), r, g, tr, f)
                for b in range(B) for o in orders for c in c_max_grid
                for r in range(len(repl_cfgs))
                for g in range(len(speed_cfgs))
                for tr in range(len(trace_cfgs))
                for f in range(len(fault_cfgs))]
        sims = [simulate(dags[r], {k: v[b] for k, v in pred_d.items()},
                         {k: v[b] for k, v in act_d.items()},
                         c_max=c, order=o, cost_model=cost_model,
                         include_transfers=include_transfers,
                         init_phase=init_phase, adaptive=adaptive, t0=t0,
                         portfolio=trace_cfgs[tr], arrivals=release,
                         replica_slowdown=slow[g],
                         faults=fault_cfgs[f], retry=retry_eff,
                         init_window=init_window, chunk_jobs=chunk_jobs,
                         egress_lookahead=egress_lookahead,
                         concurrency=concurrency, coldstart=coldstart,
                         pool_trace=pool_trace, offload_mask=offload_mask)
                for (b, o, c, r, g, tr, f) in grid]
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
            orders=tuple(o for (_, o, _, _, _, _, _) in grid),
            c_max=np.array([c for (_, _, c, _, _, _, _) in grid]),
            batch_idx=np.array([b for (b, _, _, _, _, _, _) in grid]),
            release=None if release is None
            else np.broadcast_to(release, (len(grid), J)).copy(),
            replica=np.stack([r.replica for r in sims]),
            replicas=np.stack(
                [repl_cfgs[r] for (_, _, _, r, _, _, _) in grid]),
            segment=np.stack([r.segment for r in sims]),
            trace_idx=np.array([tr for (_, _, _, _, _, tr, _) in grid]),
            attempts=np.stack([r.attempts for r in sims]),
            failed=np.stack([r.failed for r in sims]),
            abandoned=np.stack([r.abandoned for r in sims]),
            fault_idx=np.array([f for (_, _, _, _, _, _, f) in grid]),
            queue_wait=np.stack([r.queue_wait for r in sims]),
            cold=np.stack([r.cold for r in sims]))
    if engine != "vector":
        raise ValueError(f"unknown engine {engine!r}")
    return sweep_scenarios(
        [dict(dag=dag, pred=pred, act=act, c_max_grid=c_max_grid,
              orders=orders, arrivals=arrivals, replicas=replicas,
              replica_speeds=replica_speeds, price_traces=price_traces,
              faults=faults, offload_mask=offload_mask)],
        cost_model=cost_model, include_transfers=include_transfers,
        init_phase=init_phase, adaptive=adaptive, t0=t0,
        portfolio=portfolio, retry=retry, init_window=init_window,
        chunk_jobs=chunk_jobs, egress_lookahead=egress_lookahead,
        concurrency=concurrency, coldstart=coldstart,
        pool_trace=pool_trace, engine_impl=engine_impl, device=device)[0]


_TASK_KEYS = {"dag", "pred", "act", "c_max_grid", "orders", "arrivals",
              "replicas", "replica_speeds", "price_traces", "faults",
              "workload", "offload_mask", "init_phase", "adaptive",
              "init_window", "name"}


def sweep_scenarios(
    tasks: Sequence[Dict],
    cost_model: CostModel = LAMBDA_COST,
    include_transfers: bool = True,
    init_phase: bool = True,
    adaptive: bool = True,
    t0: float = 0.0,
    engine: str = "vector",
    portfolio: Optional[ProviderPortfolio] = None,
    retry=None,
    init_window: Optional[float] = None,
    chunk_jobs: Optional[int] = None,
    egress_lookahead: bool = False,
    concurrency=None,
    coldstart=None,
    pool_trace=None,
    engine_impl: Optional[str] = None,
    device=None,
) -> List[VectorSimResult]:
    """Run several scenario grids — e.g. a whole Fig.-4 figure, one task per
    application — as one batched sweep.

    Each task is a dict with keys ``dag``, ``pred`` (or a ``workload``
    spec), optional ``act``, ``c_max_grid``, ``orders``, ``arrivals``,
    ``replicas``, ``replica_speeds``, ``price_traces`` and ``faults``
    (the axes of :func:`simulate_scenarios`), and may override the
    sweep's scheduling flags per task: ``init_phase``, ``adaptive``,
    ``init_window`` and ``offload_mask``. Results come back in task order.
    Every task pads to the sweep's common stage count (inert stages),
    replica bound (absent slots) and segment bound (segments that never
    activate); tasks with a common job count and the same effective
    flags run as one batched engine call on ``device`` (``"cuda"`` unless
    given), and a task that ``chunk_jobs`` pages runs alone, page by
    page. ``retry``, ``chunk_jobs``, ``egress_lookahead``,
    ``concurrency``, ``coldstart`` and ``pool_trace`` (see
    :func:`simulate_scenarios`) are per-call and bind every task; a pool
    trace provisions each task's pool at the trace's per-stage maximum.
    ``engine_impl`` picks the engine's inner loop (:data:`ENGINE_IMPLS`;
    every impl gives the same result). A repeated call over an unchanged
    grid reuses its host preparation (``_PREP_CACHE``; ``plan_s`` of
    ``_LAST_RUN_STATS`` reads 0 then), whatever the device.
    ``engine="des"`` replays each task through :func:`simulate_scenarios`
    with ``engine="des"``.
    """
    for i, t in enumerate(tasks):
        bad = set(t) - _TASK_KEYS
        if bad:
            raise ValueError(f"tasks[{i}]: unknown task keys {sorted(bad)}")
    if engine == "des":
        return [simulate_scenarios(
            t["dag"], t.get("pred"), t.get("act"),
            t.get("c_max_grid", (60.0,)), t.get("orders", ("spt",)),
            cost_model=cost_model, include_transfers=include_transfers,
            init_phase=t.get("init_phase", init_phase),
            adaptive=t.get("adaptive", adaptive), t0=t0, engine="des",
            portfolio=portfolio, arrivals=t.get("arrivals"),
            replicas=t.get("replicas"),
            replica_speeds=t.get("replica_speeds"),
            price_traces=t.get("price_traces"), faults=t.get("faults"),
            retry=retry, init_window=t.get("init_window", init_window),
            chunk_jobs=chunk_jobs, egress_lookahead=egress_lookahead,
            workload=t.get("workload"), concurrency=concurrency,
            coldstart=coldstart, pool_trace=pool_trace,
            offload_mask=t.get("offload_mask"))
            for t in tasks]
    if engine != "vector":
        raise ValueError(f"unknown engine {engine!r}")
    if t0 < 0:
        # the engine sign-encodes eviction times as -t - 1, so the clock
        # must stay non-negative (the DES has no such restriction)
        raise ValueError("engine='vector' requires t0 >= 0")
    if chunk_jobs is not None and int(chunk_jobs) < 1:
        raise ValueError(f"chunk_jobs must be >= 1, got {chunk_jobs}")
    impl = resolve_engine_impl(engine_impl)
    dev = resolve_device(device)
    _LAST_RUN_STATS.clear()
    t_prep = time.perf_counter()
    # the device is not in the key: an entry holds host arrays only, moved
    # to the device per engine call
    refs: List[object] = []
    fp = ("v1", _prep_fp(list(tasks), refs), _prep_fp(cost_model, refs),
          bool(include_transfers), float(t0), _prep_fp(portfolio, refs),
          _prep_fp(retry, refs),
          None if init_window is None else float(init_window),
          None if chunk_jobs is None else int(chunk_jobs),
          _prep_fp(concurrency, refs), _prep_fp(coldstart, refs),
          _prep_fp(pool_trace, refs))
    hit = _PREP_CACHE.get(fp)
    if hit is not None:
        _PREP_CACHE.move_to_end(fp)
        prepped, plan_s = hit[0], 0.0
    else:
        prepped, plan_s = _prep_sweep(
            tasks, cost_model, include_transfers, t0, portfolio, retry,
            init_window, chunk_jobs, concurrency, coldstart, pool_trace)
        # refs pins every id-keyed object of fp for the entry's lifetime,
        # so a reclaimed id can never alias a live key
        _PREP_CACHE[fp] = (prepped, tuple(refs))
        while len(_PREP_CACHE) > _PREP_CACHE_MAX:
            _PREP_CACHE.popitem(last=False)
    _LAST_RUN_STATS.update(prep_s=time.perf_counter() - t_prep,
                           plan_s=plan_s, impl=impl, device=str(dev),
                           engine_s=0.0, finalize_s=0.0, trips=[])

    results: List[Optional[VectorSimResult]] = [None] * len(prepped)
    # tasks of one shape family (job count, fault and load flags,
    # effective scheduling flags) run as one call (the scenario lanes are
    # independent, so the split is result-invariant); a paged task runs
    # alone; empty tasks need no engine at all
    groups: Dict[tuple, List[int]] = {}
    for i, p in enumerate(prepped):
        if p.J == 0:
            results[i] = _empty_result(p)
            continue
        ld = p.load
        fam = (p.J, p.faulty, p.eff_modes(bool(init_phase), bool(adaptive)),
               None if ld is None else (ld.capped, ld.cold, ld.pooled, ld.C))
        if _is_paged(p, chunk_jobs):
            fam = ("paged", i)
        groups.setdefault(fam, []).append(i)
    for grp in groups.values():
        ps = [prepped[i] for i in grp]
        mode, adapt = ps[0].eff_modes(bool(init_phase), bool(adaptive))
        t_run = time.perf_counter()
        if _is_paged(ps[0], chunk_jobs):
            out = _run_paged(ps[0], dev, bool(include_transfers), mode,
                             adapt, bool(egress_lookahead), int(chunk_jobs),
                             impl)
        else:
            fused = {name: np.concatenate([p.args[name] for p in ps])
                     for name in ps[0].args}
            out = _engine_call(ps[0], fused, dev, bool(include_transfers),
                               mode, adapt, bool(egress_lookahead), impl)
        t_done = time.perf_counter()
        lo = 0
        for i, p in zip(grp, ps):
            sub = {k: v[lo:lo + p.S] for k, v in out.items()}
            results[i] = p.pack(_finalize(p, sub))
            lo += p.S
        _LAST_RUN_STATS["engine_s"] += t_done - t_run
        _LAST_RUN_STATS["finalize_s"] += time.perf_counter() - t_done
    return results


def _prep_fp(obj, refs: List[object]):
    """Structural fingerprint of one sweep input for the prep cache.

    Scalars, strings, sequences, dicts and arrays key by value (arrays by
    shape, dtype and a digest of their content, so an in-place edit
    misses); opaque config objects (DAGs, portfolios, cost models, fault
    and cold-start configs) key by identity and are appended to ``refs``,
    which the cache entry keeps alive, so a live entry never meets a
    recycled ``id``.
    """
    if obj is None or isinstance(obj, (bool, int, float, complex, str,
                                       bytes)):
        return obj
    if isinstance(obj, np.generic):
        return ("np", obj.dtype.str, obj.item())
    if isinstance(obj, torch.Tensor):
        obj = obj.detach().cpu().numpy()
    if isinstance(obj, np.ndarray):
        return ("nd", obj.shape, obj.dtype.str,
                hash(np.ascontiguousarray(obj).tobytes()))
    if isinstance(obj, (list, tuple)):
        return ("seq", tuple(_prep_fp(o, refs) for o in obj))
    if isinstance(obj, dict):
        return ("map", tuple(
            (k, _prep_fp(v, refs))
            for k, v in sorted(obj.items(), key=lambda kv: repr(kv[0]))))
    refs.append(obj)
    return ("id", id(obj))


#: repeated sweeps over an unchanged grid (a benchmark's warm and timed
#: calls, a study re-running a figure) skip the host preparation; at most
#: this many grids are kept, the least recently used dropped first
_PREP_CACHE: "OrderedDict[tuple, tuple]" = OrderedDict()
_PREP_CACHE_MAX = 8


def _prep_sweep(tasks, cost_model, include_transfers, t0, portfolio, retry,
                init_window, chunk_jobs, concurrency, coldstart,
                pool_trace) -> Tuple[List[_Task], float]:
    """Validate and normalize a sweep's tasks into engine-ready
    :class:`_Task` bundles padded to one shape family (the cacheable part
    of :func:`sweep_scenarios`). Returns them and ``plan_s``, the seconds
    their constructors took: the policy decisions (priority keys,
    placement matrices, offload plans)."""
    M_pad = max(t["dag"].num_stages for t in tasks)
    tasks = [dict(t) for t in tasks]
    base_pf = as_portfolio(portfolio, cost_model)
    any_faulty = any(t.get("faults") is not None for t in tasks)
    retry_eff = (retry or RetryPolicy()) if any_faulty else retry
    # load-dependent latency configs: per-call, shared by every task (caps
    # bind per provider, which every price trace shares)
    cs = as_coldstart(coldstart)
    ptr = as_pool_trace(pool_trace)
    caps_vec = norm_concurrency(concurrency, base_pf)
    caps_eff = caps_vec if np.isfinite(caps_vec).any() else None
    validate_load_kwargs(
        caps_eff is not None, cs, ptr, faulty=any_faulty,
        chunk_jobs=chunk_jobs,
        replicas_axis=any(t.get("replicas") is not None for t in tasks))
    for i, t in enumerate(tasks):
        if ptr is not None:
            # provision the pool at the trace's per-stage maximum and mask
            # availability with the slot windows (the DES's transform)
            M_t = t["dag"].num_stages
            on_t, off_t, _ = ptr.slot_windows(M_t)
            t["dag"] = t["dag"].with_replicas(
                ptr.materialize(M_t).max(axis=0))
            t["_pool"] = (on_t, off_t)
        if t.get("workload") is not None:
            from .workloads import resolve_workload
            if t.get("pred") is not None:
                raise ValueError(
                    f"tasks[{i}]: pass either pred or workload=, not both")
            t["pred"], t["act"], wl_release = resolve_workload(
                t["workload"], t["dag"], t0)
            if t.get("arrivals") is None:
                t["arrivals"] = wl_release
        if t.get("replicas") is not None:
            t["replicas"] = _norm_replica_axis(t["replicas"], t["dag"],
                                               where=f"tasks[{i}]")
        t["price_traces"] = _norm_trace_axis(t.get("price_traces"), base_pf,
                                             where=f"tasks[{i}]")
        if t.get("faults") is not None:
            J_t = int(np.asarray(t["pred"]["P_private"]).shape[-2])
            t["faults"] = normalize_fault_axis(
                t["faults"], J_t, t["dag"].num_stages, retry_eff,
                where=f"tasks[{i}]")
    I_max = max(_max_replica_bound(t["dag"], t.get("replicas"))
                for t in tasks)
    S_seg = max(_max_segment_bound(t["price_traces"]) for t in tasks)
    # the outage-window bound of the sweep's shape family (the attempt
    # bound is the retry policy's, every fault model padded to it)
    W = max([max_outage_slots(t["faults"]) for t in tasks
             if t.get("faults") is not None] or [0])
    t_plan = time.perf_counter()
    prepped = [_Task(t["dag"], t["pred"], t.get("act"),
                     t.get("c_max_grid", (60.0,)),
                     t.get("orders", ("spt",)), cost_model, t0, M_pad,
                     I_max=I_max, portfolio=portfolio,
                     include_transfers=bool(include_transfers),
                     arrivals=t.get("arrivals"),
                     replicas=t.get("replicas"),
                     replica_speeds=t.get("replica_speeds"),
                     price_traces=t["price_traces"], S_seg=S_seg,
                     faults=t.get("faults"), retry=retry_eff,
                     init_window=t.get("init_window", init_window), W=W,
                     caps=caps_eff, coldstart=cs, pool=t.get("_pool"),
                     offload_mask=t.get("offload_mask"),
                     init_override=t.get("init_phase"),
                     adaptive_override=t.get("adaptive"),
                     where=f"tasks[{i}]")
               for i, t in enumerate(tasks)]
    return prepped, time.perf_counter() - t_plan


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
        c_max=p.c_max_out.copy(), batch_idx=p.batch_out.copy(),
        release=None if p.release is None else np.zeros((p.S, 0)),
        replica=np.full((p.S, 0, p.M), -1, dtype=np.int64),
        replicas=p.repl_out.copy(),
        segment=np.full((p.S, 0, p.M), -1, dtype=np.int64),
        trace_idx=p.trace_out.copy(),
        attempts=np.zeros((p.S, 0, p.M), dtype=np.int64),
        failed=np.zeros((p.S, 0, p.M), dtype=np.int64),
        abandoned=np.zeros((p.S, 0), dtype=bool),
        fault_idx=p.fault_out.copy(),
        queue_wait=np.zeros((p.S, 0, p.M)),
        cold=np.zeros((p.S, 0, p.M), dtype=bool))
