"""Discrete-event simulator of the hybrid platform + Alg. 1 event loop.

Stands in for the live AWS-Lambda/OpenFaaS deployment: private replicas are
exclusive servers (I_k per stage), the public cloud has unlimited
parallelism, and data transfers pay an upload/download latency. The
*scheduler* sees only **predicted** latencies (from the perf models); the
clock advances with **actual** latencies, so model error degrades schedule
quality exactly as in the live system (Sec. V-C, Fig. 5).

Semantics of one ACD sweep follow Alg. 1 lines 14-20 with the dispatched
jobs removed as the loop progresses (offloading a job frees queue capacity
for those behind it): a sequential kept-prefix scan.

Workloads are either the paper's batch (every job released at ``t0``) or
an exogenous arrival stream (:mod:`.arrivals`): ``simulate(arrivals=...)``
injects per-job release times as heap events. Each release epoch enqueues
the arriving jobs at their source stages (or sends them straight public if
the initialization phase marked them) and re-runs the ACD sweep; deadlines
are per-job, ``release[j] + C_max``, which degenerates to the single batch
deadline ``t0 + C_max`` when every release is ``t0`` — the batch path is
bit-exact pre/post this generalization (``tests/test_arrivals.py``).

The public cloud is a provider *portfolio* (:mod:`.cost`): each offloaded
(job, stage) runs on its cheapest feasible provider. With static prices
the argmin is precomputed in the constructor, so the event loop only ever
reads pre-gathered per-provider durations and prices; under **price
traces** the argmin is evaluated at the *offload epoch* — the event time
at which ``_start_public`` fires — over each provider's price segment
active at that instant, and the chosen (provider, segment) pair is locked
for the whole stage (billing, latency multiplier, downloads). ``loc``
holds the provider index (-1 = private replica), ``segment`` the billed
price segment (-1 = private; 0 for static portfolios). When a forced-
public cascade moves a DAG edge between providers, the upstream
provider's egress (at the upstream stage's recorded segment) is billed on
the edge's un-multiplied download volume.

Engine selection: this module is the ``engine="des"`` reference
implementation — an event heap driving per-stage sorted queues. The
``engine="vector"`` twin (:mod:`.vectorsim`) runs the same algorithm as
per-stage event loops in PyTorch (DAG structure as data, the scenario
axis as a batch dimension), batched over whole scenario grids;
:func:`simulate` dispatches between them, and
:func:`.vectorsim.sweep_scenarios` evaluates whole figures at once.

Hot-path notes (perf rewrite): queues are kept sorted by ``bisect.insort``
on precomputed ``(key, job)`` tuples instead of re-sorting on every
arrival; the ACD kept-prefix scan runs as a vectorized first-violator
loop over numpy views of the queue (equivalent to the sequential scan
because every job ahead of the first violator is kept in both); per-stage
adjacency/descendants/sinks come from the cached ``AppDAG`` structure; and
the Eqn.-1 cost of every (job, stage) is precomputed as one matrix.
"""
from __future__ import annotations

import bisect
import dataclasses
import heapq
import itertools
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from .arrivals import ArrivalsLike, resolve_release
from .coldstart import (ColdStartLike, ColdStartModel, ConcurrencyLike,
                        PoolTraceLike, as_coldstart, as_pool_trace,
                        norm_concurrency, validate_load_kwargs)
from .cost import (CostModel, EGRESS_GB_PER_S, LAMBDA_COST,
                   ProviderPortfolio, as_portfolio)
from .dag import AppDAG
from .faults import FaultLike, FaultModel, RetryPolicy, as_fault_model
from .greedy import init_offload, t_max
from .priority import ORDERS

WAITING, QUEUED, RUNNING, DONE = 0, 1, 2, 3
# Placement is a provider index: PRIVATE (-1) is the private cloud, values
# >= 0 index the portfolio's public providers (0 for the scalar model).
PRIVATE = -1


@dataclasses.dataclass
class SimResult:
    """One executed schedule: times, placement, and billed cost.

    ``deadline`` is the *relative* deadline C_max; for batch runs the
    absolute deadline is ``t0 + C_max``, under an arrival stream each job
    has its own, ``release[j] + C_max``. ``release`` records the stream
    (``None`` for the batch path, where every release is ``t0``).

    Under a :class:`~.faults.FaultModel`, ``attempts``/``failed`` count
    public invocation attempts per (job, stage) and ``abandoned`` marks
    jobs whose recovery was impossible before their deadline: their
    unfinished stages keep NaN ``end`` times, ``completion`` is NaN, and
    the ``makespan`` is taken over completed jobs only (abandoned jobs
    count as SLA misses in :meth:`sla_attainment`). Without faults the
    fields are the trivial derivations (attempts = public_mask, failed =
    0, abandoned = none), so engine-equivalence checks can always compare
    them.
    """

    makespan: float
    cost_usd: float
    public_mask: np.ndarray      # [J, M] bool: ran in the public cloud
    start: np.ndarray            # [J, M] stage start times (s)
    end: np.ndarray              # [J, M] stage end times (s)
    completion: np.ndarray       # [J] job completion (results in private storage)
    n_offloaded_stages: int
    n_init_offloaded_jobs: int
    per_stage_offloads: np.ndarray  # [M]
    deadline: float
    provider: Optional[np.ndarray] = None  # [J, M] int: -1 private, else index
    release: Optional[np.ndarray] = None   # [J] job release times (None=batch)
    replica: Optional[np.ndarray] = None   # [J, M] int: private replica, -1 = public
    segment: Optional[np.ndarray] = None   # [J, M] int: price segment, -1 = private
    attempts: Optional[np.ndarray] = None  # [J, M] int: public attempts made
    failed: Optional[np.ndarray] = None    # [J, M] int: failed public attempts
    abandoned: Optional[np.ndarray] = None  # [J] bool: recovery was impossible
    queue_wait: Optional[np.ndarray] = None  # [J, M] capped-slot FIFO wait (s)
    cold: Optional[np.ndarray] = None      # [J, M] bool: paid a cold start

    @property
    def offload_fraction(self) -> float:
        return float(self.public_mask.mean())

    @property
    def met_deadline(self) -> bool:
        return bool(self.makespan <= self.deadline + 1e-9)

    @property
    def flow_time(self) -> np.ndarray:
        """[J] per-job latency: completion minus release (release=t0 batch)."""
        if self.release is None:
            if not self.completion.size:
                return self.completion
            t0 = float(self.completion.max()) - self.makespan
            return self.completion - t0
        return self.completion - self.release

    def sla_attainment(self, sla_s: Optional[float] = None) -> float:
        """Fraction of jobs finishing within ``sla_s`` of their release.

        Defaults to the schedule's own relative deadline C_max. For batch
        runs every release is the common ``t0``, so this is the fraction of
        jobs completing by the batch deadline.
        """
        if not self.completion.size:
            return 1.0
        sla = self.deadline if sla_s is None else float(sla_s)
        return float((self.flow_time <= sla + 1e-9).mean())

    @property
    def abandoned_fraction(self) -> float:
        """Fraction of jobs abandoned by the recovery layer (0 w/o faults)."""
        if self.abandoned is None or not self.completion.size:
            return 0.0
        return float(self.abandoned.mean())


class _Sim:
    def __init__(self, dag: AppDAG, pred: Dict[str, np.ndarray],
                 act: Dict[str, np.ndarray], c_max: float, order: str,
                 cost_model: CostModel, include_transfers: bool,
                 init_phase: bool, adaptive: bool, t0: float,
                 replica_slowdown: Optional[Dict[Tuple[int, int], float]] = None,
                 portfolio: Optional[ProviderPortfolio] = None,
                 release: Optional[np.ndarray] = None,
                 faults: Optional[FaultModel] = None,
                 retry: Optional[RetryPolicy] = None,
                 init_window: Optional[float] = None,
                 chunk_jobs: Optional[int] = None,
                 egress_lookahead: bool = False,
                 caps: Optional[np.ndarray] = None,
                 coldstart: Optional[ColdStartModel] = None,
                 pool: Optional[Tuple[np.ndarray, np.ndarray]] = None,
                 offload_mask: Optional[np.ndarray] = None):
        self.dag = dag
        self.J, self.M = pred["P_private"].shape
        self.pred = pred
        self.act = act
        self.c_max = c_max
        self.t0 = t0
        # per-job absolute deadlines: release + C_max (relative SLA). For a
        # batch every release is t0, so deadline_j is the constant t0+C_max
        # and the arithmetic below is bit-identical to the scalar-deadline
        # code it replaced.
        self.release = release
        rel = np.full(self.J, t0) if release is None \
            else np.asarray(release, dtype=np.float64)
        self._rel = rel
        self.deadline_j = rel + c_max
        self.order = order
        self.cost_model = cost_model
        self.portfolio = as_portfolio(portfolio, cost_model)
        self.include_transfers = include_transfers
        self.adaptive = adaptive
        self.init_phase = init_phase
        # None = classic Alg. 1 (whole trace visible at t0); a float gates
        # init offload to jobs released within [t0, t0 + init_window]
        self.init_window = init_window
        # precomputed per-job offload plan ([J] bool): when given it
        # REPLACES the capacity-prefix initialization rule — the policy
        # harness's hook for externally-decided placements
        self.offload_mask = offload_mask
        # windowed event admission: arrival epochs enter the heap in pages
        # of >= chunk_jobs jobs (the same page boundaries the vector
        # engine's streaming path uses); None keeps the whole horizon in
        # the heap up front
        if chunk_jobs is not None and int(chunk_jobs) < 1:
            raise ValueError("chunk_jobs must be >= 1")
        self._chunk = None if chunk_jobs is None else int(chunk_jobs)
        self._lookahead = bool(egress_lookahead)
        # (stage, replica_idx) -> multiplicative slowdown (straggler injection)
        self.replica_slowdown = replica_slowdown or {}
        # fault layer: failures are scenario data (.faults), evaluated by
        # retry re-enqueue heap events; the no-fault path below is the
        # verbatim pre-fault code (the chain path reuses its expressions,
        # so a zero FaultModel reproduces it bit-exactly)
        self._faulty = faults is not None
        if self._faulty:
            self._retry = retry if retry is not None else RetryPolicy()
            self._fail_g = faults.fail                        # [J, M, A]
            self._delay_g = self._retry.delays(faults.jitter)  # [J, M, A]
            self._A = faults.num_attempt_slots
            self._kill_frac = float(faults.kill_frac)
            self._fb_on = bool(self._retry.private_fallback)
            self._outw = faults.outage_windows(
                self.portfolio.num_providers)                 # [P, W, 2]
            self._okill = bool(faults.outage_kills) and self._outw.shape[1] > 0

        # provider selection: each (job, stage), if offloaded, runs on the
        # cheapest feasible provider by *predicted* billed cost. Static
        # portfolios precompute the argmin (time-independent, shared with
        # the vector engine and the MILP baseline); price-traced portfolios
        # precompute the full [P, S, J, M] segment-indexed matrices and
        # defer the argmin to the offload epoch (_start_public), where the
        # active segment of each provider is known.
        mem = dag.mem_mb
        pf = self.portfolio
        # the precomputed fast path needs placement to be a static per-
        # (job, stage) argmin: time-independent prices AND no cross-
        # provider switch penalty (single provider). Multi-provider
        # portfolios resolve placement at the offload epoch, where the
        # upstream providers (and so the egress penalty) are known.
        # Retry re-placement masks providers per attempt, so the fault
        # layer always resolves placement at the attempt epoch too.
        # concurrency caps need the segmented [P, S] matrices too: the
        # occupancy term re-prices providers at every offload epoch
        self._static_prices = (pf.is_static and pf.num_providers == 1
                               and not self._faulty and caps is None)
        down_pred = pred["download"] if include_transfers else None
        down_act = act["download"] if include_transfers else None
        sinkm = dag.is_sink if include_transfers else None
        if self._static_prices:
            H_pred_sel = pf.np_selection_costs(pred["P_public"], mem,
                                               down_pred, sinkm,
                                               require=~dag.must_private_mask)
            self.prov = pf.select(H_pred_sel)                  # [J, M]
            lat = pf.latency_mults[self.prov]                  # [J, M]
            H_pred = pf.min_cost(H_pred_sel)
        else:
            self._sel_pst = pf.np_selection_costs_seg(
                pred["P_public"], mem, down_pred, sinkm,
                require=~dag.must_private_mask)                # [P, S, J, M]
            self._cost_pst = pf.np_stage_costs_seg(
                act["P_public"], mem, down_act, sinkm)         # [P, S, J, M]
            self._edges = pf.segment_edges()                   # [P, S]
            self._lat_seg = pf.latency_mults_seg()             # [P, S]
            self._iota_P = np.arange(pf.num_providers)
            # keys/init-offload see the trace prices at plan time t0 (the
            # same static [J, M] matrix the vector engine's keys use)
            seg0 = pf.segments_at(t0)                          # [P]
            H_pred = np.min(self._sel_pst[self._iota_P, seg0], axis=0)
        # egress rates per (provider, segment): cross-provider cascade
        # billing reads these for static portfolios too (S=1 there)
        self._egress_seg = pf.egress_seg()                     # [P, S]

        # priority keys: per-stage and whole-job, from *predicted* quantities
        # (H seen by the keys = the selected provider's predicted price)
        key_fn = ORDERS[order]
        self.stage_keys = np.stack(
            [key_fn(pred["P_private"], H_pred, k) for k in range(self.M)], axis=1)
        self.job_keys = key_fn(pred["P_private"], H_pred, None)
        self.H_pred = H_pred
        # Gamma(l): per-job critical-path remainder, predicted private latencies
        self.path_rem = dag.longest_path_latency(pred["P_private"])  # [J, M]

        # hot-path precomputation ------------------------------------------
        self.P_pred = np.ascontiguousarray(pred["P_private"], dtype=np.float64)
        # plain-float nested lists: scalar reads off numpy arrays dominate
        # the event loop otherwise
        self._act_priv = act["P_private"].tolist()
        if self._static_prices:
            # billed cost of every (job, stage) on its selected provider
            # (actual runtime; includes sink egress when transfers are
            # modeled); public/transfer draws carry the selected provider's
            # latency multiplier
            H_act_sel = pf.np_stage_costs(act["P_public"], mem, down_act,
                                          sinkm)
            self.H_act = np.take_along_axis(H_act_sel, self.prov[None],
                                            axis=0)[0]
            self._act_pub = (act["P_public"] * lat).tolist()
            self._act_up = (act["upload"] * lat).tolist()
            self._act_down = (act["download"] * lat).tolist()
            self._prov_l = self.prov.tolist()
            self._cost_l = self.H_act.tolist()
        else:
            # raw draws; the offload epoch's (provider, segment) supplies
            # the latency multiplier and the billed price
            self._act_pub_raw = act["P_public"].tolist()
            self._act_up_raw = act["upload"].tolist()
            self._act_down_raw = act["download"].tolist()
        # un-multiplied download volumes (GB) for cross-provider egress:
        # predicted volumes feed the selection penalty (a decision),
        # actual volumes the billing
        self._down_gb_pred = (pred["download"] * EGRESS_GB_PER_S).tolist()
        self._down_gb = (act["download"] * EGRESS_GB_PER_S).tolist()
        self._keys_l = self.stage_keys.tolist()
        # cached DAG structure
        self._succ = dag.succ_lists
        self._pred_l = dag.pred_lists
        # predecessors in topological-position order: the egress penalty /
        # billing accumulate in exactly the vector engine's stage order,
        # so float summation associates identically and near-tie argmins
        # cannot flip between engines
        _pos = {s: i for i, s in enumerate(dag.topo_order())}
        self._pred_topo = [sorted(ps, key=_pos.__getitem__)
                           for ps in dag.pred_lists]
        self._succ_topo = [sorted(ss, key=_pos.__getitem__)
                           for ss in dag.succ_lists]
        self._desc = dag.descendant_lists
        self._is_sink = set(dag.sink_ids)
        self._repl = [max(int(r), 1) for r in dag.replicas]
        self._pinned = [bool(s.must_private) for s in dag.stages]

        # runtime state
        self.status = np.full((self.J, self.M), WAITING, dtype=np.int8)
        self.loc = np.full((self.J, self.M), PRIVATE, dtype=np.int16)
        # billed price segment of each public (job, stage); -1 = private
        self.segment = np.full((self.J, self.M), -1, dtype=np.int16)
        # which private replica ran each (job, stage); -1 = ran public
        self.replica = np.full((self.J, self.M), -1, dtype=np.int32)
        self.forced_public = np.zeros((self.J, self.M), dtype=bool)
        self.start = np.full((self.J, self.M), np.nan)
        self.end = np.full((self.J, self.M), np.nan)
        self.completion = np.zeros(self.J)
        # queues[k]: (key, job) tuples kept sorted by bisect.insort — the
        # same total order as the seed's sort(key=(stage_key, job))
        self.queues: List[List[Tuple[float, int]]] = [[] for _ in range(self.M)]
        self.free_replicas: List[List[int]] = [
            list(range(dag.stages[k].replicas)) for k in range(self.M)]
        self.cost = 0.0
        self.n_offloaded = 0
        self.per_stage_offloads = np.zeros(self.M, dtype=np.int64)
        self.n_init_off = 0
        self.attempts = np.zeros((self.J, self.M), dtype=np.int64)
        self.failed = np.zeros((self.J, self.M), dtype=np.int64)
        self.abandoned = np.zeros(self.J, dtype=bool)
        self.queue_wait = np.zeros((self.J, self.M))
        self.coldarr = np.zeros((self.J, self.M), dtype=bool)

        # load-dependent latency state (.coldstart): per-(stage, provider)
        # FIFO slot pools under concurrency caps, per-replica/slot idle
        # timestamps under a cold-start model, per-slot availability
        # windows under a pool trace. All gated so degenerate configs run
        # the verbatim pre-change code above.
        self._caps = caps
        self._capped = caps is not None
        self._cs = coldstart
        self._pool = pool
        if self._capped or self._cs is not None:
            # $/s of held capacity per (provider, segment, stage): prices
            # queueing delay and warm-up into the argmin and the bill
            self._occ_psm = pf.np_occupancy_rates_seg(mem)     # [P, S, M]
        if self._cs is not None:
            self._wu_pub = self._cs.provider_warm_ups(pf.num_providers)
            self._wu_priv = self._cs.warm_up_s
            self._ka = self._cs.keep_alive_s
            s2z = self._cs.scale_to_zero
        if self._capped:
            self._slotc: Dict[Tuple[int, int], np.ndarray] = {}
            self._slot_idle: Dict[Tuple[int, int], np.ndarray] = {}
            idle0 = -np.inf if (self._cs is not None
                                and self._cs.scale_to_zero) else float(t0)
            for k in range(self.M):
                for p in range(pf.num_providers):
                    if np.isfinite(caps[p]):
                        c = int(caps[p])
                        self._slotc[(k, p)] = np.full(c, float(t0))
                        self._slot_idle[(k, p)] = np.full(c, idle0)
        if self._cs is not None:
            # private replicas: idle-since timestamps (turn-on instant for
            # late pool slots, -inf under scale-to-zero)
            self._idle_priv = []
            for k in range(self.M):
                n_k = len(self.free_replicas[k])
                if s2z:
                    self._idle_priv.append(np.full(n_k, -np.inf))
                elif pool is not None:
                    self._idle_priv.append(
                        np.maximum(float(t0), pool[0][k][:n_k]).astype(
                            np.float64))
                else:
                    self._idle_priv.append(np.full(n_k, float(t0)))
        self._heap: List[Tuple[float, int, Callable, tuple]] = []
        self._seq = itertools.count()

    # -- event plumbing -------------------------------------------------
    def _at(self, t: float, fn: Callable, *args):
        heapq.heappush(self._heap, (t, next(self._seq), fn, args))

    def run(self) -> SimResult:
        self._initialize()
        heap = self._heap
        while heap:
            t, _, fn, args = heapq.heappop(heap)
            fn(t, *args)
        public_mask = self.loc != PRIVATE
        completion = self.completion
        if not self._faulty:
            makespan = float(np.max(completion) - self.t0) if self.J else 0.0
            attempts = public_mask.astype(np.int64)
        else:
            # abandoned jobs never complete: completion is NaN and the
            # makespan is taken over the jobs that did finish
            completion = completion.copy()
            completion[self.abandoned] = np.nan
            ok = ~self.abandoned
            makespan = float(np.max(completion[ok]) - self.t0) \
                if ok.any() else 0.0
            attempts = self.attempts
        return SimResult(
            makespan=makespan, cost_usd=self.cost,
            public_mask=public_mask, start=self.start, end=self.end,
            completion=completion, n_offloaded_stages=self.n_offloaded,
            n_init_offloaded_jobs=self.n_init_off,
            per_stage_offloads=self.per_stage_offloads, deadline=self.c_max,
            provider=self.loc.astype(np.int64),
            release=None if self.release is None else self._rel.copy(),
            replica=self.replica.astype(np.int64),
            segment=self.segment.astype(np.int64),
            attempts=attempts, failed=self.failed.copy(),
            abandoned=self.abandoned.copy(),
            queue_wait=self.queue_wait.copy(), cold=self.coldarr.copy())

    # -- Alg. 1 initialization phase ------------------------------------
    def _initialize(self):
        if self.offload_mask is not None:
            # externally-decided placement (policy harness): the mask is
            # the whole plan — no capacity-prefix scan
            off = np.asarray(self.offload_mask, dtype=bool).copy()
        elif self.init_phase:
            C_total = self.pred["P_private"].sum(axis=1)
            cap = t_max(self.dag.replicas, self.c_max)
            if self.init_window is not None:
                # under arrivals the planner must not see the whole trace
                # at t0: only jobs released within the first window are
                # init-offload candidates (zeroed demand keeps the rest
                # from consuming capacity in the prefix scan)
                elig = self._rel <= self.t0 + self.init_window
                off = init_offload(np.where(elig, C_total, 0.0),
                                   self.job_keys, cap) & elig
            else:
                off = init_offload(C_total, self.job_keys, cap)
        else:
            off = np.zeros(self.J, dtype=bool)
        self.n_init_off = int(off.sum())
        if self._pool is not None:
            # pool-trace turn-ons: slots not yet active at t0 leave the
            # free pool and re-enter via heap events at their turn-on
            # instants (the vector engine's clock0 = max(t0, on) twin);
            # turn-offs are checked lazily at dispatch time
            on_w = self._pool[0]
            for k in range(self.M):
                late = [r for r in self.free_replicas[k]
                        if on_w[k][r] > self.t0]
                if late:
                    drop = set(late)
                    self.free_replicas[k] = [
                        r for r in self.free_replicas[k] if r not in drop]
                    for r in late:
                        self._at(float(on_w[k][r]), self._pool_on_event,
                                 k, r)
        pinned = self.dag.must_private_mask
        self.forced_public[off[:, None] & ~pinned[None, :]] = True
        # the t0 batch keeps the seed's direct path (enqueue all, then one
        # sweep per stage); later release epochs become heap events
        at_t0 = self._rel <= self.t0
        for j in range(self.J):
            if at_t0[j]:
                for k in self.dag.source_ids:
                    self._stage_ready(self.t0, j, k)
        for k in range(self.M):
            self._sweep_and_dispatch(self.t0, k)
        later = np.flatnonzero(~at_t0)
        if later.size:
            times = self._rel[later]
            epochs = [(float(t_r), tuple(int(j) for j in later[times == t_r]))
                      for t_r in np.unique(times)]
            if self._chunk is None:
                for t_r, jobs in epochs:
                    self._at(t_r, self._arrival_epoch, jobs)
            else:
                # windowed admission: the heap only ever holds ~chunk_jobs
                # future arrival epochs; the last epoch of each window
                # admits the next when it fires (its time strictly
                # precedes every epoch it admits, so heap order is
                # preserved). Tied release groups share an epoch and are
                # never split across windows.
                self._epochs = epochs
                self._epoch_pos = 0
                self._admit_window()

    def _admit_window(self):
        start = self._epoch_pos
        n = 0
        while self._epoch_pos < len(self._epochs) and n < self._chunk:
            n += len(self._epochs[self._epoch_pos][1])
            self._epoch_pos += 1
        last = self._epoch_pos - 1
        for i in range(start, self._epoch_pos):
            t_r, jobs = self._epochs[i]
            self._at(t_r, self._arrival_epoch, jobs, i == last)

    def _arrival_epoch(self, t: float, jobs: Tuple[int, ...],
                       chain_next: bool = False):
        """Release epoch: arriving jobs enqueue at their source stages (or
        go straight public if the initialization phase marked them), then
        the ACD sweep re-runs over each source queue. Jobs sharing a
        release time enqueue together before any dispatch, mirroring the
        t0 batch path. An arrival that goes straight public is not a queue
        change and triggers no sweep — the same convention
        :meth:`_propagate_done` uses for forced-public downstream stages
        (and the one the vector engine's eligibility-filtered arrival
        stream encodes)."""
        if chain_next and self._epoch_pos < len(self._epochs):
            self._admit_window()
        for j in jobs:
            for k in self.dag.source_ids:
                self._stage_ready(t, j, k)
        for k in self.dag.source_ids:
            if any(not self.forced_public[j, k] for j in jobs):
                self._sweep_and_dispatch(t, k)

    # -- readiness / queueing -------------------------------------------
    def _stage_ready(self, t: float, j: int, k: int):
        """All predecessors of (j,k) are done: enqueue or go public."""
        self.status[j, k] = QUEUED
        if self.forced_public[j, k]:
            self._start_public(t, j, k)
        else:
            bisect.insort(self.queues[k], (self._keys_l[j][k], j))

    def _on_queue_change(self, t: float, k: int):
        self._sweep_and_dispatch(t, k)

    def _sweep_and_dispatch(self, t: float, k: int):
        """ACD kept-prefix scan (lines 14-20), then fill free replicas."""
        q = self.queues[k]
        if self.adaptive and q and not self._pinned[k]:
            I_k = self._repl[k]
            jobs = np.fromiter((jj for (_, jj) in q), dtype=np.int64, count=len(q))
            P = self.P_pred[jobs, k]
            # slack_i = I_k * (D_i - t - path_rem_i); job i is offloaded iff
            # the kept-prefix of P ahead of it exceeds slack_i (ACD < 0).
            # D_i is the job's own deadline (release_i + C_max; the common
            # batch deadline when every release is t0). The first violator
            # under the *full* prefix equals the first under the
            # kept-prefix (everything ahead of it is kept), so removing
            # first violators one at a time reproduces the sequential scan.
            slack = I_k * (self.deadline_j[jobs] - t - self.path_rem[jobs, k])
            while jobs.size:
                prefix_excl = np.cumsum(P) - P
                viol = np.flatnonzero(prefix_excl > slack)
                if viol.size == 0:
                    break
                i = int(viol[0])
                self._offload_now(t, int(jobs[i]), k)
                del q[i]
                jobs = np.delete(jobs, i)
                P = np.delete(P, i)
                slack = np.delete(slack, i)
        # dispatch to free replicas: head of queue takes the lowest-index
        # free replica (the pool is kept sorted, so pop(0) is the min) —
        # the deterministic tie-break shared with the vector engine, which
        # makes the replica *assignment* (not just timings) engine-exact
        free = self.free_replicas[k]
        if self._pool is not None:
            # lazy slot retirement: a slot whose window closed stops
            # accepting work (it drains gracefully — a running job keeps
            # its completion event) and is dropped from the pool for good
            off_k = self._pool[1][k]
            while free and q:
                r = free[0]
                if t >= off_k[r]:
                    free.pop(0)
                    continue
                _, j = q.pop(0)
                free.pop(0)
                self._start_private(t, j, k, r)
        else:
            while free and q:
                _, j = q.pop(0)
                r = free.pop(0)
                self._start_private(t, j, k, r)

    # -- private execution ----------------------------------------------
    def _start_private(self, t: float, j: int, k: int, r: int):
        self.status[j, k] = RUNNING
        self.loc[j, k] = PRIVATE
        self.replica[j, k] = r
        start = t
        if self._cs is not None:
            # cold start: the replica was idle longer than the keep-alive
            # window (or never used, under scale-to-zero) — the warm-up
            # penalty is additive, not scaled by straggler slowdowns
            idle = self._idle_priv[k][r]
            if t - idle > self._ka or idle == -np.inf:
                self.coldarr[j, k] = True
                start = t + self._wu_priv
        self.start[j, k] = start
        dur = self._act_priv[j][k]
        if self.replica_slowdown:
            dur *= self.replica_slowdown.get((k, r), 1.0)
        self._at(start + dur, self._private_done, j, k, r)

    def _private_done(self, t: float, j: int, k: int, r: int):
        self.status[j, k] = DONE
        self.end[j, k] = t
        if self._cs is not None:
            self._idle_priv[k][r] = t
        # sorted re-insert keeps the lowest-index-free dispatch rule exact
        bisect.insort(self.free_replicas[k], r)
        self._propagate_done(t, j, k)
        self._on_queue_change(t, k)

    def _pool_on_event(self, t: float, k: int, r: int):
        """Pool-trace slot turn-on: join the pool, re-run the sweep."""
        bisect.insort(self.free_replicas[k], r)
        self._on_queue_change(t, k)

    # -- public execution -------------------------------------------------
    def _offload_now(self, t: float, j: int, k: int):
        """Job j evicted from queue k: stage k + all descendants go public
        (privacy-pinned stages excepted, constraint (12))."""
        # the vector engine carries eviction instants sign-encoded as
        # -t - 1 inside its queue state; the encode/decode roundtrip can
        # shave one ulp when t + 1 crosses a binade, so the offload epoch
        # here passes through the identical (idempotent) expression —
        # both engines then price and start the eviction at the same float
        t = -(-t - 1.0) - 1.0
        self.forced_public[j, k] = True
        for d in self._desc[k]:
            if not self._pinned[d]:
                self.forced_public[j, d] = True
        self._start_public(t, j, k)

    def _selc_at(self, t: float, j: int, k: int):
        """Decision-epoch selection costs [P] + active segments [P].

        The argmin runs over each provider's price segment active at
        ``t``, plus the provider-affinity penalty — placing stage k on a
        provider other than a public predecessor's pays that
        predecessor's (predicted) egress to move the edge, so cascades
        prefer staying put unless the price gap covers the hop.

        With ``egress_lookahead`` each candidate additionally carries a
        one-edge downstream recourse term: per unpinned successor edge
        (k, v), the candidate provider's own egress rate (at its active
        segment) times the predicted edge volume — the cost the schedule
        will pay to move stage k's output *off* that provider if v lands
        elsewhere (or back to private storage). Successor terms accumulate
        after the predecessor terms, in ascending topological order, the
        same float association as the vector engine. Plan-time priority
        keys exclude the term (it is a decision-epoch quantity).
        """
        segs = (self._edges <= t).sum(axis=1) - 1              # [P]
        selc = self._sel_pst[self._iota_P, segs, j, k]         # [P]
        if self.include_transfers:
            loc_j = self.loc[j]
            seg_j = self.segment[j]
            for u in self._pred_topo[k]:
                lu = loc_j[u]
                if lu >= 0:
                    pen = (self._egress_seg[lu, seg_j[u]]
                           * self._down_gb_pred[j][u])
                    selc = selc + np.where(self._iota_P != lu, pen, 0.0)
            if self._lookahead:
                egc = self._egress_seg[self._iota_P, segs]     # [P]
                for v in self._succ_topo[k]:
                    if not self._pinned[v]:
                        selc = selc + egc * self._down_gb_pred[j][k]
        return selc, segs

    def _start_public_capped(self, t: float, j: int, k: int):
        """Offload epoch under concurrency caps.

        Each capped provider exposes ``cap`` FIFO slots for stage k (one
        function's reserved concurrency); the dispatch would take the
        earliest-free slot (lowest index on ties), waiting
        ``max(0, slot_clock - ready)`` if all are busy, plus the
        provider's warm-up when that slot has been idle past the
        keep-alive window. Both delays are priced as occupancy (the
        segment's $/GB-s rate times the stage's memory) and added to the
        candidate's selection cost, so a congested or cold provider
        prices itself out of the argmin; the chosen provider's wait and
        warm-up then also delay the start and join the bill. Uncapped
        providers model an unbounded warm fleet: zero wait, never cold.
        """
        selc, segs = self._selc_at(t, j, k)
        pf = self.portfolio
        P = pf.num_providers
        lm = self._lat_seg[self._iota_P, segs]                 # [P]
        up_raw = 0.0
        if self.include_transfers:
            preds = self._pred_l[k]
            loc_j = self.loc[j]
            if (not preds) or any(loc_j[p] == PRIVATE for p in preds):
                up_raw = self._act_up_raw[j][k]
        ready = t + up_raw * lm                                # [P]
        wait = np.zeros(P)
        cold = np.zeros(P, dtype=bool)
        slot = np.zeros(P, dtype=np.int64)
        for p in range(P):
            sc = self._slotc.get((k, p))
            if sc is None:
                continue  # unbounded fleet: always a warm slot free
            s_i = int(np.argmin(sc))
            slot[p] = s_i
            wait[p] = max(0.0, sc[s_i] - ready[p])
            if self._cs is not None:
                idle = self._slot_idle[(k, p)][s_i]
                cold[p] = (ready[p] + wait[p] - idle > self._ka
                           or idle == -np.inf)
        wu = self._wu_pub if self._cs is not None else np.zeros(P)
        occ = self._occ_psm[self._iota_P, segs, k]             # [P]
        prov = int(np.argmin(selc + occ * (wait + cold * wu)))
        seg = int(segs[prov])
        self.loc[j, k] = prov
        self.segment[j, k] = seg
        self.n_offloaded += 1
        self.per_stage_offloads[k] += 1
        if self.include_transfers:
            loc_j = self.loc[j]
            for u in self._pred_topo[k]:
                lu = loc_j[u]
                if lu >= 0 and lu != prov:
                    self.cost += (self._egress_seg[lu, self.segment[j, u]]
                                  * self._down_gb[j][u])
        start = ready[prov] + wait[prov] + cold[prov] * wu[prov]
        end = start + self._act_pub_raw[j][k] * lm[prov]
        self.start[j, k] = start
        self.queue_wait[j, k] = wait[prov]
        if cold[prov]:
            self.coldarr[j, k] = True
        self.cost += (self._cost_pst[prov, seg, j, k]
                      + occ[prov] * (wait[prov] + cold[prov] * wu[prov]))
        sc = self._slotc.get((k, prov))
        if sc is not None:
            sc[slot[prov]] = end
            if self._cs is not None:
                self._slot_idle[(k, prov)][slot[prov]] = end
        self._at(end, self._public_done, j, k)

    def _start_public(self, t: float, j: int, k: int):
        self.status[j, k] = RUNNING
        if self._faulty:
            self._start_public_faulty(t, j, k)
            return
        if self._capped:
            self._start_public_capped(t, j, k)
            return
        if self._static_prices:
            prov = self._prov_l[j][k]
            seg = 0
            up_eff = self._act_up[j][k]
            dur = self._act_pub[j][k]
            billed = self._cost_l[j][k]
        else:
            # (provider, segment) lock for the whole stage even if
            # execution spans a price breakpoint
            selc, segs = self._selc_at(t, j, k)
            prov = int(np.argmin(selc))
            seg = int(segs[prov])
            lm = self._lat_seg[prov, seg]
            up_eff = self._act_up_raw[j][k] * lm
            dur = self._act_pub_raw[j][k] * lm
            billed = self._cost_pst[prov, seg, j, k]
        self.loc[j, k] = prov
        self.segment[j, k] = seg
        self.n_offloaded += 1
        self.per_stage_offloads[k] += 1
        up = 0.0
        if self.include_transfers:
            # upload whenever some input of stage k lives in private storage
            preds = self._pred_l[k]
            loc_j = self.loc[j]
            needs_up = (not preds) or any(loc_j[p] == PRIVATE for p in preds)
            if needs_up:
                up = up_eff
            # cross-provider cascade: an edge whose endpoints run public on
            # *different* providers pays the upstream provider's egress (at
            # the upstream stage's recorded segment) on the *actual* edge
            # volume
            for u in self._pred_topo[k]:
                lu = loc_j[u]
                if lu >= 0 and lu != prov:
                    self.cost += (self._egress_seg[lu, self.segment[j, u]]
                                  * self._down_gb[j][u])
        self.start[j, k] = t + up
        self.cost += billed
        self._at(t + up + dur, self._public_done, j, k)

    def _public_done(self, t: float, j: int, k: int):
        self.status[j, k] = DONE
        self.end[j, k] = t
        self._propagate_done(t, j, k)

    # -- fault layer: attempt chains, retry events, degraded recovery ------
    def _outage_at(self, t: float) -> np.ndarray:
        """[P] bool: provider inside an outage window at ``t``."""
        w = self._outw
        return ((w[:, :, 0] <= t) & (t < w[:, :, 1])).any(axis=1)

    def _selc_feasible(self, t: float, j: int, k: int, mask: np.ndarray):
        """Selection costs with outage-dark and already-failed providers
        masked to +inf (the same encoding mem-infeasibility uses)."""
        selc, segs = self._selc_at(t, j, k)
        selc = (selc + np.where(self._outage_at(t), np.inf, 0.0)
                + np.where(mask, np.inf, 0.0))
        return selc, segs

    def _start_public_faulty(self, t: float, j: int, k: int):
        """Offload epoch under a FaultModel: start the attempt chain."""
        mask = np.zeros(self.portfolio.num_providers, dtype=bool)
        selc, segs = self._selc_feasible(t, j, k, mask)
        if not np.isfinite(selc).any():
            # every provider dark/infeasible at the decision epoch: no
            # attempt is even dispatched
            self.start[j, k] = t
            self._resolve_failed(t, j, k)
            return
        # inputs are staged once, before the first attempt (retries rerun
        # from cloud storage) — the upload carries the first attempt's
        # provider multiplier, exactly as the fault-free path would
        prov = int(np.argmin(selc))
        lm = self._lat_seg[prov, int(segs[prov])]
        up = 0.0
        if self.include_transfers:
            preds = self._pred_l[k]
            loc_j = self.loc[j]
            needs_up = (not preds) or any(loc_j[p] == PRIVATE for p in preds)
            if needs_up:
                up = self._act_up_raw[j][k] * lm
        self.start[j, k] = t + up
        self._run_attempt(t, j, k, 0, mask, up)

    def _retry_public(self, t: float, j: int, k: int, a: int,
                      mask: np.ndarray):
        """Backoff expired: re-enter the placement argmin (heap event)."""
        self._run_attempt(t, j, k, a, mask, 0.0)

    def _run_attempt(self, t_att: float, j: int, k: int, a: int,
                     mask: np.ndarray, up: float):
        selc, segs = self._selc_feasible(t_att, j, k, mask)
        prov = int(np.argmin(selc))
        seg = int(segs[prov])
        lm = self._lat_seg[prov, seg]
        dur = self._act_pub_raw[j][k] * lm
        s = t_att + up
        e = s + dur
        billed = self._cost_pst[prov, seg, j, k]
        self.attempts[j, k] += 1
        # failure instant: the grid draw fires after kill_frac of the
        # duration; an outage window *starting* strictly inside the
        # execution interval reclaims the attempt at the window start
        t_fail = s + self._kill_frac * dur if self._fail_g[j, k, a] \
            else np.inf
        if self._okill:
            starts = self._outw[prov, :, 0]
            hit = starts[(starts > s) & (starts < e)]
            if hit.size:
                t_fail = min(t_fail, float(hit.min()))
        if not np.isfinite(t_fail):
            # success: bill egress (predecessors in topo order) then the
            # stage price — the fault-free path's accumulation order
            self.loc[j, k] = prov
            self.segment[j, k] = seg
            self.n_offloaded += 1
            self.per_stage_offloads[k] += 1
            if self.include_transfers:
                loc_j = self.loc[j]
                for u in self._pred_topo[k]:
                    lu = loc_j[u]
                    if lu >= 0 and lu != prov:
                        self.cost += (self._egress_seg[lu, self.segment[j, u]]
                                      * self._down_gb[j][u])
            self.cost += billed
            self._at(e, self._public_done, j, k)
            return
        # lost work bills pro-rata on the consumed fraction; the provider
        # is masked out of every later attempt of this (job, stage)
        self.failed[j, k] += 1
        self.cost += billed * ((t_fail - s) / dur if dur > 0.0 else 0.0)
        mask = mask.copy()
        mask[prov] = True
        if a + 1 < self._A:
            t_next = t_fail + self._delay_g[j, k, a + 1]
            if t_next <= self.deadline_j[j]:
                selc_n, _ = self._selc_feasible(t_next, j, k, mask)
                if np.isfinite(selc_n).any():
                    self._at(t_next, self._retry_public, j, k, a + 1, mask)
                    return
        self._resolve_failed(t_fail, j, k)

    def _resolve_failed(self, t_res: float, j: int, k: int):
        """Recovery terminal: degraded private slot, or abandon the job.

        The fallback is availability over schedule quality — a dedicated
        nominal-speed local slot outside the stage's replica pool (Alg.
        1's queues are not re-entered mid-failure), taken only when it
        can still start by the job's deadline. Otherwise the job is
        abandoned: this stage never finishes (NaN end) and its
        descendants never become ready.
        """
        if self._fb_on and t_res <= self.deadline_j[j]:
            self.start[j, k] = t_res
            self._at(t_res + self._act_priv[j][k], self._fallback_done, j, k)
        else:
            self.abandoned[j] = True

    def _fallback_done(self, t: float, j: int, k: int):
        self.status[j, k] = DONE
        self.end[j, k] = t
        self._propagate_done(t, j, k)

    # -- DAG propagation ---------------------------------------------------
    def _propagate_done(self, t: float, j: int, k: int):
        status_j = self.status[j]
        for q in self._succ[k]:
            if status_j[q] == WAITING and all(
                    status_j[p] == DONE for p in self._pred_l[q]):
                self._stage_ready(t, j, q)
                if not self.forced_public[j, q]:
                    self._on_queue_change(t, q)
        if k in self._is_sink:
            down = 0.0
            if self.include_transfers and self.loc[j, k] != PRIVATE:
                if self._static_prices:
                    down = self._act_down[j][k]
                else:
                    # the locked (provider, segment) supplies the multiplier
                    down = self._act_down_raw[j][k] * self._lat_seg[
                        self.loc[j, k], self.segment[j, k]]
            if t + down > self.completion[j]:
                self.completion[j] = t + down


def _with_transfer_defaults(d: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Shallow-copy ``d`` and default missing transfer matrices to zero.

    Copying keeps :func:`simulate` from mutating caller-owned dicts.
    """
    d = dict(d)
    zeros = None
    for key in ("upload", "download"):
        if key not in d:
            if zeros is None:
                zeros = np.zeros_like(d["P_private"])
            d[key] = zeros
    return d


def simulate(
    dag: AppDAG,
    pred: Dict[str, np.ndarray],
    act: Optional[Dict[str, np.ndarray]] = None,
    c_max: float = 60.0,
    order: str = "spt",
    cost_model: CostModel = LAMBDA_COST,
    include_transfers: bool = True,
    init_phase: bool = True,
    adaptive: bool = True,
    t0: float = 0.0,
    replica_slowdown: Optional[Dict[Tuple[int, int], float]] = None,
    engine: str = "des",
    portfolio: Optional[ProviderPortfolio] = None,
    arrivals: ArrivalsLike = None,
    faults: FaultLike = None,
    retry: Optional[RetryPolicy] = None,
    init_window: Optional[float] = None,
    chunk_jobs: Optional[int] = None,
    egress_lookahead: bool = False,
    concurrency: ConcurrencyLike = None,
    coldstart: ColdStartLike = None,
    pool_trace: PoolTraceLike = None,
    offload_mask: Optional[np.ndarray] = None,
    device=None,
) -> SimResult:
    """Run Alg. 1 over the hybrid platform simulator.

    ``pred``/``act``: dicts with P_private, P_public [J,M] (s) and upload,
    download [J,M] (s). ``act`` defaults to ``pred`` (perfect models).
    ``replica_slowdown`` injects stragglers: {(stage, replica): factor},
    a multiplicative slowdown on the private duration of everything that
    replica runs — supported by both engines (the vector engine carries
    per-replica speeds as a masked [M, I_max] matrix of scenario data).
    ``engine``: ``"des"`` (event-heap reference) or ``"vector"`` (the
    batched PyTorch engine in :mod:`.vectorsim`, run on ``device``:
    ``"cuda"`` unless given). ``portfolio``: a
    :class:`ProviderPortfolio` — offloaded stages run on their cheapest
    feasible provider; defaults to a single provider shaped like
    ``cost_model``. ``arrivals``: an exogenous release stream
    (:mod:`.arrivals` process, spec string, or explicit [J] release
    times); ``None`` is the paper's batch at ``t0``. Under a stream,
    deadlines are per-job ``release + c_max``.

    Replica dispatch is deterministic in both engines: the head of a
    stage queue takes the **lowest-indexed free replica** of that
    stage's pool. The tie-break makes straggler injection well-defined
    (the slowdown of replica ``r`` binds to exactly the jobs dispatched
    to slot ``r``) and the per-(job, stage) replica assignment reported
    in ``SimResult.replica`` engine-exact, not just the timings.

    ``faults``: a :class:`~.faults.FaultModel` (or a bare failure rate in
    [0, 1], drawn at seed 0) enabling the fault-injection/recovery layer;
    ``retry`` the :class:`~.faults.RetryPolicy` governing attempt budget,
    backoff and re-placement (defaults to ``RetryPolicy()`` when faults
    are given). ``init_window``: when set (and ``init_phase``), only jobs
    released within ``t0 + init_window`` are init-offload candidates —
    the non-clairvoyant variant for arrival streams.

    ``chunk_jobs``: streaming page size. The DES admits arrival epochs
    into the event heap in windows of at least ``chunk_jobs`` jobs (the
    heap holds the active window instead of the whole horizon); the
    vector engine pages jobs through fixed-shape chunks in release order
    (compile cache keyed on the chunk family, not total J) with
    per-replica clocks carried across pages. Results are equivalent to
    the monolithic path on tie-free draws (bit-exact per page when no
    page's work overlaps the next page's releases — the engine verifies
    this and falls back to larger pages otherwise). ``egress_lookahead``
    adds a one-edge downstream-egress recourse term to the placement
    argmin (see ``_Sim._selc_at``), identically in both engines.

    Load-dependent latency (:mod:`.coldstart`, both engines, identical
    results): ``concurrency`` caps a provider's parallelism per stage
    (``None`` reads the providers' own ``max_concurrency``; an int, a
    per-provider list, or a name/index override dict) — dispatch beyond
    the cap queues FIFO, and the queueing delay enters the placement
    argmin and the bill as occupancy; ``coldstart`` (a
    :class:`~.coldstart.ColdStartModel`, kwargs dict, or bare warm-up
    float) makes the first dispatch to a replica/slot idle past the
    keep-alive window pay a warm-up penalty; ``pool_trace`` (a
    :class:`~.coldstart.PoolTrace`) scales the private pool mid-horizon.
    Degenerate configs (uncapped, zero penalty, constant pool) are
    bit-exact vs the pre-change path. Not combinable with ``faults``,
    ``chunk_jobs``, or (for ``pool_trace``) a ``replicas`` axis.

    ``offload_mask`` ([J] bool) injects an externally-decided offload
    plan: marked jobs are forced public at every non-pinned stage (the
    same cascade the initialization phase uses) and the capacity-prefix
    rule is skipped entirely — the hook the pluggable policy harness
    (:mod:`repro.serving.policies`) drives. Not combinable with
    ``init_window`` (the mask already *is* the resolved plan).
    """
    act = act if act is not None else pred
    pred = _with_transfer_defaults(pred)
    act = _with_transfer_defaults(act)
    release = resolve_release(arrivals, pred["P_private"].shape[0], t0)
    if offload_mask is not None:
        if init_window is not None:
            raise ValueError("offload_mask and init_window are mutually "
                             "exclusive (the mask is the resolved plan)")
        offload_mask = np.asarray(offload_mask, dtype=bool)
        J_m = pred["P_private"].shape[0]
        if offload_mask.shape != (J_m,):
            raise ValueError(f"offload_mask must have shape ({J_m},), "
                             f"got {offload_mask.shape}")
    fault_model = None
    if faults is not None:
        retry = retry if retry is not None else RetryPolicy()
        fault_model = as_fault_model(faults, *pred["P_private"].shape, retry)
    # load-dependent latency config (shared normalization/validation so
    # both engines accept and reject inputs identically)
    caps_vec = norm_concurrency(concurrency, as_portfolio(portfolio,
                                                          cost_model))
    caps = caps_vec if np.isfinite(caps_vec).any() else None
    cs = as_coldstart(coldstart)
    ptr = as_pool_trace(pool_trace)
    validate_load_kwargs(caps is not None, cs, ptr,
                         faulty=fault_model is not None,
                         chunk_jobs=chunk_jobs)
    pool = None
    if ptr is not None:
        # the provisioned pool is the trace's per-stage max: ACD slack,
        # t_max capacity and replica identities all see the max counts,
        # and the slot windows mask availability inside them
        on_w, off_w, _ = ptr.slot_windows(dag.num_stages)
        dag = dag.with_replicas(ptr.materialize(dag.num_stages).max(axis=0))
        pool = (on_w, off_w)
    if replica_slowdown:
        # shared validator (same errors as the vector engine's speeds
        # axis): both engines reject bad factors/stages identically
        from .vectorsim import _max_replica_bound, _norm_speed_axis
        _norm_speed_axis([replica_slowdown], dag.num_stages,
                         _max_replica_bound(dag, None))
    if engine == "vector":
        from .vectorsim import simulate_scenarios
        batched = simulate_scenarios(
            dag, pred, act, c_max_grid=(c_max,), orders=(order,),
            cost_model=cost_model, include_transfers=include_transfers,
            init_phase=init_phase, adaptive=adaptive, t0=t0,
            portfolio=portfolio, arrivals=release,
            replica_speeds=None if not replica_slowdown
            else [replica_slowdown],
            faults=None if fault_model is None else [fault_model],
            retry=retry, init_window=init_window,
            chunk_jobs=chunk_jobs, egress_lookahead=egress_lookahead,
            concurrency=concurrency, coldstart=coldstart,
            pool_trace=pool_trace, offload_mask=offload_mask,
            device=device)
        return batched.scenario(0)
    if engine != "des":
        raise ValueError(f"unknown engine {engine!r}")
    sim = _Sim(dag, pred, act, c_max, order, cost_model, include_transfers,
               init_phase, adaptive, t0, replica_slowdown, portfolio,
               release=release, faults=fault_model, retry=retry,
               init_window=init_window, chunk_jobs=chunk_jobs,
               egress_lookahead=egress_lookahead,
               caps=caps, coldstart=cs, pool=pool,
               offload_mask=offload_mask)
    return sim.run()


def simulate_all_public(dag, pred, act=None, cost_model=LAMBDA_COST,
                        include_transfers=True,
                        portfolio: Optional[ProviderPortfolio] = None,
                        arrivals: ArrivalsLike = None) -> SimResult:
    """Baseline: everything offloaded on release (capacity prefix = 0)."""
    act = act if act is not None else pred
    pred2 = dict(pred)
    pred2["P_private"] = np.full_like(pred["P_private"], 1e12)  # nothing fits
    res = simulate(dag, pred2, act, c_max=0.0, order="spt",
                   cost_model=cost_model, include_transfers=include_transfers,
                   adaptive=False, portfolio=portfolio, arrivals=arrivals)
    return dataclasses.replace(res, deadline=res.makespan)


def simulate_all_private(dag, pred, act=None, order: str = "spt",
                         cost_model=LAMBDA_COST,
                         portfolio: Optional[ProviderPortfolio] = None,
                         arrivals: ArrivalsLike = None) -> SimResult:
    """Baseline: C_max large enough that nothing offloads (Sec. V-C)."""
    act = act if act is not None else pred
    big = float(np.sum((act or pred)["P_private"])) + 1e6
    return simulate(dag, pred, act, c_max=big, order=order,
                    cost_model=cost_model, init_phase=True, adaptive=True,
                    portfolio=portfolio, arrivals=arrivals)
