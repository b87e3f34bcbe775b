"""Hybrid serving: the paper's scheduler as a first-class LLM feature.

A batch of inference requests with an SLA deadline is exactly Skedulix's
scenario. Each request is a 3-stage DAG job:

    prefill (compute-bound) -> decode (memory-bound) -> pack (tiny)

The *private cloud* is the reserved pod: I_k serving replicas per stage
(disaggregated prefill/decode, each replica a mesh slice). The *public
cloud* is elastic accelerator capacity billed by the Lambda-style model
(Eqn. 1 with configurable quantum/rate). Latency predictions come from
roofline-derived analytic stage models (per-arch FLOPs/bytes over the
replica's chips) — the serving analogue of the paper's ridge regressions;
ridge models fitted on simulated traces reproduce the paper's pipeline
end-to-end.

``plan_batch_torch`` runs the initialization phase of Alg. 1 (capacity
prefix rule) on tensors: the stable sort where they live, the prefix sum
on the host. ``schedule`` executes one (order, C_max) point on the
host's event-heap DES; ``schedule_sweep`` evaluates a whole SLA grid —
every (order, deadline) scenario of a request batch — as one batched
call of the torch engine (``engine="vector"``) on the scheduler's
device, with ``engine="des"`` as the serial event-heap reference.

``serve_online`` is the continuous-traffic mode: requests arrive over
time (any :mod:`repro_torch.core.arrivals` process), each carrying a relative
SLA. With ``replan_every_s=Δ`` it runs as a rolling horizon — releases
are quantized up to the next planning epoch, so the scheduler admits an
epoch's requests together, re-runs the ACD eviction sweep over every
queue, and never migrates in-flight work (dispatch is final in both
engines). SLA attainment is measured against the *true* arrival times,
so admission delay counts against the SLA.

``autoscale_frontier`` is the pod-sizing mode: replica counts are
scenario *data* in the vector engine, so a whole grid of pool sizings x
SLA deadlines (x optional straggler-speed configs) evaluates as one
batched call, and the result is the cost/SLA Pareto frontier — total
cost being elastic overflow spend plus the reserved pod
(replica-seconds at a committed-use discount of the elastic rate). That is the serving
analogue of the paper's Fig.-5 robustness story: how much pool does a
target attainment need, and what does each extra replica buy.

``spot_frontier`` is the pricing mode: elastic pool prices become
piecewise-constant *traces* over the serving horizon
(:class:`.core.cost.PriceTrace` — spot markets, diurnal tariffs), each
offloaded request billed in the segment active at its offload epoch.
Pricing is scenario data too, so a whole grid of market scenarios x SLA
deadlines evaluates as one batched call and comes back Pareto-tagged —
under which market, and how tight an SLA, is overflow serving still
worth it.

Device: :class:`HybridServingScheduler` takes ``device=`` (``cuda`` unless
the caller names another; it raises without a GPU) and runs every
``engine="vector"`` call and the ridge fit there, so each adaptive sweep
launches ``acd_evict`` and each capped provider's dispatch chain
``fifo_dispatch``. The reports' reductions (attainment, pod cost, Pareto
masks) stay on the host in numpy float64, in the JAX package's order.
The latency model's peaks are an H100 SXM's (dense bf16 FLOP/s, HBM
bytes/s) unless given.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.arrivals import ArrivalsLike, resolve_release
from ..core.coldstart import queue_wait_ewma
from ..core.cost import (USD_PER_GB_MS, CostModel, PriceTrace, Provider,
                         ProviderPortfolio)
from ..core.dag import AppDAG, Stage
from ..core.greedy import init_offload_torch
from ..core.perfmodel import fit_app_perf_model, AppPerfModel
from ..core.scheduler import BatchReport, SkedulixScheduler
from ..core.simulator import SimResult, simulate
from ..core.vectorsim import VectorSimResult, resolve_device
from ..kernels.cost import HBM_BW, PEAK_FLOPS
from ..models.config import ModelConfig
from .policies import (PolicyContext, SkedulixGreedy, compare_policies,
                       policy_from_mode)


def serving_dag(prefill_replicas: int = 2, decode_replicas: int = 4,
                pack_replicas: int = 2, mem_mb: float = 16384.0) -> AppDAG:
    """prefill -> decode -> pack. mem_mb drives the elastic cost model
    (an accelerator-hour has a memory-equivalent price in Eqn. 1 terms)."""
    return AppDAG(
        name="llm_serve",
        stages=(
            Stage("prefill", replicas=prefill_replicas, mem_mb=mem_mb),
            Stage("decode", replicas=decode_replicas, mem_mb=mem_mb),
            Stage("pack", replicas=pack_replicas, mem_mb=512.0),
        ),
        edges=((0, 1), (1, 2)),
    )


@dataclasses.dataclass
class ServingLatencyModel:
    """Roofline-derived stage latencies for one arch on one replica.

    prefill: compute-bound  t = 2*N_active*L / (chips*peak*mfu)
    decode:  memory-bound   t = new_tokens * bytes_per_step / (chips*bw*eff)
    pack:    constant small overhead

    ``peak_flops`` and ``hbm_bw`` are one chip's peaks: an H100 SXM's by
    default.
    """

    cfg: ModelConfig
    chips_per_replica: int = 8
    mfu: float = 0.4
    mem_eff: float = 0.6
    public_speedup: float = 2.0       # elastic replicas are bigger slices
    public_startup_s: float = 0.5     # provisioning/attach latency
    pack_s: float = 0.02
    peak_flops: float = PEAK_FLOPS    # one H100 SXM's, kernels.cost
    hbm_bw: float = HBM_BW

    def _n_active(self) -> int:
        return self.cfg.active_param_count()

    def prefill_s(self, prompt_len: np.ndarray) -> np.ndarray:
        flops = 2.0 * self._n_active() * np.asarray(prompt_len, np.float64)
        return flops / (self.chips_per_replica * self.peak_flops
                        * self.mfu)

    def decode_s(self, new_tokens: np.ndarray, kv_len: np.ndarray) -> np.ndarray:
        # per step: stream params (bf16) + KV cache bytes
        kv_bytes = self._kv_bytes(kv_len)
        step_bytes = 2.0 * self._n_active() + kv_bytes
        return (np.asarray(new_tokens, np.float64) * step_bytes
                / (self.chips_per_replica * self.hbm_bw * self.mem_eff))

    def _kv_bytes(self, kv_len: np.ndarray) -> np.ndarray:
        c = self.cfg
        n_attn = len(c.attn_layers)
        eff = np.minimum(np.asarray(kv_len, np.float64),
                         c.window if c.window else np.inf)
        per_tok = 2 * n_attn * c.num_kv_heads * c.hd * 2  # k+v bf16
        state = 0.0
        if c.block_pattern != ("attn",):
            state = (c.num_layers - n_attn) * c.d_model * 8  # recurrent state
        return eff * per_tok + state

    def latencies(self, prompt_len: np.ndarray, new_tokens: np.ndarray,
                  rng: Optional[np.random.Generator] = None,
                  jitter: float = 0.06) -> Dict[str, np.ndarray]:
        """[J,3] private/public latency matrices (+ transfer)."""
        prompt_len = np.asarray(prompt_len, np.float64)
        new_tokens = np.asarray(new_tokens, np.float64)
        J = prompt_len.shape[0]
        P_priv = np.stack([
            self.prefill_s(prompt_len),
            self.decode_s(new_tokens, prompt_len + new_tokens),
            np.full(J, self.pack_s),
        ], axis=1)
        P_pub = P_priv / self.public_speedup + self.public_startup_s
        P_pub[:, 2] = self.pack_s + 0.05
        if rng is not None:
            P_priv = P_priv * rng.lognormal(0, jitter, P_priv.shape)
            P_pub = P_pub * rng.lognormal(0, jitter, P_pub.shape)
        # transfers: prompt upload / result download over DCN
        up = np.tile((prompt_len * 4 / 1e9 + 0.01)[:, None], (1, 3))
        down = np.tile((new_tokens * 4 / 1e9 + 0.01)[:, None], (1, 3))
        return {"P_private": P_priv, "P_public": P_pub,
                "upload": up, "download": down}


def elastic_portfolio(n: int = 3) -> ProviderPortfolio:
    """N elastic accelerator pools for overflow serving.

    All Lambda-shaped, but with non-dominated reservation terms: a
    committed-use discounter trades a deep rate cut for coarse billing
    and slow attach, a premium pool bills fine quanta and attaches fast.
    The cheapest pool therefore depends on each request's stage runtime —
    long decodes land on the discounter, short ones on the premium pool.
    """
    profiles = [
        # (quantum_ms, rate mult, egress $/GB, latency mult)
        (1000.0, 1.00, 0.02, 1.00),   # on-demand baseline
        (4000.0, 0.55, 0.04, 1.25),   # committed-use: cheap, coarse, slow
        (100.0, 1.20, 0.00, 0.90),    # premium: fine quanta, fast attach
    ]
    pools = []
    for i in range(n):
        q, r, e, lm = profiles[i % len(profiles)]
        r *= 1.0 + 0.05 * (i // len(profiles))  # keep clones distinct
        pools.append(Provider(
            f"elastic{i}", quantum_ms=q, usd_per_gb_ms=r * USD_PER_GB_MS,
            egress_usd_per_gb=e, latency_mult=lm))
    return ProviderPortfolio(tuple(pools))


def plan_batch_torch(P_private: torch.Tensor, keys: torch.Tensor,
                     capacity: float) -> torch.Tensor:
    """Alg. 1 initialization phase: offload mask [J] on the tensors'
    device.

    The per-job totals add the stage columns left to right (numpy's row
    sum order below eight stages), the stable sort runs where the tensors
    live and the capacity prefix is summed on the host in float64
    (:func:`.core.greedy.init_offload_torch`), so the mask equals numpy's
    ``init_offload(P_private.sum(1), keys, capacity)`` bit for bit."""
    C_total = P_private[:, 0]
    for k in range(1, P_private.shape[1]):
        C_total = C_total + P_private[:, k]
    return init_offload_torch(C_total.to(torch.float64), keys, capacity)


@dataclasses.dataclass
class OnlineReport:
    """One continuous-serving run: executed schedule + stream metadata.

    ``release`` holds the true request arrival times; ``admitted`` the
    times the scheduler first saw each request (equal to ``release`` when
    replanning continuously, quantized up to the replan grid otherwise).
    SLA attainment and latency percentiles are measured against the true
    releases — admission delay under a coarse replan interval shows up as
    lost attainment, which is exactly the fidelity/staleness trade a
    rolling-horizon controller makes.
    """

    result: SimResult
    release: np.ndarray        # [J] true arrival times
    admitted: np.ndarray       # [J] planning-epoch arrival times
    sla_s: float               # relative per-request SLA
    replan_every_s: float      # 0 = replan at every arrival event
    mode: str                  # hybrid | private | public

    @property
    def flow_time(self) -> np.ndarray:
        """[J] request latency: completion minus *true* release.

        NaN for abandoned requests (under a fault model with exhausted
        retry budgets) — they never complete.
        """
        return self.result.completion - self.release

    @property
    def abandoned(self) -> np.ndarray:
        """[J] bool: requests the fault layer gave up on (all-False when
        serving fault-free)."""
        ab = self.result.abandoned
        if ab is None:
            return np.zeros(self.release.shape, dtype=bool)
        return np.asarray(ab, dtype=bool)

    @property
    def sla_attainment(self) -> float:
        """Fraction of *all* requests finishing within the SLA — an
        abandoned request counts as a miss (NaN flow compares False)."""
        if not self.release.size:
            return 1.0
        flow = self.flow_time
        with np.errstate(invalid="ignore"):
            return float((flow <= self.sla_s + 1e-9).mean())

    @property
    def sla_attainment_served(self) -> float:
        """SLA attainment over the requests that *were* served —
        degradation quality separated from availability loss."""
        ok = ~self.abandoned
        if not ok.any():
            return 1.0
        flow = self.flow_time[ok]
        with np.errstate(invalid="ignore"):
            return float((flow <= self.sla_s + 1e-9).mean())

    def summary(self) -> Dict[str, float]:
        r = self.result
        n = max(len(self.release), 1)
        served = self.flow_time[~self.abandoned]
        return {
            "requests": float(len(self.release)),
            "sla_s": float(self.sla_s),
            "replan_every_s": float(self.replan_every_s),
            "sla_attainment": self.sla_attainment,
            "sla_attainment_served": self.sla_attainment_served,
            "abandoned_frac": float(self.abandoned.mean())
            if self.release.size else 0.0,
            "cost_usd": float(r.cost_usd),
            "cost_per_1k_req_usd": float(r.cost_usd) / n * 1000.0,
            "mean_latency_s": float(served.mean()) if served.size else 0.0,
            "p95_latency_s": float(np.percentile(served, 95.0))
            if served.size else 0.0,
            "offload_frac": float(r.offload_fraction),
            "makespan_s": float(r.makespan),
        }


def pareto_mask(cost: np.ndarray, quality: np.ndarray) -> np.ndarray:
    """Non-dominated mask: minimize ``cost``, maximize ``quality``.

    Point ``s`` is dominated iff some point is no worse on both axes and
    strictly better on at least one. Duplicate (cost, quality) points
    all survive (neither strictly improves on the other).
    """
    cost = np.asarray(cost, dtype=np.float64)
    quality = np.asarray(quality, dtype=np.float64)
    better = ((cost[None, :] <= cost[:, None])
              & (quality[None, :] >= quality[:, None])
              & ((cost[None, :] < cost[:, None])
                 | (quality[None, :] > quality[:, None])))
    return ~better.any(axis=1)


@dataclasses.dataclass
class AutoscaleFrontier:
    """One pod-sizing sweep: replica configs x deadlines, Pareto-tagged.

    Scenario ``s`` ran replica config ``replicas[s]`` with scheduler
    deadline ``c_max[s]``; ``sla`` is the fraction of requests finishing
    within the *fixed* target ``sla_s`` (one per frontier call), so
    every point measures the same promise and the (cost, sla) axes are
    comparable across deadlines. ``total_usd = public_usd +
    reserve_usd``: elastic overflow spend plus the reserved pod, priced
    as replica-seconds of each stage's memory config over the serving
    horizon (``max(makespan, c_max)``) at a committed-use fraction of
    the elastic $/GB-ms rate. ``pareto`` marks the non-dominated
    (total_usd, sla) points; ``frontier()`` returns their indices in
    ascending-cost order. ``result`` keeps the full batched
    :class:`VectorSimResult` (per-request times, placements, replica
    assignments) for drill-down.
    """

    replicas: np.ndarray     # [S, M] per-scenario replica counts
    c_max: np.ndarray        # [S] scheduler deadline knob
    sla_s: float             # the fixed SLA target all points report on
    sla: np.ndarray          # [S] fraction of requests meeting sla_s
    public_usd: np.ndarray   # [S] elastic overflow spend (Eqn. 1)
    reserve_usd: np.ndarray  # [S] reserved-pod cost over the horizon
    total_usd: np.ndarray    # [S]
    makespan: np.ndarray     # [S]
    pareto: np.ndarray       # [S] bool: on the cost/SLA frontier
    result: VectorSimResult

    @property
    def num_scenarios(self) -> int:
        return int(self.total_usd.shape[0])

    def frontier(self) -> np.ndarray:
        """Indices of the non-dominated points, cheapest first."""
        idx = np.flatnonzero(self.pareto)
        return idx[np.argsort(self.total_usd[idx], kind="stable")]

    def table(self) -> str:
        """The frontier as an aligned text table (cheapest first)."""
        lines = [f"{'replicas':>14} {'c_max s':>8} {'SLA':>6} "
                 f"{'public $':>9} {'pod $':>9} {'total $':>9}"]
        for s in self.frontier():
            cfg = "x".join(str(int(c)) for c in self.replicas[s])
            lines.append(
                f"{cfg:>14} {self.c_max[s]:8.2f} {self.sla[s]:6.3f} "
                f"{self.public_usd[s]:9.4f} {self.reserve_usd[s]:9.4f} "
                f"{self.total_usd[s]:9.4f}")
        return "\n".join(lines)


def spot_elastic_traces(n: int = 3, num_segments: int = 6,
                        horizon_s: float = 60.0, seed: int = 0,
                        volatility: float = 0.4,
                        families: Optional[int] = None,
                        ) -> List[Tuple[PriceTrace, ...]]:
    """``families`` spot-market pricings of :func:`elastic_portfolio`'s
    ``n`` pools (default: one family per pool): per family, one
    :class:`PriceTrace` per provider — ready to pass as a
    ``price_traces=`` axis / ``trace_grid``. Each trace's rate and
    egress follow the shared :func:`.core.cost.price_walk` market model
    (latency held flat — elastic attach behavior is a pool property, not
    market state), so every market opens at the flat pool tariff and
    drifts from there."""
    from ..core.cost import price_walk

    base = elastic_portfolio(n)
    out = []
    rng = np.random.default_rng(seed)
    S = int(num_segments)
    bps = tuple(horizon_s * (s + 1) / S for s in range(S - 1))
    for _ in range(max(int(n if families is None else families), 1)):
        traces = []
        for p in base.providers:
            walk = price_walk(rng, S, volatility)
            traces.append(PriceTrace(
                usd_per_gb_ms=tuple(p.usd_per_gb_ms * walk),
                egress_usd_per_gb=tuple(p.egress_usd_per_gb * walk),
                latency_mult=(p.latency_mult,) * S,
                breakpoints=bps))
        out.append(tuple(traces))
    return out


@dataclasses.dataclass
class SpotFrontier:
    """One pricing sweep: price-trace families x deadlines, Pareto-tagged.

    Scenario ``s`` ran trace family ``trace_idx[s]`` (an index into the
    ``trace_grid`` handed to :meth:`HybridServingScheduler.spot_frontier`)
    with scheduler deadline ``c_max[s]``; ``sla`` measures attainment
    against the one fixed target ``sla_s``, so every point reports on the
    same promise. ``cost_usd`` is the elastic overflow spend under that
    scenario's market (decision-epoch priced — each offload billed in
    the segment active at its offload epoch). ``pareto`` marks the
    non-dominated (cost, sla) points; ``result`` keeps the full batched
    :class:`VectorSimResult` (providers, segments, times) for drill-down.
    """

    trace_idx: np.ndarray    # [S] which trace family
    c_max: np.ndarray        # [S] scheduler deadline knob
    sla_s: float             # the fixed SLA target all points report on
    sla: np.ndarray          # [S] fraction of requests meeting sla_s
    cost_usd: np.ndarray     # [S] elastic overflow spend
    makespan: np.ndarray     # [S]
    pareto: np.ndarray       # [S] bool: on the cost/SLA frontier
    result: VectorSimResult

    @property
    def num_scenarios(self) -> int:
        return int(self.cost_usd.shape[0])

    def frontier(self) -> np.ndarray:
        """Indices of the non-dominated points, cheapest first."""
        idx = np.flatnonzero(self.pareto)
        return idx[np.argsort(self.cost_usd[idx], kind="stable")]

    def per_trace_cost(self) -> np.ndarray:
        """[T] total overflow spend per trace family (summed over its
        deadline grid) — the headline \"what does this market cost us\"."""
        T = int(self.trace_idx.max()) + 1 if self.trace_idx.size else 0
        return np.array([self.cost_usd[self.trace_idx == t].sum()
                         for t in range(T)])

    def table(self) -> str:
        """The frontier as an aligned text table (cheapest first)."""
        lines = [f"{'trace':>6} {'c_max s':>8} {'SLA':>6} {'cost $':>10}"]
        for s in self.frontier():
            lines.append(
                f"{int(self.trace_idx[s]):>6} {self.c_max[s]:8.2f} "
                f"{self.sla[s]:6.3f} {self.cost_usd[s]:10.5f}")
        return "\n".join(lines)


@dataclasses.dataclass
class ReliabilityFrontier:
    """One reliability sweep: fault configs x deadlines, Pareto-tagged.

    Scenario ``s`` ran fault config ``fault_idx[s]`` (an index into the
    ``fault_grid`` handed to
    :meth:`HybridServingScheduler.reliability_frontier`) with scheduler
    deadline ``c_max[s]``. ``availability`` is the fraction of requests
    *served at all* (1 - abandoned fraction); ``sla`` is attainment
    against the one fixed target ``sla_s`` with abandoned requests
    counting as misses, so the two separate "did we answer" from "did we
    answer in time". ``cost_usd`` includes retries' lost partial work —
    failures are billed for the fraction executed before the kill.
    ``pareto`` marks the non-dominated (cost, sla) points; ``result``
    keeps the full batched :class:`VectorSimResult` (per-request
    attempts, failures, abandonment) for drill-down.
    """

    fault_idx: np.ndarray     # [S] which fault config
    c_max: np.ndarray         # [S] scheduler deadline knob
    sla_s: float              # the fixed SLA target all points report on
    sla: np.ndarray           # [S] attainment incl. abandonment misses
    availability: np.ndarray  # [S] fraction of requests served at all
    cost_usd: np.ndarray      # [S] elastic spend incl. lost work
    makespan: np.ndarray      # [S] over the served requests
    pareto: np.ndarray        # [S] bool: on the cost/SLA frontier
    result: VectorSimResult

    @property
    def num_scenarios(self) -> int:
        return int(self.cost_usd.shape[0])

    def frontier(self) -> np.ndarray:
        """Indices of the non-dominated points, cheapest first."""
        idx = np.flatnonzero(self.pareto)
        return idx[np.argsort(self.cost_usd[idx], kind="stable")]

    def table(self) -> str:
        """The frontier as an aligned text table (cheapest first)."""
        lines = [f"{'fault':>6} {'c_max s':>8} {'SLA':>6} {'avail':>6} "
                 f"{'cost $':>10}"]
        for s in self.frontier():
            lines.append(
                f"{int(self.fault_idx[s]):>6} {self.c_max[s]:8.2f} "
                f"{self.sla[s]:6.3f} {self.availability[s]:6.3f} "
                f"{self.cost_usd[s]:10.5f}")
        return "\n".join(lines)


class HybridServingScheduler:
    """Skedulix over a pod of serving replicas + elastic overflow.

    ``device`` (``"cuda"`` unless given; raises without a GPU) runs the
    ridge fit and every ``engine="vector"`` call; the DES
    (``schedule``, ``baselines`` and ``engine="des"``) runs on the host.
    """

    def __init__(self, cfg: ModelConfig, dag: Optional[AppDAG] = None,
                 latency_model: Optional[ServingLatencyModel] = None,
                 cost_model: Optional[CostModel] = None,
                 portfolio: Optional[ProviderPortfolio] = None,
                 device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.dag = dag or serving_dag()
        self.lat = latency_model or ServingLatencyModel(cfg)
        # elastic accelerator pricing, Lambda-shaped: 1s quantum, the same
        # $/GB-ms rate as the batch pipeline (one constant, one source)
        self.cost_model = cost_model or CostModel(
            quantum_ms=1000.0, usd_per_gb_ms=USD_PER_GB_MS)
        # optional multi-cloud portfolio: overflow picks the cheapest
        # feasible elastic provider per offloaded stage
        self.portfolio = portfolio
        self.sched = SkedulixScheduler(self.dag, cost_model=self.cost_model,
                                       portfolio=portfolio)
        self.perf_model: Optional[AppPerfModel] = None

    # -- the paper's pipeline: traces -> ridge models -> schedule --
    def fit_perf_models(self, n_train: int = 256, seed: int = 0):
        rng = np.random.default_rng(seed)
        plen = rng.integers(64, 4096, n_train)
        ntok = rng.integers(16, 512, n_train)
        act = self.lat.latencies(plen, ntok, rng)
        traces = {
            "base_features": np.stack([plen, ntok], 1).astype(np.float64),
            "private": act["P_private"],
            "public": act["P_public"],
            "outsize": np.tile((ntok * 4.0)[:, None], (1, 3)),
            "overhead": np.zeros((n_train, 3)),
        }
        self.perf_model = fit_app_perf_model(self.dag, traces,
                                             device=self.device)
        return self.perf_model

    def _pred_act(self, prompt_len, new_tokens, seed: int, use_ridge: bool):
        """(pred, act) for one batch: ridge predictions (or the noiseless
        analytic model) vs a jittered actual-latency draw."""
        rng = np.random.default_rng(seed)
        act = self.lat.latencies(prompt_len, new_tokens, rng)
        if use_ridge and self.perf_model is not None:
            feats = np.stack([prompt_len, new_tokens], 1).astype(np.float64)
            pred = self.perf_model.predict(feats)
            pred = {k: pred[k] for k in ("P_private", "P_public",
                                         "upload", "download")}
        else:
            pred = self.lat.latencies(prompt_len, new_tokens, None)
        return pred, act

    def schedule(self, prompt_len: np.ndarray, new_tokens: np.ndarray,
                 c_max: float, order: str = "spt", seed: int = 1,
                 use_ridge: bool = True) -> BatchReport:
        pred, act = self._pred_act(prompt_len, new_tokens, seed, use_ridge)
        return self.sched.schedule_batch(c_max=c_max, pred=pred, act=act,
                                         order=order)

    def schedule_sweep(self, prompt_len: np.ndarray, new_tokens: np.ndarray,
                       c_max_grid: Sequence[float],
                       orders: Sequence[str] = ("spt",), seed: int = 1,
                       use_ridge: bool = True,
                       engine: str = "vector",
                       **sweep_kwargs) -> VectorSimResult:
        """Schedule the batch across a whole (order x SLA-deadline) grid.

        The serving twin of Fig. 4: one batched engine call instead of one
        DES replay per grid point; scenario ``s`` of the result is the
        (orders[s], c_max[s]) schedule of the same request batch. Extra
        keyword arguments (``replicas=``, ``replica_speeds=``,
        ``arrivals=``) forward to
        :meth:`.scheduler.SkedulixScheduler.schedule_sweep`.
        """
        pred, act = self._pred_act(prompt_len, new_tokens, seed, use_ridge)
        return self.sched.schedule_sweep(
            c_max_grid, pred=pred, act=act, orders=orders, engine=engine,
            device=self.device, **sweep_kwargs)

    def autoscale_frontier(self, prompt_len: np.ndarray,
                           new_tokens: np.ndarray,
                           replica_grid: Sequence,
                           c_max_grid: Sequence[float],
                           order: str = "spt", seed: int = 1,
                           use_ridge: bool = True, engine: str = "vector",
                           replica_speeds=None, sla_s: Optional[float] = None,
                           reserve_rate_frac: float = 0.4,
                           t0: float = 0.0) -> AutoscaleFrontier:
        """Size the serving pod: sweep replica configs x deadlines in one
        batched call and return the cost/SLA Pareto frontier.

        ``replica_grid`` entries are per-stage replica count vectors [M]
        (or bare ints, broadcast across stages); ``c_max_grid`` sweeps
        the *scheduler's* deadline knob (a looser C_max offloads less —
        cheaper, slower). Attainment is always measured against the one
        fixed target ``sla_s`` (default: the tightest deadline of the
        grid), so every point reports on the same promise and the
        (cost, sla) axes stay comparable — measuring each scenario
        against its own deadline would let "loose and idle" dominate
        everything. Replica counts are scenario *data* in the vector
        engine, so the whole ``configs x deadlines`` grid — ≥ 8 configs
        x ≥ 4 deadlines is routine — runs as a single device call on one
        compiled executable (``engine="des"`` replays it serially for
        parity). ``replica_speeds`` adds a straggler axis (Fig.-5-style
        degradation grids) swept in the same call.

        Total cost per scenario = elastic overflow spend (Eqn. 1) + the
        reserved pod: each stage-``k`` replica bills its memory config at
        ``reserve_rate_frac`` of the elastic $/GB-ms rate over the
        serving horizon ``max(makespan, c_max)`` — the committed-use
        discount that makes pool sizing a real trade instead of
        "more replicas always win".
        """
        M = self.dag.num_stages
        # no int() coercion here: the core validator rejects fractional
        # counts instead of silently truncating to a smaller pod
        cfgs = [np.full(M, c) if np.ndim(c) == 0 else np.asarray(c)
                for c in replica_grid]
        pred, act = self._pred_act(prompt_len, new_tokens, seed, use_ridge)
        res = self.sched.schedule_sweep(
            c_max_grid, pred=pred, act=act, orders=(order,), engine=engine,
            replicas=cfgs, replica_speeds=replica_speeds, t0=t0,
            device=self.device)
        sla_s = float(min(c_max_grid) if sla_s is None else sla_s)
        rel = (np.full_like(res.completion, t0) if res.release is None
               else res.release)
        flow = res.completion - rel
        sla = ((flow <= sla_s + 1e-9).mean(axis=1)
               if flow.shape[1] else np.ones(res.num_scenarios))
        # reserved pod: replica-seconds x memory config at the
        # committed-use fraction of the elastic rate
        rate_k = (self.dag.mem_mb / 1024.0) * (
            self.cost_model.usd_per_gb_ms * 1e3) * float(reserve_rate_frac)
        horizon = np.maximum(res.makespan, res.c_max)
        reserve = (res.replicas * rate_k[None, :]).sum(axis=1) * horizon
        total = res.cost_usd + reserve
        return AutoscaleFrontier(
            replicas=res.replicas, c_max=res.c_max, sla_s=sla_s, sla=sla,
            public_usd=res.cost_usd, reserve_usd=reserve, total_usd=total,
            makespan=res.makespan, pareto=pareto_mask(total, sla),
            result=res)

    def spot_frontier(self, prompt_len: np.ndarray, new_tokens: np.ndarray,
                      trace_grid: Sequence,
                      c_max_grid: Sequence[float],
                      order: str = "spt", seed: int = 1,
                      use_ridge: bool = True, engine: str = "vector",
                      sla_s: Optional[float] = None,
                      t0: float = 0.0) -> SpotFrontier:
        """Sweep elastic-pricing families against SLA deadlines in one
        batched call and return the cost/SLA Pareto frontier.

        ``trace_grid`` entries are pricings of the scheduler's elastic
        pools — :class:`.core.cost.PriceTrace` tuples (one per provider,
        e.g. from :func:`spot_elastic_traces`), whole
        :class:`ProviderPortfolio` variants (e.g.
        :func:`.core.cost.diurnal_portfolio`), or ``None`` for the flat
        base pricing; ``c_max_grid`` sweeps the scheduler's deadline
        knob. Pricing is scenario *data* in the vector engine
        (segment-indexed billing matrices), so the whole
        ``markets x deadlines`` grid runs as a single device call — the
        pricing analogue of :meth:`autoscale_frontier`'s pod-sizing
        sweep, answering \"under which market, and how tight an SLA, is
        overflow serving still worth it\". Attainment is measured
        against the fixed target ``sla_s`` (default: the tightest
        deadline of the grid). Each offloaded request bills in the price
        segment active at its offload epoch (decision-epoch pricing), so
        a market spike mid-horizon genuinely lands on the requests
        offloaded during it.
        """
        trace_grid = list(trace_grid)
        pred, act = self._pred_act(prompt_len, new_tokens, seed, use_ridge)
        res = self.sched.schedule_sweep(
            c_max_grid, pred=pred, act=act, orders=(order,), engine=engine,
            price_traces=trace_grid, t0=t0, device=self.device)
        sla_s = float(min(c_max_grid) if sla_s is None else sla_s)
        rel = (np.full_like(res.completion, t0) if res.release is None
               else res.release)
        flow = res.completion - rel
        sla = ((flow <= sla_s + 1e-9).mean(axis=1)
               if flow.shape[1] else np.ones(res.num_scenarios))
        return SpotFrontier(
            trace_idx=res.trace_idx, c_max=res.c_max, sla_s=sla_s, sla=sla,
            cost_usd=res.cost_usd, makespan=res.makespan,
            pareto=pareto_mask(res.cost_usd, sla), result=res)

    def reliability_frontier(self, prompt_len: np.ndarray,
                             new_tokens: np.ndarray,
                             fault_grid: Sequence,
                             c_max_grid: Sequence[float],
                             order: str = "spt", seed: int = 1,
                             use_ridge: bool = True, engine: str = "vector",
                             retry=None, sla_s: Optional[float] = None,
                             t0: float = 0.0) -> ReliabilityFrontier:
        """Sweep failure regimes against SLA deadlines in one batched call
        and return the cost/SLA Pareto frontier.

        ``fault_grid`` entries are failure configs of the elastic pools —
        :class:`.core.faults.FaultModel` objects (per-provider outage
        windows, seeded per-attempt failure draws), bare failure rates
        in [0, 1] (drawn deterministically at seed = their grid index),
        or ``None`` for the fault-free reference; ``c_max_grid`` sweeps
        the scheduler's deadline knob, and every faulty scenario
        recovers under the one ``retry``
        :class:`.core.faults.RetryPolicy`. Failures are scenario *data*
        in the vector engine (a bounded attempt axis in the shape
        family), so the whole ``faults x deadlines`` grid runs as a
        single device call — the reliability analogue of
        :meth:`spot_frontier`, answering "how much does each nine of
        availability cost, and does a looser SLA buy it back".
        Attainment is measured against the fixed target ``sla_s``
        (default: the tightest deadline of the grid) with abandoned
        requests counting as misses; ``availability`` reports the
        abandonment axis on its own.
        """
        fault_grid = list(fault_grid)
        pred, act = self._pred_act(prompt_len, new_tokens, seed, use_ridge)
        res = self.sched.schedule_sweep(
            c_max_grid, pred=pred, act=act, orders=(order,), engine=engine,
            faults=fault_grid, retry=retry, t0=t0, device=self.device)
        sla_s = float(min(c_max_grid) if sla_s is None else sla_s)
        rel = (np.full_like(res.completion, t0) if res.release is None
               else res.release)
        flow = res.completion - rel
        with np.errstate(invalid="ignore"):
            sla = ((flow <= sla_s + 1e-9).mean(axis=1)
                   if flow.shape[1] else np.ones(res.num_scenarios))
        avail = (1.0 - res.abandoned.mean(axis=1)
                 if res.abandoned is not None and res.abandoned.shape[1]
                 else np.ones(res.num_scenarios))
        return ReliabilityFrontier(
            fault_idx=res.fault_idx, c_max=res.c_max, sla_s=sla_s, sla=sla,
            availability=avail, cost_usd=res.cost_usd,
            makespan=res.makespan, pareto=pareto_mask(res.cost_usd, sla),
            result=res)

    def serve_online(self, prompt_len: np.ndarray, new_tokens: np.ndarray,
                     arrivals: ArrivalsLike, sla_s: float,
                     replan_every_s: float = 0.0, order: str = "spt",
                     seed: int = 1, use_ridge: bool = True,
                     engine: str = "vector",
                     mode: str = "hybrid",
                     faults=None, retry=None,
                     init_offload: bool = False,
                     replica_step_times=None,
                     workload=None,
                     chunk_jobs: Optional[int] = None,
                     egress_lookahead: bool = True,
                     concurrency=None,
                     coldstart=None,
                     pool_trace=None,
                     stage_queue_waits=None,
                     policy=None) -> OnlineReport:
        """Continuous serving: requests arrive over time, each with an SLA.

        ``arrivals`` is any :mod:`repro_torch.core.arrivals` stream (process,
        spec string like ``"poisson:4.0"``, or explicit release times);
        ``sla_s`` is the per-request relative deadline. With
        ``replan_every_s=Δ > 0`` the controller runs a rolling horizon:
        releases quantize *up* to the next multiple of Δ, so the
        scheduler admits each window's requests together at the epoch
        boundary, re-runs the ACD eviction sweep over every stage queue,
        and leaves in-flight work pinned (a dispatched stage is never
        migrated — in either engine, dispatch is final). ``Δ = 0``
        replans at every arrival instant (the event-driven limit).

        ``mode`` selects the policy: ``"hybrid"`` (Alg. 1's ACD eviction
        loop), ``"private"`` (never offload — requests queue on the
        pod), or ``"public"`` (every request straight to elastic
        capacity). ``policy=`` generalizes ``mode=``: any
        :class:`.policies.Policy` instance (or registry name, e.g.
        ``"noah"``, ``"costanalysis"``) supplies the admission,
        ordering, and placement decisions instead — the legacy modes
        are exactly ``SkedulixGreedy`` / ``PrivateOnly`` /
        ``PublicOnly`` and stay bit-identical through the policy path.
        Hybrid mode is genuinely non-clairvoyant by default:
        the clairvoyant initialization offload (which plans over the
        whole trace at t0) is disabled, so every offload is an ACD
        eviction decided from queue state and per-request deadlines at
        the current epoch. ``init_offload=True`` re-enables the capacity
        plan *gated to the first replan window* — only requests released
        within ``replan_every_s`` of t0 (exactly the requests a live
        controller has seen at its first epoch) compete for the
        prefix-rule budget, keeping the controller causal. SLA
        attainment in the report is against *true* arrival times.

        Graceful degradation: ``faults`` (a
        :class:`.core.faults.FaultModel` or scalar failure rate) injects
        provider outages and per-attempt failures; interrupted requests
        re-queue under the ``retry`` :class:`.core.faults.RetryPolicy` —
        re-placed on the cheapest provider *outside* the outage, falling
        back to a private slot when the budget is exhausted, and
        reported as ``abandoned`` when even that cannot meet the SLA.
        In-flight pinning still holds: a dispatched attempt is never
        migrated, only its *failure* triggers re-placement. The report
        separates availability loss (``abandoned_frac``) from served
        quality (``sla_attainment_served``).

        ``replica_step_times`` wires live pod telemetry into the plan: a
        ``{(stage, replica): [step seconds...]}`` history, run through
        the EWMA straggler detector
        (:func:`repro_torch.training.fault.straggler_slowdowns`); flagged
        replicas enter the simulation slowed by their measured factor,
        so queues on straggling replicas grow and the ACD sweep routes
        around them.

        Scale-out: ``workload`` (a :mod:`repro_torch.core.workloads` spec like
        ``"azure:day=tue,scale=1e5"``) replaces ``arrivals`` with the
        trace-derived release stream — its ``scale`` must equal the
        request count, the durations still come from the serving perf
        model. ``chunk_jobs`` pages the job axis through streaming
        chunks in either engine (the rolling-horizon replan grid and
        the page boundaries compose: pages follow release order, replan
        windows quantize the releases). ``egress_lookahead`` (default
        on — the placement-myopia fix) makes every offload's argmin
        charge the candidate provider's own egress against the
        request's downstream edges, so multi-provider serving stops
        parking fat intermediate results on cheap-compute/expensive-
        egress providers; with a single provider the term is
        argmin-neutral, leaving solo serving byte-identical.

        Load-dependent serving: ``concurrency``/``coldstart``/
        ``pool_trace`` switch on the congestion model
        (:mod:`repro_torch.core.coldstart` — per-provider concurrency caps
        with FIFO queueing, keep-alive/cold-start warm-up penalties,
        mid-horizon pod resizing). Because the scheduler's latency
        *predictions* stay load-independent, a congested elastic pool
        would otherwise be offloaded to as eagerly as an idle one —
        ``stage_queue_waits`` closes that loop: a chronological list of
        per-replan observations (each a length-M vector of mean public
        queue wait per stage, the telemetry twin of
        ``replica_step_times``), smoothed by
        :func:`repro_torch.core.coldstart.queue_wait_ewma` and folded into the
        predicted public latencies, so the replan priority keys, the ACD
        eviction slack, and the placement argmin all see the congestion
        the controller has actually observed.
        """
        from ..training.fault import straggler_slowdowns

        prompt_len = np.asarray(prompt_len)
        J = prompt_len.shape[0]
        pred, act = self._pred_act(prompt_len, new_tokens, seed, use_ridge)
        if workload is not None:
            if arrivals is not None:
                raise ValueError("pass either arrivals or workload=, "
                                 "not both")
            from ..core.workloads import parse_workload, resolve_workload
            wl = parse_workload(workload)
            if int(wl.scale) != J:
                raise ValueError(
                    f"workload scale ({int(wl.scale)}) must match the "
                    f"request count ({J})")
            _, _, arrivals = resolve_workload(wl, self.dag, 0.0)
        release = resolve_release(arrivals, J, 0.0)
        if release is None:
            release = np.zeros(J)
        if policy is None:
            # legacy mode strings resolve to their extracted policies
            if mode == "hybrid":
                policy = SkedulixGreedy(init_offload=init_offload)
            else:
                policy = policy_from_mode(mode)
            label = mode
        else:
            if isinstance(policy, str):
                policy = policy_from_mode(policy)
            label = policy.name
        admitted = policy.admit(release, float(replan_every_s))
        slow = (straggler_slowdowns(replica_step_times)
                if replica_step_times else None)
        qw = (queue_wait_ewma(stage_queue_waits)
              if stage_queue_waits is not None else None)
        if qw is not None:
            if qw.shape != (self.dag.num_stages,):
                raise ValueError(
                    f"stage_queue_waits samples must have length "
                    f"{self.dag.num_stages}, got shape {qw.shape}")
            # congestion feedback: observed queue wait inflates the
            # *predicted* public latencies only — priority keys, ACD
            # slack, and the placement argmin see the congested pool,
            # while the actual draws (act) stay the ground truth
            pred = dict(pred)
            pred["P_public"] = pred["P_public"] + qw[None, :]
        ctx = PolicyContext(
            dag=self.dag, sla_s=float(sla_s),
            replan_every_s=float(replan_every_s), release=release,
            admitted=admitted, order=policy.order or order,
            cost_model=self.cost_model, portfolio=self.portfolio)
        plan = policy.plan(pred, act, ctx)
        kw = dict(order=policy.order or order, cost_model=self.cost_model,
                  portfolio=self.portfolio, arrivals=admitted,
                  engine=engine, faults=faults, retry=retry,
                  replica_slowdown=slow or None, chunk_jobs=chunk_jobs,
                  egress_lookahead=egress_lookahead,
                  concurrency=concurrency, coldstart=coldstart,
                  pool_trace=pool_trace, device=self.device)
        res = simulate(self.dag, plan.pred, act, c_max=plan.c_max,
                       **plan.sim_kwargs, **kw)
        if plan.report_deadline is not None:
            res = dataclasses.replace(res, deadline=plan.report_deadline)
        return OnlineReport(result=res, release=release, admitted=admitted,
                            sla_s=float(sla_s),
                            replan_every_s=float(replan_every_s),
                            mode=label)

    def compare_policies(self, prompt_len: np.ndarray,
                         new_tokens: np.ndarray,
                         policies: Sequence, sla_s: float,
                         arrivals: ArrivalsLike = None,
                         replan_every_s: float = 0.0, order: str = "spt",
                         seed: int = 1, use_ridge: bool = True,
                         engine: str = "vector",
                         faults=None, retry=None, price_traces=None,
                         concurrency=None, coldstart=None, pool_trace=None,
                         egress_lookahead: bool = True,
                         chunk_jobs: Optional[int] = None):
        """Evaluate several online policies on one request stream as ONE
        batched sweep and return the Fig.-4-style
        :class:`.policies.PolicyReport` (cost, SLA attainment against
        true arrivals, makespan, offload/abandonment fractions per
        policy). ``policies`` entries are :class:`.policies.Policy`
        instances or registry names; ``faults``/``price_traces`` add
        scenario axes shared by every policy. See
        :func:`.policies.compare_policies`.
        """
        pred, act = self._pred_act(prompt_len, new_tokens, seed, use_ridge)
        return compare_policies(
            policies, self.dag, pred, act, sla_s, arrivals=arrivals,
            replan_every_s=replan_every_s, order=order, engine=engine,
            cost_model=self.cost_model, portfolio=self.portfolio,
            faults=faults, retry=retry, price_traces=price_traces,
            concurrency=concurrency, coldstart=coldstart,
            pool_trace=pool_trace, egress_lookahead=egress_lookahead,
            chunk_jobs=chunk_jobs, device=self.device)

    def baselines(self, prompt_len, new_tokens, seed: int = 1):
        rng = np.random.default_rng(seed)
        act = self.lat.latencies(prompt_len, new_tokens, rng)
        pred = self.lat.latencies(prompt_len, new_tokens, None)
        pub = self.sched.baseline_all_public(pred, act)
        priv = self.sched.baseline_all_private(pred, act)
        return pub, priv
