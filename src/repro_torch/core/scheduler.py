"""SkedulixScheduler — the user-facing orchestration service (Sec. III-A).

Ties together: predictions -> Alg. 1 greedy scheduling -> hybrid execution
(discrete-event sim standing in for the live platform).

Two execution engines back the service: :meth:`SkedulixScheduler.schedule`
accepts ``engine="des"`` (the event-heap reference, the default) or
``engine="vector"`` (the batched PyTorch engine in :mod:`.vectorsim`);
:meth:`SkedulixScheduler.schedule_sweep` evaluates a whole (order x C_max)
scenario grid in one batched call — the unit of work behind every
deadline-sweep figure — on ``device`` (``"cuda"`` unless given). Both
accept ``arrivals=`` to schedule an exogenous release stream
(:mod:`.arrivals`) instead of the paper's batch at ``t0``; deadlines then
become per-job relative SLAs (``release + C_max``). Predictions come as
``pred``, or from job features through the attached perf model
(:mod:`.perfmodel`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np

from .arrivals import ArrivalsLike
from .cost import CostModel, LAMBDA_COST, ProviderPortfolio
from .dag import AppDAG
from .simulator import SimResult, simulate, simulate_all_private, simulate_all_public
from .vectorsim import VectorSimResult, simulate_scenarios


@dataclasses.dataclass
class BatchReport:
    """One scheduled batch: the executed :class:`SimResult` plus the
    inputs that produced it (predictions, priority order, deadline)."""

    result: SimResult
    pred: Dict[str, np.ndarray]
    order: str
    c_max: float

    def summary(self) -> Dict[str, float]:
        """Flat metric dict: makespan, cost, deadline/SLA attainment,
        offload counters, and per-provider placement counts (portfolio
        runs). ``sla_attainment`` is the fraction of jobs finishing
        within ``c_max`` of their release (= ``met_deadline`` for a
        batch with every release at ``t0``)."""
        r = self.result
        out = {
            "makespan_s": r.makespan,
            "c_max": self.c_max,
            "cost_usd": r.cost_usd,
            "met_deadline": float(r.met_deadline),
            "sla_attainment": r.sla_attainment(),
            "offload_frac": r.offload_fraction,
            "n_offloaded_stages": float(r.n_offloaded_stages),
            "n_init_offloaded_jobs": float(r.n_init_offloaded_jobs),
        }
        if r.provider is not None and r.provider.size:
            # stages placed per public provider (portfolio runs)
            used, counts = np.unique(r.provider[r.provider >= 0],
                                     return_counts=True)
            out["n_providers_used"] = float(len(used))
            for p, c in zip(used.tolist(), counts.tolist()):
                out[f"stages_on_provider_{p}"] = float(c)
        return out


class SkedulixScheduler:
    """Long-running scheduler service for one application.

    ``perf_model`` (an :class:`.perfmodel.AppPerfModel`) turns job
    features into predictions (:meth:`predict`). :meth:`schedule` runs
    Alg. 1 with the chosen priority order against actual latencies
    (if given) to produce the executed schedule —
    for the paper's batch released at ``t0``, or, with ``arrivals=``, for
    an exogenous release stream. ``portfolio`` generalizes the public
    cloud to N providers: every offloaded (job, stage) runs on the
    cheapest feasible one.
    """

    def __init__(self, dag: AppDAG, perf_model=None,
                 cost_model: CostModel = LAMBDA_COST,
                 portfolio: Optional[ProviderPortfolio] = None):
        self.dag = dag
        self.perf_model = perf_model
        self.cost_model = cost_model
        # multi-cloud: offloaded stages go to the cheapest feasible provider
        self.portfolio = portfolio

    def predict(self, base_features: np.ndarray) -> Dict[str, np.ndarray]:
        """Per-stage latency/transfer predictions from the perf model
        (numpy float64 P_private, P_public, sizes, upload, download)."""
        if self.perf_model is None:
            raise ValueError("no perf model attached")
        return self.perf_model.predict(base_features)

    def schedule(
        self,
        c_max: float,
        base_features: Optional[np.ndarray] = None,
        pred: Optional[Dict[str, np.ndarray]] = None,
        act: Optional[Dict[str, np.ndarray]] = None,
        order: str = "spt",
        arrivals: ArrivalsLike = None,
        workload=None,
        **sim_kwargs,
    ) -> BatchReport:
        """Schedule one workload at one (order, C_max) point.

        ``pred`` (or ``base_features`` through the perf model) drives the
        decisions; ``act`` drives the clock. ``arrivals`` switches from
        the batch-at-``t0`` regime to an exogenous release stream — an
        :class:`.arrivals.ArrivalProcess`, a spec string like
        ``"poisson:4.0"``, or an explicit ``[J]`` release-time vector;
        each job then has its own deadline ``release + c_max``.
        ``workload`` replaces ``pred`` with a trace-derived spec
        (:mod:`.workloads`, e.g. ``"azure:day=tue,scale=1e5"``) whose
        release stream becomes the default arrivals. Extra keyword
        arguments (``engine=``, ``device=``, ``chunk_jobs=``, ``t0=``,
        flags) forward to :func:`.simulator.simulate`.
        """
        if workload is not None:
            if pred is not None:
                raise ValueError("pass either pred or workload=, not both")
            from .workloads import resolve_workload
            pred, act, wl_release = resolve_workload(
                workload, self.dag, sim_kwargs.get("t0", 0.0))
            if arrivals is None:
                arrivals = wl_release
        elif pred is None:
            pred = self.predict(base_features)
        res = simulate(self.dag, pred, act, c_max=c_max, order=order,
                       cost_model=self.cost_model, portfolio=self.portfolio,
                       arrivals=arrivals, **sim_kwargs)
        return BatchReport(result=res, pred=pred, order=order, c_max=c_max)

    # the pre-arrivals name; `schedule` is the same method
    schedule_batch = schedule

    def schedule_sweep(
        self,
        c_max_grid: Sequence[float],
        base_features: Optional[np.ndarray] = None,
        pred: Optional[Dict[str, np.ndarray]] = None,
        act: Optional[Dict[str, np.ndarray]] = None,
        orders: Sequence[str] = ("spt",),
        engine: str = "vector",
        arrivals: ArrivalsLike = None,
        replicas=None,
        replica_speeds=None,
        price_traces=None,
        faults=None,
        retry=None,
        workload=None,
        chunk_jobs: Optional[int] = None,
        egress_lookahead: bool = False,
        concurrency=None,
        coldstart=None,
        pool_trace=None,
        device=None,
        **sim_kwargs,
    ) -> VectorSimResult:
        """Run Alg. 1 over the whole ``orders x c_max_grid`` scenario grid.

        One batched engine call with ``engine="vector"`` on ``device``
        (``"cuda"`` unless given); ``engine="des"`` replays the grid
        serially through the reference simulator for parity checks.
        ``arrivals`` applies one exogenous release stream across every
        scenario of the grid (per-job deadlines ``release + c_max``).

        ``replicas`` adds an autoscaling axis — a list of per-stage
        replica count vectors [M], each a private-pool sizing swept
        against every deadline of the grid; ``replica_speeds`` adds a
        straggler axis — ``{(stage, replica): factor}`` dicts or [M, I]
        slowdown arrays; ``price_traces`` adds a pricing axis — portfolio
        variants or per-provider :class:`.cost.PriceTrace` lists;
        ``faults`` adds a reliability axis — :class:`.faults.FaultModel`
        configs, scalar failure rates or ``None`` entries, recovered
        under the ``retry`` :class:`.faults.RetryPolicy`. All are
        scenario data in the vector engine: the whole grid is one batched
        call.

        ``workload`` replaces ``pred``/``base_features`` with a trace-
        derived workload spec (:mod:`.workloads`, e.g.
        ``"azure:day=tue,scale=1e5"``) whose release stream becomes the
        default arrivals; ``chunk_jobs`` pages the job axis (results equal
        to the monolithic run's: the knob for days of 10^5 jobs);
        ``egress_lookahead`` adds the one-edge downstream-egress term to
        the placement argmin. ``concurrency``, ``coldstart`` and
        ``pool_trace`` add load-dependent latency shared by every scenario
        (per-provider concurrency caps with FIFO queueing, cold starts, a
        time-varying private pool; see :func:`.vectorsim.simulate_scenarios`).
        """
        if pred is None and workload is None:
            pred = self.predict(base_features)
        return simulate_scenarios(
            self.dag, pred, act, c_max_grid=c_max_grid, orders=orders,
            cost_model=self.cost_model, portfolio=self.portfolio,
            engine=engine, arrivals=arrivals, replicas=replicas,
            replica_speeds=replica_speeds, price_traces=price_traces,
            faults=faults, retry=retry, workload=workload,
            chunk_jobs=chunk_jobs, egress_lookahead=egress_lookahead,
            concurrency=concurrency, coldstart=coldstart,
            pool_trace=pool_trace, device=device, **sim_kwargs)

    def baseline_all_public(self, pred, act=None,
                            arrivals: ArrivalsLike = None) -> SimResult:
        """Everything offloaded on release (paper Sec. V-C baseline)."""
        return simulate_all_public(self.dag, pred, act,
                                   cost_model=self.cost_model,
                                   portfolio=self.portfolio,
                                   arrivals=arrivals)

    def baseline_all_private(self, pred, act=None, order="spt",
                             arrivals: ArrivalsLike = None) -> SimResult:
        """Nothing offloaded: C_max loose enough that all jobs fit."""
        return simulate_all_private(self.dag, pred, act, order=order,
                                    cost_model=self.cost_model,
                                    portfolio=self.portfolio,
                                    arrivals=arrivals)
