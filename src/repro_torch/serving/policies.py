"""Pluggable online scheduling policies and the Fig.-4 comparison harness.

``serve_online`` used to hard-code one rolling-horizon heuristic. This
module factors its decisions into a :class:`Policy` protocol with three
pluggable components:

* **admission** — :meth:`Policy.admit` maps true release times to the
  times the controller actually sees them (the default quantizes up to
  the next replan epoch, exactly ``serve_online``'s behavior);
* **ordering** — :attr:`Policy.order` optionally overrides the queue
  priority rule (``None`` inherits the caller's);
* **placement** — :meth:`Policy.plan` turns predictions into a
  :class:`PolicyPlan`: the (possibly transformed) prediction dict, the
  scheduler deadline knob ``c_max``, and the simulation flags that
  realize the placement — either the engine-native ACD eviction loop
  (``init_phase``/``init_window``/``adaptive``) or an externally decided
  ``offload_mask`` (a [J] bool plan consumed by both engines, see
  :func:`repro_torch.core.simulator.simulate`).

Policies
--------
:class:`SkedulixGreedy` is the paper's Alg. 1 extracted verbatim — its
plan reproduces the exact ``simulate`` keywords the pre-refactor
``serve_online(mode="hybrid")`` passed, so it is bit-exact by
construction (and pinned by ``tests/test_torch_policies.py``). Likewise
:class:`PrivateOnly` / :class:`PublicOnly` reproduce the old
``mode="private"`` / ``mode="public"`` calls.

:class:`NoahSharedQueue` adapts NOAH (Stein 2018, arXiv 1809.06100):
requests share one virtual queue over the private pool, a fluid backlog
estimate predicts each request's finish time at admission, and requests
whose predicted finish busts the deadline spill to the elastic cloud.

:class:`CostAnalysisPlacement` adapts the cost-analysis allocation
policies of De Palma et al. 2023 (arXiv 2310.20391): a request is placed
on the public cloud only when its cheapest billed public cost stays
within ``budget_frac`` of the private opportunity cost (reserved
GB-seconds it would otherwise hold) *and* its predicted public path
meets the SLA.

:class:`RandomFeasible` is the null hypothesis: a seeded Bernoulli
offload plan (pinned stages stay private; the engine's provider argmin
handles memory feasibility as it does for the init-phase plan).

Comparison harness
------------------
:func:`compare_policies` evaluates a policy list over ONE
:func:`repro_torch.core.vectorsim.sweep_scenarios` call — each policy is a
task carrying its own prediction transform, release quantization, and
per-task scheduling-flag overrides, so an ACD-adaptive policy and
fixed-placement baselines batch into the same device sweep (sharing the
compiled shape family), optionally crossed with ``faults`` and
``price_traces`` scenario axes. The result is a Fig.-4-style
:class:`PolicyReport`: cost, SLA attainment (against *true* arrivals),
makespan, offload and abandonment fractions per policy.

The sweep runs on ``device`` (``cuda`` unless the caller names another):
there every ACD-adaptive policy's eviction sweeps launch the ``acd_evict``
kernel and capped providers' dispatch chains ``fifo_dispatch``. Policy
decisions and the report's means stay on the host in numpy float64, in
the JAX package's order.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..core.arrivals import ArrivalsLike, resolve_release
from ..core.cost import LAMBDA_COST, CostModel, ProviderPortfolio
from ..core.dag import AppDAG
from ..core.vectorsim import VectorSimResult, sweep_scenarios

__all__ = [
    "Policy", "PolicyContext", "PolicyPlan", "PolicyReport",
    "SkedulixGreedy", "PrivateOnly", "PublicOnly", "RandomFeasible",
    "NoahSharedQueue", "CostAnalysisPlacement",
    "POLICIES", "policy_from_mode", "compare_policies",
]

# wall-time spent in Policy.plan/admit during the last compare_policies
# call (host clock) — the serving-layer twin of vectorsim._LAST_RUN_STATS,
# printed by chip_smoke.py's serving-scheduler phase
_LAST_POLICY_STATS: Dict[str, float] = {}


@dataclasses.dataclass(frozen=True)
class PolicyContext:
    """Everything a policy may condition on at planning time.

    ``release`` holds the *true* arrival times, ``admitted`` the
    policy's own admission output (what a causal controller sees);
    plans that peek at ``release`` directly are clairvoyant and should
    say so in their docstring.
    """

    dag: AppDAG
    sla_s: float
    replan_every_s: float
    release: np.ndarray        # [J] true arrival times
    admitted: np.ndarray       # [J] post-admission release times
    order: str
    cost_model: CostModel
    portfolio: Optional[ProviderPortfolio]
    t0: float = 0.0


@dataclasses.dataclass
class PolicyPlan:
    """A policy's decision, expressed as simulation inputs.

    ``sim_kwargs`` may carry any of the per-task scheduling-flag
    overrides understood by :func:`~repro_torch.core.vectorsim.sweep_scenarios`
    (``init_phase``, ``adaptive``, ``init_window``, ``offload_mask``).
    ``report_deadline`` optionally overrides the deadline *recorded* in
    the result (not the scheduling knob) — ``PublicOnly`` schedules at
    ``c_max=0`` but reports against the SLA, exactly as the pre-refactor
    ``mode="public"`` did.
    """

    pred: Dict[str, np.ndarray]
    c_max: float
    sim_kwargs: Dict[str, object] = dataclasses.field(default_factory=dict)
    report_deadline: Optional[float] = None


class Policy:
    """Base class: admission + ordering + placement.

    Subclasses set ``name`` (the report/registry key), optionally
    ``order`` (``None`` = inherit the caller's priority rule), and
    implement :meth:`plan`. The default :meth:`admit` quantizes releases
    up to the next replan epoch — byte-identical to ``serve_online``'s
    rolling-horizon admission.
    """

    name: str = "policy"
    order: Optional[str] = None

    def admit(self, release: np.ndarray,
              replan_every_s: float) -> np.ndarray:
        if replan_every_s > 0.0:
            return np.ceil(release / replan_every_s) * replan_every_s
        return release.copy()

    def plan(self, pred: Dict[str, np.ndarray],
             act: Optional[Dict[str, np.ndarray]],
             ctx: PolicyContext) -> PolicyPlan:
        raise NotImplementedError

    def __repr__(self) -> str:
        return f"{type(self).__name__}(name={self.name!r})"


class SkedulixGreedy(Policy):
    """The paper's Alg. 1 (ACD eviction loop), extracted from
    ``serve_online(mode="hybrid")`` — bit-exact to the pre-refactor
    behavior: non-clairvoyant by default (every offload is an ACD
    eviction), with ``init_offload=True`` re-enabling the capacity
    prefix rule gated to the first replan window."""

    name = "skedulix"

    def __init__(self, init_offload: bool = False):
        self.init_offload = bool(init_offload)

    def plan(self, pred, act, ctx):
        kw: Dict[str, object] = dict(
            init_phase=self.init_offload,
            init_window=(float(ctx.replan_every_s)
                         if self.init_offload else None))
        return PolicyPlan(pred=pred, c_max=float(ctx.sla_s), sim_kwargs=kw)


class PrivateOnly(Policy):
    """Never offload: every request queues on the reserved pod
    (``serve_online(mode="private")``). Zero elastic spend, SLA
    attainment bounded by pool capacity."""

    name = "private"

    def plan(self, pred, act, ctx):
        return PolicyPlan(pred=pred, c_max=float(ctx.sla_s),
                          sim_kwargs=dict(init_phase=False, adaptive=False))


class PublicOnly(Policy):
    """Every request straight to elastic capacity
    (``serve_online(mode="public")``): the private pool is priced out
    (``P_private=1e12``) and the deadline knob drops to 0 so the init
    plan offloads everything; attainment is still reported against the
    SLA."""

    name = "public"

    def plan(self, pred, act, ctx):
        blocked = dict(pred)
        blocked["P_private"] = np.full_like(
            np.asarray(pred["P_private"], dtype=np.float64), 1e12)
        return PolicyPlan(pred=blocked, c_max=0.0,
                          sim_kwargs=dict(adaptive=False),
                          report_deadline=float(ctx.sla_s))


class RandomFeasible(Policy):
    """Seeded Bernoulli offload plan — the null-hypothesis baseline.

    Each request independently offloads with probability ``p_offload``.
    Must-private stages stay pinned and the engine's provider argmin
    enforces memory feasibility, exactly as for the init-phase plan.
    """

    name = "random"

    def __init__(self, p_offload: float = 0.5, seed: int = 0):
        if not 0.0 <= p_offload <= 1.0:
            raise ValueError(f"p_offload must be in [0, 1], got {p_offload}")
        self.p_offload = float(p_offload)
        self.seed = int(seed)

    def plan(self, pred, act, ctx):
        J = int(np.asarray(pred["P_private"]).shape[0])
        rng = np.random.default_rng(self.seed)
        mask = rng.random(J) < self.p_offload
        return PolicyPlan(pred=pred, c_max=float(ctx.sla_s),
                          sim_kwargs=dict(adaptive=False,
                                          offload_mask=mask))


class NoahSharedQueue(Policy):
    """Shared-queue spillover after NOAH (Stein 2018, arXiv 1809.06100).

    NOAH schedules serverless executions on a shared resource pool by
    predicting each job's queueing delay and acting before deadlines
    bust. Adapted here: requests join one virtual queue over the
    private pool; a fluid backlog estimate (per-stage work draining at
    the pool's aggregate replica rate) predicts each request's finish
    at its admission instant, and requests whose predicted finish
    exceeds ``release + headroom * sla_s`` spill to the elastic cloud.
    Causal: the scan walks admission order and only ever looks at
    requests admitted so far.
    """

    name = "noah"

    def __init__(self, headroom: float = 1.0):
        if headroom <= 0.0:
            raise ValueError(f"headroom must be > 0, got {headroom}")
        self.headroom = float(headroom)

    def plan(self, pred, act, ctx):
        P = np.asarray(pred["P_private"], dtype=np.float64)
        J, M = P.shape
        cap = np.maximum(np.asarray(ctx.dag.replicas, dtype=np.float64),
                         1.0)
        admit = np.asarray(ctx.admitted, dtype=np.float64)
        order = np.argsort(admit, kind="stable")
        backlog = np.zeros(M)
        mask = np.zeros(J, dtype=bool)
        t_prev = float(admit[order[0]]) if J else 0.0
        budget = self.headroom * float(ctx.sla_s)
        for j in order:
            t = float(admit[j])
            # drain the shared queue at the pool's aggregate rate
            backlog = np.maximum(backlog - (t - t_prev) * cap, 0.0)
            t_prev = t
            wait = float((backlog / cap).sum())
            work = float(P[j].sum())
            if t + wait + work > float(ctx.release[j]) + budget:
                mask[j] = True     # spill to the elastic shared queue
            else:
                backlog = backlog + P[j]
        return PolicyPlan(pred=pred, c_max=float(ctx.sla_s),
                          sim_kwargs=dict(adaptive=False,
                                          offload_mask=mask))


class CostAnalysisPlacement(Policy):
    """Cost-analysis placement after De Palma et al. 2023
    (arXiv 2310.20391).

    Their allocation-priority DSL ranks placement targets by a cost
    analysis of each function on each zone. Adapted here: a request
    offloads only when (a) its cheapest billed public cost — provider
    argmin over :meth:`~repro_torch.core.cost.ProviderPortfolio
    .np_selection_costs_seg` at the ``t0`` price segment, summed over
    its offloadable stages — stays within ``budget_frac`` of the
    private *opportunity cost* (the reserved GB-seconds it would hold,
    priced at the cost model's rate, the same rate
    ``autoscale_frontier`` reserves at), and (b) its predicted public
    path (latency + transfers) meets the SLA. Pinned stages always run
    privately and are excluded from both sides of the comparison.
    """

    name = "costanalysis"

    def __init__(self, budget_frac: float = 1.0):
        if budget_frac <= 0.0:
            raise ValueError(
                f"budget_frac must be > 0, got {budget_frac}")
        self.budget_frac = float(budget_frac)

    def plan(self, pred, act, ctx):
        dag = ctx.dag
        pf = (ctx.portfolio if ctx.portfolio is not None
              else ProviderPortfolio.from_cost_model(ctx.cost_model))
        P_pub = np.asarray(pred["P_public"], dtype=np.float64)
        P_priv = np.asarray(pred["P_private"], dtype=np.float64)
        free = ~dag.must_private_mask                       # offloadable
        sel = pf.np_selection_costs_seg(
            P_pub, dag.mem_mb, pred.get("download"), dag.is_sink,
            require=~dag.must_private_mask, num_segments=1)[:, 0]
        stage_cost = sel.min(axis=0)                        # [J, M]
        with np.errstate(invalid="ignore"):
            job_cost = stage_cost[:, free].sum(axis=1)      # inf=infeasible
        rate = (dag.mem_mb / 1024.0) * ctx.cost_model.usd_per_gb_ms * 1e3
        opportunity = (P_priv * rate[None, :])[:, free].sum(axis=1)
        path = (P_pub
                + np.asarray(pred.get("upload", 0.0), dtype=np.float64)
                + np.asarray(pred.get("download", 0.0), dtype=np.float64))
        latency = (path[:, free].sum(axis=1)
                   + P_priv[:, ~free].sum(axis=1))
        with np.errstate(invalid="ignore"):
            mask = ((job_cost <= self.budget_frac * opportunity)
                    & (latency <= float(ctx.sla_s) + 1e-9))
        return PolicyPlan(pred=pred, c_max=float(ctx.sla_s),
                          sim_kwargs=dict(adaptive=False,
                                          offload_mask=mask))


# registry: mode strings (serve_online back-compat) and bench/CLI names
POLICIES: Dict[str, type] = {
    "hybrid": SkedulixGreedy,
    "skedulix": SkedulixGreedy,
    "private": PrivateOnly,
    "public": PublicOnly,
    "random": RandomFeasible,
    "noah": NoahSharedQueue,
    "costanalysis": CostAnalysisPlacement,
}


def policy_from_mode(mode: str, **kwargs) -> Policy:
    """Resolve a registry name (e.g. ``serve_online``'s legacy ``mode=``
    strings) to a policy instance; ``kwargs`` go to the constructor."""
    try:
        cls = POLICIES[mode]
    except KeyError:
        raise ValueError(f"unknown policy {mode!r}; "
                         f"known: {sorted(POLICIES)}") from None
    return cls(**kwargs)


@dataclasses.dataclass
class PolicyReport:
    """Fig.-4-style comparison: one row per policy, columns averaged
    over the scenario grid (faults x price traces). SLA attainment is
    against *true* arrival times; abandoned requests count as misses.
    """

    policies: Tuple[str, ...]
    sla_s: float
    release: np.ndarray            # [J] true arrivals
    cost_usd: np.ndarray           # [n_policies, S]
    sla: np.ndarray                # [n_policies, S]
    makespan: np.ndarray           # [n_policies, S]
    offload_frac: np.ndarray       # [n_policies, S]
    abandoned_frac: np.ndarray     # [n_policies, S]
    plan_s: float                  # wall-time spent in Policy.plan
    results: List[VectorSimResult]

    def __getitem__(self, name: str) -> Dict[str, float]:
        for row in self.summary():
            if row["policy"] == name:
                return row
        raise KeyError(name)

    def summary(self) -> List[Dict[str, float]]:
        rows = []
        for i, name in enumerate(self.policies):
            rows.append({
                "policy": name,
                "cost_usd": float(self.cost_usd[i].mean()),
                "sla": float(self.sla[i].mean()),
                "makespan": float(self.makespan[i].mean()),
                "offload_frac": float(self.offload_frac[i].mean()),
                "abandoned_frac": float(self.abandoned_frac[i].mean()),
            })
        return rows

    def table(self) -> str:
        hdr = (f"{'policy':<14} {'cost $':>12} {'sla':>7} "
               f"{'makespan s':>11} {'offload':>8} {'abandon':>8}")
        lines = [hdr, "-" * len(hdr)]
        for r in self.summary():
            lines.append(
                f"{r['policy']:<14} {r['cost_usd']:>12.6f} "
                f"{r['sla']:>7.3f} {r['makespan']:>11.3f} "
                f"{r['offload_frac']:>8.3f} {r['abandoned_frac']:>8.3f}")
        return "\n".join(lines)

    def __str__(self) -> str:
        return self.table()


PolicyLike = Union[str, Policy]


def compare_policies(
    policies: Sequence[PolicyLike],
    dag: AppDAG,
    pred: Dict[str, np.ndarray],
    act: Optional[Dict[str, np.ndarray]],
    sla_s: float,
    arrivals: ArrivalsLike = None,
    replan_every_s: float = 0.0,
    order: str = "spt",
    engine: str = "vector",
    cost_model: CostModel = LAMBDA_COST,
    portfolio: Optional[ProviderPortfolio] = None,
    faults=None,
    retry=None,
    price_traces: Optional[Sequence] = None,
    concurrency=None,
    coldstart=None,
    pool_trace=None,
    egress_lookahead: bool = True,
    chunk_jobs: Optional[int] = None,
    t0: float = 0.0,
    device=None,
) -> PolicyReport:
    """Evaluate a policy list on one workload as ONE batched sweep.

    Each policy becomes one :func:`~repro_torch.core.vectorsim.sweep_scenarios`
    task — its own admission quantization, prediction transform, and
    per-task scheduling-flag overrides — optionally crossed with
    ``faults`` and ``price_traces`` scenario axes shared by every
    policy, so the whole policies x faults x markets grid runs as a
    single device call per shape family on ``device`` (``"cuda"`` unless
    given; ``engine="des"`` is the serial host reference; checksums must
    agree). Entries of ``policies`` may be
    :class:`Policy` instances or registry names (``"skedulix"``,
    ``"noah"``, ...).

    Returns a :class:`PolicyReport`; module-level
    ``_LAST_POLICY_STATS["policy_s"]`` records the wall-time the
    policies' ``plan``/``admit`` calls took (decision overhead, distinct
    from engine time).
    """
    resolved: List[Policy] = [
        policy_from_mode(p) if isinstance(p, str) else p for p in policies]
    names = tuple(p.name for p in resolved)
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate policy names in {names}; "
                         "give instances distinct .name values")
    J = int(np.asarray(pred["P_private"]).shape[0])
    release = resolve_release(arrivals, J, t0)
    if release is None:
        release = np.full(J, float(t0))

    _LAST_POLICY_STATS.clear()
    t_plan = time.perf_counter()
    tasks: List[Dict] = []
    deadlines: List[Optional[float]] = []
    for pol in resolved:
        admitted = pol.admit(release, float(replan_every_s))
        ctx = PolicyContext(
            dag=dag, sla_s=float(sla_s),
            replan_every_s=float(replan_every_s), release=release,
            admitted=admitted, order=pol.order or order,
            cost_model=cost_model, portfolio=portfolio, t0=float(t0))
        plan = pol.plan(pred, act, ctx)
        task: Dict = {"dag": dag, "pred": plan.pred, "act": act,
                      "c_max_grid": (float(plan.c_max),),
                      "orders": (pol.order or order,),
                      "arrivals": admitted}
        if faults is not None:
            task["faults"] = faults
        if price_traces is not None:
            task["price_traces"] = list(price_traces)
        task.update(plan.sim_kwargs)
        tasks.append(task)
        deadlines.append(plan.report_deadline)
    _LAST_POLICY_STATS["policy_s"] = time.perf_counter() - t_plan

    results = sweep_scenarios(
        tasks, cost_model=cost_model, engine=engine, portfolio=portfolio,
        retry=retry, t0=t0, chunk_jobs=chunk_jobs,
        egress_lookahead=egress_lookahead, concurrency=concurrency,
        coldstart=coldstart, pool_trace=pool_trace, device=device)

    cost, sla, mk, off, aband = [], [], [], [], []
    final: List[VectorSimResult] = []
    for res, dl in zip(results, deadlines):
        if dl is not None:
            res = dataclasses.replace(
                res, deadline=np.full_like(res.deadline, float(dl)))
        final.append(res)
        flow = res.completion - release[None, :]
        with np.errstate(invalid="ignore"):
            met = np.where(np.isnan(flow), False,
                           flow <= float(sla_s) + 1e-9)
        sla.append(met.mean(axis=1) if J else np.ones(res.num_scenarios))
        cost.append(res.cost_usd)
        mk.append(res.makespan)
        off.append(res.offload_fraction)
        aband.append(res.abandoned.mean(axis=1)
                     if res.abandoned is not None and J
                     else np.zeros(res.num_scenarios))
    return PolicyReport(
        policies=names, sla_s=float(sla_s), release=release,
        cost_usd=np.stack(cost), sla=np.stack(sla), makespan=np.stack(mk),
        offload_frac=np.stack(off), abandoned_frac=np.stack(aband),
        plan_s=float(_LAST_POLICY_STATS["policy_s"]), results=final)
