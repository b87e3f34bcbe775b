"""Public-cloud cost models (paper Eqn. 1), scalar and multi-provider.

The paper's Eqn. 1 is the scalar Lambda shape

    h(t) = 100 * ceil(t/100) * (M/1024) * (0.00001667/1000)

with t in milliseconds and M the memory configuration in MB; Lambda bills
a *minimum of one quantum*, so h(0) is one quantum's price, not $0
(``min_quantums``). :class:`CostModel` reproduces exactly that, with the
quantum, $/GB-ms rate and minimum-billed quantums as parameters so elastic
TPU/GPU billing (per second, per 100 ms, ...) uses the same code path.

Portfolio semantics (multi-cloud)
---------------------------------
:class:`ProviderPortfolio` generalizes the scalar model to N public
providers. Each :class:`Provider` carries its own billing quantum, $/GB-ms
rate, egress price ($/GB on results leaving the provider), a latency
multiplier applied to the ``P_public``/transfer draws (a slower provider
both runs longer *and* bills that longer runtime), and an optional memory
cap (stages whose ``mem_mb`` exceeds it are infeasible there). Placement
becomes a provider *index*: ``-1`` is the private cloud, ``0..N-1`` a
public provider. Alg. 1's eviction offloads each (job, stage) to the
**cheapest feasible provider** — the argmin over the portfolio of the
*predicted* billed cost (execution + sink egress), shared bit-for-bit by
the DES, the vector engine and the MILP baseline. Egress is charged where
the platform pays a download: at public sink stages, on the un-multiplied
transfer volume (``download_s * EGRESS_GB_PER_S``), and — since the
price-trace extension — on DAG edges whose endpoints run public on
*different* providers (a forced-public cascade moving data between
clouds), billed at the upstream provider's egress price in the upstream
stage's recorded segment. A single-provider portfolio built from a
:class:`CostModel` reproduces the scalar pipeline exactly.

Time-dependent pricing (price traces)
-------------------------------------
:class:`PriceTrace` makes a provider's $/GB-ms rate, egress price and
latency multiplier **piecewise-constant functions of simulated time**:
segment ``s`` is active on ``[breakpoints[s-1], breakpoints[s])`` (the new
price applies *at* the breakpoint instant), the first segment from
``-inf``, the last to ``+inf``. The billing quantum, min-quantums and
memory cap stay static — they are contract terms, not market state.

Decision-epoch semantics: the provider *and* the price segment of an
offloaded (job, stage) are locked at the **offload epoch** — the stage's
arrival time when it was forced public (initialization offload or an
upstream eviction cascade), the eviction instant when the ACD evicts it.
The argmin runs over every provider's segment active at that epoch; the
whole stage then bills at the locked segment's rate even if execution
spans a breakpoint (the cloud quoted a price when the work was placed).
Priority keys and the initialization offload see the trace prices at
``t0`` (plan time), so queue order stays static and both engines agree.
A 1-segment trace is bit-exact against the same provider's static fields.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

USD_PER_GB_MS = 0.00001667 / 1000.0  # AWS Lambda (Feb 2020)
QUANTUM_MS = 100.0
MIN_QUANTUMS = 1.0                   # Lambda bills at least one quantum
EGRESS_GB_PER_S = 0.125              # transfer volume of one link-second (1 Gbps)


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Deterministic execution-cost model: rounded time x memory x rate.

    ``min_quantums`` floors the billed quantums — zero (or negative, e.g.
    a ridge model extrapolating below 0) execution-time draws bill one
    quantum, as Lambda does, instead of $0.
    """

    quantum_ms: float = QUANTUM_MS
    usd_per_gb_ms: float = USD_PER_GB_MS
    min_quantums: float = MIN_QUANTUMS

    def __call__(self, t_ms, mem_mb):
        """Cost (USD) of executing for ``t_ms`` at memory ``mem_mb``.

        Works on scalars and numpy arrays (broadcasting).
        """
        t_ms = np.asarray(t_ms)
        quantums = np.maximum(np.ceil(t_ms / self.quantum_ms),
                              self.min_quantums)
        return (self.quantum_ms * quantums
                * (np.asarray(mem_mb) / 1024.0) * self.usd_per_gb_ms)

    def np_cost(self, t_ms, mem_mb):
        """Pure-numpy twin for the discrete-event hot loop."""
        quantums = np.maximum(
            np.ceil(np.asarray(t_ms, dtype=np.float64) / self.quantum_ms),
            self.min_quantums)
        return (self.quantum_ms * quantums
                * (np.asarray(mem_mb, dtype=np.float64) / 1024.0)
                * self.usd_per_gb_ms)


LAMBDA_COST = CostModel()


def lambda_cost(t_ms, mem_mb):
    """Eqn. 1 with the paper's constants."""
    return LAMBDA_COST(t_ms, mem_mb)


def stage_costs(P_public_s: np.ndarray, mem_mb: np.ndarray,
                model: CostModel = LAMBDA_COST) -> np.ndarray:
    """H_{k,j}: public cost of each (job, stage).

    ``P_public_s``: [J, M] public latencies in *seconds*;
    ``mem_mb``: [M].  Returns [J, M] USD.
    """
    return model.np_cost(np.asarray(P_public_s) * 1e3, np.asarray(mem_mb)[None, :])


# -- time-dependent pricing ------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PriceTrace:
    """Piecewise-constant price trace: one provider's market state over time.

    ``usd_per_gb_ms``/``egress_usd_per_gb``/``latency_mult`` hold one value
    per segment; ``breakpoints`` the ``S-1`` strictly-increasing instants
    where the next segment takes over (the new price applies *at* the
    breakpoint). Zero-length segments (repeated breakpoints) are rejected —
    a segment no offload epoch can ever land in is a spec bug, not data.
    """

    usd_per_gb_ms: Tuple[float, ...]
    egress_usd_per_gb: Tuple[float, ...] = ()
    latency_mult: Tuple[float, ...] = ()
    breakpoints: Tuple[float, ...] = ()

    def __post_init__(self):
        rate = tuple(float(x) for x in np.atleast_1d(self.usd_per_gb_ms))
        S = len(rate)
        if S < 1:
            raise ValueError("a price trace needs at least one segment")
        eg = tuple(float(x) for x in np.atleast_1d(self.egress_usd_per_gb)) \
            or (0.0,) * S
        lm = tuple(float(x) for x in np.atleast_1d(self.latency_mult)) \
            or (1.0,) * S
        bp = tuple(float(x) for x in np.atleast_1d(self.breakpoints)) \
            if np.size(self.breakpoints) else ()
        for name, vals, n in (("egress_usd_per_gb", eg, S),
                              ("latency_mult", lm, S),
                              ("breakpoints", bp, S - 1)):
            if len(vals) != n:
                raise ValueError(
                    f"{name}: expected {n} entries for a {S}-segment "
                    f"trace, got {len(vals)}")
        if not all(np.isfinite(rate)) or not all(np.isfinite(eg)):
            raise ValueError("segment prices must be finite")
        if not all(np.isfinite(lm)) or any(x <= 0 for x in lm):
            raise ValueError("latency multipliers must be finite and > 0")
        if any(not np.isfinite(b) for b in bp):
            raise ValueError("breakpoints must be finite")
        if any(b2 <= b1 for b1, b2 in zip(bp, bp[1:])):
            bad = [i for i, (b1, b2) in enumerate(zip(bp, bp[1:]))
                   if b2 <= b1]
            raise ValueError(
                f"breakpoints must be strictly increasing (zero-length "
                f"segment at breakpoint index {bad[0]})")
        object.__setattr__(self, "usd_per_gb_ms", rate)
        object.__setattr__(self, "egress_usd_per_gb", eg)
        object.__setattr__(self, "latency_mult", lm)
        object.__setattr__(self, "breakpoints", bp)

    @property
    def num_segments(self) -> int:
        return len(self.usd_per_gb_ms)

    def edges(self) -> np.ndarray:
        """[S] segment start instants; ``edges[0] = -inf``.

        ``segment_at(t) == (edges <= t).sum() - 1`` — the formulation both
        engines evaluate (as a comparison-sum over data, not a sort).
        """
        return np.concatenate([[-np.inf],
                               np.asarray(self.breakpoints, np.float64)])

    def segment_at(self, t: float) -> int:
        """Active segment at time ``t`` (new price applies at a breakpoint)."""
        return int((self.edges() <= t).sum() - 1)


# -- provider portfolio ----------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Provider:
    """One public provider's billing + latency profile.

    ``quantum_ms``/``usd_per_gb_ms``/``min_quantums`` are the provider's
    Eqn.-1 execution billing (duration rounded up to the quantum, at
    least ``min_quantums`` of it, times memory times rate);
    ``latency_mult`` scales the public execution *and* transfer draws (and
    the billed runtime with them); ``egress_usd_per_gb`` prices results
    leaving the provider (charged at public sinks); ``max_mem_mb`` caps the
    memory configurations the provider can host (None = unlimited).

    ``trace`` makes the rate/egress/latency-multiplier **time-dependent**
    (:class:`PriceTrace`); when set it overrides those three scalar fields
    segment-by-segment (quantum, min-quantums and the memory cap stay
    static). ``effective_trace()`` is the single pricing source both
    engines read: a traced provider returns its trace, a static provider a
    1-segment trace of its scalar fields — bit-identical arithmetic.

    ``max_concurrency`` caps how many invocations of one *function*
    (stage) the provider runs at once — the account-level reserved
    concurrency of real FaaS platforms, binding per (provider, stage).
    ``None`` means an unbounded fleet (the pre-congestion model): a
    dispatch never waits and never finds a cold slot. A capped provider
    exposes ``max_concurrency`` FIFO slots per stage; dispatch beyond the
    cap queues, and the queueing delay is billed as occupancy (linear at
    the segment's $/GB-s rate — a held slot is paid-for capacity, not a
    quantized execution) and fed into the placement argmin.
    """

    name: str
    quantum_ms: float = QUANTUM_MS
    usd_per_gb_ms: float = USD_PER_GB_MS
    egress_usd_per_gb: float = 0.0
    latency_mult: float = 1.0
    min_quantums: float = MIN_QUANTUMS
    max_mem_mb: Optional[float] = None
    trace: Optional[PriceTrace] = None
    max_concurrency: Optional[int] = None

    def __post_init__(self):
        if self.max_concurrency is not None:
            mc = int(self.max_concurrency)
            if mc < 1:
                raise ValueError(
                    f"max_concurrency must be >= 1 (or None = unbounded), "
                    f"got {self.max_concurrency}")
            object.__setattr__(self, "max_concurrency", mc)

    def cost_model(self) -> CostModel:
        """The provider's scalar execution-billing model."""
        return CostModel(quantum_ms=self.quantum_ms,
                         usd_per_gb_ms=self.usd_per_gb_ms,
                         min_quantums=self.min_quantums)

    def effective_trace(self) -> PriceTrace:
        """The provider's pricing as a trace (1 segment when static)."""
        if self.trace is not None:
            return self.trace
        return PriceTrace(usd_per_gb_ms=(self.usd_per_gb_ms,),
                          egress_usd_per_gb=(self.egress_usd_per_gb,),
                          latency_mult=(self.latency_mult,))

    def with_trace(self, trace: Optional[PriceTrace]) -> "Provider":
        """This provider under a (possibly None = static) price trace."""
        return dataclasses.replace(self, trace=trace)


@dataclasses.dataclass(frozen=True)
class ProviderPortfolio:
    """N public providers; placement generalizes to a provider index.

    All matrix methods use a leading provider axis ``[P, ...]`` and pure
    float64 numpy so the DES preamble, the vector engine's data arrays and
    the MILP coefficients are byte-identical.
    """

    providers: Tuple[Provider, ...]

    def __post_init__(self):
        if not self.providers:
            raise ValueError("portfolio needs at least one provider")

    @classmethod
    def from_cost_model(cls, model: CostModel = LAMBDA_COST,
                        name: str = "lambda") -> "ProviderPortfolio":
        """Single-provider portfolio reproducing a scalar :class:`CostModel`."""
        return cls((Provider(name, quantum_ms=model.quantum_ms,
                             usd_per_gb_ms=model.usd_per_gb_ms,
                             min_quantums=model.min_quantums),))

    @property
    def num_providers(self) -> int:
        return len(self.providers)

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(p.name for p in self.providers)

    @property
    def latency_mults(self) -> np.ndarray:
        """[P] the providers' *static* latency multipliers (segment-blind;
        the segmented pipeline reads :meth:`latency_mults_seg` instead)."""
        return np.array([p.latency_mult for p in self.providers],
                        dtype=np.float64)

    @property
    def concurrency_caps(self) -> np.ndarray:
        """[P] per-stage concurrency cap of each provider (``+inf`` for an
        unbounded fleet). Float so capped/uncapped batch into one array;
        the engines compare ``np.isfinite`` to pick the queued path."""
        return np.array([np.inf if p.max_concurrency is None
                         else float(p.max_concurrency)
                         for p in self.providers], dtype=np.float64)

    def np_occupancy_rates_seg(self, mem_mb: np.ndarray,
                               num_segments: Optional[int] = None
                               ) -> np.ndarray:
        """[P, S, M] $/second of *held* capacity per (provider, segment,
        stage): ``usd_per_gb_ms * 1e3 * mem_mb / 1024``.

        This is the linear (un-quantized) rate that prices queueing delay
        and cold-start warm-up: a slot waiting for or warming a function
        is paid-for occupancy, not a rounded execution, so no quantum
        applies. Shared float64 numpy so the DES argmin term, the vector
        engine's data array and the billed totals are byte-identical.
        """
        mem = np.asarray(mem_mb, dtype=np.float64)
        rates = np.stack([r for (_, r, _, _) in self._seg(num_segments)])
        return rates[:, :, None] * 1e3 * (mem[None, None, :] / 1024.0)

    # -- time-dependent pricing (segment-indexed data) ---------------------

    @property
    def is_static(self) -> bool:
        """True when every provider's pricing is time-independent *and*
        matches its scalar fields — the precomputed static fast paths
        (static-price pipeline) then reproduce the segmented pipeline
        exactly.
        A 1-segment trace whose values differ from the scalar fields is
        constant over time but must still price through the trace.
        """
        for p in self.providers:
            if p.trace is None:
                continue
            tr = p.trace
            if tr.num_segments != 1 \
                    or tr.usd_per_gb_ms[0] != p.usd_per_gb_ms \
                    or tr.egress_usd_per_gb[0] != p.egress_usd_per_gb \
                    or tr.latency_mult[0] != p.latency_mult:
                return False
        return True

    @property
    def num_segments(self) -> int:
        """S: the portfolio's segment bound (max over providers)."""
        return max(p.effective_trace().num_segments for p in self.providers)

    def _seg(self, num_segments: Optional[int] = None):
        """Per-provider traces padded to a common segment count.

        Padding repeats the last segment's prices with a ``+inf`` start
        edge, so a padded segment is never the active one — portfolios of
        different segment counts batch into one ``[P, S]`` shape family.
        """
        S = self.num_segments if num_segments is None else int(num_segments)
        if S < self.num_segments:
            raise ValueError(
                f"cannot pad {self.num_segments}-segment portfolio "
                f"down to {S} segments")
        traces = [p.effective_trace() for p in self.providers]
        out = []
        for tr in traces:
            pad = S - tr.num_segments
            out.append((
                np.concatenate([tr.edges(), np.full(pad, np.inf)]),
                np.array(tr.usd_per_gb_ms + (tr.usd_per_gb_ms[-1],) * pad),
                np.array(tr.egress_usd_per_gb
                         + (tr.egress_usd_per_gb[-1],) * pad),
                np.array(tr.latency_mult + (tr.latency_mult[-1],) * pad)))
        return out

    def segment_edges(self, num_segments: Optional[int] = None) -> np.ndarray:
        """[P, S] segment start instants (``edges[:, 0] = -inf``; padded
        segments start at ``+inf``). The active segment of provider ``p``
        at time ``t`` is ``(edges[p] <= t).sum() - 1`` — the comparison
        both engines evaluate on this array as data."""
        return np.stack([e for (e, _, _, _) in self._seg(num_segments)])

    def latency_mults_seg(self, num_segments: Optional[int] = None
                          ) -> np.ndarray:
        """[P, S] latency multiplier per (provider, segment)."""
        return np.stack([lm for (_, _, _, lm) in self._seg(num_segments)])

    def egress_seg(self, num_segments: Optional[int] = None) -> np.ndarray:
        """[P, S] egress $/GB per (provider, segment)."""
        return np.stack([eg for (_, _, eg, _) in self._seg(num_segments)])

    def segments_at(self, t: float) -> np.ndarray:
        """[P] each provider's active segment at time ``t``."""
        return np.array([p.effective_trace().segment_at(t)
                         for p in self.providers], dtype=np.int64)

    def feasible_mask(self, mem_mb: np.ndarray,
                      require: Optional[np.ndarray] = None) -> np.ndarray:
        """[P, M] bool: provider p can host stage k's memory config.

        Raises when a stage has no feasible provider, except stages where
        ``require`` is False — privacy-pinned stages never offload, so
        they don't need one.
        """
        mem = np.asarray(mem_mb, dtype=np.float64)
        rows = [np.ones_like(mem, dtype=bool) if p.max_mem_mb is None
                else mem <= p.max_mem_mb for p in self.providers]
        mask = np.stack(rows, axis=0)
        uncovered = ~mask.any(axis=0)
        if require is not None:
            uncovered = uncovered & np.asarray(require, dtype=bool)
        if uncovered.any():
            bad = np.flatnonzero(uncovered)
            raise ValueError(
                f"no feasible provider for stage(s) {bad.tolist()} "
                f"(mem_mb={mem[bad].tolist()})")
        return mask

    def np_stage_costs(self, P_public_s: np.ndarray, mem_mb: np.ndarray,
                       download_s: Optional[np.ndarray] = None,
                       sink_mask: Optional[np.ndarray] = None) -> np.ndarray:
        """[P, J, M] billed USD of each (job, stage) on each provider.

        Billing = execution (provider-multiplied runtime through the
        provider's quantum/rate/min-quantums) + egress at sink stages on
        the un-multiplied download volume.
        """
        P_pub = np.asarray(P_public_s, dtype=np.float64)
        mem = np.asarray(mem_mb, dtype=np.float64)[None, :]
        out = np.empty((self.num_providers,) + P_pub.shape, dtype=np.float64)
        for i, p in enumerate(self.providers):
            t_ms = p.latency_mult * P_pub * 1e3
            out[i] = p.cost_model().np_cost(t_ms, mem)
            if p.egress_usd_per_gb and download_s is not None \
                    and sink_mask is not None:
                gb = np.asarray(download_s, np.float64) * EGRESS_GB_PER_S
                out[i] += np.where(np.asarray(sink_mask, bool)[None, :],
                                   p.egress_usd_per_gb * gb, 0.0)
        return out

    def np_selection_costs(self, P_public_s, mem_mb, download_s=None,
                           sink_mask=None,
                           require: Optional[np.ndarray] = None) -> np.ndarray:
        """[P, J, M] argmin key: billed cost, +inf where mem-infeasible.

        Stages exempted via ``require=False`` (privacy-pinned — they never
        offload) keep their unmasked prices even when no provider could
        host them, so the priority keys they feed stay finite.
        """
        H = self.np_stage_costs(P_public_s, mem_mb, download_s, sink_mask)
        feas = self.feasible_mask(mem_mb, require)
        uncovered = ~feas.any(axis=0)          # only possible where exempt
        return np.where((feas | uncovered[None, :])[:, None, :], H, np.inf)

    def select(self, selection_costs: np.ndarray) -> np.ndarray:
        """[J, M] cheapest-feasible provider index (ties -> lowest index)."""
        from .greedy import select_provider
        return select_provider(selection_costs)

    def min_cost(self, selection_costs: np.ndarray) -> np.ndarray:
        """[J, M] the selected provider's cost — the H the priority keys
        and the scalar pipeline see."""
        return np.min(selection_costs, axis=0)

    def np_stage_costs_seg(self, P_public_s: np.ndarray, mem_mb: np.ndarray,
                           download_s: Optional[np.ndarray] = None,
                           sink_mask: Optional[np.ndarray] = None,
                           num_segments: Optional[int] = None) -> np.ndarray:
        """[P, S, J, M] billed USD per (provider, price segment, job, stage).

        The segment-indexed twin of :meth:`np_stage_costs`: each segment
        prices the provider-multiplied runtime through that segment's
        $/GB-ms rate and latency multiplier (the quantum and min-quantums
        are static contract terms) plus that segment's egress at sinks.
        For a static provider ``[:, 0]`` is byte-identical to
        :meth:`np_stage_costs` — the same numpy ops in the same order.
        """
        P_pub = np.asarray(P_public_s, dtype=np.float64)
        mem = np.asarray(mem_mb, dtype=np.float64)[None, :]
        segs = self._seg(num_segments)
        S = len(segs[0][0])
        out = np.empty((self.num_providers, S) + P_pub.shape,
                       dtype=np.float64)
        for i, p in enumerate(self.providers):
            _, rate, eg, lm = segs[i]
            for s in range(S):
                t_ms = lm[s] * P_pub * 1e3
                cm = CostModel(quantum_ms=p.quantum_ms,
                               usd_per_gb_ms=rate[s],
                               min_quantums=p.min_quantums)
                out[i, s] = cm.np_cost(t_ms, mem)
                if eg[s] and download_s is not None and sink_mask is not None:
                    gb = np.asarray(download_s, np.float64) * EGRESS_GB_PER_S
                    out[i, s] += np.where(
                        np.asarray(sink_mask, bool)[None, :],
                        eg[s] * gb, 0.0)
        return out

    def np_selection_costs_seg(self, P_public_s, mem_mb, download_s=None,
                               sink_mask=None,
                               require: Optional[np.ndarray] = None,
                               num_segments: Optional[int] = None
                               ) -> np.ndarray:
        """[P, S, J, M] argmin key per segment: billed cost, +inf where
        mem-infeasible (feasibility is a static contract term — the same
        mask for every segment; see :meth:`np_selection_costs`)."""
        H = self.np_stage_costs_seg(P_public_s, mem_mb, download_s,
                                    sink_mask, num_segments)
        feas = self.feasible_mask(mem_mb, require)
        uncovered = ~feas.any(axis=0)          # only possible where exempt
        return np.where((feas | uncovered[None, :])[:, None, None, :],
                        H, np.inf)


def demo_portfolio(n: int = 3) -> ProviderPortfolio:
    """Deterministic N-provider portfolio for benchmarks and tests.

    Profiles are chosen so the argmin genuinely moves with the workload:
    a coarse-quantum discounter wins long executions, a fine-quantum
    premium provider wins short ones, and the memory-capped edge provider
    only bids on small stages.
    """
    if n < 1:
        raise ValueError(f"demo_portfolio needs n >= 1 providers, got {n}")
    base = [
        Provider("lambda", quantum_ms=QUANTUM_MS,
                 usd_per_gb_ms=USD_PER_GB_MS, egress_usd_per_gb=0.09),
        Provider("faas-coarse", quantum_ms=1000.0,
                 usd_per_gb_ms=0.62 * USD_PER_GB_MS,
                 egress_usd_per_gb=0.12, latency_mult=0.85),
        Provider("faas-fine", quantum_ms=1.0,
                 usd_per_gb_ms=1.35 * USD_PER_GB_MS,
                 egress_usd_per_gb=0.05, latency_mult=1.2),
        Provider("edge", quantum_ms=50.0,
                 usd_per_gb_ms=2.1 * USD_PER_GB_MS,
                 egress_usd_per_gb=0.0, latency_mult=0.7,
                 max_mem_mb=2048.0),
    ]
    if n <= len(base):
        return ProviderPortfolio(tuple(base[:n]))
    extra = [
        Provider(f"prov{i}", quantum_ms=QUANTUM_MS * (1 + i % 3),
                 usd_per_gb_ms=(0.8 + 0.07 * i) * USD_PER_GB_MS,
                 egress_usd_per_gb=0.01 * (i % 5),
                 latency_mult=0.8 + 0.05 * (i % 7))
        for i in range(len(base), n)
    ]
    return ProviderPortfolio(tuple(base + extra))


def price_walk(rng: np.random.Generator, num_segments: int,
               volatility: float) -> np.ndarray:
    """[S] multiplicative spot-price walk, anchored at 1 for segment 0
    (lognormal steps of ``volatility``) — the shared market model behind
    :func:`spot_portfolio` and the serving layer's trace families."""
    return np.exp(np.concatenate(
        [[0.0], np.cumsum(rng.normal(0.0, volatility, num_segments - 1))]))


def spot_portfolio(n: int = 3, num_segments: int = 6,
                   horizon_s: float = 60.0, seed: int = 0,
                   volatility: float = 0.35) -> ProviderPortfolio:
    """``demo_portfolio(n)`` under spot-market price traces.

    Each provider's $/GB-ms rate and egress price follow an independent
    multiplicative random walk (lognormal steps of ``volatility``) across
    ``num_segments`` equal windows of ``horizon_s``; latency multipliers
    wobble up to ±20% around the static value (a congested market is
    also a slower one). Segment 0 equals the static provider exactly —
    walk and wobble are both anchored at 1 there — so the trace is a
    pure perturbation of the static portfolio (``spot_portfolio(n, 1)``
    *is* ``demo_portfolio(n)``) and the cheapest provider genuinely
    changes hands over the horizon. Deterministic in ``seed``.
    """
    base = demo_portfolio(n)
    if num_segments < 1:
        raise ValueError(f"need >= 1 segments, got {num_segments}")
    rng = np.random.default_rng(seed)
    S = int(num_segments)
    bps = tuple(horizon_s * (s + 1) / S for s in range(S - 1))
    providers = []
    for p in base.providers:
        walk = price_walk(rng, S, volatility)
        phase = rng.uniform(0, 2 * np.pi)
        x = 2 * np.pi * np.arange(S) / max(S, 1) + phase
        wobble = 1.0 + 0.1 * (np.sin(x) - np.sin(phase))
        providers.append(p.with_trace(PriceTrace(
            usd_per_gb_ms=tuple(p.usd_per_gb_ms * walk),
            egress_usd_per_gb=tuple(p.egress_usd_per_gb * walk),
            latency_mult=tuple(p.latency_mult * wobble),
            breakpoints=bps)))
    return ProviderPortfolio(tuple(providers))


def diurnal_portfolio(n: int = 3, period_s: float = 40.0,
                      cycles: int = 2, peak_mult: float = 1.6,
                      off_mult: float = 0.7) -> ProviderPortfolio:
    """``demo_portfolio(n)`` under phase-shifted day/night tariffs.

    Every provider alternates between a peak tariff (``peak_mult`` x its
    static rate/egress) and an off-peak one (``off_mult`` x) with period
    ``period_s``, each provider phase-shifted by ``period_s / n`` — so at
    any instant some provider is off-peak and the placement argmin rotates
    through the portfolio as the clock advances. ``cycles`` full periods
    are materialized; the trace then holds its last tariff.
    """
    base = demo_portfolio(n)
    half = period_s / 2.0
    providers = []
    for i, p in enumerate(base.providers):
        phase = period_s * i / max(n, 1)
        # tariff parity follows the *absolute* half-period grid anchored
        # at the provider's phase: the half-period starting at
        # phase + s*half is peak for even s, off-peak for odd s, and the
        # segment before the first kept boundary continues the cycle
        # backwards (index s-1) — so phase-shifted providers genuinely
        # disagree at every instant instead of collapsing onto provider
        # 0's schedule once non-positive boundaries are dropped. The
        # grid starts two half-periods before the phase (phase < one
        # period), so every t >= 0 lands inside a materialized
        # half-period rather than an unbounded pre-phase segment.
        bounds = [(s, phase + half * s) for s in range(-2, 2 * cycles)]
        kept = [(s, b) for s, b in bounds if b > 0.0]
        bps = tuple(b for _, b in kept)
        idxs = ([kept[0][0] - 1] + [s for s, _ in kept]) if kept else [0]
        mults = [peak_mult if (s % 2 == 0) else off_mult for s in idxs]
        providers.append(p.with_trace(PriceTrace(
            usd_per_gb_ms=tuple(p.usd_per_gb_ms * m for m in mults),
            egress_usd_per_gb=tuple(p.egress_usd_per_gb * m for m in mults),
            latency_mult=(p.latency_mult,) * len(mults),
            breakpoints=bps)))
    return ProviderPortfolio(tuple(providers))


def scaled_portfolio(pf: ProviderPortfolio, factor: float
                     ) -> ProviderPortfolio:
    """Every segment price of every provider scaled by ``factor``.

    Latency multipliers, quanta and feasibility are untouched, so with a
    price-blind priority order the schedule is identical and the billed
    total scales by exactly ``factor`` — the \"uniformly cheaper trace\"
    of the property suite.
    """
    providers = []
    for p in pf.providers:
        tr = p.effective_trace()
        scaled = PriceTrace(
            usd_per_gb_ms=tuple(r * factor for r in tr.usd_per_gb_ms),
            egress_usd_per_gb=tuple(e * factor
                                    for e in tr.egress_usd_per_gb),
            latency_mult=tr.latency_mult, breakpoints=tr.breakpoints)
        providers.append(p.with_trace(scaled))
    return ProviderPortfolio(tuple(providers))


def as_portfolio(portfolio: Optional[ProviderPortfolio],
                 cost_model: CostModel) -> ProviderPortfolio:
    """Normalize the (portfolio, cost_model) call-site convention: an
    explicit portfolio wins, else the scalar model wraps as one provider."""
    if portfolio is not None:
        return portfolio
    return ProviderPortfolio.from_cost_model(cost_model)
