"""Load-dependent latency: cold starts, keep-alive, and pool traces.

Skedulix's latency models are load-independent, but real hybrid-platform
latency comes from congestion state: provider concurrency limits, queue
depth, and cold starts after idle gaps (Kaffes et al. 2021, Peri et al.
2024). This module holds the *configuration* side of that state — the
simulation state itself (slot clocks, idle timestamps) lives inside each
engine's hot loop so the two engines stay exactly equivalent.

Three knobs, threaded as ``concurrency=`` / ``coldstart=`` /
``pool_trace=`` through ``simulate``, ``simulate_scenarios``,
``sweep_scenarios``, ``schedule_sweep`` and ``serve_online``:

``concurrency``
    Per-provider concurrency caps, binding **per (provider, stage)** —
    one serverless *function*'s reserved concurrency, as on real FaaS
    platforms. A capped provider exposes ``cap`` FIFO slots per stage;
    dispatch beyond the cap queues. The queueing delay is billed as
    linear occupancy (:meth:`.cost.ProviderPortfolio.np_occupancy_rates_seg`)
    and enters the placement argmin, so a congested provider prices
    itself out of the selection. Caps bind per stage, not globally per
    provider, because the vector engine decomposes the horizon in stage
    topological order: a *global* provider cap would couple stages
    bidirectionally in time, which no feed-forward pass can express —
    and per-function limits are what providers actually sell.

``coldstart``
    A :class:`ColdStartModel`: the first dispatch to a replica (private
    pool) or slot (capped public provider) that has been idle longer
    than ``keep_alive_s`` pays ``warm_up_s`` before execution begins.
    The cold condition is ``start - idle_from > keep_alive_s`` (strict:
    an idle gap of exactly the window stays warm); ``idle_from`` of a
    never-used replica is its initial clock, or ``-inf`` under
    ``scale_to_zero`` (everything starts cold). Uncapped public
    providers model an unbounded warm fleet and never go cold — which
    is also what keeps the degenerate (uncapped) config bit-exact
    against the pre-congestion path. Public warm-up is billed as
    occupancy at the locked segment's rate and predicted in the argmin
    (both engines resolve the slot a dispatch *would* take and test the
    cold condition on it).

``pool_trace``
    A :class:`PoolTrace`: piecewise-constant private pool sizes — scale
    the pod mid-horizon. Slot ``i`` of stage ``k`` is active while the
    stage's count exceeds ``i``; a slot's activity must be one
    contiguous window (re-activating a slot is rejected — model it as a
    larger pool with a later turn-on instead), so in the vector
    engine's replica-clock machinery turn-on is just the slot's initial
    clock and turn-off a free-mask condition, with no new event types.
    A running job drains gracefully past its slot's turn-off; the slot
    only stops accepting new work.

Design rule (mirrors faults/pricing): all three are **scenario data**,
not code paths — degenerate configs (uncapped, zero-penalty, constant
pool) must compile to the pre-change graph bit-for-bit, which the
engines guarantee by gating the new graph structure on Python-level
build flags derived from the config.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np

from .cost import ProviderPortfolio


@dataclasses.dataclass(frozen=True)
class ColdStartModel:
    """Keep-alive / cold-start configuration.

    ``warm_up_s``: the warm-up penalty (seconds) a cold dispatch pays
    before execution begins — additive, *not* scaled by straggler
    slowdowns (initialization is runtime work, not stage compute).
    ``keep_alive_s``: the idle window after which a replica/slot goes
    cold (``inf`` = always warm once provisioned). ``scale_to_zero``:
    never-used replicas start cold (idle since ``-inf``) instead of
    warm-from-provisioning. ``provider_warm_up_s``: optional per-public-
    provider warm-up overrides (defaults to ``warm_up_s`` everywhere);
    only *capped* providers ever pay it — an uncapped provider is an
    unbounded warm fleet.
    """

    warm_up_s: float = 0.0
    keep_alive_s: float = np.inf
    scale_to_zero: bool = False
    provider_warm_up_s: Optional[Tuple[float, ...]] = None

    def __post_init__(self):
        wu = float(self.warm_up_s)
        ka = float(self.keep_alive_s)
        if not np.isfinite(wu) or wu < 0.0:
            raise ValueError(f"warm_up_s must be finite and >= 0, got {wu}")
        if np.isnan(ka) or ka < 0.0:
            raise ValueError(f"keep_alive_s must be >= 0, got {ka}")
        pw = self.provider_warm_up_s
        if pw is not None:
            pw = tuple(float(x) for x in np.atleast_1d(pw))
            if any(not np.isfinite(x) or x < 0.0 for x in pw):
                raise ValueError(
                    f"provider_warm_up_s must be finite and >= 0, got {pw}")
        object.__setattr__(self, "warm_up_s", wu)
        object.__setattr__(self, "keep_alive_s", ka)
        object.__setattr__(self, "scale_to_zero", bool(self.scale_to_zero))
        object.__setattr__(self, "provider_warm_up_s", pw)

    @property
    def is_null(self) -> bool:
        """True when the model can never alter a schedule: no penalty
        anywhere and no scale-to-zero. (Cold *flags* may still be set —
        a zero-penalty cold is observable but free — so ``is_null``
        gates billing/timing graph changes only, never attribution.)"""
        pw = self.provider_warm_up_s
        return (self.warm_up_s == 0.0 and not self.scale_to_zero
                and (pw is None or all(x == 0.0 for x in pw)))

    def provider_warm_ups(self, num_providers: int) -> np.ndarray:
        """[P] warm-up penalty per public provider."""
        if self.provider_warm_up_s is None:
            return np.full(num_providers, self.warm_up_s, dtype=np.float64)
        pw = np.asarray(self.provider_warm_up_s, dtype=np.float64)
        if pw.shape != (num_providers,):
            raise ValueError(
                f"provider_warm_up_s: expected {num_providers} entries, "
                f"got {len(pw)}")
        return pw


ColdStartLike = Union[None, ColdStartModel, float, Dict]


def as_coldstart(coldstart: ColdStartLike) -> Optional[ColdStartModel]:
    """Normalize the ``coldstart=`` argument.

    ``None`` stays None (cold starts off); a float is shorthand for
    "pay this warm-up after any idle gap" (zero keep-alive); a dict is
    ``ColdStartModel(**dict)``.
    """
    if coldstart is None or isinstance(coldstart, ColdStartModel):
        return coldstart
    if isinstance(coldstart, dict):
        return ColdStartModel(**coldstart)
    return ColdStartModel(warm_up_s=float(coldstart), keep_alive_s=0.0)


ConcurrencyLike = Union[None, int, Sequence, Dict]


def norm_concurrency(concurrency: ConcurrencyLike,
                     portfolio: ProviderPortfolio) -> np.ndarray:
    """[P] float per-stage cap per provider (``+inf`` = unbounded).

    ``None`` reads the providers' own ``max_concurrency`` fields; an int
    caps every provider; a length-P sequence gives one cap per provider
    (``None`` entries = unbounded); a dict overrides by provider name or
    index on top of the portfolio's own caps.
    """
    P = portfolio.num_providers
    if concurrency is None:
        caps = portfolio.concurrency_caps
    elif isinstance(concurrency, dict):
        caps = portfolio.concurrency_caps.copy()
        names = {n: i for i, n in enumerate(portfolio.names)}
        for key, val in concurrency.items():
            idx = names[key] if isinstance(key, str) else int(key)
            if not 0 <= idx < P:
                raise ValueError(f"concurrency: unknown provider {key!r}")
            caps[idx] = np.inf if val is None else float(val)
    elif np.isscalar(concurrency):
        caps = np.full(P, float(concurrency), dtype=np.float64)
    else:
        seq = list(concurrency)
        if len(seq) != P:
            raise ValueError(
                f"concurrency: expected {P} per-provider caps, "
                f"got {len(seq)}")
        caps = np.array([np.inf if c is None else float(c) for c in seq],
                        dtype=np.float64)
    finite = caps[np.isfinite(caps)]
    if ((finite < 1.0) | (finite != np.floor(finite))).any():
        raise ValueError(
            f"concurrency caps must be positive integers (or None/inf = "
            f"unbounded), got {caps.tolist()}")
    if (np.isnan(caps) | (caps < 1.0)).any():
        raise ValueError(
            f"concurrency caps must be positive integers (or None/inf = "
            f"unbounded), got {caps.tolist()}")
    return caps


@dataclasses.dataclass(frozen=True)
class PoolTrace:
    """Piecewise-constant private pool sizes: scale the pod mid-horizon.

    ``counts`` holds one entry per segment — an int (every stage gets
    that many replicas) or a length-M per-stage vector; segment ``s`` is
    active on ``[breakpoints[s-1], breakpoints[s])``, the first segment
    from the start of time, the last forever. Slot ``i`` of stage ``k``
    is active while ``count_k > i``; each slot's activity must be one
    contiguous window (no re-activation) and every stage must end with
    at least one replica, else queued work could never drain.
    """

    counts: Tuple
    breakpoints: Tuple[float, ...] = ()

    def __post_init__(self):
        cnts = tuple(
            tuple(int(x) for x in np.atleast_1d(c)) for c in self.counts)
        if not cnts:
            raise ValueError("pool trace needs at least one segment")
        bp = tuple(float(b) for b in np.atleast_1d(self.breakpoints)) \
            if np.size(self.breakpoints) else ()
        if len(bp) != len(cnts) - 1:
            raise ValueError(
                f"breakpoints: expected {len(cnts) - 1} entries for a "
                f"{len(cnts)}-segment pool trace, got {len(bp)}")
        if any(not np.isfinite(b) for b in bp):
            raise ValueError("pool breakpoints must be finite")
        if any(b2 <= b1 for b1, b2 in zip(bp, bp[1:])):
            raise ValueError("pool breakpoints must be strictly increasing")
        if any(x < 0 for c in cnts for x in c):
            raise ValueError("pool counts must be >= 0")
        object.__setattr__(self, "counts", cnts)
        object.__setattr__(self, "breakpoints", bp)

    @property
    def num_segments(self) -> int:
        return len(self.counts)

    def materialize(self, num_stages: int) -> np.ndarray:
        """[S_p, M] int replica count per (segment, stage)."""
        rows = []
        for c in self.counts:
            if len(c) == 1:
                rows.append(np.full(num_stages, c[0], dtype=np.int64))
            elif len(c) == num_stages:
                rows.append(np.asarray(c, dtype=np.int64))
            else:
                raise ValueError(
                    f"pool trace counts: expected a scalar or {num_stages} "
                    f"per-stage entries, got {len(c)}")
        out = np.stack(rows)
        if (out[-1] < 1).any():
            bad = np.flatnonzero(out[-1] < 1)
            raise ValueError(
                f"pool trace must end with >= 1 replica per stage "
                f"(stage(s) {bad.tolist()} scale to zero forever)")
        return out

    def slot_windows(self, num_stages: int
                     ) -> Tuple[np.ndarray, np.ndarray, int]:
        """Per-slot availability windows ``(on, off, I_max)``.

        ``on``/``off`` are [M, I_max] float64: slot ``i`` of stage ``k``
        accepts dispatches on ``[on, off)`` (``on = -inf`` when active
        from the start, ``off = +inf`` when never retired). Raises when
        a slot's activity is not one contiguous window — model a pool
        that shrinks and later re-grows as a larger pool whose extra
        slots turn on late, so each physical slot keeps one window.
        """
        counts = self.materialize(num_stages)
        S_p = counts.shape[0]
        I_max = int(counts.max())
        edges = np.concatenate([[-np.inf],
                                np.asarray(self.breakpoints, np.float64)])
        on = np.full((num_stages, I_max), np.inf, dtype=np.float64)
        off = np.full((num_stages, I_max), np.inf, dtype=np.float64)
        for k in range(num_stages):
            for i in range(I_max):
                active = counts[:, k] > i          # [S_p] bool
                if not active.any():
                    continue
                s_on = int(np.argmax(active))
                rest = active[s_on:]
                s_off = s_on + int(np.argmin(rest)) if not rest.all() else S_p
                if active[s_off:].any():
                    raise ValueError(
                        f"pool trace re-activates slot {i} of stage {k}; "
                        f"slots must have one contiguous active window — "
                        f"use a larger pool with a late turn-on instead")
                on[k, i] = edges[s_on]
                off[k, i] = edges[s_off] if s_off < S_p else np.inf
        return on, off, I_max


PoolTraceLike = Union[None, "PoolTrace", Dict]


def as_pool_trace(pool_trace: PoolTraceLike) -> Optional[PoolTrace]:
    """Normalize the ``pool_trace=`` argument (None / PoolTrace / kwargs)."""
    if pool_trace is None or isinstance(pool_trace, PoolTrace):
        return pool_trace
    if isinstance(pool_trace, dict):
        return PoolTrace(**pool_trace)
    raise ValueError(
        f"pool_trace: expected a PoolTrace or a kwargs dict, got "
        f"{type(pool_trace).__name__}")


def validate_load_kwargs(capped: bool, coldstart, pool_trace, *,
                         faulty: bool = False, chunk_jobs=None,
                         replicas_axis: bool = False) -> None:
    """Reject feature combinations neither engine supports.

    One shared checker so both engines fail with the identical message:
    the fault-recovery layer and the streaming job pager do not carry
    slot-clock / idle state (caps, cold starts and pool windows are
    whole-horizon couplings), and a ``replicas=`` scenario axis and a
    ``pool_trace=`` both claim ownership of the private pool sizes.
    """
    active = capped or (coldstart is not None) or (pool_trace is not None)
    if not active:
        return
    what = "concurrency caps / coldstart / pool_trace"
    if faulty:
        raise ValueError(f"faults cannot be combined with {what}")
    if chunk_jobs is not None:
        raise ValueError(f"chunk_jobs cannot be combined with {what}")
    if replicas_axis and pool_trace is not None:
        raise ValueError(
            "a replicas axis cannot be combined with pool_trace "
            "(both size the private pool)")


def queue_wait_ewma(samples: Sequence[np.ndarray],
                    alpha: float = 0.5) -> Optional[np.ndarray]:
    """EWMA of observed per-stage queue waits — serving-side telemetry.

    ``samples``: chronological per-replan observations, each a length-M
    vector of mean queue wait (seconds) per stage; the most recent
    sample carries weight ``alpha``. Returns the [M] smoothed estimate
    (``None`` when there are no samples), which ``serve_online`` folds
    into the replan priority keys — the same telemetry shape as the
    straggler EWMA (:func:`..training.fault.straggler_slowdowns`), so
    online serving reacts to congestion it has actually observed rather
    than trusting load-independent latency predictions.
    """
    if not 0.0 < alpha <= 1.0:
        raise ValueError(f"alpha must be in (0, 1], got {alpha}")
    est = None
    for s in samples:
        s = np.asarray(s, dtype=np.float64)
        if (s < 0).any() or not np.isfinite(s).all():
            raise ValueError("queue-wait samples must be finite and >= 0")
        est = s.copy() if est is None else (1.0 - alpha) * est + alpha * s
    return est
