"""Exogenous arrival processes: from batch-at-t0 to continuous serving.

The paper schedules a *batch* of jobs all released at ``t0`` (Sec. III).
This module generalizes the workload to an exogenous arrival stream: each
job ``j`` carries a release time ``release[j] >= t0`` and becomes eligible
for queueing/offloading only once it arrives. A batch is the degenerate
stream with every release at ``t0`` — both engines reproduce the batch
path bit-exactly in that case (``tests/test_arrivals.py``).

An :class:`ArrivalProcess` is a deterministic recipe for a release-time
vector: given a job count and ``t0`` it returns ``[J]`` absolute release
times. Stochastic processes carry an explicit seed, so the DES and the
vector engine — and any two calls — always see the identical stream.

Semantics under arrivals (shared by both engines):

* the initialization offload (Alg. 1 lines 2-10), when enabled, still runs
  over the whole batch at plan time — the trace is treated as *known* when
  the schedule is cut (clairvoyant admission), and jobs selected for
  offload go public the moment they arrive. The rolling-horizon serving
  mode in :mod:`repro.serving.hybrid` disables it (``init_phase=False``)
  and quantizes admission onto a re-plan grid, so every offload there is
  an event-driven ACD decision from information available at the time;
* deadlines become per-job: job ``j`` must finish by ``release[j] + C_max``
  (a relative SLA), which degenerates to the paper's single absolute
  deadline ``t0 + C_max`` for a batch. The ACD of Sec. III-B uses the
  per-job deadline;
* every arrival is a scheduling epoch: the arriving job is enqueued (or
  sent straight public if marked at initialization) and the stage's ACD
  kept-prefix sweep re-runs, exactly as it does after every completion.

Processes
---------
:class:`BatchArrivals`    — everything at ``t0`` (the paper's regime).
:class:`TraceArrivals`    — deterministic offsets from ``t0`` (replay).
:class:`PoissonArrivals`  — i.i.d. exponential inter-arrival gaps.
:class:`MMPPArrivals`     — 2-phase Markov-modulated Poisson bursts.

:func:`parse_arrivals` maps CLI-style specs (``"poisson:4.0"``,
``"mmpp:1,10:10,2"``, ``"trace:0,0.5,2"``) onto these classes;
:func:`resolve_release` normalizes any accepted ``arrivals=`` argument
(process, spec string, or explicit release array) to a validated ``[J]``
release vector.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import numpy as np


@dataclasses.dataclass(frozen=True)
class ArrivalProcess:
    """Base class: a deterministic recipe for job release times."""

    def release_times(self, num_jobs: int, t0: float = 0.0) -> np.ndarray:
        """Absolute release times ``[num_jobs]``, each ``>= t0``."""
        raise NotImplementedError

    def describe(self) -> str:
        return type(self).__name__


@dataclasses.dataclass(frozen=True)
class BatchArrivals(ArrivalProcess):
    """The paper's regime: every job released at ``t0``."""

    def release_times(self, num_jobs: int, t0: float = 0.0) -> np.ndarray:
        return np.full(num_jobs, float(t0), dtype=np.float64)

    def describe(self) -> str:
        return "batch"


@dataclasses.dataclass(frozen=True)
class TraceArrivals(ArrivalProcess):
    """Deterministic replay: ``offsets[j]`` seconds after ``t0``.

    Offsets need not be sorted — job ``j`` keeps its identity (and its
    latency row) regardless of where it lands in time.
    """

    offsets: Tuple[float, ...]

    def __post_init__(self):
        object.__setattr__(self, "offsets",
                           tuple(float(x) for x in self.offsets))
        if any(x < 0.0 for x in self.offsets):
            raise ValueError("trace offsets must be >= 0")

    def release_times(self, num_jobs: int, t0: float = 0.0) -> np.ndarray:
        if num_jobs != len(self.offsets):
            raise ValueError(
                f"trace has {len(self.offsets)} offsets for {num_jobs} jobs")
        return float(t0) + np.asarray(self.offsets, dtype=np.float64)

    def describe(self) -> str:
        return f"trace[{len(self.offsets)}]"


@dataclasses.dataclass(frozen=True)
class PoissonArrivals(ArrivalProcess):
    """Homogeneous Poisson stream: exponential gaps at ``rate`` jobs/s.

    The first job arrives one gap *after* ``t0`` (no atom at the origin).
    The explicit ``seed`` makes the stream a pure function of
    ``(rate, seed, num_jobs)``, so both engines draw the same times.
    """

    rate: float
    seed: int = 0

    def __post_init__(self):
        if not self.rate > 0.0:
            raise ValueError(f"rate must be > 0, got {self.rate}")

    def release_times(self, num_jobs: int, t0: float = 0.0) -> np.ndarray:
        rng = np.random.default_rng(self.seed)
        gaps = rng.exponential(1.0 / self.rate, num_jobs)
        return float(t0) + np.cumsum(gaps)

    def describe(self) -> str:
        return f"poisson(rate={self.rate:g})"


@dataclasses.dataclass(frozen=True)
class MMPPArrivals(ArrivalProcess):
    """2-phase Markov-modulated Poisson process (bursty traffic).

    The stream alternates between phases with arrival rates ``rates[i]``
    and exponentially distributed dwell times of mean ``dwell[i]`` seconds.
    Because both the phase process and the arrivals are memoryless, each
    step draws a candidate gap at the current rate and a time-to-switch;
    whichever comes first wins (competing exponentials).
    """

    rates: Tuple[float, float] = (1.0, 10.0)
    dwell: Tuple[float, float] = (10.0, 2.0)
    seed: int = 0

    def __post_init__(self):
        if len(self.rates) != 2 or len(self.dwell) != 2:
            raise ValueError("MMPP is 2-phase: rates and dwell take 2 values")
        if any(not r > 0.0 for r in self.rates):
            raise ValueError(f"rates must be > 0, got {self.rates}")
        if any(not d > 0.0 for d in self.dwell):
            raise ValueError(f"dwell means must be > 0, got {self.dwell}")

    def release_times(self, num_jobs: int, t0: float = 0.0) -> np.ndarray:
        rng = np.random.default_rng(self.seed)
        out = np.empty(num_jobs, dtype=np.float64)
        t, phase = float(t0), 0
        n = 0
        while n < num_jobs:
            gap = rng.exponential(1.0 / self.rates[phase])
            switch = rng.exponential(self.dwell[phase])
            if gap <= switch:
                t += gap
                out[n] = t
                n += 1
            else:
                t += switch
                phase = 1 - phase
        return out

    def describe(self) -> str:
        return (f"mmpp(rates={self.rates[0]:g},{self.rates[1]:g};"
                f"dwell={self.dwell[0]:g},{self.dwell[1]:g})")


ArrivalsLike = Union[ArrivalProcess, str, Sequence[float], np.ndarray, None]


def parse_arrivals(spec: str) -> ArrivalProcess:
    """Parse a CLI-style arrival spec into an :class:`ArrivalProcess`.

    Grammar (fields after the kind are ``:``-separated)::

        batch                      everything at t0
        trace:T1,T2,...            offsets (s) from t0, one per job
        poisson:RATE[:SEED]        Poisson at RATE jobs/s
        mmpp:R1,R2:D1,D2[:SEED]    2-phase MMPP (rates; mean dwells, s)
    """
    head, _, rest = spec.strip().partition(":")
    kind = head.lower()
    if kind == "batch":
        if rest:
            raise ValueError(f"batch takes no arguments: {spec!r}")
        return BatchArrivals()
    if kind == "trace":
        if not rest:
            raise ValueError(f"trace needs offsets: {spec!r}")
        return TraceArrivals(tuple(float(x) for x in rest.split(",")))
    if kind == "poisson":
        parts = rest.split(":") if rest else []
        if not 1 <= len(parts) <= 2:
            raise ValueError(f"poisson:RATE[:SEED] expected, got {spec!r}")
        seed = int(parts[1]) if len(parts) == 2 else 0
        return PoissonArrivals(rate=float(parts[0]), seed=seed)
    if kind == "mmpp":
        parts = rest.split(":") if rest else []
        if not 2 <= len(parts) <= 3:
            raise ValueError(f"mmpp:R1,R2:D1,D2[:SEED] expected, got {spec!r}")
        rates = tuple(float(x) for x in parts[0].split(","))
        dwell = tuple(float(x) for x in parts[1].split(","))
        seed = int(parts[2]) if len(parts) == 3 else 0
        return MMPPArrivals(rates=rates, dwell=dwell, seed=seed)
    raise ValueError(f"unknown arrival process {head!r} in {spec!r}")


def resolve_release(arrivals: ArrivalsLike, num_jobs: int,
                    t0: float = 0.0) -> Optional[np.ndarray]:
    """Normalize an ``arrivals=`` argument to a ``[J]`` release vector.

    Accepts ``None`` (batch semantics — returns ``None`` so callers keep
    the exact batch code path), an :class:`ArrivalProcess`, a spec string
    for :func:`parse_arrivals`, or an explicit array of absolute release
    times. Validates shape and ``release >= t0``.
    """
    if arrivals is None:
        return None
    if isinstance(arrivals, str):
        arrivals = parse_arrivals(arrivals)
    if isinstance(arrivals, ArrivalProcess):
        rel = np.asarray(arrivals.release_times(num_jobs, t0),
                         dtype=np.float64)
    else:
        rel = np.asarray(arrivals, dtype=np.float64)
    if rel.shape != (num_jobs,):
        raise ValueError(
            f"release times have shape {rel.shape}, expected ({num_jobs},)")
    if not np.all(np.isfinite(rel)):
        raise ValueError("release times must be finite")
    if np.any(rel < t0 - 1e-12):
        raise ValueError(
            f"release times must be >= t0={t0} "
            f"(min was {float(rel.min())})")
    return np.maximum(rel, t0)
