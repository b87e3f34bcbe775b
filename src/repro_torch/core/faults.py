"""Fault injection and recovery: failures as deterministic scenario data.

The platforms the paper targets do not run failure-free — Lambda throttles
and times out, pods get evicted, spot capacity gets reclaimed mid-stage.
This module makes those events *scenario data*, not runtime randomness, so
the discrete-event reference and the batched vector engine stay exactly
equivalent under chaos:

* :class:`FaultModel` — a seeded per-(job, stage, attempt) grid of
  invocation-failure draws, per-provider **outage windows** over simulated
  time, and an optional mid-stage kill fraction (lost work is billed
  pro-rata on the consumed duration). The grid is materialized once with
  ``numpy.random.default_rng(seed)``; both engines then evaluate the same
  arrays, so a failure is a *fact of the scenario*, never a coin flipped
  at event time.
* :class:`RetryPolicy` — attempt budget, exponential backoff with
  jitter-from-seed (the jitter grid lives in the FaultModel, so backoff
  delays are scenario data too), and the recovery rules: a failed attempt
  re-enters the placement argmin with the failed provider masked; when no
  feasible provider remains (all failed or in outage) the stage falls
  back to a **private recovery slot** (nominal-speed local execution that
  bypasses the stage queue — degraded mode, not scheduling); when
  recovery is impossible before the job's deadline the job is marked
  **abandoned** (its downstream stages never run, completion is NaN, and
  SLA accounting reports it separately).

Semantics shared by both engines (documented once, implemented twice):

* Failure draws apply to *public* invocation attempts only; private
  replicas and the recovery slot are reliable.
* Attempt ``a`` of a public (job, stage) re-runs the cheapest-feasible
  placement argmin at its own dispatch epoch (decision-epoch pricing:
  retries can land in a different price segment), over providers that are
  mem-feasible, not yet failed for this stage, and not inside an outage
  window at that epoch.
* A grid failure is detected after ``kill_frac`` of the attempt's public
  duration (1.0 = timeout semantics: the full duration is consumed and
  billed); with ``outage_kills`` an outage window *starting* strictly
  inside the attempt's execution interval kills it at the window start.
  Lost work bills the attempt's full stage cost scaled by the consumed
  fraction of its duration.
* Input upload is paid once, before the first attempt (inputs are staged
  in cloud storage); cross-provider cascade egress and sink downloads
  bill against the *successful* attempt's (provider, segment) only.
* A retry is scheduled iff attempts remain, the backoff target
  ``t_fail + delay`` is at or before the job's deadline, and some
  provider is feasible at that target — otherwise the fallback/abandon
  rule above applies at the failure instant.

The MILP bound (:mod:`.milp`) stays failure-free: under a non-null
FaultModel its optimum is a lower bound on the achievable cost/makespan,
with a gap that grows with the failure rate (see :mod:`.milp`).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Recovery knobs shared by both engines (and the training loop).

    ``max_attempts`` counts *all* public attempts of a (job, stage),
    including the first — 1 means no retries. Backoff before attempt
    ``a >= 1`` is ``backoff_s * backoff_mult**(a-1) * (1 + jitter_frac *
    u)`` with ``u`` the scenario's seeded jitter draw in [0, 1), so the
    whole backoff schedule is deterministic data. ``private_fallback``
    enables the degraded-mode recovery slot; without it, exhausting the
    feasible providers abandons the job.
    """

    max_attempts: int = 3
    backoff_s: float = 0.5
    backoff_mult: float = 2.0
    jitter_frac: float = 0.0
    private_fallback: bool = True

    def __post_init__(self):
        if int(self.max_attempts) < 1:
            raise ValueError(
                f"max_attempts must be >= 1, got {self.max_attempts}")
        if not (self.backoff_s >= 0.0 and np.isfinite(self.backoff_s)):
            raise ValueError(f"backoff_s must be finite >= 0, "
                             f"got {self.backoff_s}")
        if not (self.backoff_mult > 0.0 and np.isfinite(self.backoff_mult)):
            raise ValueError(f"backoff_mult must be finite > 0, "
                             f"got {self.backoff_mult}")
        if not 0.0 <= self.jitter_frac <= 1.0:
            raise ValueError(f"jitter_frac must be in [0, 1], "
                             f"got {self.jitter_frac}")

    def backoff_delay(self, attempt: int, u: float = 0.0) -> float:
        """Delay before attempt ``attempt`` (>= 1); attempt 0 has none.

        This is the one backoff schedule in the codebase — the training
        loop's restart wrapper (:func:`repro.training.fault
        .run_with_restarts`) sleeps on it too.
        """
        if attempt <= 0:
            return 0.0
        return float(self.backoff_s * self.backoff_mult ** (attempt - 1)
                     * (1.0 + self.jitter_frac * u))

    def delays(self, jitter: np.ndarray) -> np.ndarray:
        """[..., A] backoff delays from a jitter grid (delay[..., 0] = 0)."""
        jitter = np.asarray(jitter, dtype=np.float64)
        a = np.arange(jitter.shape[-1])
        base = np.where(a > 0,
                        self.backoff_s
                        * self.backoff_mult ** np.maximum(a - 1, 0), 0.0)
        return base * (1.0 + self.jitter_frac * jitter)


OutageWindows = Sequence[Tuple[int, float, float]]


@dataclasses.dataclass(frozen=True)
class FaultModel:
    """One deterministic fault scenario for a (J jobs, M stages) workload.

    ``fail[j, k, a]`` — attempt ``a`` of (job j, stage k) fails when run
    publicly (provider-independent draw). ``jitter[j, k, a]`` in [0, 1)
    feeds the retry backoff. ``outages`` are ``(provider, start, end)``
    half-open windows of simulated time during which that provider
    accepts no dispatches (and, with ``outage_kills``, reclaims attempts
    whose execution a window start interrupts). ``kill_frac`` is the
    fraction of an attempt's duration consumed before a grid failure is
    detected (1.0 = timeout semantics).
    """

    fail: np.ndarray                      # [J, M, A] bool
    jitter: np.ndarray                    # [J, M, A] float in [0, 1)
    outages: Tuple[Tuple[int, float, float], ...] = ()
    kill_frac: float = 1.0
    outage_kills: bool = True

    def __post_init__(self):
        fail = np.asarray(self.fail, dtype=bool)
        jitter = np.asarray(self.jitter, dtype=np.float64)
        if fail.ndim != 3:
            raise ValueError(f"fail grid must be [J, M, A], "
                             f"got shape {fail.shape}")
        if jitter.shape != fail.shape:
            raise ValueError(f"jitter grid shape {jitter.shape} does not "
                             f"match fail grid {fail.shape}")
        if jitter.size and not ((jitter >= 0.0) & (jitter < 1.0)).all():
            raise ValueError("jitter draws must lie in [0, 1)")
        if not 0.0 < self.kill_frac <= 1.0:
            raise ValueError(f"kill_frac must be in (0, 1], "
                             f"got {self.kill_frac}")
        wins = []
        for i, w in enumerate(self.outages):
            try:
                p, s, e = int(w[0]), float(w[1]), float(w[2])
            except (TypeError, ValueError, IndexError):
                raise ValueError(
                    f"outages[{i}]: expected (provider, start, end), "
                    f"got {w!r}") from None
            if p < 0:
                raise ValueError(f"outages[{i}]: provider index {p} "
                                 f"is negative")
            if not (np.isfinite(s) and s < e):
                raise ValueError(f"outages[{i}]: window [{s}, {e}) "
                                 f"is empty or has a non-finite start")
            wins.append((p, s, e))
        object.__setattr__(self, "fail", fail)
        object.__setattr__(self, "jitter", jitter)
        object.__setattr__(self, "outages", tuple(wins))

    # -- shape / triviality ------------------------------------------------
    @property
    def num_jobs(self) -> int:
        return int(self.fail.shape[0])

    @property
    def num_stages(self) -> int:
        return int(self.fail.shape[1])

    @property
    def num_attempt_slots(self) -> int:
        return int(self.fail.shape[2])

    @property
    def is_null(self) -> bool:
        """True when the model can never perturb a schedule."""
        return not self.fail.any() and not self.outages

    # -- constructors ------------------------------------------------------
    @staticmethod
    def none(num_jobs: int, num_stages: int,
             max_attempts: int = 1) -> "FaultModel":
        """The zero model: no failure draws, no outages."""
        shape = (num_jobs, num_stages, max_attempts)
        return FaultModel(fail=np.zeros(shape, dtype=bool),
                          jitter=np.zeros(shape))

    @staticmethod
    def from_rate(rate: float, num_jobs: int, num_stages: int,
                  max_attempts: int = 3, seed: int = 0,
                  outages: OutageWindows = (),
                  kill_frac: float = 1.0,
                  outage_kills: bool = True) -> "FaultModel":
        """Seeded iid failure draws at probability ``rate`` per attempt."""
        if not 0.0 <= rate <= 1.0:
            raise ValueError(f"fault rate must be in [0, 1], got {rate}")
        rng = np.random.default_rng(seed)
        shape = (int(num_jobs), int(num_stages), int(max_attempts))
        # one contiguous uniform block: the fail grid thresholds the first
        # half, the jitter grid is the second — adding attempts therefore
        # never reshuffles earlier draws of the same seed
        fail = rng.random(shape) < float(rate)
        jitter = rng.random(shape)
        return FaultModel(fail=fail, jitter=jitter,
                          outages=tuple(outages),
                          kill_frac=float(kill_frac),
                          outage_kills=bool(outage_kills))

    # -- engine plumbing ---------------------------------------------------
    def padded(self, max_attempts: int) -> "FaultModel":
        """Pad the attempt axis with always-succeed slots (a chain ends at
        its first success, so extra slots never change a schedule)."""
        A = self.num_attempt_slots
        if A == max_attempts:
            return self
        if A > max_attempts:
            raise ValueError(
                f"fault grid has {A} attempt slots but the retry policy "
                f"allows only {max_attempts} attempts")
        pad = max_attempts - A
        return dataclasses.replace(
            self,
            fail=np.concatenate(
                [self.fail,
                 np.zeros(self.fail.shape[:2] + (pad,), dtype=bool)],
                axis=2),
            jitter=np.concatenate(
                [self.jitter, np.zeros(self.jitter.shape[:2] + (pad,))],
                axis=2))

    def outage_windows(self, num_providers: int,
                       num_slots: Optional[int] = None) -> np.ndarray:
        """[P, W, 2] window array; absent slots are the empty ``[inf, inf)``.

        ``num_slots`` pads W up to a sweep-wide bound (padded windows
        never activate). Raises when a window names a provider outside
        the portfolio — acceptance must not depend on which engine runs
        the scenario.
        """
        per: List[List[Tuple[float, float]]] = [[] for _ in
                                                range(int(num_providers))]
        for i, (p, s, e) in enumerate(self.outages):
            if p >= num_providers:
                raise ValueError(
                    f"outages[{i}]: provider {p} out of range for a "
                    f"{num_providers}-provider portfolio")
            per[p].append((s, e))
        W = max([len(ws) for ws in per] + [0])
        if num_slots is not None:
            if num_slots < W:
                raise ValueError(f"num_slots={num_slots} below the "
                                 f"model's window count {W}")
            W = int(num_slots)
        out = np.full((int(num_providers), W, 2), np.inf)
        for p, ws in enumerate(per):
            for w, (s, e) in enumerate(sorted(ws)):
                out[p, w] = (s, e)
        return out

    def validate_workload(self, num_jobs: int, num_stages: int,
                          where: str = "") -> None:
        pre = f"{where}: " if where else ""
        if (self.num_jobs, self.num_stages) != (num_jobs, num_stages):
            raise ValueError(
                f"{pre}fault grid is for ({self.num_jobs} jobs, "
                f"{self.num_stages} stages); the workload has "
                f"({num_jobs} jobs, {num_stages} stages)")


FaultLike = Union[None, float, FaultModel]


def as_fault_model(faults: FaultLike, num_jobs: int, num_stages: int,
                   retry: RetryPolicy, seed: int = 0,
                   where: str = "") -> FaultModel:
    """One axis entry -> a validated FaultModel padded to the retry budget.

    ``None`` is the zero model; a float is an iid failure rate drawn at
    ``seed`` (axis normalization passes the entry index, so distinct
    float entries get distinct, reproducible grids).
    """
    pre = f"{where}: " if where else ""
    if faults is None:
        return FaultModel.none(num_jobs, num_stages, retry.max_attempts)
    if isinstance(faults, FaultModel):
        faults.validate_workload(num_jobs, num_stages, where)
        return faults.padded(retry.max_attempts)
    try:
        rate = float(faults)
    except (TypeError, ValueError):
        raise ValueError(
            f"{pre}expected a FaultModel, a failure rate in [0, 1], or "
            f"None — got {type(faults).__name__}") from None
    return FaultModel.from_rate(rate, num_jobs, num_stages,
                                retry.max_attempts, seed=seed)


def normalize_fault_axis(faults, num_jobs: int, num_stages: int,
                         retry: RetryPolicy,
                         where: str = "") -> Optional[List[FaultModel]]:
    """``faults=`` axis -> list of FaultModel (None = no fault layer).

    A bare FaultModel or float is the one-point axis; a sequence mixes
    ``None`` (zero model), floats (seeded iid rates — entry ``i`` draws
    at seed ``i``) and FaultModel entries. Every entry pads to the retry
    policy's attempt budget, so one attempt axis serves the whole sweep.
    """
    if faults is None:
        return None
    if isinstance(faults, (FaultModel, float, int)):
        faults = [faults]
    cfgs = list(faults)
    if not cfgs:
        raise ValueError(f"{where}: faults axis is empty" if where
                         else "faults axis is empty")
    return [as_fault_model(f, num_jobs, num_stages, retry, seed=i,
                           where=f"{where}: faults[{i}]" if where
                           else f"faults[{i}]")
            for i, f in enumerate(cfgs)]


def max_outage_slots(models: Sequence[FaultModel]) -> int:
    """W: the per-provider outage-window bound of a normalized axis."""
    best = 0
    for m in models:
        cnt: dict = {}
        for (p, _, _) in m.outages:
            cnt[p] = cnt.get(p, 0) + 1
        best = max(best, max(cnt.values(), default=0))
    return best
