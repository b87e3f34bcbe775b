"""Fault-tolerance plumbing: preemption capture, restart-with-resume,
straggler detection.

Straggler *mitigation* at the job level is the paper's own ACD mechanism
(slow replica => queue delay grows => ACD < 0 => offload) — see
serving/hybrid.py. Here we provide the training-loop side: a SIGTERM/
SIGINT guard that requests a clean checkpoint at the next step boundary,
an exponential-backoff restart wrapper that resumes from the latest
checkpoint, and an EWMA step timer that flags straggling steps.

Host code (``signal``, ``time`` and the core's :class:`RetryPolicy`), as
in the JAX package; ``serve_online`` turns pod telemetry into straggler
slowdowns through :func:`straggler_slowdowns`.
"""
from __future__ import annotations

import signal
import time
from typing import Callable, Dict, Optional, Sequence, Tuple, TypeVar

from ..core.faults import RetryPolicy

T = TypeVar("T")


class PreemptionGuard:
    """Registers SIGTERM/SIGINT handlers; ``should_stop`` flips once."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self._stop = False
        self._prev = {}
        for s in signals:
            try:
                self._prev[s] = signal.signal(s, self._handler)
            except ValueError:   # not main thread (tests)
                pass

    def _handler(self, signum, frame):
        self._stop = True

    @property
    def should_stop(self) -> bool:
        return self._stop

    def restore(self):
        for s, h in self._prev.items():
            signal.signal(s, h)


class StepTimer:
    """EWMA step-time tracker; flags stragglers at ``threshold``x median."""

    def __init__(self, alpha: float = 0.1, threshold: float = 2.0):
        self.alpha = alpha
        self.threshold = threshold
        self.ewma: Optional[float] = None
        self.last: Optional[float] = None
        self.straggles = 0

    def observe(self, dt: float) -> bool:
        self.last = dt
        if self.ewma is None:
            self.ewma = dt
            return False
        is_straggler = dt > self.threshold * self.ewma
        if is_straggler:
            self.straggles += 1
        # straggler steps do not poison the baseline
        if not is_straggler:
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
        return is_straggler


def run_with_restarts(make_and_run: Callable[[int], T], max_restarts: int = 3,
                      backoff_s: float = 0.0,
                      retryable=(RuntimeError, OSError),
                      policy: Optional[RetryPolicy] = None) -> T:
    """Run ``make_and_run(attempt)``; on a retryable failure, back off and
    re-invoke — the callee is expected to resume from its latest
    checkpoint. Non-retryable exceptions propagate.

    The backoff schedule is the scheduler core's
    :meth:`.core.faults.RetryPolicy.backoff_delay` — the one exponential
    schedule in the codebase, shared with the simulators' retry
    re-placement; ``policy`` overrides the default built from
    ``max_restarts``/``backoff_s``.
    """
    policy = policy or RetryPolicy(max_attempts=max_restarts + 1,
                                   backoff_s=float(backoff_s))
    attempt = 0
    while True:
        try:
            return make_and_run(attempt)
        except retryable:
            attempt += 1
            if attempt >= policy.max_attempts:
                raise
            delay = policy.backoff_delay(attempt)
            if delay > 1e-12:
                time.sleep(delay)


def straggler_slowdowns(
    step_times: Dict[Tuple[int, int], Sequence[float]],
    alpha: float = 0.1, threshold: float = 2.0,
) -> Dict[Tuple[int, int], float]:
    """EWMA straggler flags -> per-replica slowdown factors.

    ``step_times`` maps ``(stage, replica)`` to that replica's observed
    step-time history; each stream runs through a :class:`StepTimer` and
    replicas whose *latest* step straggles (``> threshold x`` their own
    EWMA baseline) report a slowdown factor ``last / ewma``. The result
    is exactly the ``replica_slowdown=`` format the simulators take, so
    online controllers can feed live telemetry straight into replanning
    (see ``serve_online``'s ``replica_step_times=``).
    """
    out: Dict[Tuple[int, int], float] = {}
    for key, times in step_times.items():
        timer = StepTimer(alpha=alpha, threshold=threshold)
        flagged = False
        for dt in times:
            flagged = timer.observe(float(dt))
        if flagged and timer.ewma:
            out[(int(key[0]), int(key[1]))] = float(timer.last / timer.ewma)
    return out
