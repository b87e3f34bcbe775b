# Training-side fault tolerance (port of repro.training.fault): preemption
# guard, restart-with-backoff on the core's RetryPolicy, EWMA straggler
# detection feeding serve_online's replica slowdowns. The trainer, the
# checkpoints and the data pipeline are ROADMAP Queue 1 item 11.
from .fault import (PreemptionGuard, StepTimer, run_with_restarts,
                    straggler_slowdowns)

__all__ = ["PreemptionGuard", "StepTimer", "run_with_restarts",
           "straggler_slowdowns"]
