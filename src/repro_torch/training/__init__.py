# Training substrate (port of repro.training): AdamW (+int8-quantized
# moments), checkpoints in the reference's layout, fault tolerance
# (preemption guard, restart with backoff on the core's RetryPolicy, EWMA
# straggler detection feeding serve_online's replica slowdowns), the train
# loop.
from .checkpoint import AsyncCheckpointer, latest_step, restore, save
from .fault import (PreemptionGuard, StepTimer, run_with_restarts,
                    straggler_slowdowns)
from .optimizer import (AdamWConfig, AdamWState, adamw_init, adamw_update,
                        dequantize_q8, quantize_q8)
from .train_loop import Trainer, make_train_step, train_params

__all__ = ["AdamWConfig", "AdamWState", "adamw_init", "adamw_update",
           "quantize_q8", "dequantize_q8", "save", "restore", "latest_step",
           "AsyncCheckpointer", "PreemptionGuard", "StepTimer",
           "run_with_restarts", "straggler_slowdowns", "Trainer",
           "make_train_step", "train_params"]
