"""PyTorch and CUDA port of the Skedulix reproduction.

The JAX package ``repro`` is the reference; this package runs the same
algorithms on an NVIDIA GPU, one slice at a time, and is held against the
reference value for value. It imports ``torch`` and numpy, never JAX and
nothing of ``repro``. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``.

Ported so far: Algorithm 1's batch path with load-dependent latency
(concurrency caps, cold starts, pool traces) and the paper's profile ->
predict -> schedule loop: ``core`` (DAGs, costs, arrivals, priorities, the
greedy math, the DES, the batched engine, the ridge perf models and the
scheduler service), ``apps`` (the matrix, video and image applications as
PyTorch stage programs, and trace generation) and ``kernels`` (the CUDA
``acd_evict``, ``fifo_dispatch`` and ``matmul`` kernels with their plain
PyTorch versions).
"""
from . import apps, core, kernels
from .apps import SPECS, fit_models, generate_traces, split_traces
from .core import (APPS, AppDAG, AppPerfModel, SkedulixScheduler, Stage,
                   simulate, simulate_scenarios, sweep_scenarios)

__all__ = ["apps", "core", "kernels", "APPS", "AppDAG", "Stage",
           "SkedulixScheduler", "simulate", "simulate_scenarios",
           "sweep_scenarios", "SPECS", "generate_traces", "split_traces",
           "fit_models", "AppPerfModel"]
