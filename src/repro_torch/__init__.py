"""PyTorch and CUDA port of the Skedulix reproduction.

The JAX package ``repro`` is the reference; this package runs the same
algorithms on an NVIDIA GPU, one slice at a time, and is held against the
reference value for value. It imports ``torch`` and numpy, never JAX and
nothing of ``repro``. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``.

Ported so far: Algorithm 1's batch path with load-dependent latency
(concurrency caps, cold starts, pool traces): ``core`` (DAGs, costs,
arrivals, priorities, the greedy math, the DES, the batched engine and the
scheduler service) and ``kernels`` (the CUDA ``acd_evict`` and
``fifo_dispatch`` kernels with their plain PyTorch versions).
"""
from . import core, kernels
from .core import (APPS, AppDAG, SkedulixScheduler, Stage, simulate,
                   simulate_scenarios, sweep_scenarios)

__all__ = ["core", "kernels", "APPS", "AppDAG", "Stage",
           "SkedulixScheduler", "simulate", "simulate_scenarios",
           "sweep_scenarios"]
