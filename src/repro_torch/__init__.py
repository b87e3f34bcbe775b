"""PyTorch and CUDA port of the Skedulix reproduction.

The JAX package ``repro`` is the reference; this package runs the same
algorithms on an NVIDIA GPU, one slice at a time, and is held against the
reference value for value. It imports ``torch`` and numpy, never JAX and
nothing of ``repro``. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``.

Ported so far: Algorithm 1's batch path with load-dependent latency
(concurrency caps, cold starts, pool traces), the paper's profile ->
predict -> schedule loop, the model stack's serving path, and the
scheduler applied to LLM serving:

- ``core``: DAGs, costs, arrivals, priorities, the greedy math, the DES,
  the batched engine, the ridge perf models, the scheduler service and
  the MILP bound (host);
- ``apps``: the matrix, video and image applications as PyTorch stage
  programs, and trace generation;
- ``models``: the decoder LM's serving modes (``Model.prefill``,
  ``Model.decode_step``) with RG-LRU and RWKV-6 recurrent blocks and
  windowed attention;
- ``configs``: the architectures the port serves (``rwkv6-1.6b``,
  ``recurrentgemma-9b``) and the assigned shapes;
- ``serving``: the batched greedy ``InferenceEngine``, the hybrid
  LLM-serving scheduler (batches, online streams, frontiers) and the
  policy harness;
- ``training``: the fault-tolerance helpers the online controller uses;
- ``launch``: the serving and training entry points (``python -m
  repro_torch.launch.serve``, ``... .train``), the meshes, and the
  multi-pod dry run on meta tensors (``python -m
  repro_torch.launch.dryrun``) with its input specs, step counter and
  roofline on the H100's peaks;
- ``kernels``: the hand-written CUDA kernels ``acd_evict``,
  ``fifo_dispatch``, ``matmul``, ``flash_attention``, ``flash_decode``,
  ``rglru`` and ``rwkv6``, with their plain PyTorch versions.
"""
from . import (apps, configs, core, kernels, launch, models, serving,
               training)
from .apps import SPECS, fit_models, generate_traces, split_traces
from .core import (APPS, AppDAG, AppPerfModel, SkedulixScheduler, Stage,
                   simulate, simulate_scenarios, sweep_scenarios)
from .models import Model, ModelConfig
from .serving import InferenceEngine, Request

__all__ = ["apps", "configs", "core", "kernels", "launch", "models",
           "serving", "training",
           "APPS", "AppDAG", "Stage", "SkedulixScheduler", "simulate",
           "simulate_scenarios", "sweep_scenarios", "SPECS",
           "generate_traces", "split_traces", "fit_models", "AppPerfModel",
           "Model", "ModelConfig", "InferenceEngine", "Request"]
