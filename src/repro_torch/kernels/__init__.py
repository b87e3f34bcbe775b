"""Hand-written CUDA kernels of the port, with their plain PyTorch versions.

  acd_evict     — greedy ACD kept-prefix sweep over the priority queue
                  (port of ``repro.kernels.acd_sweep``;
                  ``csrc/acd_evict.cu``)
  fifo_dispatch — capped FIFO public-dispatch chain of one stage (port of
                  ``repro.kernels.dispatch``; ``csrc/fifo_dispatch.cu``)
  matmul        — tiled ``x @ y`` with float32 accumulation, the matrix
                  app's MM stage (port of ``repro.kernels.matmul``;
                  ``csrc/matmul.cu``)

``ops`` holds the checked wrappers (plain version for CPU tensors, the
kernel for CUDA tensors, launch counts), ``ref`` the plain versions,
``build`` the ``nvcc`` build into ``build/kernels/``.
"""
from . import ops, ref
from .ops import acd_evict, fifo_dispatch, matmul
from .ref import acd_evict_plain, fifo_dispatch_plain, matmul_plain

__all__ = ["ops", "ref", "acd_evict", "acd_evict_plain", "fifo_dispatch",
           "fifo_dispatch_plain", "matmul", "matmul_plain"]
