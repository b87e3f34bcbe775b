"""Hand-written CUDA kernels of the port, with their plain PyTorch versions.

  acd_evict — greedy ACD kept-prefix sweep over the priority queue
              (port of ``repro.kernels.acd_sweep``; ``csrc/acd_evict.cu``)

``ops`` holds the checked wrappers (plain version for CPU tensors, the
kernel for CUDA tensors, launch counts), ``ref`` the plain versions,
``build`` the ``nvcc`` build into ``build/kernels/``.
"""
from . import ops, ref
from .ops import acd_evict
from .ref import acd_evict_plain

__all__ = ["ops", "ref", "acd_evict", "acd_evict_plain"]
