"""Hand-written CUDA kernels of the port, with their plain PyTorch versions.

  acd_evict     — greedy ACD kept-prefix sweep over the priority queue
                  (port of ``repro.kernels.acd_sweep``;
                  ``csrc/acd_evict.cu``)
  fifo_dispatch — capped FIFO public-dispatch chain of one stage (port of
                  ``repro.kernels.dispatch``; ``csrc/fifo_dispatch.cu``)
  matmul        — ``x @ y`` with float32 accumulation: the matrix app's
                  MM stage in IEEE float32 on the CUDA cores, and every
                  weight product of the served models in bf16 on the
                  tensor cores (``models.layers.linear``) (port of
                  ``repro.kernels.matmul``; ``csrc/matmul.cu``)
  flash_attention — prefill attention with an online softmax, causal and
                  sliding-window masks, GQA (port of
                  ``repro.kernels.flash_attention``;
                  ``csrc/flash_attention.cu``)
  flash_decode  — one new token per head against a KV cache (port of
                  ``repro.kernels.flash_decode``; ``csrc/flash_decode.cu``)
  rglru         — RG-LRU gated linear scan of recurrentgemma's recurrent
                  blocks (port of ``repro.kernels.rglru``;
                  ``csrc/rglru.cu``)
  rwkv6         — RWKV-6 WKV recurrence with data-dependent decay of
                  rwkv6's time-mix blocks (port of ``repro.kernels.rwkv6``;
                  ``csrc/rwkv6.cu``)

``ops`` holds the checked wrappers (plain version for CPU tensors, the
kernel for CUDA tensors, launch counts), ``ref`` the plain versions,
``build`` the ``nvcc`` build into ``build/kernels/``.
"""
from . import ops, ref
from .ops import (acd_evict, fifo_dispatch, flash_attention, flash_decode,
                  matmul, rglru, rwkv6)
from .ref import (acd_evict_plain, fifo_dispatch_plain,
                  flash_attention_plain, flash_decode_plain, matmul_plain,
                  rglru_plain, rwkv6_plain)

__all__ = ["ops", "ref", "acd_evict", "acd_evict_plain", "fifo_dispatch",
           "fifo_dispatch_plain", "flash_attention", "flash_attention_plain",
           "flash_decode", "flash_decode_plain", "matmul", "matmul_plain",
           "rglru", "rglru_plain", "rwkv6", "rwkv6_plain"]
