"""IEEE float32 on the card, whatever the process set.

The reference computes its float32 products and convolutions in IEEE
float32. On the card, cuBLAS products follow ``torch.backends.cuda.matmul``
and cuDNN convolutions ``torch.backends.cudnn``, and either may run in
TF32 (cuDNN does by default; a process may turn it on for cuBLAS). The
port's float32 products and convolutions (the ridge fits and predictions,
the image app's resize and DCT, the video detector) run inside
:func:`ieee_float32`, which turns TF32 off for the scope and gives the
process its own settings back after it. Float64 work is not affected by
TF32 and needs no scope.
"""
from __future__ import annotations

import contextlib
from typing import Iterator

import torch


@contextlib.contextmanager
def ieee_float32() -> Iterator[None]:
    """TF32 off for cuBLAS and cuDNN inside the scope (also a decorator).

    cuBLAS's setting is read and restored through the ``fp32_precision``
    API where this PyTorch has it: reading it back through the legacy
    ``allow_tf32`` flag raises once a process has set the new one."""
    matmul = torch.backends.cuda.matmul
    new_api = hasattr(matmul, "fp32_precision")
    prev = matmul.fp32_precision if new_api else matmul.allow_tf32
    cudnn = torch.backends.cudnn
    try:
        if new_api:
            matmul.fp32_precision = "ieee"
        else:
            matmul.allow_tf32 = False
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic,
                         allow_tf32=False):
            yield
    finally:
        if new_api:
            matmul.fp32_precision = prev
        else:
            matmul.allow_tf32 = prev
