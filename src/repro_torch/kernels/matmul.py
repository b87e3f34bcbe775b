"""ctypes binding of the CUDA ``matmul`` kernel (``csrc/matmul.cu``).

Port of the Pallas kernel ``src/repro/kernels/matmul.py:matmul``: a tiled
``x @ y`` with float32 accumulation, one block per 64 x 64 output tile,
reading both operands through their element strides. This module only
launches; :func:`repro_torch.kernels.ops.matmul` is the checked public
wrapper that the matrix application calls.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_ARGTYPES = [_P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             _I64, _I64, _I64, _I64, _P]
_FNS = {}


def _fn(dtype: torch.dtype):
    fn = _FNS.get(dtype)
    if fn is None:
        lib = build.load("matmul")
        fn = getattr(lib, {torch.float32: "matmul_f32",
                           torch.bfloat16: "matmul_bf16"}[dtype])
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _FNS[dtype] = fn
    return fn


def launch(x: torch.Tensor, y: torch.Tensor, out: torch.Tensor) -> None:
    """Launch the kernel on the current stream: ``out`` [M, N] (dense) gets
    ``x`` [M, K] @ ``y`` [K, N], read through their strides. The caller
    has checked devices, dtypes and shapes; raises if the launch reports a
    CUDA error."""
    M, K = x.shape
    N = y.shape[1]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _fn(x.dtype)(x.data_ptr(), y.data_ptr(), out.data_ptr(), M, N, K,
                       x.stride(0), x.stride(1), y.stride(0), y.stride(1),
                       stream)
    if err != 0:
        raise RuntimeError(f"matmul launch failed: cudaError_t {err}")
