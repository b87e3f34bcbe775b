"""ctypes binding of the CUDA ``acd_evict`` kernel (``csrc/acd_evict.cu``).

Port of the Pallas kernel ``src/repro/kernels/acd_sweep.py:acd_evict``:
the greedy ACD kept-prefix sweep, one block per queue row. This module
only launches; :func:`repro_torch.kernels.ops.acd_evict` is the checked
public wrapper that the engine calls.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
_FNS = {}


def _fn(dtype: torch.dtype):
    fn = _FNS.get(dtype)
    if fn is None:
        lib = build.load("acd_evict")
        fn = getattr(lib, {torch.float64: "acd_evict_f64",
                           torch.float32: "acd_evict_f32"}[dtype])
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _FNS[dtype] = fn
    return fn


def launch(P: torch.Tensor, thresh: torch.Tensor, mask: torch.Tensor,
           out: torch.Tensor) -> None:
    """Launch the kernel on the current stream: ``out`` [B, J] bool gets
    the evict mask. The caller has checked devices, dtypes, shapes and
    contiguity; raises if the launch reports a CUDA error."""
    B, J = P.shape
    stream = torch.cuda.current_stream(P.device).cuda_stream
    err = _fn(P.dtype)(P.data_ptr(), thresh.data_ptr(), mask.data_ptr(),
                       out.data_ptr(), B, J, stream)
    if err != 0:
        raise RuntimeError(f"acd_evict launch failed: cudaError_t {err}")
