"""ctypes binding of the CUDA ``rglru`` kernel (``csrc/rglru.cu``).

Port of the Pallas kernel ``src/repro/kernels/rglru.py:rglru``: the RG-LRU
scan, one thread per (batch, feature) column with the carry in a
register. This module only launches; :func:`repro_torch.kernels.ops.rglru`
is the checked public wrapper that ``models/recurrent.py`` calls.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build

_P = ctypes.c_void_p
_ARGTYPES = [_P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             _P]
_FN = []


def _fn():
    if not _FN:
        fn = build.load("rglru").rglru_f32
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _FN.append(fn)
    return _FN[0]


def launch(x: torch.Tensor, a: torch.Tensor, h0: Optional[torch.Tensor],
           y: torch.Tensor, hT: torch.Tensor) -> None:
    """Launch the kernel on the current stream: ``y`` [B, T, D] and ``hT``
    [B, D] (dense float32) get the scan of ``x``, ``a`` [B, T, D] from
    ``h0`` [B, D] (zeros when ``None``). The caller has checked devices,
    dtypes, shapes and contiguity; raises if the launch reports a CUDA
    error."""
    B, T, D = x.shape
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _fn()(x.data_ptr(), a.data_ptr(),
                None if h0 is None else h0.data_ptr(), y.data_ptr(),
                hT.data_ptr(), B, T, D, stream)
    if err != 0:
        raise RuntimeError(f"rglru launch failed: cudaError_t {err}")
