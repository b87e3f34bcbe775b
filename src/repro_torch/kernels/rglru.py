"""ctypes bindings of the CUDA ``rglru`` kernel (``csrc/rglru.cu``) and
of its backward (``csrc/rglru_bwd.cu``).

Port of the Pallas kernel ``src/repro/kernels/rglru.py:rglru``: the RG-LRU
scan, one thread per (batch, feature) column with the carry in a
register; the backward walks the same columns in reverse time. This module
only launches; :func:`repro_torch.kernels.ops.rglru` (and its autograd
Function, whose backward calls ``ops.rglru_bwd``) is the checked public
wrapper that ``models/recurrent.py`` calls.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P, _P, _P, _P, _P, _I, _I, _I, _P]
_BWD_ARGTYPES = [_P] * 9 + [_I, _I, _I, _P]
_FNS = {}


def _fn():
    fn = _FNS.get("rglru")
    if fn is None:
        fn = build.load("rglru").rglru_f32
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _FNS["rglru"] = fn
    return fn


def _bwd_fn():
    fn = _FNS.get("rglru_bwd")
    if fn is None:
        fn = build.load("rglru_bwd").rglru_bwd_f32
        fn.argtypes = _BWD_ARGTYPES
        fn.restype = ctypes.c_int
        _FNS["rglru_bwd"] = fn
    return fn


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def launch(x: torch.Tensor, a: torch.Tensor, h0: Optional[torch.Tensor],
           y: torch.Tensor, hT: torch.Tensor) -> None:
    """Launch the kernel on the current stream: ``y`` [B, T, D] and ``hT``
    [B, D] (dense float32) get the scan of ``x``, ``a`` [B, T, D] from
    ``h0`` [B, D] (zeros when ``None``). The caller has checked devices,
    dtypes, shapes and contiguity; raises if the launch reports a CUDA
    error."""
    B, T, D = x.shape
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _fn()(x.data_ptr(), a.data_ptr(), _ptr(h0), y.data_ptr(),
                hT.data_ptr(), B, T, D, stream)
    if err != 0:
        raise RuntimeError(f"rglru launch failed: cudaError_t {err}")


def launch_backward(x: torch.Tensor, a: torch.Tensor, y: torch.Tensor,
                    dy: torch.Tensor, h0: Optional[torch.Tensor],
                    dhT: Optional[torch.Tensor], dx: torch.Tensor,
                    da: torch.Tensor, dh0: torch.Tensor) -> None:
    """Launch the backward kernel on the current stream: ``dx``, ``da`` [B,
    T, D] and ``dh0`` [B, D] (dense float32) get the gradients of the scan
    of ``x``, ``a`` from ``h0`` (its output ``y``) at ``dy`` and ``dhT``
    (zeros when ``None``). The caller has checked devices, dtypes, shapes
    and contiguity; raises if the launch reports a CUDA error."""
    B, T, D = x.shape
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _bwd_fn()(x.data_ptr(), a.data_ptr(), y.data_ptr(), dy.data_ptr(),
                    _ptr(h0), _ptr(dhT), dx.data_ptr(), da.data_ptr(),
                    dh0.data_ptr(), B, T, D, stream)
    if err != 0:
        raise RuntimeError(f"rglru_bwd launch failed: cudaError_t {err}")
