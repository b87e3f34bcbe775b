"""ctypes binding of the CUDA ``rwkv6`` kernel (``csrc/rwkv6.cu``).

Port of the Pallas kernel ``src/repro/kernels/rwkv6.py:rwkv6``: the WKV
recurrence, one block per (batch, head) with each state column in the
registers of four threads, reading ``r``, ``k``, ``v``, ``w`` and writing ``o`` through
their strides. This module only launches;
:func:`repro_torch.kernels.ops.rwkv6` is the checked public wrapper that
``models/recurrent.py`` calls.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P]
#: head sizes Dk the kernel is compiled for, and its largest Dv
DK_SIZES = (16, 32, 64)
MAX_DV = 128
_FNS = {}


def _fn(dtype: torch.dtype):
    fn = _FNS.get(dtype)
    if fn is None:
        lib = build.load("rwkv6")
        fn = getattr(lib, {torch.float32: "rwkv6_f32",
                           torch.bfloat16: "rwkv6_bf16"}[dtype])
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _FNS[dtype] = fn
    return fn


def launch(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           w: torch.Tensor, u: torch.Tensor, s0: Optional[torch.Tensor],
           o: torch.Tensor, sT: torch.Tensor) -> None:
    """Launch the kernel on the current stream: ``o`` [B, H, T, Dv] (any
    strides with a unit last one) and ``sT`` [B, H, Dk, Dv] (dense) get
    the recurrence of ``r``, ``k``, ``w`` [B, H, T, Dk], ``v`` [B, H, T,
    Dv] (read through their strides), ``u`` [H, Dk] and ``s0`` (zeros when
    ``None``). The caller has checked devices, dtypes, shapes and strides;
    raises if the launch reports a CUDA error."""
    B, H, T, Dk = r.shape
    Dv = v.shape[-1]
    strides = (ctypes.c_longlong * 15)(*(
        s for x in (r, k, v, w, o) for s in x.stride()[:3]))
    stream = torch.cuda.current_stream(r.device).cuda_stream
    err = _fn(r.dtype)(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                       w.data_ptr(), u.data_ptr(),
                       None if s0 is None else s0.data_ptr(), o.data_ptr(),
                       sT.data_ptr(), B, H, T, Dk, Dv,
                       ctypes.cast(strides, _P), stream)
    if err != 0:
        raise RuntimeError(f"rwkv6 launch failed: cudaError_t {err}")
