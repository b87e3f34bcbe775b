"""ctypes binding of the CUDA ``flash_decode`` kernel
(``csrc/flash_decode.cu``).

Port of the Pallas kernel ``src/repro/kernels/flash_decode.py:
flash_decode``: one new token per query head against a KV cache, one
block per (KV head, batch row) with the group's query heads as the rows of
each product, reading q, k and v through their strides. This module only
launches; :func:`repro_torch.kernels.ops.flash_decode` is the checked
public wrapper that ``models/model.py`` calls.
"""
from __future__ import annotations

import ctypes
import torch

from . import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_S2 = ctypes.c_longlong * 2
_S3 = ctypes.c_longlong * 3
_PLL = ctypes.POINTER(ctypes.c_longlong)  # a host array of strides
_ARGTYPES = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float,
             _PLL, _PLL, _PLL, _P]
_FNS = {}


def _fn(dtype: torch.dtype):
    fn = _FNS.get(dtype)
    if fn is None:
        lib = build.load("flash_decode")
        fn = getattr(lib, {torch.float32: "flash_decode_f32",
                           torch.bfloat16: "flash_decode_bf16"}[dtype])
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _FNS[dtype] = fn
    return fn


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           length: torch.Tensor, end: torch.Tensor,
           out: torch.Tensor) -> None:
    """Launch the kernel on the current stream: ``out`` [B, Hq, D] (dense)
    gets the attention of ``q`` [B, Hq, D] over the live keys of ``k``/``v``
    [B, Hkv, S, D] (each read through its strides): the last
    n = min(length[b], S) positions before ``end[b]``, position P at slot
    P % S. The caller has checked devices, dtypes, shapes and the unit
    stride along D; raises if the launch reports a CUDA error (also for a
    group too wide for the kernel: (Hq / Hkv) x D, D rounded up to a power
    of two >= 32, above 32 x 256)."""
    B, Hq, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _fn(q.dtype)(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       length.data_ptr(), end.data_ptr(), out.data_ptr(), B, Hq, Hkv, S, D,
                       D ** -0.5, _S2(*q.stride()[:2]), _S3(*k.stride()[:3]),
                       _S3(*v.stride()[:3]), stream)
    if err != 0:
        raise RuntimeError(f"flash_decode launch failed: cudaError_t {err}")
