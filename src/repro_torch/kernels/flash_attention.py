"""ctypes binding of the CUDA ``flash_attention`` kernel
(``csrc/flash_attention.cu``).

Port of the Pallas kernel ``src/repro/kernels/flash_attention.py:
flash_attention``: prefill attention with an online softmax, one block per
(64-query tile, query head, batch row), the KV loop inside the block,
reading q, k, v and out through their strides. This module only launches;
:func:`repro_torch.kernels.ops.flash_attention` is the checked public
wrapper that ``models/layers.py`` calls.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_STRIDES = ctypes.c_longlong * 3
_PLL = ctypes.POINTER(ctypes.c_longlong)  # a host array of strides
_ARGTYPES = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
             ctypes.c_float, _PLL, _PLL, _PLL, _PLL, _P]
_FNS = {}


def _fn(dtype: torch.dtype):
    fn = _FNS.get(dtype)
    if fn is None:
        lib = build.load("flash_attention")
        fn = getattr(lib, {torch.float32: "flash_attention_f32",
                           torch.bfloat16: "flash_attention_bf16"}[dtype])
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _FNS[dtype] = fn
    return fn


def _bhs(t: torch.Tensor):
    return _STRIDES(*t.stride()[:3])


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           out: torch.Tensor, causal: bool, window: Optional[int]) -> None:
    """Launch the kernel on the current stream: ``out`` [B, Hq, Sq, D] gets
    the attention of ``q`` over ``k``/``v`` [B, Hkv, Sk, D], each read
    through its strides. The caller has checked devices, dtypes, shapes and
    the unit stride along D; raises if the launch reports a CUDA error."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _fn(q.dtype)(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       out.data_ptr(), B, Hq, Hkv, Sq, Sk, D, int(causal),
                       0 if window is None else int(window), D ** -0.5,
                       _bhs(q), _bhs(k), _bhs(v), _bhs(out), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: cudaError_t "
                           f"{err}")
