"""ctypes binding of the CUDA ``fifo_dispatch`` kernel
(``csrc/fifo_dispatch.cu``).

Port of the Pallas kernel ``src/repro/kernels/dispatch.py:fifo_dispatch``:
the capped FIFO public-dispatch chain, one block per scenario row. This
module only launches; :func:`repro_torch.kernels.ops.fifo_dispatch` is the
checked public wrapper that the engine calls.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

_P = ctypes.c_void_p
_ARGTYPES = ([_P] * 18 + [ctypes.c_int] * 4
             + [ctypes.c_double, ctypes.c_int, _P])
_FN = []


def _fn():
    if not _FN:
        fn = build.load("fifo_dispatch").fifo_dispatch_f64
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _FN.append(fn)
    return _FN[0]


def launch(order, n_pub, ready, dur, selc, occ, seg, capped, wu, sclk0,
           sidle0, keep_alive: float, cold: bool, outs) -> None:
    """Launch the kernel on the current stream, writing the seven [B, J]
    tensors of ``outs`` (prov, seg, wait, cold, start, end, extra). The
    caller has checked devices, dtypes, shapes and contiguity; raises if
    the launch reports a CUDA error."""
    B, P, J = ready.shape
    C = sclk0.shape[2]
    stream = torch.cuda.current_stream(ready.device).cuda_stream
    ptrs = [x.data_ptr() for x in (order, n_pub, ready, dur, selc, occ, seg,
                                   capped, wu, sclk0, sidle0, *outs)]
    err = _fn()(*ptrs, B, P, J, C, float(keep_alive), int(bool(cold)),
                stream)
    if err != 0:
        raise RuntimeError(f"fifo_dispatch launch failed: cudaError_t {err}")
