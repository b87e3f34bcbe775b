"""ctypes binding of the CUDA ``fifo_dispatch`` kernel
(``csrc/fifo_dispatch.cu``).

Port of the Pallas kernel ``src/repro/kernels/dispatch.py:fifo_dispatch``:
the capped FIFO public-dispatch chain, one block per scenario row, its
chain run by one thread on a slot pool in registers while the block's
other warps gather and precompute the next tile. This module only
launches; :func:`repro_torch.kernels.ops.fifo_dispatch` is the checked
public wrapper that the engine calls.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import build

_P = ctypes.c_void_p
_ARGTYPES = ([_P] * 18 + [ctypes.c_int] * 4
             + [ctypes.c_double, ctypes.c_int, _P])
_FN = []
_PROBE = []


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


def chain_step_probe(inp: torch.Tensor, n: int, keep_alive: float,
                     out: torch.Tensor, cycles: torch.Tensor) -> None:
    """Launch the chain-step probe on the current stream: one thread runs
    ``n`` dependent steps of the chain on a 3 x 2 pool in registers, every
    provider capped, cold starts on, from the 27 float64 of ``inp`` (the
    pool's clocks and idle stamps, then ready, dur, selc, occ per provider,
    then wu); ``out`` [7] float64 gets the pool, ``cycles`` [1] int64 the
    SM clocks the loop took. For the chain floor
    (:func:`chain_step_latency`); the engine never calls it."""
    if not _PROBE:
        fn = build.load("fifo_dispatch").fifo_chain_step_probe
        fn.argtypes = [_P, ctypes.c_int, ctypes.c_double, _P, _P, _P]
        fn.restype = ctypes.c_int
        _PROBE.append(fn)
    err = _PROBE[0](inp.data_ptr(), n, float(keep_alive), out.data_ptr(),
                    cycles.data_ptr(),
                    torch.cuda.current_stream(inp.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fifo chain probe failed: cudaError_t {err}")


def chain_step_latency(n: int = 1 << 14) -> Tuple[float, float]:
    """(SM clocks, ns) per dependent step of the chain (the engine's 3 x 2
    pool, every provider capped, cold starts on), from one
    :func:`chain_step_probe` launch of ``n`` steps on the current device,
    timed by CUDA events after a warm-up launch: the step behind
    ``fifo_dispatch``'s chain floor."""
    dev = torch.device("cuda", torch.cuda.current_device())
    pool = [0.5, 0.25, 1.0, 0.75, 0.125, 2.0] * 2
    per_p = [0.0, 1.0, 0.5, 0.1, 0.0, 1.5, 0.6, 0.2, 0.0, 0.8, 0.7, 0.3]
    inp = torch.tensor(pool + per_p + [0.4, 0.5, 0.6], dtype=torch.float64,
                       device=dev)
    out = torch.empty(7, dtype=torch.float64, device=dev)
    cycles = torch.empty(1, dtype=torch.int64, device=dev)
    chain_step_probe(inp, n, 1.0, out, cycles)
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    chain_step_probe(inp, n, 1.0, out, cycles)
    t1.record()
    torch.cuda.synchronize()
    return int(cycles.item()) / n, t0.elapsed_time(t1) * 1e6 / n
