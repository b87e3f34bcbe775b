"""ctypes binding of the CUDA ``acd_evict`` kernel (``csrc/acd_evict.cu``).

Port of the Pallas kernel ``src/repro/kernels/acd_sweep.py:acd_evict``:
the greedy ACD kept-prefix sweep, one block per queue row, its serial
chain run over the row's masked jobs only, compacted by the block's other
warps. This module only launches; :func:`repro_torch.kernels.ops.acd_evict`
is the checked public wrapper that the engine calls.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

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


def chain_step_probe(pt: torch.Tensor, n: int, out: torch.Tensor,
                     cycles: torch.Tensor) -> None:
    """Launch the chain-step probe on the current stream: one thread runs
    ``n`` x 8 dependent float64 steps on ``pt`` (16 float64 on the card:
    eight demands, then eight thresholds); ``out`` [1] float64 gets the
    sum, ``cycles`` [1] int64 the SM clocks the loop took. For the chain
    floor (:func:`chain_step_latency`); the engine never calls it."""
    fn = _FNS.get("probe")
    if fn is None:
        fn = build.load("acd_evict").acd_chain_step_probe
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FNS["probe"] = fn
    err = fn(pt.data_ptr(), n, out.data_ptr(), cycles.data_ptr(),
             torch.cuda.current_stream(pt.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"acd chain probe failed: cudaError_t {err}")


def chain_step_latency(n: int = 1 << 16) -> Tuple[float, float]:
    """(SM clocks, ns) per dependent float64 step of the chain, from one
    :func:`chain_step_probe` launch of ``n`` x 8 steps on the current
    device, timed by CUDA events after a warm-up launch: the step behind
    ``acd_evict``'s chain floor."""
    dev = torch.device("cuda", torch.cuda.current_device())
    pt = torch.tensor([1e-3] * 8 + [1e300] * 8, dtype=torch.float64,
                      device=dev)
    out = torch.empty(1, dtype=torch.float64, device=dev)
    cycles = torch.empty(1, dtype=torch.int64, device=dev)
    chain_step_probe(pt, n, out, cycles)
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    chain_step_probe(pt, n, out, cycles)
    t1.record()
    torch.cuda.synchronize()
    steps = 8 * n
    return int(cycles.item()) / steps, t0.elapsed_time(t1) * 1e6 / steps
