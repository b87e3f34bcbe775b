"""ctypes binding of the CUDA ``matmul`` kernels (``csrc/matmul.cu``).

Port of the Pallas kernel ``src/repro/kernels/matmul.py:matmul``: ``x @ y``
with float32 accumulation, reading both operands through their element
strides. float32 runs a CUDA-core kernel in IEEE float32 (one block per
64 x 64 output tile). bf16 runs on the tensor cores: consumer warpgroups
run ``wgmma`` m64n64k16 on tiles that a producer warp stages through an
``mbarrier`` ring by TMA (or, for operands TMA cannot take, by its own
threads into the same swizzled layout), laid out by :func:`tile_plan`.
This module only launches; :func:`repro_torch.kernels.ops.matmul` is the
checked public wrapper that the matrix application and ``layers.linear``
call.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from . import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_longlong
_ARGTYPES = {torch.float32: [_P, _P, _P, _I, _I, _I, _I64, _I64, _I64, _I64,
                             _P],
             torch.bfloat16: [_P, _P, _P, _I, _I, _I, _I64, _I64, _I64, _I64,
                              _I, _I, _I, _I, _P]}
_FNS = {}

#: n of the kernel's one wgmma instruction, m64n64k16, for every shape
X_WIDTH = 64
#: K per pipeline stage (one 128-byte swizzle row of bf16), summed in
#: 16-deep wgmma chunks in ascending k; the wgmma accumulators hold the
#: whole sum (no promotion into a second float32 sum)
BK = 64
#: X-wide instructions per k step a two-warpgroup block may take, most
#: first, and the fewest blocks that may take more than one
N_INSTR = (4, 2, 1)
MIN_BLOCKS = 32


class TilePlan(NamedTuple):
    """How the bf16 kernel cuts one product beyond the constants above.
    ``b_major`` fixes, with them, each output element's arithmetic; only
    the last two fields may depend on M.

    ``b_major``: how y sits in shared memory (``"k"``: K contiguous,
    ``"mn"``: N contiguous, wgmma's transpose bit); ``warpgroups``: 64-row
    consumer warpgroups per block; ``n_instr``: X-wide instructions per
    warpgroup per k step."""
    b_major: str
    warpgroups: int
    n_instr: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def tile_plan(M: int, N: int, K: int,
              y_strides: Tuple[int, int]) -> TilePlan:
    """The bf16 kernel's tile plan for ``[M, K] @ [K, N]`` with y's element
    strides (along K, along N). y's layout comes from its strides, not from
    M. M picks the block rows (one warpgroup up to 64 rows, else two) and,
    for two, the most instructions per step that still give
    ``MIN_BLOCKS`` blocks. (On the H100 a narrower X, which launches more
    blocks at decode, came within about 5% of X = 64 there, faster at some
    shapes and slower at others: PERF.md §6.)"""
    syk, syn = y_strides
    b_major = "k" if syk == 1 and not (syn == 1 and N > 1) else "mn"
    if M <= 64:
        return TilePlan(b_major, 1, 1)
    n_instr = next((ni for ni in N_INSTR[:-1] if _cdiv(M, 128)
                    * _cdiv(N, ni * X_WIDTH) >= MIN_BLOCKS), 1)
    return TilePlan(b_major, 2, n_instr)


def _fn(dtype: torch.dtype):
    fn = _FNS.get(dtype)
    if fn is None:
        lib = build.load("matmul")
        fn = getattr(lib, {torch.float32: "matmul_f32",
                           torch.bfloat16: "matmul_bf16"}[dtype])
        fn.argtypes = _ARGTYPES[dtype]
        fn.restype = ctypes.c_int
        _FNS[dtype] = fn
    return fn


def launch(x: torch.Tensor, y: torch.Tensor, out: torch.Tensor, *,
           _by_threads: bool = False) -> None:
    """Launch the kernel on the current stream: ``out`` [M, N] (dense) gets
    ``x`` [M, K] @ ``y`` [K, N], read through their strides. The caller
    has checked devices, dtypes and shapes; raises if the launch reports a
    CUDA error. ``_by_threads`` stages both bf16 operands by threads where
    TMA would take them (to hold the two staging paths against each
    other)."""
    M, K = x.shape
    N = y.shape[1]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    args = [x.data_ptr(), y.data_ptr(), out.data_ptr(), M, N, K,
            x.stride(0), x.stride(1), y.stride(0), y.stride(1)]
    if x.dtype == torch.bfloat16:
        plan = tile_plan(M, N, K, y.stride())
        args += [plan.n_instr, plan.warpgroups, int(plan.b_major == "k"),
                 int(_by_threads)]
    err = _fn(x.dtype)(*args, stream)
    if err != 0:
        raise RuntimeError(f"matmul launch failed: cudaError_t {err}")
