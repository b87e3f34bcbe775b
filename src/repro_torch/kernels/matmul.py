"""ctypes binding of the CUDA ``matmul`` kernels (``csrc/matmul.cu``).

Port of the Pallas kernel ``src/repro/kernels/matmul.py:matmul``: ``x @ y``
with float32 accumulation, reading both operands through their element
strides. float32 runs CUDA-core kernels in IEEE float32, one of a few
compiled configurations chosen by :func:`tile_plan_f32` (64 x 128 tiles
for large products, 32 x 64 ones for the matrix app's squares and decode
steps, one row a thread for N <= 8), every output one ascending ``fmaf``
chain whatever the plan. bf16 runs on the tensor cores: consumer warpgroups
run ``wgmma`` m64n64k16 on tiles that a producer warp stages through an
``mbarrier`` ring by TMA (or, for operands TMA cannot take, by its own
threads into the same swizzled layout), laid out by :func:`tile_plan`.
This module only launches; :func:`repro_torch.kernels.ops.matmul` is the
checked public wrapper that the matrix application and ``layers.linear``
call.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from . import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_longlong
_ARGTYPES = {torch.float32: [_P, _P, _P, _I, _I, _I, _I64, _I64, _I64, _I64,
                             _I, _I, _I, _P],
             torch.bfloat16: [_P, _P, _P, _I, _I, _I, _I64, _I64, _I64, _I64,
                              _I, _I, _I, _I, _I, _P]}
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


#: the float32 kernel's compiled configurations, numbered as
#: ``csrc/matmul.cu:matmul_f32`` takes them: the skinny kernel, then the
#: tile kernels by (block rows, block columns)
F32_CONFIGS = {"skinny": 0, (64, 128): 1, (32, 64): 2}
#: N up to which the skinny kernel runs (one row per thread, N chains)
SKINNY_N = 8
#: rows a skinny block stages
SKINNY_ROWS = 128
#: the large tile, and the small one
F32_LARGE = (64, 128)
F32_SMALL = (32, 64)
#: streaming multiprocessors of the H100 SXM
SMS = 132
#: staging codes of the C interface: 4-byte cp.async copies walking the
#: named dimension, or 16 bytes at a time along it ("vec_*": cp.async
#: copies, except x along k in the tile kernels: register loads stored
#: transposed)
X_LOADS = {"k": 0, "m": 1, "vec_m": 2, "vec_k": 3}
Y_LOADS = {"n": 0, "k": 1, "vec_n": 2}


class F32Plan(NamedTuple):
    """How the float32 kernel runs one product. Every plan gives every
    output element the same bits: one float32 ``fmaf`` chain over k = 0 ..
    K16 - 1 in ascending order from 0.0f (K16: K rounded up to 16, the
    steps past K adding ``fmaf(0, 0, acc)``); no split-K, no tree, no TF32,
    no second accumulator. So the plan may follow M, N and K freely.

    ``regime``: ``"large"``, ``"small"`` or ``"skinny"``; ``block``: the
    output rows and columns a block computes; ``x_load`` / ``y_load``: how
    each operand is staged (``"k"``, ``"m"``, ``"n"``: 4-byte copies
    walking that dimension; ``"vec_k"``, ``"vec_m"``, ``"vec_n"``: 16
    bytes at a time along it, which the kernel turns into 4-byte copies
    where the base is not 16-byte aligned)."""
    regime: str
    block: Tuple[int, int]
    x_load: str
    y_load: str


@functools.lru_cache(maxsize=4096)  # every launch asks; shapes repeat
def tile_plan_f32(M: int, N: int, K: int,
                  strides: Tuple[int, int, int, int]) -> F32Plan:
    """The float32 kernel's plan for ``[M, K] @ [K, N]`` with the element
    strides (x along M, x along K, y along K, y along N), a function of
    these alone. N <= ``SKINNY_N`` (every row mean) runs the skinny kernel.
    A product that gives ``F32_LARGE`` tiles two waves of ``SMS`` blocks
    takes them; the rest take ``F32_SMALL`` (how the two tiles were
    chosen on the H100: PERF.md §6). Each operand is loaded along its
    unit-stride dimension."""
    if N <= SKINNY_N:
        return F32Plan("skinny", (SKINNY_ROWS, N), *f32_loads(True, strides))
    loads = f32_loads(False, strides)

    if _cdiv(M, F32_LARGE[0]) * _cdiv(N, F32_LARGE[1]) >= 2 * SMS:
        return F32Plan("large", F32_LARGE, *loads)
    return F32Plan("small", F32_SMALL, *loads)


def f32_loads(skinny: bool, strides: Tuple[int, int, int, int]
              ) -> Tuple[str, str]:
    """(x_load, y_load) of the skinny or the tile kernels for the element
    strides (x along M, x along K, y along K, y along N): 16-byte copies
    where the kernel's contiguous dimension has unit stride and 16-byte
    steps, else 4-byte copies along the unit-stride dimension."""
    sxm, sxk, syk, syn = strides
    x_k = "vec_k" if sxk == 1 and sxm % 4 == 0 else "k"
    if skinny:  # rows of x along k; y's few columns element by element
        return (x_k if sxk == 1 else "m"), "n"
    x = (x_k if sxk == 1 else "vec_m" if sxm == 1 and sxk % 4 == 0
         else "m" if sxm == 1 else "k")
    y = ("vec_n" if syn == 1 and syk % 4 == 0
         else "n" if syn == 1 or syk != 1 else "k")
    return x, y


def f32_plans(M: int, N: int, K: int,
              strides: Tuple[int, int, int, int]) -> Tuple[F32Plan, ...]:
    """:func:`tile_plan_f32`'s plan, then every other configuration of
    ``F32_CONFIGS`` forced on the same product (the skinny kernel only for
    N <= ``SKINNY_N``): what the tests and ``chip_smoke.py`` hold
    against each other, bit for bit."""
    own = tile_plan_f32(M, N, K, strides)
    plans = [own]
    for key in F32_CONFIGS:
        if key == "skinny":
            if N <= SKINNY_N and own.regime != "skinny":
                plans.append(F32Plan("skinny", (SKINNY_ROWS, N),
                                     *f32_loads(True, strides)))
        elif key != own.block:
            plans.append(F32Plan("large" if key == F32_LARGE else "small",
                                 key, *f32_loads(False, strides)))
    return tuple(plans)


def f32_blocks(M: int, N: int, plan: F32Plan) -> int:
    """Blocks the float32 kernel launches for ``plan``."""
    if plan.regime == "skinny":
        return _cdiv(M, SKINNY_ROWS)
    return _cdiv(M, plan.block[0]) * _cdiv(N, plan.block[1])


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
           _by_threads: bool = False,
           _f32_plan: Optional[F32Plan] = None) -> None:
    """Launch the kernel on the current stream: ``out`` [M, N] (dense) gets
    ``x`` [M, K] @ ``y`` [K, N], read through their strides, in x's dtype
    or, for bf16 operands, as float32 sums. The caller
    has checked devices, dtypes and shapes; raises if the launch reports a
    CUDA error. ``_by_threads`` stages both bf16 operands by threads where
    TMA would take them (to hold the two staging paths against each
    other); ``_f32_plan`` replaces :func:`tile_plan_f32`'s plan (to hold
    the float32 configurations against each other)."""
    M, K = x.shape
    N = y.shape[1]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    args = [x.data_ptr(), y.data_ptr(), out.data_ptr(), M, N, K,
            x.stride(0), x.stride(1), y.stride(0), y.stride(1)]
    if x.dtype == torch.float32:
        plan = _f32_plan or tile_plan_f32(M, N, K, x.stride() + y.stride())
        args += [F32_CONFIGS["skinny" if plan.regime == "skinny"
                             else plan.block],
                 X_LOADS[plan.x_load], Y_LOADS[plan.y_load]]
    else:
        plan = tile_plan(M, N, K, y.stride())
        args += [plan.n_instr, plan.warpgroups, int(plan.b_major == "k"),
                 int(_by_threads), int(out.dtype == torch.float32)]
    err = _fn(x.dtype)(*args, stream)
    if err != 0:
        raise RuntimeError(f"matmul launch failed: cudaError_t {err}")
