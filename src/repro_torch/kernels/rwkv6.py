"""ctypes binding of the CUDA ``rwkv6`` kernel (``csrc/rwkv6.cu``).

Port of the Pallas kernel ``src/repro/kernels/rwkv6.py:rwkv6``: the WKV
recurrence, each warp holding one row group (Dk / 4 consecutive rows) of
a column group's state in its lanes' registers, the group's rows split
between the two half-warps (the second continuing the first's sum a step
later), the staged chunks read in 16-byte broadcast loads, the groups'
sums added per chunk, reading ``r``, ``k``, ``v``, ``w`` and writing ``o``
through their strides. :func:`launch_plan` cuts a head's columns into
column groups and blocks; no plan changes a value. This module only
launches; :func:`repro_torch.kernels.ops.rwkv6` is the checked public
wrapper that ``models/recurrent.py`` calls.

The backward (``csrc/rwkv6_bwd.cu``, :func:`launch_backward`) takes one
block per (b, h), each thread two state rows of ``tiles`` column tiles
(:func:`backward_plan`, from Dk and Dv alone): a forward pass writes the
state every ``chunk`` steps into a float32 workspace
(:func:`workspace_floats`), then the chunks are walked in reverse, each
chunk's states recomputed from its checkpoint into the threads'
registers. :func:`backward_geometry` mirrors the kernel's block size and
shared memory; no plan changes a value.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Optional, Tuple

import torch

from . import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P]
#: head sizes Dk the kernel is compiled for, and its largest Dv
DK_SIZES = (16, 32, 64)
MAX_DV = 128
#: columns a lane may hold (the kernel's instantiations), most first: a
#: lane reuses each staged r, k, w for its columns (3 floats a row and
#: step against 7 operations a column), and fewer columns give more warps
#: (four were never faster at the shapes timed: PERF.md §6)
COLS = (2, 1)
#: lanes of a half-warp (the columns of a column group, C each), the row
#: groups of a column group (one a warp), and the most column groups a
#: block holds (the kernel's launch bound)
LANES = 16
ROW_GROUPS = 4
MAX_GROUPS = 4
#: streaming multiprocessors of the H100 SXM, the schedulers of one SM,
#: and the warps a plan wants on each: with one, a warp's own dependent
#: steps show (PERF.md §6: one column a lane 1.030 ms against two 1.241
#: at the long batch's 64 heads on the H100)
SMS = 132
SCHEDULERS = 4
WARPS_PER_SCHEDULER = 2
_FNS = {}
_BWD_ARGTYPES = ([_P] * 15 + [ctypes.c_longlong] + [_I] * 5 + [_P, _P, _P])
#: the backward's thread tile (``kRows`` state rows by ``kTile`` columns a
#: column tile in ``csrc/rwkv6_bwd.cu``), its most threads a block, its
#: pass 1 ring in chunks, and the shared memory a block may take
BWD_ROWS = 2
BWD_TILE = 4
BWD_MAX_THREADS = 512
BWD_SLOTS = 4
SMEM_MAX = 232448


class BackwardPlan(NamedTuple):
    """How the backward kernel cuts a head: ``tiles`` column tiles (of
    four columns) a thread, and the ``chunk`` of steps between two
    checkpoints, whose states a thread keeps in registers (2 rows x 4
    tiles x chunk = 64 floats in both plans). Every plan gives every
    element the same bits."""
    tiles: int
    chunk: int


#: the plans compiled, in order of preference: (2, 4) only at Dk = 64
BWD_PLANS = (BackwardPlan(1, 8), BackwardPlan(2, 4))


class BackwardGeometry(NamedTuple):
    """The block of a plan (``Geo`` in ``csrc/rwkv6_bwd.cu``): its
    threads, the columns they hold (Dv padded to whole groups of
    ``tiles`` column tiles) and its dynamic shared memory in bytes."""
    threads: int
    width: int
    smem: int


def backward_geometry(plan: BackwardPlan, Dk: int, Dv: int,
                      itemsize: int) -> BackwardGeometry:
    """The kernel's ``geometry`` for ``plan`` at Dk, Dv and inputs of
    ``itemsize`` bytes (r, k, v, do): the shared memory holds pass 1's ring
    of ``BWD_SLOTS`` staged chunks or pass 2's tile sums of a chunk
    (whichever is larger), pass 2's two staged chunks and its chunk
    widened to float32, a checkpoint tile and two chunks' dots and r_t k_t
    products."""
    dv4 = _cdiv(Dv, BWD_TILE) * BWD_TILE
    nct = dv4 // BWD_TILE
    groups = _cdiv(nct, plan.tiles)
    width = groups * plan.tiles * BWD_TILE
    # dr's, dk's, dw's tile sums of a chunk, then dv's in rows of
    # MAX_DV + 1 floats (``kVRow``)
    sums = plan.chunk * (3 * nct * Dk + Dk // BWD_TILE * (MAX_DV + 1))
    step = sum(_cdiv(n, 16) * 16 for n in (
        Dk * itemsize, Dk * itemsize, Dk * 4, width * itemsize,
        width * itemsize))
    slot = plan.chunk * step
    shared = _cdiv(max(4 * sums, BWD_SLOTS * slot), 16) * 16
    smem = (shared + 2 * slot + 4 * plan.chunk * (3 * Dk + 2 * width)
            + 4 * Dk * width + 8 * plan.chunk * (1 + Dk))
    return BackwardGeometry(Dk // BWD_ROWS * groups, width, smem)


def _bwd_fits(plan: BackwardPlan, Dk: int, Dv: int) -> bool:
    return ((plan.tiles == 1 or Dk == 64) and backward_geometry(
        plan, Dk, Dv, 4).threads <= BWD_MAX_THREADS)


def backward_plan(Dk: int, Dv: int) -> BackwardPlan:
    """The backward's plan for heads of Dk x Dv, a function of these alone
    (never of B, H or T): one column tile a thread with an 8-step chunk
    while the block stays within ``BWD_MAX_THREADS`` (16 warps at 64 x
    64), else two with a 4-step chunk (Dk = 64, Dv > 64)."""
    return next(p for p in BWD_PLANS if _bwd_fits(p, Dk, Dv))


def backward_plans(Dk: int, Dv: int) -> List[BackwardPlan]:
    """Every compiled plan that fits the head, :func:`backward_plan`'s
    first: what the tests and the development probe hold against one
    another, bit for bit."""
    own = backward_plan(Dk, Dv)
    return [own] + [p for p in BWD_PLANS if p != own and _bwd_fits(p, Dk, Dv)]


def backward_cells(plan: BackwardPlan, Dk: int, Dv: int
                   ) -> List[Tuple[int, int]]:
    """Every (row, column) of the state that the kernel's threads hold
    under ``plan``, in the order of (thread, row, column) and as the kernel
    indexes them (thread t: row pair t mod (Dk / 2), column group
    t div (Dk / 2)), the columns at or past ``Dv`` left out: each of
    Dk x Dv must come exactly once."""
    pairs = Dk // BWD_ROWS
    ncol = plan.tiles * BWD_TILE
    out = []
    for t in range(backward_geometry(plan, Dk, Dv, 4).threads):
        i0, j0 = (t % pairs) * BWD_ROWS, (t // pairs) * ncol
        out += [(i0 + a, j0 + c) for a in range(BWD_ROWS)
                for c in range(ncol) if j0 + c < Dv]
    return out


class Plan(NamedTuple):
    """How the kernel cuts one launch: ``cols`` state columns per lane,
    ``groups`` column groups per block (each ``16 * cols`` columns wide,
    four warps: one a row group) and ``splits`` column blocks per head.
    Every plan gives every element the same bits."""
    cols: int
    groups: int
    splits: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _split(heads: int, per_head: int, n_sm: int) -> Tuple[int, int]:
    """(column groups per block, blocks per head) that keep the busiest
    SM's warp count lowest (blocks spread evenly over the SMs), the fewest
    blocks on a tie: every block stages the head's r, k and w again."""
    best = None
    for s in range(_cdiv(per_head, MAX_GROUPS), per_head + 1):
        groups = _cdiv(per_head, s)
        splits = _cdiv(per_head, groups)
        load = _cdiv(heads * splits, n_sm) * groups
        if best is None or load < best[0]:
            best = (load, groups, splits)
    return best[1], best[2]


def _fits(cols: int, Dv: int) -> bool:
    """A column group no wider than the head (one column a lane always)."""
    return cols == 1 or LANES * cols <= Dv


def _plan(B: int, H: int, Dv: int, cols: int, n_sm: int) -> Plan:
    groups, splits = _split(B * H, _cdiv(Dv, LANES * cols), n_sm)
    return Plan(cols, groups, splits)


def launch_plan(B: int, H: int, Dv: int, n_sm: int = SMS) -> Plan:
    """The plan for ``B * H`` heads of ``Dv`` columns on ``n_sm`` SMs, a
    function of these alone (never of T, so a prefill and the decode steps
    after it share it; they would share the bits regardless): the most
    columns a lane that still give every scheduler ``WARPS_PER_SCHEDULER``
    warps, else one, then the column split of :func:`_split`."""
    want = WARPS_PER_SCHEDULER * SCHEDULERS * n_sm
    cols = next((c for c in COLS if _fits(c, Dv) and B * H * _cdiv(
        Dv, LANES * c) * ROW_GROUPS >= want), 1)
    return _plan(B, H, Dv, cols, n_sm)


def plans(B: int, H: int, Dv: int, n_sm: int = SMS) -> List[Plan]:
    """:func:`launch_plan`'s plan, then the other column counts that fit
    the head, with their own split: what the tests and the development
    probe hold against one another, bit for bit."""
    own = launch_plan(B, H, Dv, n_sm)
    return [own] + [_plan(B, H, Dv, cols, n_sm) for cols in COLS
                    if cols != own.cols and _fits(cols, Dv)]


def plan_columns(plan: Plan, Dv: int) -> List[int]:
    """Every column the kernel computes under ``plan``, in the order of
    (block, column group, lane, column) and as the kernel indexes them,
    the ones at or past ``Dv`` left out: each of 0 .. Dv - 1 must come
    exactly once."""
    width = LANES * plan.cols
    out = []
    for split in range(plan.splits):
        c0 = split * plan.groups * width
        for group in range(plan.groups):
            for lane in range(LANES):
                for c in range(plan.cols):
                    j = c0 + group * width + lane * plan.cols + c
                    if j < Dv:
                        out.append(j)
    return out


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


@functools.lru_cache(maxsize=16)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=1024)  # a decode step's launches repeat it
def _plan_arg(B: int, H: int, Dv: int, index: int) -> ctypes.Array:
    """:func:`launch_plan`'s plan on device ``index`` as the kernel takes
    it (three ints on the host), built once a shape."""
    return (ctypes.c_int * 3)(*launch_plan(B, H, Dv, _sm_count(index)))


def launch(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           w: torch.Tensor, u: torch.Tensor, s0: Optional[torch.Tensor],
           o: torch.Tensor, sT: torch.Tensor, *,
           _plan: Optional[Plan] = None) -> None:
    """Launch the kernel on the current stream: ``o`` [B, H, T, Dv] (any
    strides with a unit last one) and ``sT`` [B, H, Dk, Dv] (dense) get
    the recurrence of ``r``, ``k``, ``w`` [B, H, T, Dk], ``v`` [B, H, T,
    Dv] (read through their strides), ``u`` [H, Dk] and ``s0`` (zeros when
    ``None``). The caller has checked devices, dtypes, shapes and strides;
    raises if the launch reports a CUDA error. ``_plan`` replaces
    :func:`launch_plan`'s (to hold the plans against one another)."""
    B, H, T, Dk = r.shape
    Dv = v.shape[-1]
    plan = (_plan_arg(B, H, Dv, r.device.index or 0) if _plan is None
            else (ctypes.c_int * 3)(*_plan))
    strides = (ctypes.c_longlong * 15)(*(
        s for x in (r, k, v, w, o) for s in x.stride()[:3]))
    stream = torch.cuda.current_stream(r.device).cuda_stream
    # ctypes passes each host array by its address
    err = _fn(r.dtype)(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                       w.data_ptr(), u.data_ptr(),
                       None if s0 is None else s0.data_ptr(), o.data_ptr(),
                       sT.data_ptr(), B, H, T, Dk, Dv, strides, plan, stream)
    if err != 0:
        raise RuntimeError(f"rwkv6 launch failed: cudaError_t {err}")


def workspace_floats(B: int, H: int, T: int, Dk: int, Dv: int,
                     plan: Optional[BackwardPlan] = None) -> int:
    """float32 elements of the backward's workspace (``workspace_floats``
    in ``csrc/rwkv6_bwd.cu``, which refuses a smaller one): a [Dk, width]
    state (:func:`backward_geometry`'s padded columns) for every checkpoint
    but the last chunk's, ceil(T / chunk) - 1 a (b, h), under ``plan``
    (:func:`backward_plan`'s when ``None``)."""
    plan = backward_plan(Dk, Dv) if plan is None else plan
    width = backward_geometry(plan, Dk, Dv, 4).width
    return B * H * (_cdiv(T, plan.chunk) - 1) * Dk * width


def _bwd_fn(dtype: torch.dtype):
    key = ("bwd", dtype)
    fn = _FNS.get(key)
    if fn is None:
        lib = build.load("rwkv6_bwd")
        fn = getattr(lib, {torch.float32: "rwkv6_bwd_f32",
                           torch.bfloat16: "rwkv6_bwd_bf16"}[dtype])
        fn.argtypes = _BWD_ARGTYPES
        fn.restype = ctypes.c_int
        _FNS[key] = fn
    return fn


def launch_backward(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    w: torch.Tensor, u: torch.Tensor, do: torch.Tensor,
                    s0: Optional[torch.Tensor], dsT: Optional[torch.Tensor],
                    dr: torch.Tensor, dk: torch.Tensor, dv: torch.Tensor,
                    dw: torch.Tensor, du_part: torch.Tensor,
                    ds0: torch.Tensor, work: torch.Tensor, *,
                    _plan: Optional[BackwardPlan] = None) -> None:
    """Launch the backward kernel on the current stream: ``dr``, ``dk``,
    ``dw`` [B, H, T, Dk], ``dv`` [B, H, T, Dv] (any strides with a unit
    last one), ``du_part`` [B, H, Dk] and ``ds0`` [B, H, Dk, Dv] (dense)
    get the gradients of the recurrence of ``r``, ``k``, ``v``, ``w``
    (read through their strides), ``u`` and ``s0`` at ``do`` (the gradient
    of o, through its strides) and ``dsT`` (dense; zeros when ``None``);
    ``work`` holds at least :func:`workspace_floats` float32 elements of
    the plan. The caller has checked devices, dtypes, shapes and strides;
    raises if the launch reports a CUDA error. ``_plan`` replaces
    :func:`backward_plan`'s (to hold the plans against one another)."""
    B, H, T, Dk = r.shape
    Dv = v.shape[-1]
    plan = backward_plan(Dk, Dv) if _plan is None else _plan
    strides = (ctypes.c_longlong * 27)(*(
        s for x in (r, k, v, w, do, dr, dk, dv, dw) for s in x.stride()[:3]))
    stream = torch.cuda.current_stream(r.device).cuda_stream
    err = _bwd_fn(r.dtype)(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        do.data_ptr(), None if s0 is None else s0.data_ptr(),
        None if dsT is None else dsT.data_ptr(), dr.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), dw.data_ptr(), du_part.data_ptr(),
        ds0.data_ptr(), work.data_ptr(), work.numel(), B, H, T, Dk, Dv,
        strides, (ctypes.c_int * 2)(*plan), stream)
    if err != 0:
        raise RuntimeError(f"rwkv6_bwd launch failed: cudaError_t {err}")
