"""The work of each model kernel, from shapes and dtypes, and the counters
that a step's kernels and collectives report to.

One cost function per kernel gives ``(operations, bytes)`` of one call:
the operations the function needs and the bytes it must move, each input
read once and each output written once, with only the live slots of a KV
cache (the bound column of PERF.md §6, which chip_smoke.py computes from
these functions). ``launch.roofline`` turns them into times on the card's
peaks, defined here once (:data:`PEAK_FLOPS`, :data:`HBM_BW`,
:data:`LINK_BW`) for the roofline, the serving latency model and
chip_smoke.py.

A counter (``launch.counting.StepCounter``) registers itself in
:data:`COUNTERS` while it counts. The wrappers of :mod:`.ops` then report
each kernel call (:func:`note_kernel`, on the card, on ``meta`` and
through the plain version on the CPU), and the distribution layer's
collective helpers each collective (:func:`note_collective`). With no
counter registered a report is one test of an empty list.
"""
from __future__ import annotations

import contextlib
import functools
from typing import List, Tuple

import torch

#: H100 SXM5 80GB, 700 W (NVIDIA data sheet): dense bf16 tensor-core FLOP/s
PEAK_FLOPS = 989e12
#: its HBM3 bytes/s
HBM_BW = 3.35e12
#: bytes/s of one 400 Gb/s NDR InfiniBand port, one per card (DGX H100)
LINK_BW = 50e9

#: the counters now counting (a step's ``StepCounter``s), innermost last
COUNTERS: List = []
#: how deep the calls inside :func:`quiet` are nested
QUIET = [0]


def note_kernel(name: str, operations: int, nbytes: int) -> None:
    """One call of kernel ``name`` doing ``operations`` and moving
    ``nbytes``, reported to every registered counter."""
    for c in COUNTERS:
        c.kernel(name, operations, nbytes)


@contextlib.contextmanager
def quiet():
    """Counters skip the aten ops run inside (a kernel's own: its plain
    version on the CPU, or reading a decode's live slots to cost it)."""
    QUIET[0] += 1
    try:
        yield
    finally:
        QUIET[0] -= 1


def note_collective(kind: str, out: torch.Tensor, group_size: int) -> None:
    """One collective of ``kind`` (the reference's names: ``all-gather``,
    ``all-reduce``, ``reduce-scatter``, ``all-to-all``,
    ``collective-permute``) whose output on this rank is ``out``, over a
    group of ``group_size`` ranks."""
    if COUNTERS:
        nbytes = out.numel() * out.element_size()
        for c in COUNTERS:
            c.collective(kind, nbytes, group_size)


def matmul(M: int, K: int, N: int, dtype: torch.dtype,
           out_dtype: torch.dtype = None) -> Tuple[int, int]:
    """[M, K] @ [K, N] in ``dtype``: 2MNK operations; x and y read, out
    written (in ``out_dtype``, float32 for a row-parallel product's
    partials; ``dtype`` by default)."""
    out = (out_dtype or dtype).itemsize
    return 2 * M * N * K, (M * K + K * N) * dtype.itemsize + M * N * out


@functools.lru_cache(maxsize=4096)
def live_pairs(sq: int, sk: int, causal: bool, window) -> int:
    """Live (query, key) pairs of one (batch row, head) of a prefill:
    query i at position sk - sq + i, key j live iff j <= its position
    (causal) and j > its position - window."""
    n = 0
    for i in range(sq):
        qpos = sk - sq + i
        hi = min(sk - 1, qpos) if causal else sk - 1
        lo = max(0, qpos - window + 1) if window else 0
        n += max(0, hi - lo + 1)
    return n


def flash_attention(q_shape, k_shape, dtype: torch.dtype, causal: bool,
                    window) -> Tuple[int, int]:
    """Prefill attention of q [B, Hq, Sq, D] over k, v [B, Hkv, Sk, D]:
    4 D operations per live pair and query head (the two dots); q read and
    out written, K and V read once."""
    B, Hq, Sq, D = q_shape
    Hkv, Sk = k_shape[1], k_shape[2]
    ops = 4 * B * Hq * D * live_pairs(Sq, Sk, bool(causal), window)
    return ops, (2 * B * Hq * Sq * D + 2 * B * Hkv * Sk * D) * dtype.itemsize


def flash_decode(q_shape, Hkv: int, q_dtype: torch.dtype,
                 kv_dtype: torch.dtype, live: int) -> Tuple[int, int]:
    """One token of q [B, Hq, D] against ``live`` cache slots in all (the
    sum over the batch rows of min(length, S)): 4 D operations per live
    slot and query head; q read and out written in q's dtype, the live K
    and V rows read in the cache's."""
    B, Hq, D = q_shape
    return (4 * Hq * D * live,
            2 * B * Hq * D * q_dtype.itemsize
            + 2 * Hkv * live * D * kv_dtype.itemsize)


def flash_decode_partial(q_shape, Hkv: int, q_dtype: torch.dtype,
                         kv_dtype: torch.dtype, live: int,
                         pieces: int) -> Tuple[int, int]:
    """One rank's part of :func:`flash_decode` against its run of a cache
    cut along the slots: its ``live`` slots' operations and K/V rows, q
    read, and a float32 partial (m, l and D outputs) of every query head
    written for each of its ``pieces`` (the chunks of a batch row's live
    range that meet its slots, summed over the rows:
    :func:`.ref.decode_pieces`)."""
    B, Hq, D = q_shape
    return (4 * Hq * D * live,
            B * Hq * D * q_dtype.itemsize
            + 2 * Hkv * live * D * kv_dtype.itemsize
            + Hq * pieces * (2 + D) * 4)


def flash_decode_merge(q_shape, q_dtype: torch.dtype,
                       pieces: int) -> Tuple[int, int]:
    """The merge of every rank's partials: ``pieces`` of them for each
    query head (the (chunk, rank) pairs whose keys meet, summed over the
    batch rows and ranks: :func:`.ref.decode_pieces`), per partial and
    query head its two scales (a max, two subtractions, two exponentials)
    and 3 operations on each of l and the D outputs; those partials read,
    out written in q's dtype."""
    B, Hq, D = q_shape
    n = Hq * pieces
    return n * (5 + 3 * (1 + D)), (n * (2 + D) * 4
                                   + B * Hq * D * q_dtype.itemsize)


def rglru(B: int, T: int, D: int, with_h0: bool) -> Tuple[int, int]:
    """The RG-LRU scan over [B, T, D] float32: seven operations per element;
    x and a read and y written, h0 read (where given) and h_T written."""
    n = B * T * D
    return 7 * n, 3 * n * 4 + (2 if with_h0 else 1) * B * D * 4


def rwkv6(B: int, H: int, T: int, Dk: int, Dv: int, dtype: torch.dtype,
          with_s0: bool) -> Tuple[int, int]:
    """The WKV recurrence: per (b, h, t) 2 Dk Dv for r^T S, 3 Dk Dv for
    w * S + k^T v and 3 Dk + 2 Dv for the bonus; r, k, v read and o written
    in ``dtype``, w (float32) and u read, s0 read (where given) and S_T
    written (float32)."""
    nbytes = (B * H * T * (2 * Dk + 2 * Dv) * dtype.itemsize
              + B * H * T * Dk * 4 + H * Dk * 4
              + (2 if with_s0 else 1) * B * H * Dk * Dv * 4)
    return B * H * T * (5 * Dk * Dv + 3 * Dk + 2 * Dv), nbytes


def rglru_backward(B: int, T: int, D: int, with_h0: bool,
                   with_dhT: bool) -> Tuple[int, int]:
    """The RG-LRU backward over [B, T, D] float32: fifteen operations per
    element (``csrc/rglru_bwd.cu``: the carry's add and product, 1 - a^2,
    its clamp and root, dx, and the seven of da); x, a, y and dy read and
    dx and da written, h0 and dh_T read (where given) and dh0 written."""
    n = B * T * D
    rows = B * D * 4
    return 15 * n, 6 * n * 4 + (1 + int(with_h0) + int(with_dhT)) * rows


def rwkv6_backward(B: int, H: int, T: int, Dk: int, Dv: int,
                   dtype: torch.dtype, with_s0: bool,
                   with_dsT: bool) -> Tuple[int, int]:
    """What the WKV recurrence's gradients need, whatever kernel computes
    them: per (b, h, t) 14 Dk Dv operations (S_{t-1} recomputed once, 3;
    the sums of dr, dk, dv and dw, 2 each; the dS update, 3), 11 Dk and
    4 Dv (the dot do . v once, shared by dr, dk and du; r u, u k and the
    bonus terms of dr, dk and dv; du's product and add). r, k, v and do
    read and dr, dk, dv written in ``dtype``, w read and dw written
    (float32), u read and du written, s0 and dS_T read (where given) and
    ds0 written."""
    n = B * H * T
    state = B * H * Dk * Dv * 4
    nbytes = (n * ((2 * Dk + 2 * Dv) + (2 * Dk + Dv)) * dtype.itemsize
              + n * Dk * 4 * 2 + 2 * H * Dk * 4
              + (1 + int(with_s0) + int(with_dsT)) * state)
    return n * (14 * Dk * Dv + 11 * Dk + 4 * Dv), nbytes


def rwkv6_backward_kernel(B: int, H: int, T: int, Dk: int, Dv: int,
                          dtype: torch.dtype, with_s0: bool, with_dsT: bool,
                          tiles: int, chunk: int) -> Tuple[int, int]:
    """What ``csrc/rwkv6_bwd.cu`` does for :func:`rwkv6_backward`'s work
    under its plan (``tiles`` column tiles of four a thread, a checkpoint
    every ``chunk`` steps: ``kernels/rwkv6.py:backward_plan``), a reading of
    its design beside the bound. With Dv4 the columns padded to a multiple
    of four and P those padded to whole groups of ``tiles`` tiles (the
    columns the threads hold), per (b, h, t): 18 Dk P elementwise
    operations (the state recomputed twice, 3 each; dr's terms 4, dkv's 2,
    the products of dk, dv and dw 1 each, the dS update 3); the sums of dr,
    dk and dw, 3 Dk (3 P / 4 + Dv4 / 4 - 1) adds (three within each tile a
    thread holds, then the tiles in order); dv's, 3 Dk P / 2 within its
    tiles of four rows (each of the two row pairs of a tile adds three) and
    Dv (Dk / 4 - 1) across them; r u once a thread, Dk P / (4 tiles); 3 Dk
    for du (r k, its product with the dot, the add) and 2 Dv for the dot.
    The bytes of :func:`rwkv6_backward` with the per-(b, h) du partials
    written in place of du, and the float32 [Dk, P] checkpoints before
    every chunk but the last, written and read once."""
    n = B * H * T
    dv4 = -(-Dv // 4) * 4
    width = -(-dv4 // (4 * tiles)) * 4 * tiles
    ckpt = B * H * (-(-T // chunk) - 1) * Dk * width * 4
    _, nbytes = rwkv6_backward(B, H, T, Dk, Dv, dtype, with_s0, with_dsT)
    per_step = (18 * Dk * width + 3 * Dk * (3 * width // 4 + dv4 // 4 - 1)
                + 3 * Dk * width // 2 + Dv * (Dk // 4 - 1)
                + Dk * width // (4 * tiles) + 3 * Dk + 2 * Dv)
    return n * per_step, nbytes + (B - 1) * H * Dk * 4 + 2 * ckpt