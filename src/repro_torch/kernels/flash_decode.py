"""ctypes binding of the CUDA ``flash_decode`` kernel
(``csrc/flash_decode.cu``).

Port of the Pallas kernel ``src/repro/kernels/flash_decode.py:
flash_decode``: one new token per query head against a KV cache, reading
q, k and v through their strides; float8_e4m3fn caches are widened
exactly on load (the ``_kv8`` entry points). bf16 runs on the tensor
cores, one block per (256-position chunk of the live range, KV head and
group of up to 16 query heads, batch row), each writing a partial to
float32 scratch that :func:`launch` allocates, then a merge kernel (both
in one C call); float32 runs one CUDA-core block per (KV head, batch
row). A cache cut along its slots over ranks has two more entries, each one
C call: :func:`launch_partial` (``_part``: this rank's chunks' float32
partials) and :func:`launch_merge` (every rank's partials merged in the
whole-cache kernel's chunk order). This module only launches;
:func:`repro_torch.kernels.ops.flash_decode` (and ``ops.
flash_decode_partial`` / ``flash_decode_merge``) are the checked public
wrappers that ``models/model.py`` calls.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build
from .ref import ATTN_CHUNK, MASKED_LOGIT, decode_local_chunks

_P = ctypes.c_void_p
_I = ctypes.c_int
_S2 = ctypes.c_longlong * 2
_S3 = ctypes.c_longlong * 3
_PLL = ctypes.POINTER(ctypes.c_longlong)  # a host array of strides
_ARGTYPES = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float,
             _PLL, _PLL, _PLL]
_FNS = {}


def _fn(q_dtype: torch.dtype, kv_dtype: torch.dtype):
    """The C entry point for q's and the caches' dtypes: ``_f32`` /
    ``_bf16``, with ``_kv8`` for float8_e4m3fn caches."""
    fn = _FNS.get((q_dtype, kv_dtype))
    if fn is None:
        lib = build.load("flash_decode")
        name = ("flash_decode_f32" if q_dtype == torch.float32
                else "flash_decode_bf16")
        if kv_dtype == torch.float8_e4m3fn:
            name += "_kv8"
        fn = getattr(lib, name)
        # bf16: the scratch part_m, part_l, part_acc
        scratch = [] if q_dtype == torch.float32 else [_P, _P, _P]
        fn.argtypes = _ARGTYPES + scratch + [_P]
        fn.restype = ctypes.c_int
        _FNS[q_dtype, kv_dtype] = fn
    return fn


def chunks(S: int) -> int:
    """The bf16 kernel's grid along the cache: the most ATTN_CHUNK-position
    chunks that the live keys of a cache of ``S`` slots can span (the C
    side's ``flash_decode_chunks``)."""
    return (S + ATTN_CHUNK - 2) // ATTN_CHUNK + 1 if S > 0 else 0


def blocks(length: torch.Tensor, end: torch.Tensor, S: int, Hq: int,
           Hkv: int):
    """(launched, working) blocks of the bf16 kernel for ``length`` and
    ``end`` [B]: the grid, and the blocks whose chunk holds live keys (the
    others return at once)."""
    groups = Hkv * -(-(Hq // Hkv) // 16)
    n = length.long().clamp(0, S)
    hi = end.long()
    lo = (hi - n).clamp_min(0)
    count = torch.where(hi > lo, torch.div(hi - 1, ATTN_CHUNK,
                                           rounding_mode="floor")
                        - torch.div(lo, ATTN_CHUNK, rounding_mode="floor")
                        + 1, 0)
    return (chunks(S) * groups * length.shape[0],
            int(count.sum()) * groups)


def scratch(q: torch.Tensor, S: int) -> Optional[torch.Tensor]:
    """The bf16 kernel's float32 partials for q [B, Hq, D] over S cache
    slots (each chunk's running max, sum and D outputs a query head), on
    q's device; ``None`` for float32 q, whose kernel keeps none."""
    if q.dtype != torch.bfloat16:
        return None
    B, Hq, D = q.shape
    return torch.empty(B * Hq * chunks(S) * (2 + D), dtype=torch.float32,
                       device=q.device)


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           length: torch.Tensor, end: torch.Tensor,
           out: torch.Tensor) -> None:
    """Launch the kernel on the current stream: ``out`` [B, Hq, D] (dense)
    gets the attention of ``q`` [B, Hq, D] over the live keys of ``k``/``v``
    [B, Hkv, S, D] (q's dtype or float8_e4m3fn, each read through its
    strides): the last
    n = min(length[b], S) positions before ``end[b]``, position P at slot
    P % S. The caller has checked devices, dtypes, shapes and the unit
    stride along D; raises if the launch reports a CUDA error (also, in
    float32, for a group too wide for the kernel: (Hq / Hkv) x D, D
    rounded up to a power of two >= 32, above 32 x 256)."""
    B, Hq, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    parts = []
    part = scratch(q, S)
    if part is not None:
        n = B * Hq * chunks(S)
        parts = [part.data_ptr(), part[n:].data_ptr(),
                 part[2 * n:].data_ptr()]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _fn(q.dtype, k.dtype)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), length.data_ptr(),
        end.data_ptr(), out.data_ptr(), B, Hq, Hkv, S, D, D ** -0.5,
        _S2(*q.stride()[:2]), _S3(*k.stride()[:3]), _S3(*v.stride()[:3]),
        *parts, stream)
    if err != 0:
        raise RuntimeError(f"flash_decode launch failed: cudaError_t {err}")


def _part_fn(q_dtype: torch.dtype, kv_dtype: torch.dtype):
    """The ``_part`` C entry point for q's and the caches' dtypes."""
    key = ("part", q_dtype, kv_dtype)
    fn = _FNS.get(key)
    if fn is None:
        lib = build.load("flash_decode")
        name = ("flash_decode_f32" if q_dtype == torch.float32
                else "flash_decode_bf16")
        if kv_dtype == torch.float8_e4m3fn:
            name += "_kv8"
        fn = getattr(lib, name + "_part")
        fn.argtypes = ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                        ctypes.c_float, _PLL, _PLL, _PLL, _I, _I, _I, _P, _P,
                        _P, _P])
        fn.restype = ctypes.c_int
        _FNS[key] = fn
    return fn


def launch_partial(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   length: torch.Tensor, end: torch.Tensor, offset: int,
                   slots: int, out: torch.Tensor) -> None:
    """Launch this rank's part on the current stream: ``out`` (float32,
    [m | l | acc] over [B, Hq, decode_local_chunks(slots, L) (, D)]) gets
    the partials of q [B, Hq, D] over ``k``/``v`` [B, Hkv, L, D], slots
    ``offset`` .. ``offset + L - 1`` of a cache of ``slots`` whose live
    keys ``length`` and ``end`` give. The float32 kernel writes one
    partial a row (entry 0): the others are filled empty here first.
    Raises if the launch reports a CUDA error."""
    B, Hq, D = q.shape
    Hkv, L = k.shape[1], k.shape[2]
    K = decode_local_chunks(slots, L)
    n = B * Hq * K
    if q.dtype == torch.float32:
        out[:n].fill_(MASKED_LOGIT)
        out[n:].zero_()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _part_fn(q.dtype, k.dtype)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), length.data_ptr(),
        end.data_ptr(), B, Hq, Hkv, slots, D, D ** -0.5,
        _S2(*q.stride()[:2]), _S3(*k.stride()[:3]), _S3(*v.stride()[:3]),
        offset, L, K, out.data_ptr(), out[n:].data_ptr(),
        out[2 * n:].data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"flash_decode partial launch failed: "
                           f"cudaError_t {err}")


def launch_merge(parts: torch.Tensor, length: torch.Tensor,
                 end: torch.Tensor, slots: int, local_slots: int,
                 out: torch.Tensor) -> None:
    """Launch the merge on the current stream: ``out`` [B, Hq, D] (q's
    dtype) from every rank's partials ``parts`` [ranks, n] (contiguous
    rows, rank order). Raises if the launch reports a CUDA error."""
    B, Hq, D = out.shape
    key = ("merge", out.dtype)
    fn = _FNS.get(key)
    if fn is None:
        lib = build.load("flash_decode")
        fn = getattr(lib, "flash_decode_merge_f32" if out.dtype ==
                     torch.float32 else "flash_decode_merge_bf16")
        fn.argtypes = [_P, ctypes.c_longlong, _I, _I, _P, _P, _P, _I, _I,
                       _I, _I, _I, _P]
        fn.restype = ctypes.c_int
        _FNS[key] = fn
    parts = parts.contiguous()
    err = fn(parts.data_ptr(), parts.stride(0), parts.shape[0],
             decode_local_chunks(slots, local_slots), length.data_ptr(),
             end.data_ptr(), out.data_ptr(), B, Hq, slots, local_slots, D,
             torch.cuda.current_stream(out.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_decode merge launch failed: "
                           f"cudaError_t {err}")
