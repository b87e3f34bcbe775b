"""Checked public wrappers over the port's kernels.

A wrapper takes the plain version (:mod:`.ref`) only for tensors on the
CPU. For CUDA tensors it launches the hand-written kernel or raises; it
never falls back. Each wrapper counts its kernel launches in a plain
integer attribute (``acd_evict.launches``, ``fifo_dispatch.launches``,
``matmul.launches``, ``flash_attention.launches``,
``flash_decode.launches``, ``rglru.launches``, ``rglru_bwd.launches``,
``rwkv6.launches``, ``rwkv6_bwd.launches``), so a run can show that its
main path went through the kernel.

The seven model kernels (``matmul``, ``flash_attention``,
``flash_decode``, ``rglru`` and ``rwkv6`` with their backwards) also take
``meta`` tensors: the dry run's shape-only
path (``launch.dryrun``). There a wrapper checks what the card's kernel
requires (head dims up to ``ATTN_MAX_D``, at most 65535 rows, ``rwkv6``'s
``DK_SIZES``), makes the card's allocations (outputs of the kernel's
shapes and dtypes, ``flash_decode``'s partials) and launches nothing, so
``launches`` counts real launches only; where the card's path shapes the
work (``matmul``'s dW takes x.T copied contiguous in bf16), the meta path
takes the same branch. While a step counter is registered
(``kernels.cost.COUNTERS``) every call reports its kernel's operations
and bytes (:mod:`.cost`): each launch on the card, each meta call, and
each plain version's call on the CPU (whose own aten ops are then not
counted apart). With no counter the card's path tests one empty list.

Serving over a mesh adds two entries to ``flash_decode``'s kernel
(:func:`flash_decode_partial`, :func:`flash_decode_merge`: a cache cut
along its slots, each a launch of ``flash_decode``) and float32 partials
to ``matmul`` (``out_dtype``).

``matmul``, ``flash_attention``, ``rglru`` and ``rwkv6`` are
differentiable: where grad mode is on and an operand requires a gradient
they run as a ``torch.autograd.Function`` whose forward is the same kernel
(or plain version). ``matmul``'s backward is two more ``matmul`` calls
(``dX = dOut @ Y^T``, ``dY = X^T @ dOut``; one where only one operand
needs a gradient), each counted as a launch. ``flash_attention``'s
backward (:func:`flash_attention_backward`) is torch code, the same on
both devices. The recurrences' backwards are kernels of their own
(:func:`rglru_bwd`, :func:`rwkv6_bwd`: the reverse-time recurrences, the
plain loops of ``ref.rglru_backward_plain`` / ``rwkv6_backward_plain`` on
the CPU), one launch per forward in the graph; a CUDA tensor under grad
takes the Function or the call raises, never autograd of a plain loop.
The scheduler's kernels stay outside autograd.
"""
from __future__ import annotations

import threading
from typing import Optional, Tuple

import torch

from . import acd_sweep, cost as _cost, fifo
from . import flash_attention as _fa
from . import flash_decode as _fd
from . import matmul as _mm
from . import rglru as _rg
from . import rwkv6 as _rk
from .ref import (acd_evict_plain, decode_local_chunks, decode_pieces,
                  fifo_dispatch_plain, flash_attention_plain,
                  flash_decode_merge_plain, flash_decode_partial_plain,
                  flash_decode_plain, matmul_plain,
                  rglru_backward_plain, rglru_plain, rwkv6_backward_plain,
                  rwkv6_plain)

_FLOATS = (torch.float64, torch.float32)
#: the counts are bumped from the engine's scenario shards' threads too
_COUNT_LOCK = threading.Lock()
#: the devices the model kernels' wrappers take beside the CPU: the card,
#: and ``meta`` (the dry run's shapes, no kernel launched)
_KERNEL_DEVICES = ("cuda", "meta")


def _counted(fn, *args) -> None:
    """One more launch of ``fn``'s kernel; a model kernel's, on ``args``,
    is reported to any counter counting the step."""
    with _COUNT_LOCK:
        fn.launches += 1
    if args and _cost.COUNTERS:
        _note(fn, *args)


def _note(fn, *args) -> None:
    """One call of ``fn``'s kernel on ``args``, its operations and bytes
    (:mod:`.cost`), reported to the counters; not a launch."""
    with _cost.quiet():
        ops, nbytes = _COSTS[fn.__name__](*args)
    _cost.note_kernel(fn.__name__, ops, nbytes)


def _plain(fn, plain, *args, **kw):
    """``plain(*args, **kw)``, a CPU tensor's kernel, reported to any
    counter as one call of ``fn``'s kernel (its own aten ops are the
    kernel's, not counted apart)."""
    if not _cost.COUNTERS:
        return plain(*args, **kw)
    with _cost.quiet():
        out = plain(*args, **kw)
    _note(fn, *args, *kw.values())
    return out


def _check_acd(P, thresh, mask) -> None:
    for name, x in (("P", P), ("thresh", thresh), ("mask", mask)):
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"acd_evict: {name} must be a torch.Tensor")
        if x.dim() != 2:
            raise ValueError(f"acd_evict: {name} must be 2-D [B, J], "
                             f"got shape {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"acd_evict: {name} must be contiguous")
    if not (P.shape == thresh.shape == mask.shape):
        raise ValueError(
            f"acd_evict: shapes differ: P {tuple(P.shape)}, thresh "
            f"{tuple(thresh.shape)}, mask {tuple(mask.shape)}")
    if not (P.device == thresh.device == mask.device):
        raise ValueError(
            f"acd_evict: devices differ: P {P.device}, thresh "
            f"{thresh.device}, mask {mask.device}")
    if P.dtype not in _FLOATS or thresh.dtype != P.dtype:
        raise TypeError(
            f"acd_evict: P and thresh must both be float64 or both "
            f"float32, got {P.dtype} and {thresh.dtype}")
    if mask.dtype != torch.bool:
        raise TypeError(f"acd_evict: mask must be bool, got {mask.dtype}")


def acd_evict(P: torch.Tensor, thresh: torch.Tensor,
              mask: torch.Tensor) -> torch.Tensor:
    """Greedy ACD evict mask per queue row: [B, J] ``P``, ``thresh``
    (float64 or float32, the same for both) and bool ``mask`` -> [B, J]
    bool. CPU tensors run :func:`.ref.acd_evict_plain`; CUDA tensors run
    the CUDA kernel (``csrc/acd_evict.cu``)."""
    _check_acd(P, thresh, mask)
    if P.device.type == "cpu":
        return acd_evict_plain(P, thresh, mask)
    if P.device.type != "cuda":
        raise ValueError(f"acd_evict: no kernel for device {P.device}")
    out = torch.empty(P.shape, dtype=torch.bool, device=P.device)
    acd_sweep.launch(P, thresh, mask, out)
    _counted(acd_evict)
    return out


acd_evict.launches = 0


def _check_fifo(order, n_pub, ready, dur, selc, occ, seg, capped, wu, sclk0,
                sidle0, keep_alive) -> None:
    args = dict(order=order, n_pub=n_pub, ready=ready, dur=dur, selc=selc,
                occ=occ, seg=seg, capped=capped, wu=wu, sclk0=sclk0,
                sidle0=sidle0)
    for name, x in args.items():
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"fifo_dispatch: {name} must be a torch.Tensor")
        if not x.is_contiguous():
            raise ValueError(f"fifo_dispatch: {name} must be contiguous")
        if x.device != ready.device:
            raise ValueError(f"fifo_dispatch: {name} is on {x.device}, "
                             f"ready on {ready.device}")
    if ready.dim() != 3 or sclk0.dim() != 3:
        raise ValueError("fifo_dispatch: ready must be [B, P, J] and sclk0 "
                         "[B, P, C]")
    B, P, J = ready.shape
    C = sclk0.shape[2]
    want = dict(order=((B, J), torch.int32), n_pub=((B,), torch.int32),
                ready=((B, P, J), torch.float64),
                dur=((B, P, J), torch.float64),
                selc=((B, P, J), torch.float64),
                occ=((B, P, J), torch.float64), seg=((B, P, J), torch.int32),
                capped=((P,), torch.bool), wu=((P,), torch.float64),
                sclk0=((B, P, C), torch.float64),
                sidle0=((B, P, C), torch.float64))
    for name, (shape, dtype) in want.items():
        x = args[name]
        if tuple(x.shape) != shape:
            raise ValueError(f"fifo_dispatch: {name} must have shape "
                             f"{shape}, got {tuple(x.shape)}")
        if x.dtype != dtype:
            raise TypeError(f"fifo_dispatch: {name} must be {dtype}, got "
                            f"{x.dtype}")
    if P < 1 or C < 1:
        raise ValueError(f"fifo_dispatch: needs P >= 1 and C >= 1, got "
                         f"P={P}, C={C}")
    if not isinstance(keep_alive, (int, float)):
        raise TypeError("fifo_dispatch: keep_alive must be a number")


def fifo_dispatch(order: torch.Tensor, n_pub: torch.Tensor,
                  ready: torch.Tensor, dur: torch.Tensor, selc: torch.Tensor, occ: torch.Tensor,
                  seg: torch.Tensor, capped: torch.Tensor, wu: torch.Tensor,
                  sclk0: torch.Tensor, sidle0: torch.Tensor,
                  keep_alive: float, *, cold: bool = False):
    """Capped FIFO public-dispatch chain of one stage for B scenario rows:
    ``order`` [B, J] int32 (public jobs first), ``n_pub`` [B] int32,
    ``ready``/``dur``/``selc``/``occ`` [B, P, J] float64, ``seg``
    [B, P, J] int32, ``capped`` [P] bool, ``wu`` [P] float64,
    ``sclk0``/``sidle0`` [B, P, C] float64 -> (prov, seg, wait, cold,
    start, end, extra), each [B, J]. CPU tensors run
    :func:`.ref.fifo_dispatch_plain`; CUDA tensors run the CUDA kernel
    (``csrc/fifo_dispatch.cu``)."""
    _check_fifo(order, n_pub, ready, dur, selc, occ, seg, capped, wu, sclk0,
                sidle0, keep_alive)
    if ready.device.type == "cpu":
        return fifo_dispatch_plain(order, n_pub, ready, dur, selc, occ, seg,
                                   capped, wu, sclk0, sidle0,
                                   float(keep_alive), cold=bool(cold))
    if ready.device.type != "cuda":
        raise ValueError(f"fifo_dispatch: no kernel for device "
                         f"{ready.device}")
    B, _, J = ready.shape
    dev = ready.device
    outs = tuple(torch.empty((B, J), dtype=dt, device=dev) for dt in (
        torch.int32, torch.int32, torch.float64, torch.bool, torch.float64,
        torch.float64, torch.float64))
    fifo.launch(order, n_pub, ready, dur, selc, occ, seg, capped, wu, sclk0,
                sidle0, float(keep_alive), bool(cold), outs)
    _counted(fifo_dispatch)
    return outs


fifo_dispatch.launches = 0


_MATMUL_DTYPES = (torch.float32, torch.bfloat16)


def _check_matmul(x, y) -> None:
    for name, t in (("x", x), ("y", y)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"matmul: {name} must be a torch.Tensor")
        if t.dim() != 2:
            raise ValueError(f"matmul: {name} must be 2-D, got shape "
                             f"{tuple(t.shape)}")
    if x.shape[1] != y.shape[0]:
        raise ValueError(f"matmul: inner sizes differ: x {tuple(x.shape)}, "
                         f"y {tuple(y.shape)}")
    if x.device != y.device:
        raise ValueError(f"matmul: devices differ: x {x.device}, y "
                         f"{y.device}")
    if x.dtype not in _MATMUL_DTYPES or y.dtype != x.dtype:
        raise TypeError(f"matmul: x and y must both be float32 or both "
                        f"bfloat16, got {x.dtype} and {y.dtype}")


def _grad_wanted(*xs) -> bool:
    """Grad mode is on and one of ``xs`` (tensors or ``None``) needs a
    gradient."""
    return torch.is_grad_enabled() and any(
        x is not None and x.requires_grad for x in xs)


def matmul(x: torch.Tensor, y: torch.Tensor,
           out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x`` [M, K] @ ``y`` [K, N] with float32 accumulation, in
    ``x.dtype`` (float32, or bfloat16 for both), or with ``out_dtype``
    float32 the float32 sums themselves (a row-parallel product's
    partials; bf16 operands' rounded once where they are summed, not once
    a rank). Any strides are taken (``x.T`` is passed as a view). CPU
    tensors run :func:`.ref.matmul_plain`; CUDA tensors run the CUDA
    kernel (``csrc/matmul.cu``). Differentiable (:class:`_MatmulFn`) where
    grad mode is on and an operand requires a gradient (``x.dtype``
    out)."""
    _check_matmul(x, y)
    if out_dtype not in (None, x.dtype, torch.float32):
        raise TypeError(f"matmul: out_dtype must be {x.dtype} or float32, "
                        f"got {out_dtype}")
    if out_dtype == x.dtype:
        out_dtype = None
    if _grad_wanted(x, y):
        if out_dtype is not None:
            raise ValueError("matmul: float32 partials take no gradient")
        return _MatmulFn.apply(x, y)
    return _matmul(x, y, out_dtype)


def _left_operand(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the bf16 kernel's left operand on the card: a contiguous
    copy where its rows are not unit-stride (``x.T`` of a row-major x),
    which TMA does not take and the kernel would stage by threads (PERF.md
    §6: many times slower)."""
    if t.device.type in _KERNEL_DEVICES and t.dtype == torch.bfloat16 \
            and t.stride(1) != 1:
        return t.contiguous()
    return t


class _MatmulFn(torch.autograd.Function):
    """``out = X @ Y`` through :func:`_matmul`; backward ``dX = dOut @
    Y^T`` and ``dY = X^T @ dOut``, two more :func:`_matmul` calls (each a
    launch on the card) with float32 accumulation and the result in the
    operand's dtype, only for the operands that need a gradient (a norm's
    row mean multiplies by a constant column: one)."""

    @staticmethod
    def forward(ctx, x, y):
        need_x, need_y = ctx.needs_input_grad
        ctx.save_for_backward(x if need_y else None, y if need_x else None)
        return _matmul(x, y)

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        g = g.contiguous()  # an expanded or transposed incoming gradient
        dx = dy = None
        if ctx.needs_input_grad[0]:
            dx = _matmul(g, y.T)
        if ctx.needs_input_grad[1]:
            dy = _matmul(_left_operand(x.T), g)
        return dx, dy


def _matmul(x: torch.Tensor, y: torch.Tensor,
            out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """:func:`matmul` on checked operands, outside autograd (``out_dtype``
    None: x's)."""
    dev = x.device.type
    more = () if out_dtype is None else (out_dtype,)
    if dev == "cpu":
        return _plain(matmul, matmul_plain, x, y, *more)
    if dev not in _KERNEL_DEVICES:
        raise ValueError(f"matmul: no kernel for device {x.device}")
    out = torch.empty((x.shape[0], y.shape[1]), dtype=out_dtype or x.dtype,
                      device=x.device)
    if out.numel() == 0:
        return out
    if dev == "meta":
        _note(matmul, x, y, *more)
    else:
        _mm.launch(x, y, out)
        _counted(matmul, x, y, *more)
    return out


matmul.launches = 0


_ATTN_DTYPES = (torch.float32, torch.bfloat16)
#: the attention kernels take head dims up to this (llama 128,
#: recurrentgemma 256)
ATTN_MAX_D = 256


def _check_attn(name, q, k, v, q_dims, kv8=False) -> None:
    """q has ``q_dims`` dims ([B, Hq, (Sq,) D]), k and v [B, Hkv, S, D]:
    one device, one dtype (float32 or bfloat16; with ``kv8`` also k and v
    both ``float8_e4m3fn`` under either q), Hq a multiple of Hkv, a unit
    stride along D."""
    _check_tensors(name, q=q, k=k, v=v)
    if q.dim() != q_dims or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{name}: q must be {q_dims}-D and k, v 4-D, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if k.shape != v.shape:
        raise ValueError(f"{name}: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} differ")
    B, Hq, D = q.shape[0], q.shape[1], q.shape[-1]
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"{name}: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} differ in batch or head dim")
    Hkv = k.shape[1]
    if Hkv < 1 or Hq % Hkv != 0:
        raise ValueError(f"{name}: Hq={Hq} is not a multiple of Hkv={Hkv}")
    kv_ok = k.dtype == v.dtype and (k.dtype == q.dtype or (
        kv8 and k.dtype == torch.float8_e4m3fn))
    if q.dtype not in _ATTN_DTYPES or not kv_ok:
        also = (" (or k and v both float8_e4m3fn)" if kv8 else "")
        raise TypeError(f"{name}: q, k and v must all be float32 or all "
                        f"bfloat16{also}, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    for arg, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1 and t.shape[-1] > 1:
            raise ValueError(f"{name}: {arg} must have a unit stride along "
                             f"its last dimension")
    if q.device.type in _KERNEL_DEVICES and not 1 <= D <= ATTN_MAX_D:
        raise ValueError(f"{name}: the kernel takes head dims 1..{ATTN_MAX_D}"
                         f", got D={D}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """Prefill attention with an online softmax: ``q`` [B, Hq, Sq, D],
    ``k``/``v`` [B, Hkv, Sk, D] (float32 or bfloat16, any strides with a
    unit last one), query positions right-aligned to ``Sk - Sq``, causal
    and sliding-window masks, GQA by ``h // (Hq / Hkv)``, scores scaled by
    ``D^-0.5`` after the dot; a row with no live key gives zeros -> [B, Hq,
    Sq, D] in ``q.dtype`` (``q``'s strides when dense). CPU tensors run
    :func:`.ref.flash_attention_plain`; CUDA tensors run the CUDA kernel
    (``csrc/flash_attention.cu``)."""
    _check_attn("flash_attention", q, k, v, 4)
    if window is not None and (isinstance(window, bool)
                               or not isinstance(window, int)
                               or window < 1):
        raise ValueError(f"flash_attention: window must be None or an int "
                         f">= 1, got {window!r}")
    causal = bool(causal)
    if _grad_wanted(q, k, v):
        return _FlashAttentionFn.apply(q, k, v, causal, window)
    return _flash_attention(q, k, v, causal, window)


class _FlashAttentionFn(torch.autograd.Function):
    """:func:`flash_attention` with its backward,
    :func:`flash_attention_backward` (torch code on either device)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        out = _flash_attention(q, k, v, causal, window)
        ctx.save_for_backward(q, k, v, out)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, out, dout,
                                              causal=ctx.causal,
                                              window=ctx.window)
        return dq, dk, dv, None, None


#: float32 scores [B, Hq, rows, Sk] the backward holds per query chunk (at
#: most; one row at the least): 256 MiB, four such tensors live at once
BWD_SCORE_ELEMS = 1 << 26


def flash_attention_backward(q, k, v, out, dout, *, causal: bool = True,
                             window: Optional[int] = None):
    """Gradients (dq, dk, dv) of :func:`flash_attention` at ``dout``, in
    the inputs' dtypes, computed in float32 from ``out``: over chunks of
    query rows (every batch row and head at once) the scores ``(q . k) *
    D^-0.5`` and probabilities are recomputed with the kernel's masks
    (causal, window, queries right-aligned to ``Sk - Sq``; a row with no
    live key has p = 0), then ``dV += P^T dO``, ``dS = P * (dO V^T -
    rowsum(dO * O)) * D^-0.5``, ``dQ = dS K`` and ``dK += dS^T Q``, dK and
    dV summed over each GQA group. The reference trains through XLA's
    autodiff of its chunked attention; no kernel has a backward."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = d ** -0.5
    dev = q.device
    qf = q.float().reshape(b, hkv, g, sq, d)
    kf, vf = k.float(), v.float()
    dof = dout.float().reshape(b, hkv, g, sq, d)
    delta = (dof * out.float().reshape(b, hkv, g, sq, d)).sum(-1)
    dq = torch.empty_like(qf)
    dk = torch.zeros((b, hkv, sk, d), dtype=torch.float32, device=dev)
    dv = torch.zeros_like(dk)
    kpos = torch.arange(sk, device=dev)
    rows = max(1, BWD_SCORE_ELEMS // max(b * hq * sk, 1))
    for r0 in range(0, sq, rows):
        r1 = min(sq, r0 + rows)
        qc, doc = qf[:, :, :, r0:r1], dof[:, :, :, r0:r1]
        qpos = torch.arange(r0, r1, device=dev)[:, None] + (sk - sq)
        live = torch.ones((r1 - r0, sk), dtype=torch.bool, device=dev)
        if causal:
            live = live & (kpos <= qpos)
        if window is not None:
            live = live & (kpos > qpos - window)
        s = torch.einsum("bhgrd,bhkd->bhgrk", qc, kf) * scale
        s = s.masked_fill(~live, float("-inf"))
        m = s.amax(-1, keepdim=True)
        p = torch.exp(s - torch.where(torch.isfinite(m), m, 0.0))
        den = p.sum(-1, keepdim=True)
        p = p / torch.where(den == 0.0, 1.0, den)
        dv += torch.einsum("bhgrk,bhgrd->bhkd", p, doc)
        dp = torch.einsum("bhgrd,bhkd->bhgrk", doc, vf)
        ds = p * (dp - delta[:, :, :, r0:r1, None]) * scale
        dq[:, :, :, r0:r1] = torch.einsum("bhgrk,bhkd->bhgrd", ds, kf)
        dk += torch.einsum("bhgrk,bhgrd->bhkd", ds, qc)
    return (dq.reshape(b, hq, sq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _flash_attention(q, k, v, causal: bool,
                     window: Optional[int]) -> torch.Tensor:
    """:func:`flash_attention` on checked operands, outside autograd."""
    dev = q.device.type
    if dev == "cpu":
        return _plain(flash_attention, flash_attention_plain, q, k, v,
                      causal=causal, window=window)
    if dev not in _KERNEL_DEVICES:
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    if q.shape[0] > 65535 or q.shape[1] > 65535:
        raise ValueError("flash_attention: the kernel takes at most 65535 "
                         "batch rows and heads")
    out = torch.empty_like(q)  # q's strides when dense, else contiguous
    if out.numel() == 0:
        return out
    if dev == "meta":
        _note(flash_attention, q, k, v, causal, window)
    else:
        _fa.launch(q, k, v, out, causal, window)
        _counted(flash_attention, q, k, v, causal, window)
    return out


flash_attention.launches = 0


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 length: torch.Tensor,
                 end: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One new token per query head against a KV cache: ``q`` [B, Hq, D],
    ``k``/``v`` [B, Hkv, S, D] (q's dtype, float32 or bfloat16, or both
    ``float8_e4m3fn``, widened exactly on load; any strides with a unit
    last one), ``length`` [B] int32 on q's device: row b has n =
    min(length[b], S) live keys, cache slots 0 .. n-1 (the TPU kernel's
    mask), or with ``end`` [B] int32 the key positions ``end[b] - n`` ..
    ``end[b] - 1``, position P at slot P % S (the model's rolling cache,
    walked in position order); a row with n = 0 gives zeros -> [B, Hq, D]
    in ``q.dtype``. CPU tensors run :func:`.ref.flash_decode_plain`; CUDA
    tensors run the CUDA kernel (``csrc/flash_decode.cu``)."""
    _check_attn("flash_decode", q, k, v, 3, kv8=True)
    _check_decode_ints(q, length, end)
    dev = q.device.type
    if dev == "cpu":
        return _plain(flash_decode, flash_decode_plain, q, k, v, length, end)
    if dev not in _KERNEL_DEVICES:
        raise ValueError(f"flash_decode: no kernel for device {q.device}")
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    if end is None:  # the first n = min(length, S) slots: positions 0..n-1
        end = length.clamp(0, k.shape[2])
    if dev == "meta":
        _fd.scratch(q, k.shape[2])  # the card's partials, for the memory
        _note(flash_decode, q, k, v, length)
    else:
        _fd.launch(q, k, v, length.contiguous(), end.contiguous(), out)
        _counted(flash_decode, q, k, v, length)
    return out


flash_decode.launches = 0


def _check_decode_ints(q, length, end) -> None:
    ints = dict(length=length) if end is None else dict(length=length,
                                                        end=end)
    _check_tensors("flash_decode", q=q, **ints)
    for arg, t in ints.items():
        if t.dtype != torch.int32 or tuple(t.shape) != (q.shape[0],):
            raise TypeError(f"flash_decode: {arg} must be int32 [B] = "
                            f"[{q.shape[0]}], got {t.dtype} "
                            f"{tuple(t.shape)}")


def flash_decode_partial(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         length: torch.Tensor, end: Optional[torch.Tensor],
                         offset: int, slots: int) -> torch.Tensor:
    """:func:`flash_decode`'s part on one rank of a cache cut along its
    slots: ``k``/``v`` [B, Hkv, L, D] are slots ``offset`` .. ``offset +
    L - 1`` of the whole cache's ``slots``; q, ``length`` and ``end`` as
    :func:`flash_decode` takes them for the whole cache. Returns this
    rank's float32 partials of every query head, packed [m | l | acc]
    over [B, Hq, ref.decode_local_chunks(slots, L) (, D)]: one for each
    chunk of the whole-cache kernel that meets these slots, in chunk
    order (:func:`.ref.flash_decode_partial_plain`), which
    :func:`flash_decode_merge` takes from every rank. bf16 q on the card
    computes each chunk as the whole-cache kernel does; float32 q's kernel
    keeps one partial of all of this rank's keys (its first entry; the
    rest empty). One launch of ``flash_decode``."""
    _check_attn("flash_decode", q, k, v, 3, kv8=True)
    _check_decode_ints(q, length, end)
    L = k.shape[2]
    if not (0 <= offset and offset + L <= slots):
        raise ValueError(f"flash_decode: slots {offset} .. {offset + L - 1} "
                         f"are not in a cache of {slots}")
    dev = q.device.type
    if dev == "cpu":
        out = _plain_quiet(flash_decode_partial_plain, q, k, v, length, end,
                           offset, slots)
        _note_partial(q, k, length, end, offset, slots)
        return out
    if dev not in _KERNEL_DEVICES:
        raise ValueError(f"flash_decode: no kernel for device {q.device}")
    n = q.shape[0] * q.shape[1] * decode_local_chunks(slots, L)
    out = torch.empty(n * (2 + q.shape[2]), dtype=torch.float32,
                      device=q.device)
    if end is None:
        end = length.clamp(0, slots)
    if dev == "meta":
        _note_partial(q, k, length, end, offset, slots)
    else:
        _fd.launch_partial(q, k, v, length.contiguous(), end.contiguous(),
                           offset, slots, out)
        with _COUNT_LOCK:
            flash_decode.launches += 1
        if _cost.COUNTERS:
            _note_partial(q, k, length, end, offset, slots)
    return out


def flash_decode_merge(parts: torch.Tensor, q: torch.Tensor,
                       length: torch.Tensor, end: Optional[torch.Tensor],
                       slots: int, local_slots: int,
                       kv_heads: int) -> torch.Tensor:
    """The attention of q [B, Hq, D] over a cache of ``slots`` slots cut
    into runs of ``local_slots`` along them, rank r holding run r, from
    every rank's :func:`flash_decode_partial` (``parts`` [ranks, n],
    float32, rank order): each row's chunks merged in the whole-cache
    kernel's chunk order, the pieces of one chunk in rank order -> [B,
    Hq, D] in q's dtype. Where ``slots`` and ``local_slots`` are
    multiples of 256 every chunk lies on one rank and a bf16 q gets the
    whole-cache kernel's result bit for bit (:func:`.ref.
    flash_decode_merge_plain` its plain version's, of any dtype); else
    the pieces of a split chunk are summed in that order. ``kv_heads``:
    the cache's KV heads (the plain version's row blocks). One launch of
    ``flash_decode``."""
    _check_decode_ints(q, length, end)
    K = decode_local_chunks(slots, local_slots)
    B, Hq, D = q.shape
    if (parts.dim() != 2 or parts.dtype != torch.float32
            or parts.shape[1] != B * Hq * K * (2 + D)
            or parts.device != q.device
            or parts.shape[0] * local_slots != slots):
        raise ValueError(f"flash_decode: parts {parts.dtype} "
                         f"{tuple(parts.shape)} are not [{slots} // "
                         f"{local_slots}, {B * Hq * K * (2 + D)}] float32 "
                         f"partials")
    if q.dtype not in _ATTN_DTYPES or Hq % kv_heads:
        raise TypeError(f"flash_decode: q {q.dtype} with {Hq} heads over "
                        f"{kv_heads} KV heads")
    dev = q.device.type
    if dev == "cpu":
        out = _plain_quiet(flash_decode_merge_plain, parts, q, length, end,
                           slots, local_slots, kv_heads)
        _note_merge(q, length, end, slots, local_slots)
        return out
    if dev not in _KERNEL_DEVICES:
        raise ValueError(f"flash_decode: no kernel for device {q.device}")
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if end is None:
        end = length.clamp(0, slots)
    if dev == "meta":
        _note_merge(q, length, end, slots, local_slots)
    else:
        _fd.launch_merge(parts, length.contiguous(), end.contiguous(),
                         slots, local_slots, out)
        with _COUNT_LOCK:
            flash_decode.launches += 1
        if _cost.COUNTERS:
            _note_merge(q, length, end, slots, local_slots)
    return out


def _plain_quiet(plain, *args):
    """``plain(*args)`` with its own aten ops out of any counter."""
    if not _cost.COUNTERS:
        return plain(*args)
    with _cost.quiet():
        return plain(*args)


def _note_partial(q, k, length, end, offset, slots) -> None:
    """A partial's work (its rank's live slots and the pieces that hold
    them: every slot of its run on ``meta``, as the whole-cache call
    counts them) to the counters."""
    if not _cost.COUNTERS:
        return
    L = k.shape[2]
    with _cost.quiet():
        if length.device.type == "meta":
            live = q.shape[0] * L
        else:
            live = _local_live(length, end, offset, L, slots)
        pieces = decode_pieces(length, end, slots, L, (offset,))
    _cost.note_kernel("flash_decode", *_cost.flash_decode_partial(
        q.shape, k.shape[1], q.dtype, k.dtype, live, pieces))


def _note_merge(q, length, end, slots, local_slots) -> None:
    """The merge's work (the pieces of every rank's run that hold live
    keys) to the counters."""
    if not _cost.COUNTERS:
        return
    with _cost.quiet():
        pieces = decode_pieces(length, end, slots, local_slots,
                               range(0, slots, local_slots))
    _cost.note_kernel("flash_decode", *_cost.flash_decode_merge(
        q.shape, q.dtype, pieces))


def _local_live(length, end, offset, L, S) -> int:
    """The live positions of every row whose slot is in offset .. offset
    + L - 1 (position P at slot P % S)."""
    n = length.long().clamp(0, S)
    hi = n if end is None else end.long()
    lo = (hi - n).clamp_min(0)
    pos = torch.arange(S, device=length.device)
    # slot s holds the live position of the row's window that is s mod S
    p = lo[:, None] + torch.remainder(pos[None] - lo[:, None], S)
    slot_live = p < hi[:, None]
    return int(slot_live[:, offset:offset + L].sum())


def _check_tensors(name, **xs) -> torch.device:
    """Every argument is a tensor, all on one device (returned)."""
    dev = None
    for arg, x in xs.items():
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name}: {arg} must be a torch.Tensor")
        if dev is None:
            dev = x.device
        elif x.device != dev:
            raise ValueError(f"{name}: {arg} is on {x.device}, the first "
                             f"argument on {dev}")
    return dev


def _check_rglru(x, a, h0) -> None:
    xs = dict(x=x, a=a) if h0 is None else dict(x=x, a=a, h0=h0)
    _check_tensors("rglru", **xs)
    if x.dim() != 3 or x.numel() == 0:
        raise ValueError(f"rglru: x must be a non-empty [B, T, D], got "
                         f"shape {tuple(x.shape)}")
    B, _, D = x.shape
    want = dict(x=tuple(x.shape), a=tuple(x.shape), h0=(B, D))
    for arg, t in xs.items():
        if tuple(t.shape) != want[arg]:
            raise ValueError(f"rglru: {arg} must have shape {want[arg]}, "
                             f"got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"rglru: {arg} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"rglru: {arg} must be contiguous")
    if x.device.type in _KERNEL_DEVICES and B > 65535:
        raise ValueError(f"rglru: the kernel takes at most 65535 rows, got "
                         f"B={B}")


def rglru(x: torch.Tensor, a: torch.Tensor,
          h0: Optional[torch.Tensor] = None
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RG-LRU scan ``h_t = a_t h_{t-1} + sqrt(max(1 - a_t^2, 0)) x_t`` over
    ``x``, ``a`` [B, T, D] float32 (contiguous) from ``h0`` [B, D] float32
    (zeros when ``None``) -> (y [B, T, D] float32, h_T [B, D] float32).
    CPU tensors run :func:`.ref.rglru_plain`; CUDA tensors run the CUDA
    kernel (``csrc/rglru.cu``). Differentiable (:class:`_RGLRUFn`, its
    backward :func:`rglru_bwd`) where grad mode is on and an operand
    requires a gradient."""
    _check_rglru(x, a, h0)
    if _grad_wanted(x, a, h0):
        return _RGLRUFn.apply(x, a, h0)
    return _rglru(x, a, h0)


class _RGLRUFn(torch.autograd.Function):
    """:func:`rglru` with its backward, :func:`rglru_bwd` (a launch of the
    backward kernel on the card): the forward saves its inputs and y, and
    an unused h_T's gradient reaches the backward as ``None``."""

    @staticmethod
    def forward(ctx, x, a, h0):
        ctx.set_materialize_grads(False)
        y, hT = _rglru(x, a, h0)
        ctx.save_for_backward(x, a, h0, y)
        return y, hT

    @staticmethod
    def backward(ctx, dy, dhT):
        x, a, h0, y = ctx.saved_tensors
        dy = torch.zeros_like(y) if dy is None else dy.contiguous()
        dx, da, dh0 = rglru_bwd(x, a, y, dy, h0,
                                None if dhT is None else dhT.contiguous())
        need = ctx.needs_input_grad
        return (dx if need[0] else None, da if need[1] else None,
                dh0 if need[2] else None)


def _rglru(x, a, h0) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`rglru` on checked operands, outside autograd."""
    dev = x.device.type
    if dev == "cpu":
        return _plain(rglru, rglru_plain, x, a, h0)
    if dev not in _KERNEL_DEVICES:
        raise ValueError(f"rglru: no kernel for device {x.device}")
    y = torch.empty_like(x)
    hT = torch.empty((x.shape[0], x.shape[2]), dtype=torch.float32,
                     device=x.device)
    if dev == "meta":
        _note(rglru, x, a, h0)
    else:
        _rg.launch(x, a, h0, y, hT)
        _counted(rglru, x, a, h0)
    return y, hT


rglru.launches = 0


def _check_rglru_bwd(x, a, y, dy, h0, dhT) -> None:
    _check_rglru(x, a, h0)
    xs = dict(x=x, y=y, dy=dy) if dhT is None else dict(x=x, y=y, dy=dy,
                                                        dhT=dhT)
    _check_tensors("rglru_bwd", **xs)
    B, _, D = x.shape
    for arg, t in xs.items():
        want = (B, D) if arg == "dhT" else tuple(x.shape)
        if tuple(t.shape) != want:
            raise ValueError(f"rglru_bwd: {arg} must have shape {want}, got "
                             f"{tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"rglru_bwd: {arg} must be float32, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"rglru_bwd: {arg} must be contiguous")


def rglru_bwd(x: torch.Tensor, a: torch.Tensor, y: torch.Tensor,
              dy: torch.Tensor, h0: Optional[torch.Tensor] = None,
              dhT: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients of :func:`rglru` at ``dy`` (of y) and ``dhT`` (of h_T,
    zeros when ``None``): ``x``, ``a``, its output ``y`` and ``dy`` [B, T,
    D], ``h0`` and ``dhT`` [B, D], all float32 and contiguous -> (dx, da
    [B, T, D], dh0 [B, D]), float32. CPU tensors run
    :func:`.ref.rglru_backward_plain`; CUDA tensors run the CUDA kernel
    (``csrc/rglru_bwd.cu``)."""
    _check_rglru_bwd(x, a, y, dy, h0, dhT)
    dev = x.device.type
    if dev == "cpu":
        return _plain(rglru_bwd, rglru_backward_plain, x, a, y, dy, h0, dhT)
    if dev not in _KERNEL_DEVICES:
        raise ValueError(f"rglru_bwd: no kernel for device {x.device}")
    dx, da = torch.empty_like(x), torch.empty_like(a)
    dh0 = torch.empty((x.shape[0], x.shape[2]), dtype=torch.float32,
                      device=x.device)
    if dev == "meta":
        _note(rglru_bwd, x, a, y, dy, h0, dhT)
    else:
        _rg.launch_backward(x, a, y, dy, h0, dhT, dx, da, dh0)
        _counted(rglru_bwd, x, a, y, dy, h0, dhT)
    return dx, da, dh0


rglru_bwd.launches = 0


_RWKV_DTYPES = (torch.float32, torch.bfloat16)


def _check_rwkv6(r, k, v, w, u, s0) -> None:
    xs = dict(r=r, k=k, v=v, w=w, u=u)
    if s0 is not None:
        xs["s0"] = s0
    dev = _check_tensors("rwkv6", **xs)
    if r.dim() != 4 or v.dim() != 4 or r.numel() == 0 or v.numel() == 0:
        raise ValueError(f"rwkv6: r and v must be non-empty [B, H, T, D], "
                         f"got {tuple(r.shape)} and {tuple(v.shape)}")
    B, H, T, Dk = r.shape
    Dv = v.shape[-1]
    want = dict(r=(B, H, T, Dk), k=(B, H, T, Dk), v=(B, H, T, Dv),
                w=(B, H, T, Dk), u=(H, Dk), s0=(B, H, Dk, Dv))
    for arg, t in xs.items():
        if tuple(t.shape) != want[arg]:
            raise ValueError(f"rwkv6: {arg} must have shape {want[arg]}, "
                             f"got {tuple(t.shape)}")
    if r.dtype not in _RWKV_DTYPES or k.dtype != r.dtype \
            or v.dtype != r.dtype:
        raise TypeError(f"rwkv6: r, k and v must all be float32 or all "
                        f"bfloat16, got {r.dtype}, {k.dtype}, {v.dtype}")
    for arg in ("w", "u", "s0"):
        if arg in xs and xs[arg].dtype != torch.float32:
            raise TypeError(f"rwkv6: {arg} must be float32, got "
                            f"{xs[arg].dtype}")
    for arg in ("r", "k", "v", "w"):
        if xs[arg].stride(-1) != 1:
            raise ValueError(f"rwkv6: {arg} must have a unit stride along "
                             f"its last dimension")
    for arg in ("u", "s0"):
        if arg in xs and not xs[arg].is_contiguous():
            raise ValueError(f"rwkv6: {arg} must be contiguous")
    if dev.type in _KERNEL_DEVICES and (Dk not in _rk.DK_SIZES
                                        or Dv > _rk.MAX_DV):
        raise ValueError(f"rwkv6: the kernel takes Dk in {_rk.DK_SIZES} "
                         f"and Dv <= {_rk.MAX_DV}, got Dk={Dk}, Dv={Dv}")


def rwkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          w: torch.Tensor, u: torch.Tensor,
          s0: Optional[torch.Tensor] = None
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RWKV-6 WKV recurrence: ``r``, ``k``, ``w`` [B, H, T, Dk], ``v``
    [B, H, T, Dv] (``r``/``k``/``v`` float32 or bfloat16, ``w`` float32;
    any strides with a unit last one, so head-split views pass without a
    copy), ``u`` [H, Dk] and ``s0`` [B, H, Dk, Dv] float32 (zeros when
    ``None``) -> (o [B, H, T, Dv] in ``v.dtype``, S_T [B, H, Dk, Dv]
    float32). CPU tensors run :func:`.ref.rwkv6_plain`; CUDA tensors run
    the CUDA kernel (``csrc/rwkv6.cu``), whose ``o`` has the strides of
    ``v``. Differentiable (:class:`_RWKV6Fn`, its backward
    :func:`rwkv6_bwd`) where grad mode is on and an operand requires a
    gradient."""
    _check_rwkv6(r, k, v, w, u, s0)
    if _grad_wanted(r, k, v, w, u, s0):
        return _RWKV6Fn.apply(r, k, v, w, u, s0)
    return _rwkv6(r, k, v, w, u, s0)


class _RWKV6Fn(torch.autograd.Function):
    """:func:`rwkv6` with its backward, :func:`rwkv6_bwd` (a launch of the
    backward kernel on the card, which recomputes the states itself): the
    forward saves only its inputs, and an unused S_T's gradient reaches the
    backward as ``None``."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0):
        ctx.set_materialize_grads(False)
        o, sT = _rwkv6(r, k, v, w, u, s0)
        ctx.save_for_backward(r, k, v, w, u, s0)
        return o, sT

    @staticmethod
    def backward(ctx, do, dsT):
        r, k, v, w, u, s0 = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(v)
        elif do.stride(-1) != 1:
            do = do.contiguous()
        grads = rwkv6_bwd(r, k, v, w, u, do, s0,
                          None if dsT is None else dsT.contiguous())
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad))


def _rwkv6(r, k, v, w, u, s0) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`rwkv6` on checked operands, outside autograd."""
    dev = r.device.type
    if dev == "cpu":
        return _plain(rwkv6, rwkv6_plain, r, k, v, w, u, s0)
    if dev not in _KERNEL_DEVICES:
        raise ValueError(f"rwkv6: no kernel for device {r.device}")
    B, H, _, Dk = r.shape
    o = torch.empty_like(v)  # v's strides when dense, else contiguous
    sT = torch.empty((B, H, Dk, v.shape[-1]), dtype=torch.float32,
                     device=r.device)
    if dev == "meta":
        _note(rwkv6, r, k, v, w, u, s0)
    else:
        _rk.launch(r, k, v, w, u, s0, o, sT)
        _counted(rwkv6, r, k, v, w, u, s0)
    return o, sT


rwkv6.launches = 0


def rwkv6_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor, do: torch.Tensor,
              s0: Optional[torch.Tensor] = None,
              dsT: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, ...]:
    """Gradients of :func:`rwkv6` at ``do`` (of o: ``v``'s shape and dtype,
    any strides with a unit last one) and ``dsT`` (of S_T, [B, H, Dk, Dv]
    float32 contiguous; zeros when ``None``), the other arguments as
    :func:`rwkv6` takes them -> (dr, dk, dv in the dtype of r, k, v; dw,
    du [H, Dk], ds0 [B, H, Dk, Dv], float32; dr, dk, dv, dw with their
    inputs' strides where those are dense). CPU tensors run
    :func:`.ref.rwkv6_backward_plain`; CUDA tensors run the CUDA kernel
    (``csrc/rwkv6_bwd.cu``, its sums in the fixed orders of
    :func:`.ref.rwkv6_backward_ordered`, bit for bit) under
    ``kernels/rwkv6.py:backward_plan`` on a workspace of
    ``kernels/rwkv6.py:workspace_floats`` (the state every ``chunk``
    steps), and du's per-(b, h) sums add over b in ascending order (the
    kernel's work: not counted apart). A CUDA launch that fails raises;
    nothing falls back to the plain version."""
    _check_rwkv6(r, k, v, w, u, s0)
    xs = dict(r=r, do=do) if dsT is None else dict(r=r, do=do, dsT=dsT)
    _check_tensors("rwkv6_bwd", **xs)
    B, H, T, Dk = r.shape
    if tuple(do.shape) != tuple(v.shape) or do.dtype != v.dtype \
            or do.stride(-1) != 1:
        raise ValueError(f"rwkv6_bwd: do must be {v.dtype} {tuple(v.shape)}"
                         f" with a unit last stride, got {do.dtype} "
                         f"{tuple(do.shape)} strides {do.stride()}")
    if dsT is not None and (tuple(dsT.shape) != (B, H, Dk, v.shape[-1])
                            or dsT.dtype != torch.float32
                            or not dsT.is_contiguous()):
        raise ValueError(f"rwkv6_bwd: dsT must be contiguous float32 "
                         f"{(B, H, Dk, v.shape[-1])}, got {dsT.dtype} "
                         f"{tuple(dsT.shape)}")
    dev = r.device.type
    if dev == "cpu":
        return _plain(rwkv6_bwd, rwkv6_backward_plain, r, k, v, w, u, do, s0,
                      dsT)
    if dev not in _KERNEL_DEVICES:
        raise ValueError(f"rwkv6_bwd: no kernel for device {r.device}")
    Dv = v.shape[-1]
    dr, dk, dv, dw = (torch.empty_like(t) for t in (r, k, v, w))
    du_part = torch.empty((B, H, Dk), dtype=torch.float32, device=r.device)
    ds0 = torch.empty((B, H, Dk, Dv), dtype=torch.float32, device=r.device)
    work = torch.empty((_rk.workspace_floats(B, H, T, Dk, Dv),),
                       dtype=torch.float32, device=r.device)
    if dev == "meta":
        _note(rwkv6_bwd, r, k, v, w, u, do, s0, dsT)
    else:
        _rk.launch_backward(r, k, v, w, u, do, s0, dsT, dr, dk, dv, dw,
                            du_part, ds0, work)
        _counted(rwkv6_bwd, r, k, v, w, u, do, s0, dsT)
    del work
    with _cost.quiet():
        du = du_part[0]
        for b in range(1, B):                 # over b in ascending order
            du = du + du_part[b]
    return dr, dk, dv, dw, du, ds0


rwkv6_bwd.launches = 0


_WRAPPERS = (acd_evict, fifo_dispatch, matmul, flash_attention,
             flash_decode, rglru, rglru_bwd, rwkv6, rwkv6_bwd)


def _decode_live(length: torch.Tensor, S: int) -> int:
    """The live cache slots of a decode call, sum over the rows of
    min(length, S): read from the data, except on ``meta``, which has none
    and counts every slot (the dry run decodes at the last position of a
    full cache, where that is the data's count)."""
    if length.device.type == "meta":
        return length.shape[0] * S
    return int(length.clamp(0, S).sum())


#: kernel name -> (operations, bytes) of one call on the wrapper's arguments
_COSTS = {
    "matmul": lambda x, y, out_dtype=None: _cost.matmul(
        x.shape[0], x.shape[1], y.shape[1], x.dtype, out_dtype),
    "flash_attention": lambda q, k, v, causal, window: _cost.flash_attention(
        q.shape, k.shape, q.dtype, causal, window),
    "flash_decode": lambda q, k, v, length, *_: _cost.flash_decode(
        q.shape, k.shape[1], q.dtype, k.dtype,
        _decode_live(length, k.shape[2])),
    "rglru": lambda x, a, h0: _cost.rglru(*x.shape, h0 is not None),
    "rwkv6": lambda r, k, v, w, u, s0: _cost.rwkv6(
        *r.shape, v.shape[-1], r.dtype, s0 is not None),
    "rglru_bwd": lambda x, a, y, dy, h0, dhT: _cost.rglru_backward(
        *x.shape, h0 is not None, dhT is not None),
    "rwkv6_bwd": lambda r, k, v, w, u, do, s0, dsT: _cost.rwkv6_backward(
        *r.shape, v.shape[-1], r.dtype, s0 is not None, dsT is not None),
}


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    for fn in _WRAPPERS:
        fn.launches = 0


def launch_counts() -> dict:
    """Kernel name -> launches since the last reset."""
    return {fn.__name__: fn.launches for fn in _WRAPPERS}
