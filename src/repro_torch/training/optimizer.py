"""AdamW with optional int8 block-quantized moments.

Port of the reference's ``training/optimizer.py``. The quantized variant
(``state_dtype="int8"``) stores m/v as int8 with a per-block float32 scale
(block = the trailing 256 elements, or the whole last dim where 256 does
not divide it): 4x less optimizer memory than bf16, 8x less than float32.
The second moment is quantized in the log domain (:func:`quantize_q8_log`).

Parameters, gradients and moments are dicts keyed by the model's dotted
parameter names (``Model.named_parameters()``); a moment is a tensor of
the parameter's shape (``float32`` / ``bfloat16``) or, for int8, a dict
``{"q", "scale"}`` (m) or ``{"q", "lo", "scale"}`` (v) in the reference's
layout: ``q`` keeps the parameter's shape, the float32 ``lo`` / ``scale``
are ``[..., nb, 1]``.

Every expression keeps the reference's association and its float32
constants (a Python float times a float32 tensor rounds the float to
float32 first, as JAX's weak typing does). :func:`adamw_update` updates
the parameters and moments in place, leaf by leaf, in slices along the
leading (stacked-layer, or row) axes of at most ``SLICE_ELEMS`` elements,
so the float32 temporaries of one slice are all it adds (llama3-8b's
stacked FFN leaf alone is 1.88 G elements). The quantization blocks run
along the last dim, which is never cut, so the slicing changes no bit.

Over a mesh (``layout=``, a ``repro_torch.distributed.MeshParams``) each
rank holds its parameters' shards and its ZeRO-1 part of the moments: the
moments' box widened along the last dim to whole blocks of the *whole*
leaf (``block=``: the whole leaf's block, never the shard's), so every
mesh quantizes the same blocks. :func:`global_norm` counts each element
once over the mesh and sums the ranks' totals; the update runs on each
rank's box and the updated parameters are gathered back to every rank
holding them. At one rank the boxes are the whole leaves and every value
is the unsharded update's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import (Dict, Iterator, NamedTuple, Optional, Sequence, Tuple,
                    Union)

import torch

Moment = Union[torch.Tensor, Dict[str, torch.Tensor]]
Params = Dict[str, torch.Tensor]
_BLOCK = 256
#: elements of one slice of the sliced update, norm and init
SLICE_ELEMS = 1 << 26


# -- int8 block quantization ------------------------------------------------
#
# Shape-preserving layout: q keeps the parameter's shape (int8) and scales
# are blocked along the last dim ([..., nb, 1]), as in the reference.

def _div(x: torch.Tensor, d) -> torch.Tensor:
    """``x / d`` for a Python number ``d``, correctly rounded on every
    device: torch's CUDA kernel multiplies by the rounded reciprocal of a
    Python divisor, where its CPU kernel (and XLA) divide; a divisor on
    ``x``'s device is divided by on both."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def _last_block(shape, full=None) -> int:
    """The block of a leaf of ``shape``, or of the whole leaf of shape
    ``full`` that ``shape`` is a part of."""
    last = int((shape if full is None else full)[-1])
    return _BLOCK if last % _BLOCK == 0 else last  # per-row fallback


def _to_blocks(x: torch.Tensor, block: Optional[int] = None) -> torch.Tensor:
    b = _last_block(x.shape) if block is None else block
    return x.reshape(*x.shape[:-1], x.shape[-1] // b, b)


def _blocks_shape(shape, full=None) -> Tuple[int, ...]:
    """The scales' shape ``[..., nb, 1]`` of a leaf of ``shape`` (a part
    of a whole leaf of shape ``full``, whose blocks it keeps)."""
    return tuple(shape[:-1]) + (int(shape[-1]) // _last_block(shape, full),
                                1)


def quantize_q8(x: torch.Tensor, block: Optional[int] = None
                ) -> Dict[str, torch.Tensor]:
    xb = _to_blocks(x.float(), block)
    scale = torch.clamp_min(_div(xb.abs().amax(-1, keepdim=True), 127.0),
                            1e-12)
    q = torch.clamp(torch.round(xb / scale), -127, 127).to(torch.int8)
    return {"q": q.reshape(x.shape), "scale": scale}


def dequantize_q8(qs: Dict[str, torch.Tensor], shape,
                  dtype: torch.dtype = torch.float32,
                  block: Optional[int] = None) -> torch.Tensor:
    qb = _to_blocks(qs["q"].float(), block)
    return (qb * qs["scale"]).reshape(shape).to(dtype)


def quantize_q8_log(x: torch.Tensor, block: Optional[int] = None
                    ) -> Dict[str, torch.Tensor]:
    """Log-domain int8 for non-negative tensors (Adam second moments):
    linear int8 on log(v) per block, so the relative error stays bounded
    across v's dynamic range."""
    xb = torch.clamp_min(_to_blocks(x.float(), block), 1e-30)
    lx = torch.log(xb)
    lo = lx.amin(-1, keepdim=True)
    scale = torch.clamp_min(_div(lx.amax(-1, keepdim=True) - lo, 254.0),
                            1e-8)
    q = (torch.round((lx - lo) / scale) - 127.0).to(torch.int8)
    return {"q": q.reshape(x.shape), "lo": lo, "scale": scale}


def _log_floor(device) -> torch.Tensor:
    """log(1e-29) in float32: below it a dequantized v is 0."""
    return torch.log(torch.tensor(1e-29, dtype=torch.float32, device=device))


def dequantize_q8_log(qs: Dict[str, torch.Tensor], shape,
                      dtype: torch.dtype = torch.float32,
                      block: Optional[int] = None) -> torch.Tensor:
    qb = _to_blocks(qs["q"].float(), block)
    lx = qs["lo"] + (qb + 127.0) * qs["scale"]
    out = torch.where(lx <= _log_floor(lx.device), 0.0, torch.exp(lx))
    return out.reshape(shape).to(dtype)


# -- AdamW --------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "float32"       # float32 | bfloat16 | int8
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


def _lr_at(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The schedule at int32 ``step``: linear warm-up, then cosine to
    ``min_lr_frac``; float32."""
    warm = _div(cfg.lr * (step + 1), max(cfg.warmup_steps, 1))
    prog = torch.clamp(_div(step - cfg.warmup_steps,
                            max(cfg.total_steps - cfg.warmup_steps, 1)),
                       0.0, 1.0)
    cos = cfg.lr * (cfg.min_lr_frac + (1 - cfg.min_lr_frac)
                    * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < cfg.warmup_steps, warm, cos)


class AdamWState(NamedTuple):
    step: torch.Tensor            # int32 [], on the parameters' device
    m: Dict[str, Moment]
    v: Dict[str, Moment]


def _slices(shape: Sequence[int], limit: int = SLICE_ELEMS
            ) -> Iterator[tuple]:
    """Index tuples over the leading axes of a leaf of ``shape`` that cut
    it into pieces of at most ``limit`` elements where they can (never
    the last axis): runs of rows, or single leading indices and then runs
    along the next axis."""
    if len(shape) <= 1:
        yield ()
        return
    row = math.prod(shape[1:])
    if row <= limit or len(shape) == 2:
        step = max(1, limit // max(row, 1))
        for i in range(0, shape[0], step):
            yield (slice(i, min(i + step, shape[0])),)
        return
    for i in range(shape[0]):
        for rest in _slices(shape[1:], limit):
            yield (i,) + rest


def _at(moment: Moment, idx: tuple) -> Moment:
    if isinstance(moment, dict):
        return {k: t[idx] for k, t in moment.items()}
    return moment[idx]


def _store(moment: Moment, idx: tuple, value: Moment) -> None:
    if isinstance(moment, dict):
        for k, t in moment.items():
            t[idx] = value[k]
    else:
        moment[idx] = value


def _read(moment: Moment, shape, dtype_cfg: str, kind: str,
          block: Optional[int] = None) -> torch.Tensor:
    if dtype_cfg == "int8":
        dq = dequantize_q8_log if kind == "v" else dequantize_q8
        return dq(moment, shape, block=block)
    return moment.float()


def _write(x: torch.Tensor, dtype_cfg: str, kind: str,
           block: Optional[int] = None) -> Moment:
    if dtype_cfg == "int8":
        qf = quantize_q8_log if kind == "v" else quantize_q8
        return qf(x, block)
    return x.to(getattr(torch, dtype_cfg))


def _moment_init(shape, device, dtype_cfg: str, kind: str,
                 block: Optional[int] = None) -> Moment:
    """A zero moment of ``shape``: int8 zeros quantized slice by slice in
    blocks of ``block`` (the reference's ``quantize(zeros)``: q, lo and
    scale constants)."""
    shape = tuple(shape)
    if dtype_cfg != "int8":
        return torch.zeros(shape, dtype=getattr(torch, dtype_cfg),
                           device=device)
    block = _last_block(shape) if block is None else block
    names = ("q", "lo", "scale") if kind == "v" else ("q", "scale")
    out = {k: torch.empty(shape if k == "q" else
                          tuple(shape[:-1]) + (shape[-1] // block, 1),
                          dtype=torch.int8 if k == "q" else torch.float32,
                          device=device) for k in names}
    for idx in _slices(shape):
        zeros = torch.zeros(out["q"][idx].shape, dtype=torch.float32,
                            device=device)
        _store(out, idx, _write(zeros, "int8", kind, block))
    return out


def adamw_init(params: Params, cfg: AdamWConfig, layout=None) -> AdamWState:
    """Zero moments of every parameter (of this rank's box of each under a
    mesh ``layout``: its ZeRO part, int8 moments in the whole leaf's
    blocks)."""
    dev = next(iter(params.values())).device

    def moment(k, p, kind):
        if layout is None:
            return _moment_init(p.shape, dev, cfg.state_dtype, kind)
        return _moment_init(layout.moment_shape(k, cfg.state_dtype == "int8"),
                            dev, cfg.state_dtype, kind, layout.block(k))
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        m={k: moment(k, p, "m") for k, p in params.items()},
        v={k: moment(k, p, "v") for k, p in params.items()})


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root (XLA's and the card's):
    torch's CPU float32 ``sqrt`` misses it in some 0.7% of inputs; the
    float64 root rounds to it (53 >= 2 * 24 + 2 bits)."""
    return torch.sqrt(x.double()).float()


def tree_order(names) -> list:
    """``names`` (dotted parameter paths) in the reference's leaf order:
    dict keys sorted at every level, list indices in ascending order."""
    return sorted(names, key=lambda n: tuple(
        (0, int(c), "") if c.isdigit() else (1, 0, c) for c in n.split(".")))


def global_norm(tree: Dict[str, torch.Tensor], layout=None) -> torch.Tensor:
    """sqrt of the sum over the leaves (in the reference's order) of each
    leaf's float32 sum of squares (a large leaf summed slice by slice; a
    ``None`` leaf, a parameter the loss does not reach, adds nothing).
    Under a mesh ``layout`` the leaves are shards: a rank adds those it
    owns (each element counted once over the mesh) and the ranks' totals
    are summed (``layout.norm_sum``, an all-reduce) before the root."""
    total = 0
    with torch.no_grad():
        for name in tree_order(tree):
            x = tree[name]
            if x is None or (layout is not None
                             and not layout.norm_owner(name)):
                continue
            leaf = 0
            for idx in _slices(x.shape):
                leaf = leaf + torch.sum(torch.square(x[idx].float()))
            total = total + leaf
        if layout is not None:
            total = layout.norm_sum(total)
    return torch.sqrt(total)


def _update_leaf(p: torch.Tensor, g: Optional[torch.Tensor], m: Moment,
                 v: Moment, cfg: AdamWConfig, clip, lr, bc1, bc2,
                 decay: float, block: Optional[int] = None) -> None:
    """One leaf's AdamW update in place, slice by slice (int8 moments in
    blocks of ``block``, by default the leaf's own)."""
    sd = cfg.state_dtype
    for idx in _slices(p.shape):
        ps = p[idx]
        shape = ps.shape
        g32 = (torch.zeros(shape, dtype=torch.float32,
                           device=p.device) if g is None
               else g[idx].float()) * clip
        m32 = _read(_at(m, idx), shape, sd, "m", block)
        v32 = _read(_at(v, idx), shape, sd, "v", block)
        m32 = cfg.b1 * m32 + (1 - cfg.b1) * g32
        v32 = cfg.b2 * v32 + (1 - cfg.b2) * g32 * g32
        upd32 = (m32 / bc1) / (_sqrt(v32 / bc2) + cfg.eps)
        p32 = ps.float()
        new_p = p32 - lr * (upd32 + cfg.weight_decay * p32 * decay)
        ps.copy_(new_p.to(p.dtype))
        _store(m, idx, _write(m32, sd, "m", block))
        _store(v, idx, _write(v32, sd, "v", block))


def adamw_update(grads: Dict[str, torch.Tensor], state: AdamWState,
                 params: Params, cfg: AdamWConfig, layout=None
                 ) -> Tuple[Params, AdamWState, Dict[str, torch.Tensor]]:
    """One AdamW step with global-norm clipping, the reference's
    arithmetic. ``params`` and the moments are updated in place (slice by
    slice) and returned, with the new state and ``{"grad_norm", "lr"}``.
    A leaf of two dims or more decays its weights (the reference tests the
    stacked leaf's ``ndim``, so a stacked norm scale decays too). Under a
    mesh ``layout`` (a ``MeshParams``) the parameters, gradients and
    moments are this rank's shards (see the module docstring)."""
    with torch.no_grad():
        gnorm = (global_norm(grads) if layout is None
                 else global_norm(grads, layout))
        clip = torch.clamp_max(cfg.grad_clip / (gnorm + 1e-9), 1.0)
        step = state.step + 1
        lr = _lr_at(cfg, state.step)
        bc1 = 1 - cfg.b1 ** step.float()
        bc2 = 1 - cfg.b2 ** step.float()
        for name, p in params.items():
            g, m, v = grads[name], state.m[name], state.v[name]
            decay = float(p.dim() >= 2)
            if layout is None:
                _update_leaf(p, g, m, v, cfg, clip, lr, bc1, bc2, decay)
                continue
            pw, gw, finish = layout.update_view(name, p, g,
                                                cfg.state_dtype == "int8")
            _update_leaf(pw, gw, m, v, cfg, clip, lr, bc1, bc2, decay,
                         layout.block(name))
            finish()
    return params, AdamWState(step=step, m=state.m, v=state.v), {
        "grad_norm": gnorm, "lr": lr}
