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
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterator, NamedTuple, Sequence, Tuple, Union

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

def _last_block(shape) -> int:
    last = int(shape[-1])
    return _BLOCK if last % _BLOCK == 0 else last  # per-row fallback


def _to_blocks(x: torch.Tensor) -> torch.Tensor:
    b = _last_block(x.shape)
    return x.reshape(*x.shape[:-1], x.shape[-1] // b, b)


def _blocks_shape(shape) -> Tuple[int, ...]:
    """The scales' shape ``[..., nb, 1]`` of a leaf of ``shape``."""
    return tuple(shape[:-1]) + (int(shape[-1]) // _last_block(shape), 1)


def quantize_q8(x: torch.Tensor) -> Dict[str, torch.Tensor]:
    xb = _to_blocks(x.float())
    scale = torch.clamp_min(xb.abs().amax(-1, keepdim=True) / 127.0, 1e-12)
    q = torch.clamp(torch.round(xb / scale), -127, 127).to(torch.int8)
    return {"q": q.reshape(x.shape), "scale": scale}


def dequantize_q8(qs: Dict[str, torch.Tensor], shape,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    qb = _to_blocks(qs["q"].float())
    return (qb * qs["scale"]).reshape(shape).to(dtype)


def quantize_q8_log(x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Log-domain int8 for non-negative tensors (Adam second moments):
    linear int8 on log(v) per block, so the relative error stays bounded
    across v's dynamic range."""
    xb = torch.clamp_min(_to_blocks(x.float()), 1e-30)
    lx = torch.log(xb)
    lo = lx.amin(-1, keepdim=True)
    scale = torch.clamp_min((lx.amax(-1, keepdim=True) - lo) / 254.0, 1e-8)
    q = (torch.round((lx - lo) / scale) - 127.0).to(torch.int8)
    return {"q": q.reshape(x.shape), "lo": lo, "scale": scale}


def _log_floor(device) -> torch.Tensor:
    """log(1e-29) in float32: below it a dequantized v is 0."""
    return torch.log(torch.tensor(1e-29, dtype=torch.float32, device=device))


def dequantize_q8_log(qs: Dict[str, torch.Tensor], shape,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    qb = _to_blocks(qs["q"].float())
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
    warm = cfg.lr * (step + 1) / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
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


def _read(moment: Moment, shape, dtype_cfg: str, kind: str) -> torch.Tensor:
    if dtype_cfg == "int8":
        dq = dequantize_q8_log if kind == "v" else dequantize_q8
        return dq(moment, shape)
    return moment.float()


def _write(x: torch.Tensor, dtype_cfg: str, kind: str) -> Moment:
    if dtype_cfg == "int8":
        qf = quantize_q8_log if kind == "v" else quantize_q8
        return qf(x)
    return x.to(getattr(torch, dtype_cfg))


def _moment_init(p: torch.Tensor, dtype_cfg: str, kind: str) -> Moment:
    """A zero moment of ``p``: int8 zeros quantized slice by slice (the
    reference's ``quantize(zeros)``: q, lo and scale constants)."""
    if dtype_cfg != "int8":
        return torch.zeros(p.shape, dtype=getattr(torch, dtype_cfg),
                           device=p.device)
    names = ("q", "lo", "scale") if kind == "v" else ("q", "scale")
    out = {k: torch.empty(p.shape if k == "q" else _blocks_shape(p.shape),
                          dtype=torch.int8 if k == "q" else torch.float32,
                          device=p.device) for k in names}
    for idx in _slices(p.shape):
        zeros = torch.zeros(p[idx].shape, dtype=torch.float32,
                            device=p.device)
        _store(out, idx, _write(zeros, "int8", kind))
    return out


def adamw_init(params: Params, cfg: AdamWConfig) -> AdamWState:
    dev = next(iter(params.values())).device
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        m={k: _moment_init(p, cfg.state_dtype, "m")
           for k, p in params.items()},
        v={k: _moment_init(p, cfg.state_dtype, "v")
           for k, p in params.items()})


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


def global_norm(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum over the leaves (in the reference's order) of each
    leaf's float32 sum of squares (a large leaf summed slice by slice; a
    ``None`` leaf, a parameter the loss does not reach, adds nothing)."""
    total = 0
    with torch.no_grad():
        for name in tree_order(tree):
            x = tree[name]
            if x is None:
                continue
            leaf = 0
            for idx in _slices(x.shape):
                leaf = leaf + torch.sum(torch.square(x[idx].float()))
            total = total + leaf
    return torch.sqrt(total)


def adamw_update(grads: Dict[str, torch.Tensor], state: AdamWState,
                 params: Params, cfg: AdamWConfig
                 ) -> Tuple[Params, AdamWState, Dict[str, torch.Tensor]]:
    """One AdamW step with global-norm clipping, the reference's
    arithmetic. ``params`` and the moments are updated in place (slice by
    slice) and returned, with the new state and ``{"grad_norm", "lr"}``.
    A leaf of two dims or more decays its weights (the reference tests the
    stacked leaf's ``ndim``, so a stacked norm scale decays too)."""
    with torch.no_grad():
        gnorm = global_norm(grads)
        clip = torch.clamp_max(cfg.grad_clip / (gnorm + 1e-9), 1.0)
        step = state.step + 1
        lr = _lr_at(cfg, state.step)
        bc1 = 1 - cfg.b1 ** step.float()
        bc2 = 1 - cfg.b2 ** step.float()
        sd = cfg.state_dtype
        for name, p in params.items():
            g, m, v = grads[name], state.m[name], state.v[name]
            decay = float(p.dim() >= 2)
            for idx in _slices(p.shape):
                ps = p[idx]
                shape = ps.shape
                g32 = (torch.zeros(shape, dtype=torch.float32,
                                   device=p.device) if g is None
                       else g[idx].float()) * clip
                m32 = _read(_at(m, idx), shape, sd, "m")
                v32 = _read(_at(v, idx), shape, sd, "v")
                m32 = cfg.b1 * m32 + (1 - cfg.b1) * g32
                v32 = cfg.b2 * v32 + (1 - cfg.b2) * g32 * g32
                upd32 = (m32 / bc1) / (_sqrt(v32 / bc2) + cfg.eps)
                p32 = ps.float()
                new_p = p32 - lr * (upd32 + cfg.weight_decay * p32 * decay)
                ps.copy_(new_p.to(p.dtype))
                _store(m, idx, _write(m32, sd, "m"))
                _store(v, idx, _write(v32, sd, "v"))
    return params, AdamWState(step=step, m=state.m, v=state.v), {
        "grad_norm": gnorm, "lr": lr}
