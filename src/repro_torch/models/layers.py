"""Shared model layers: norms, RoPE, (G)QA attention (chunked flash-style
prefill and one-token decode), gated FFN. Port of the reference's
``models/layers.py``: pure functions over explicit parameter dicts, in the
reference's layouts and with its dtype rules, so a test can hand both the
same numbers.

The ``*_init`` functions return :class:`Init` specs (shape, dtype,
distribution) instead of arrays: :class:`.model.Model` allocates its
parameters from them on its device and fills them in place, so a
full-width model is drawn on the card and weights carried from elsewhere
land in the same tensors.

Every weight product goes through :func:`linear`, the port's ``matmul``
kernel on the card: it computes each output row the same way whatever the
number of rows, and so do the norms' row means (:func:`row_mean`), so
prefill(S) + decode_step equals prefill(S+1) in bf16 as the reference's
serving paths do. Prefill attention goes through the
``flash_attention`` kernel (:func:`attention_apply`); the reference's
``chunked_attention`` and ``decode_attention`` stay here, held against the
reference by the tests.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels import ops as kops
from .config import ModelConfig

Params = Dict[str, Any]


class Init(NamedTuple):
    """One parameter: its shape, dtype and distribution. ``kind`` is
    ``"normal"`` (standard normal times ``value``) or ``"full"`` (every
    element ``value``)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype
    kind: str
    value: float


def dtype_of(name: str) -> torch.dtype:
    """The torch dtype of a config's dtype name (``"bfloat16"``, ...)."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


# -- norms ---------------------------------------------------------------

_FILLS: Dict[Tuple[int, float, torch.device], torch.Tensor] = {}
#: columns each first-level sum of :func:`row_mean` adds up
ROW_GROUP = 64


def _fill(n: int, value: float, device: torch.device) -> torch.Tensor:
    """A cached float32 [n, 1] column of ``value``."""
    col = _FILLS.get((n, value, device))
    if col is None:
        col = _FILLS[n, value, device] = torch.full(
            (n, 1), value, dtype=torch.float32, device=device)
    return col


def row_mean_launches(n: int) -> int:
    """``matmul`` launches of one :func:`row_mean` over ``n`` columns."""
    return 2 if n > ROW_GROUP and n % ROW_GROUP == 0 else 1


def row_mean(x32: torch.Tensor) -> torch.Tensor:
    """Mean over the last dim of a float32 tensor (kept as a dim of 1), in
    a fixed order whatever the number of rows: through the float32
    ``matmul``, where on the card one thread adds up each output in
    ascending order, first over groups of ``ROW_GROUP`` columns (``@``
    ones), then over the groups' sums weighted by 1/n (exact scaling for a
    power-of-two n). torch's own reductions
    choose their order from the tensor's shape, so a prefill row and the
    same row at a decode step could round apart and break prefill(S) +
    decode_step == prefill(S+1)."""
    n = x32.shape[-1]
    rows = x32.reshape(-1, n)
    if row_mean_launches(n) == 2:
        groups = kops.matmul(rows.reshape(-1, ROW_GROUP),
                             _fill(ROW_GROUP, 1.0, x32.device))
        rows = groups.reshape(-1, n // ROW_GROUP)
    mean = kops.matmul(rows, _fill(rows.shape[1], 1.0 / n, x32.device))
    return mean.reshape(*x32.shape[:-1], 1)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = row_mean(x32 * x32)
    return (x32 * torch.rsqrt(var + eps) * (1.0 + scale.float())
            ).to(x.dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    centred = x32 - row_mean(x32)
    # population variance, as jnp.var
    y = centred * torch.rsqrt(row_mean(centred * centred) + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def apply_norm(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm == "rmsnorm":
        return rmsnorm(x, p["scale"])
    return layernorm(x, p["scale"], p["bias"])


def init_norm(cfg: ModelConfig, d: int) -> Params:
    if cfg.norm == "rmsnorm":
        return {"scale": Init((d,), torch.float32, "full", 0.0)}
    return {"scale": Init((d,), torch.float32, "full", 1.0),
            "bias": Init((d,), torch.float32, "full", 0.0)}


# -- RoPE ------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x [..., S, H, D] (D even), positions [..., S]. Each head splits in
    halves (not interleaved); angles in float32."""
    d = x.shape[-1]
    half = d // 2
    freqs = torch.pow(theta, -torch.arange(0, half, dtype=torch.float32,
                                           device=x.device) / half)
    ang = positions[..., None].float() * freqs                 # [..., S, half]
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


# -- activations -------------------------------------------------------------
# The reference's activations, written as XLA expands them: one rounding to
# the input's dtype after every elementwise op, and Python constants cast to
# that dtype first (JAX's weak typing). torch's fused ``F.gelu`` /
# ``torch.sigmoid`` round once from float32 and differ from the reference
# by one bf16 ulp in a third of the elements; through the smoke models
# that puts 24-61% of the bf16 logits outside the reference suite's
# tolerance. These do not. Their cost on the card's decode step is
# measured by chip_smoke.py (``time_activations``).

def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid``: 1 / (1 + exp(-x))."""
    return 1 / (1 + torch.exp(-x))


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: x * sigmoid(x)."""
    return x * sigmoid(x)


@functools.lru_cache(maxsize=None)
def _const(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype`` (via float32, as numpy casts it): a
    tensor times this float rounds as JAX's weak-typed constant does."""
    return float(torch.tensor(value, dtype=torch.float32).to(dtype))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (its default tanh approximation):
    x * 0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 * x^3)))."""
    c = _const(math.sqrt(2 / math.pi), x.dtype)
    k = _const(0.044715, x.dtype)
    cdf = 0.5 * (1.0 + torch.tanh(c * (x + k * (x * x * x))))
    return x * cdf


# -- weight products -----------------------------------------------------------

def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x`` [..., K] @ ``w`` [K, N] with float32 accumulation, in x's dtype,
    through :func:`repro_torch.kernels.ops.matmul`, whose output rows do
    not depend on how many rows come with them. On the card (bf16) every
    element is the sum of the same ``wgmma`` m64nXk16 instructions (X and
    the operand layouts chosen from N and w's strides, never from the row
    count) over the same 16-deep K chunks in ascending k into one float32
    accumulator: no split-K, no atomics (``kernels/matmul.py:tile_plan``).
    On the CPU every row goes through a float32 product of the same
    shape, rounded once. ``w`` may be a view (a layer of the stacked
    parameters, or the tied embedding's transpose): it is read through its
    strides, never copied."""
    lead = x.shape[:-1]
    out = kops.matmul(x.reshape(-1, x.shape[-1]), w)
    return out.reshape(*lead, w.shape[1])


# -- FFN --------------------------------------------------------------------

def _act(cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    return silu(x) if cfg.act == "silu" else gelu(x)


def ffn_apply(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """Gated (SwiGLU-style) or plain 2-matrix FFN."""
    if cfg.glu:
        h = _act(cfg, linear(x, p["w_gate"])) * linear(x, p["w_up"])
    else:
        h = _act(cfg, linear(x, p["w_up"]))
    return linear(h, p["w_down"])


def ffn_init(cfg: ModelConfig, d: int, ff: int, dtype: torch.dtype) -> Params:
    s_in, s_out = d ** -0.5, ff ** -0.5
    p = {"w_up": Init((d, ff), dtype, "normal", s_in),
         "w_down": Init((ff, d), dtype, "normal", s_out)}
    if cfg.glu:
        p["w_gate"] = Init((d, ff), dtype, "normal", s_in)
    return p


# -- attention ----------------------------------------------------------------

def attn_init(cfg: ModelConfig, dtype: torch.dtype,
              heads: Optional[int] = None,
              kv_heads: Optional[int] = None) -> Params:
    H = heads or cfg.num_heads
    Hkv = kv_heads or cfg.num_kv_heads
    d, hd = cfg.d_model, cfg.hd
    s = d ** -0.5
    p = {"wq": Init((d, H * hd), dtype, "normal", s),
         "wk": Init((d, Hkv * hd), dtype, "normal", s),
         "wv": Init((d, Hkv * hd), dtype, "normal", s),
         "wo": Init((H * hd, d), dtype, "normal", (H * hd) ** -0.5)}
    if cfg.qkv_bias:
        p["bq"] = Init((H * hd,), dtype, "full", 0.0)
        p["bk"] = Init((Hkv * hd,), dtype, "full", 0.0)
        p["bv"] = Init((Hkv * hd,), dtype, "full", 0.0)
    return p


def chunked_attention(
    q: torch.Tensor,           # [B, Hq, Sq, D]
    k: torch.Tensor,           # [B, Hkv, Sk, D]
    v: torch.Tensor,
    causal: bool = True,
    window: Optional[int] = None,
    q_chunk: int = 512,
    kv_chunk: int = 512,
) -> torch.Tensor:
    """Flash-style chunked attention: an online softmax over key chunks,
    O(chunk^2) memory, the reference's chunking, padding and masking.
    Query positions are right-aligned to ``Sk - Sq``; the ``Hq / Hkv``
    query heads of a group share their KV head without a copy."""
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    group = hq // hkv
    scale = d ** -0.5
    nq = -(-sq // q_chunk)
    nk = -(-sk // kv_chunk)
    q_chunk = -(-sq // nq)
    kv_chunk = -(-sk // nk)
    sqp, skp = nq * q_chunk, nk * kv_chunk
    qp = F.pad(q, (0, 0, 0, sqp - sq))
    kp = F.pad(k, (0, 0, 0, skp - sk))
    vp = F.pad(v, (0, 0, 0, skp - sk))
    q_off = sk - sq  # right-aligned query positions
    neg = -1e30
    dev = q.device
    outs = []
    for iq in range(nq):
        qc = qp[:, :, iq * q_chunk:(iq + 1) * q_chunk]
        qcs = (qc * scale).to(qc.dtype)                         # [B,Hq,qc,D]
        qg = qcs.float().reshape(b, hkv, group, q_chunk, d)
        qpos = q_off + iq * q_chunk + torch.arange(q_chunk, device=dev)
        acc = torch.zeros((b, hkv, group, q_chunk, d), dtype=torch.float32,
                          device=dev)
        m = torch.full((b, hkv, group, q_chunk), neg, dtype=torch.float32,
                       device=dev)
        denom = torch.zeros((b, hkv, group, q_chunk), dtype=torch.float32,
                            device=dev)
        for ik in range(nk):
            kc = kp[:, :, ik * kv_chunk:(ik + 1) * kv_chunk]    # [B,Hkv,kvc,D]
            vc = vp[:, :, ik * kv_chunk:(ik + 1) * kv_chunk]
            logits = torch.einsum("bhgqd,bhkd->bhgqk", qg, kc.float())
            kpos = ik * kv_chunk + torch.arange(kv_chunk, device=dev)
            mask = kpos[None, :] < sk
            if causal:
                mask = mask & (kpos[None, :] <= qpos[:, None])
            if window is not None:
                mask = mask & (kpos[None, :] > qpos[:, None] - window)
            logits = torch.where(mask, logits, neg)
            m_new = torch.maximum(m, logits.amax(-1))
            p = torch.exp(logits - m_new[..., None])
            alpha = torch.exp(m - m_new)
            denom = denom * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhgqk,bhkd->bhgqd", p.to(vc.dtype).float(), vc.float())
            m = m_new
        out = acc / torch.clamp_min(denom, 1e-30)[..., None]
        outs.append(out.reshape(b, hq, q_chunk, d).to(q.dtype))
    return torch.cat(outs, dim=2)[:, :, :sq]


def decode_attention(
    q: torch.Tensor,           # [B, Hq, D] one new token
    k_cache: torch.Tensor,     # [B, Hkv, S, D]
    v_cache: torch.Tensor,
    pos: int,                  # current position (tokens < pos+1 valid)
    window: Optional[int] = None,
) -> torch.Tensor:
    """One-token attention over the cache, in float32 over the cache's
    storage-dtype values."""
    b, hq, d = q.shape
    _, hkv, s, _ = k_cache.shape
    group = hq // hkv
    scale = d ** -0.5
    qg = (q.reshape(b, hkv, group, d) * scale).to(k_cache.dtype)
    logits = torch.einsum("bhgd,bhsd->bhgs", qg.float(), k_cache.float())
    kpos = torch.arange(s, device=q.device)
    valid = kpos <= pos
    if window is not None:
        valid = valid & (kpos > pos - window)
    logits = torch.where(valid, logits, -1e30)
    m = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - m)
    out = torch.einsum("bhgs,bhsd->bhgd", p.to(k_cache.dtype).float(),
                       v_cache.float())
    out = out / p.sum(-1, keepdim=True)
    return out.reshape(b, hq, d).to(q.dtype)


def cache_update(cache: torch.Tensor, new: torch.Tensor,
                 slot: int) -> torch.Tensor:
    """cache [B,H,S,D] <- new [B,H,D] at position ``slot``, in place (the
    reference's dynamic-update-slice; the caller owns the cache)."""
    cache[:, :, slot] = new.to(cache.dtype)
    return cache


def attention_apply(
    cfg: ModelConfig,
    p: Params,
    x: torch.Tensor,               # [B, S, d_model]
    positions: torch.Tensor,       # [B, S]
    causal: bool = True,
    window: Optional[int] = None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Full-sequence self-attention (prefill). Returns (out, (k, v)) with
    k, v [B, Hkv, S, D] after RoPE."""
    b, s, _ = x.shape
    q = linear(x, p["wq"])
    k = linear(x, p["wk"])
    v = linear(x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, cfg.num_heads, cfg.hd)
    k = k.reshape(b, s, cfg.num_kv_heads, cfg.hd)
    v = v.reshape(b, s, cfg.num_kv_heads, cfg.hd)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    q, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    out = kops.flash_attention(q, kt, vt, causal=causal, window=window)
    out = out.transpose(1, 2).reshape(b, s, -1)
    return linear(out, p["wo"]), (kt, vt)
