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

Activations pass named points (``shard(x, "ffn_hidden")``, ...) where
the reference asks its :class:`Sharder` for a sharding constraint; the
base here is a no-op. ``repro_torch.distributed.MeshSharder`` checks the
reference's spec against the port's batch-sharded layout in training and,
serving over a mesh, brings each tensor to it: there :func:`linear` runs
column- or row-parallel by the weight's cut and attention on the local
heads (:func:`heads`, :func:`kv_for_heads`).

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


class Sharder:
    """The activations' sharding hook, called by logical name at the
    reference's points; the base returns ``x`` and counts nothing across
    ranks (an unsharded model).

    Serving over a mesh computes on the 'model' cuts
    (``repro_torch.distributed.MeshSharder`` with ``tp`` set): there a
    tensor's dim is either whole or this rank's 1/``m`` of it, and the
    hooks below move between the two. Here every dim is whole, ``tp`` is
    False and each hook is the identity."""

    #: whether the forward computes on the 'model' cuts (tensor-parallel
    #: serving), and the size of the 'model' axis
    tp = False
    m = 1
    #: this rank's index along 'model'
    rank = 0

    def __call__(self, x: torch.Tensor, name: str,
                 full: Optional[Tuple[int, ...]] = None) -> torch.Tensor:
        """``x`` at the named point; ``full`` is its whole shape where the
        tensor-parallel layout may hold a cut of it."""
        return x

    def to(self, x: torch.Tensor, name: str,
           full: Tuple[int, ...]) -> torch.Tensor:
        """``x`` brought to the named point's layout (and checked)."""
        return x

    def local(self, name: str, full: Tuple[int, ...]) -> Tuple[int, ...]:
        """The shape this rank holds of a ``full``-shaped tensor at the
        named point."""
        return tuple(full)

    def cache_local(self, last: str, full: Tuple[int, ...]
                    ) -> Tuple[int, ...]:
        """The shape this rank holds of the decode-cache leaf ``last`` of
        whole shape ``full``."""
        return tuple(full)

    def fit(self, x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
        """``x`` with dim ``dim`` brought to size ``n``: whole, or this
        rank's cut of it."""
        return x

    def reduce(self, part: torch.Tensor, dtype: torch.dtype,
               residual: bool = False) -> torch.Tensor:
        """The sum over 'model' of the float32 partials ``part`` [B, S,
        ...], rounded once to ``dtype``; with ``residual``, in the
        residual's layout (:meth:`to_residual`)."""
        return part.to(dtype)

    def to_residual(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` [B, S, d], its sequence whole, in the residual's layout
        (the 'residual' hint's cut of the sequence): ``x`` itself without
        a mesh."""
        return x

    def batch_sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the ranks that hold other rows of the batch
        (the loss's token count): ``x`` itself without a mesh."""
        return x


NO_SHARD = Sharder()


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


#: float32 bit patterns: 2^-6 (e4m3fn's least normal) and 464 (the tie
#: between 448, its largest finite value, and 480, one step past it)
_E4M3_MIN_NORMAL = 0x3C800000
_E4M3_TIE_464 = 0x43E80000
#: device -> whether torch's own bf16 -> float8_e4m3fn cast there equals
#: _to_e4m3fn on every bf16 input
_BF16_CAST_IS_XLA: Dict[torch.device, bool] = {}


def _to_e4m3fn(x: torch.Tensor) -> torch.Tensor:
    """XLA's cast to float8_e4m3fn on x's float32 bits, with integer and
    exact float ops only (the same bits on every device)."""
    a = x.float()
    bits = a.view(torch.int32)
    mag = bits & 0x7FFFFFFF
    sign = (bits >> 24) & 0x80
    # normal range: keep 3 mantissa bits, ties to even (a carry moves the
    # exponent), then rebias 127 -> 7
    m = mag.clamp_max(_E4M3_TIE_464 + 1)
    enc = ((m + (0x7FFFF + ((m >> 20) & 1))) >> 20) - ((127 - 7) << 3)
    # below 2^-6: multiples of 2^-9, ties to even; 8 is the least normal
    sub = torch.round(a.abs() * 512.0).to(torch.int32)
    enc = torch.where(mag < _E4M3_MIN_NORMAL, sub, enc)
    enc = torch.where(mag > _E4M3_TIE_464, 0x7F, enc)
    return (enc | sign).to(torch.uint8).view(torch.float8_e4m3fn)


def _bf16_cast_is_xla(device: torch.device) -> bool:
    """Whether ``Tensor.to(float8_e4m3fn)`` of bf16 on ``device`` gives
    :func:`_to_e4m3fn`'s bits on all 65,536 bf16 patterns: checked once
    per device (one sync), so a bf16 cast may take torch's single kernel
    where it is the same function. torch's CPU cast saturates to +-448;
    its CUDA cast has given NaN there, as XLA's does, and so passed the
    probe. ``meta`` tensors have no values to probe: they take the cast
    the H100 takes, torch's own (its probe passed on the card's torch
    2.11; chip_smoke's dry-run phase checks that the card still agrees)."""
    if device.type == "meta":
        return True
    same = _BF16_CAST_IS_XLA.get(device)
    if same is None:
        pat = torch.arange(-32768, 32768, dtype=torch.int32,
                           device=device).to(torch.int16).view(
                               torch.bfloat16)
        same = _BF16_CAST_IS_XLA[device] = bool(torch.equal(
            pat.to(torch.float8_e4m3fn).view(torch.uint8),
            _to_e4m3fn(pat).view(torch.uint8)))
    return same


def to_kv(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` cast to a KV cache's storage ``dtype`` as XLA's ``astype``
    casts it. For ``float8_e4m3fn``: round to nearest even from x's own
    value (bf16 and float32 widen to float32 exactly, so there is one
    rounding); a |x| that rounds above 448 (|x| > 464), +-inf and NaN
    become NaN with x's sign (0x7f / 0xff), where torch's CPU cast
    saturates to +-448. The CPU and the card give the same bits whatever
    their torch build's cast does: :func:`_to_e4m3fn`, or for bf16 torch's
    own cast where it was found equal on every bf16 input. Other dtypes:
    ``x.to``."""
    if dtype != torch.float8_e4m3fn:
        return x.to(dtype)
    if x.dtype == torch.bfloat16 and _bf16_cast_is_xla(x.device):
        return x.to(dtype)
    return _to_e4m3fn(x)


# -- norms ---------------------------------------------------------------

_FILLS: Dict[Tuple[int, float, torch.device], torch.Tensor] = {}
#: columns each first-level sum of :func:`row_mean` adds up
ROW_GROUP = 64


def _fill(n: int, value: float, device: torch.device) -> torch.Tensor:
    """A cached float32 [n, 1] column of ``value`` (a normal tensor even
    when first asked for under ``inference_mode``, so training may save it
    for its backward)."""
    col = _FILLS.get((n, value, device))
    if col is None:
        with torch.inference_mode(False):
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

def rope_exponents(half: int, device) -> torch.Tensor:
    """-i / half for i < half (float32): the frequencies' exponents,
    divided by ``half`` as a 0-dim tensor on ``device``. torch's CUDA
    kernel multiplies by the rounded reciprocal of a Python divisor, where
    its CPU kernel and XLA divide (ROADMAP Queue 3 item 25)."""
    return -torch.arange(0, half, dtype=torch.float32, device=device) \
        / torch.full((), half, dtype=torch.float32, device=device)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x [..., S, H, D] (D even), positions [..., S]. Each head splits in
    halves (not interleaved); angles in float32."""
    d = x.shape[-1]
    half = d // 2
    freqs = torch.pow(theta, rope_exponents(half, x.device))
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

def linear(x: torch.Tensor, w: torch.Tensor, shard: "Sharder" = NO_SHARD,
           residual: bool = False) -> torch.Tensor:
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
    strides, never copied.

    Under tensor parallelism (``shard.tp``) a weight handed out on its
    'model' cut carries the cut dim (``w.tp_cut``, set by ``MeshParams``):
    0 is row-parallel (``P('model', None)``: x's own columns in, float32
    partials out, summed over 'model' in rank order and rounded once), 1
    column-parallel (``P(None, 'model')``: whole x in, this rank's
    columns out); an uncut weight takes whole x. ``residual`` marks a
    block's last product, whose output joins the residual: it comes out
    whole along the model dim, in the residual's layout along the sequence
    (``shard.to_residual``)."""
    if shard.tp:
        return _tp_linear(x, w, shard, residual)
    lead = x.shape[:-1]
    out = kops.matmul(x.reshape(-1, x.shape[-1]), w)
    return out.reshape(*lead, w.shape[1])


def _tp_linear(x: torch.Tensor, w: torch.Tensor, shard: "Sharder",
               residual: bool) -> torch.Tensor:
    cut = getattr(w, "tp_cut", None)
    lead = x.shape[:-1]
    x = shard.fit(x, -1, w.shape[0])
    x2 = x.reshape(-1, x.shape[-1])
    if cut == 0:
        part = kops.matmul(x2, w, out_dtype=torch.float32)
        return shard.reduce(part.reshape(*lead, w.shape[1]), x.dtype,
                            residual)
    out = kops.matmul(x2, w).reshape(*lead, w.shape[1])
    if not residual:
        return out
    out = shard.fit(out, -1, w.shape[1] * (shard.m if cut == 1 else 1))
    return shard.to_residual(out)


# -- FFN --------------------------------------------------------------------

def _act(cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    return silu(x) if cfg.act == "silu" else gelu(x)


def ffn_apply(cfg: ModelConfig, p: Params, x: torch.Tensor,
              shard: Sharder = NO_SHARD) -> torch.Tensor:
    """Gated (SwiGLU-style) or plain 2-matrix FFN; its output joins the
    residual (:func:`linear`)."""
    if cfg.glu:
        h = (_act(cfg, linear(x, p["w_gate"], shard))
             * linear(x, p["w_up"], shard))
    else:
        h = _act(cfg, linear(x, p["w_up"], shard))
    h = shard.to(h, "ffn_hidden", h.shape[:-1] + (cfg.d_ff,))
    return linear(h, p["w_down"], shard, residual=True)


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
    qg = to_kv(q.reshape(b, hkv, group, d) * scale, k_cache.dtype)
    logits = torch.einsum("bhgd,bhsd->bhgs", qg.float(), k_cache.float())
    kpos = torch.arange(s, device=q.device)
    valid = kpos <= pos
    if window is not None:
        valid = valid & (kpos > pos - window)
    logits = torch.where(valid, logits, -1e30)
    m = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - m)
    out = torch.einsum("bhgs,bhsd->bhgd", to_kv(p, k_cache.dtype).float(),
                       v_cache.float())
    out = out / p.sum(-1, keepdim=True)
    return out.reshape(b, hq, d).to(q.dtype)


def cache_update(cache: torch.Tensor, new: torch.Tensor,
                 slot: int) -> torch.Tensor:
    """cache [B,H,S,D] <- new [B,H,D] at position ``slot``, in place (the
    reference's dynamic-update-slice, cast as its ``astype`` casts:
    :func:`to_kv`; the caller owns the cache)."""
    cache[:, :, slot] = to_kv(new, cache.dtype)
    return cache


def attention_apply(
    cfg: ModelConfig,
    p: Params,
    x: torch.Tensor,               # [B, S, d_model]
    positions: torch.Tensor,       # [B, S]
    causal: bool = True,
    window: Optional[int] = None,
    shard: Sharder = NO_SHARD,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Full-sequence self-attention (prefill). Returns (out, (k, v)) with
    k, v [B, Hkv, S, D] after RoPE (this rank's KV heads at the
    ``attn_kv`` layout); out joins the residual (:func:`linear`)."""
    b, s, _ = x.shape
    H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    q, k, v = project_qkv(cfg, p, x, shard)
    q = heads(shard, q, "attn_heads", H, hd)
    k = heads(shard, k, "attn_kv", Hkv, hd)
    v = heads(shard, v, "attn_kv", Hkv, hd)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    q = shard(q.transpose(1, 2), "attn_heads", (b, H, s, hd))  # [B, H, S, D]
    kt = shard(k.transpose(1, 2), "attn_kv", (b, Hkv, s, hd))
    vt = shard(v.transpose(1, 2), "attn_kv", (b, Hkv, s, hd))
    ks, vs = kv_for_heads(shard, kt, vt, H, Hkv, q.shape[1])
    out = kops.flash_attention(q, ks, vs, causal=causal, window=window)
    out = out.transpose(1, 2).reshape(b, s, -1)
    return linear(out, p["wo"], shard, residual=True), (kt, vt)


def project_qkv(cfg: ModelConfig, p: Params, x: torch.Tensor,
                shard: Sharder = NO_SHARD):
    """x [B, S, d] @ wq, wk, wv (+ the biases): [B, S, columns] each, this
    rank's columns where a weight is column-parallel."""
    q = linear(x, p["wq"], shard)
    k = linear(x, p["wk"], shard)
    v = linear(x, p["wv"], shard)
    if cfg.qkv_bias:
        q, k, v = (q + shard.fit(p["bq"], -1, q.shape[-1]),
                   k + shard.fit(p["bk"], -1, k.shape[-1]),
                   v + shard.fit(p["bv"], -1, v.shape[-1]))
    return q, k, v


def heads(shard: Sharder, t: torch.Tensor, name: str, h: int,
          hd: int) -> torch.Tensor:
    """``t`` [B, S, columns] (``h`` heads of ``hd``, whole or this rank's
    columns) as [B, S, heads, hd] with the heads of ``name``'s layout
    (all, or this rank's): the columns gathered or cut to them."""
    b, s = t.shape[:2]
    n = shard.local(name, (b, h, s, hd))[1]
    return shard.fit(t, -1, n * hd).reshape(b, s, n, hd)


def kv_for_heads(shard: Sharder, k: torch.Tensor, v: torch.Tensor, H: int,
                 Hkv: int, hq: int):
    """The KV heads [B, heads, S, D] that this rank's ``hq`` query heads
    read, with a uniform group: the query heads of one rank are a
    contiguous run of the ``H`` (the first at ``rank * hq`` when they are
    cut), and query head ``h`` reads KV head ``h // (H / Hkv)`` of
    ``Hkv``. ``k``/``v`` hold all KV heads, or this rank's cut of them
    (which then serves exactly this rank's query heads). A view where the
    run's KV heads serve equal groups; a copy otherwise."""
    if k.shape[1] * H == hq * Hkv:      # the KV cut matches the query cut
        return k, v
    g = H // Hkv
    h0 = shard.rank * hq if hq != H else 0
    kv = [(h0 + i) // g for i in range(hq)]
    lo, n = kv[0], kv[-1] - kv[0] + 1
    if hq % n == 0 and kv == [lo + i // (hq // n) for i in range(hq)]:
        return k[:, lo:lo + n], v[:, lo:lo + n]
    idx = torch.tensor(kv, device=k.device)
    return k.index_select(1, idx), v.index_select(1, idx)
