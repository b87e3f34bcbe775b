"""Recurrent blocks: RG-LRU (RecurrentGemma/Griffin) and RWKV-6 (Finch).

Port of the reference's ``models/recurrent.py``. Both are O(1)-state
decoders; their sequence scans run through the checked kernel wrappers
(:func:`repro_torch.kernels.ops.rglru` and ``ops.rwkv6``): the CUDA
kernels for tensors on the card, the plain loops for tensors on the CPU.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..kernels import ops as kops
from .config import ModelConfig
from .layers import (NO_SHARD, Init, Params, Sharder, gelu, linear, row_mean,
                     sigmoid, silu)

_CONV_K = 4  # temporal conv width (Griffin)


# -- RG-LRU block -----------------------------------------------------------

def rglru_init(cfg: ModelConfig, dtype: torch.dtype) -> Params:
    d = cfg.d_model
    s = d ** -0.5
    return {
        "w_x": Init((d, d), dtype, "normal", s),       # recurrent branch
        "w_gate": Init((d, d), dtype, "normal", s),    # gelu gate branch
        "w_out": Init((d, d), dtype, "normal", s),
        "w_rg": Init((d, d), dtype, "normal", s),      # recurrence gate
        "w_ig": Init((d, d), dtype, "normal", s),      # input gate
        "conv": Init((_CONV_K, d), dtype, "normal", 0.5),
        "lam": Init((d,), torch.float32, "full", 0.7),  # Lambda (decay)
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal temporal conv. x [B,S,d], w [K,d].
    ``state`` [B,K-1,d] carries the last K-1 inputs for decode."""
    k = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    xx = torch.cat([state, x], dim=1)                         # [B, S+K-1, d]
    out = sum(xx[:, i:i + x.shape[1], :] * w[i] for i in range(k))
    return out, xx[:, -(k - 1):, :]


def _decay(p: Params, x: torch.Tensor,
           shard: Sharder = NO_SHARD) -> torch.Tensor:
    """a_t = exp(-c * softplus(lam) * sigmoid(W_rg x))  in (0, 1)."""
    c = 8.0
    r = sigmoid(linear(x, p["w_rg"], shard).float())
    lam = shard.fit(p["lam"], -1, r.shape[-1])
    # jax.nn.softplus is logaddexp(x, 0)
    softplus = torch.logaddexp(lam, torch.zeros_like(lam))
    return torch.exp(-c * softplus * r)


def rglru_block(cfg: ModelConfig, p: Params, x: torch.Tensor,
                state: Optional[Dict[str, torch.Tensor]] = None,
                shard: Sharder = NO_SHARD
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x [B,S,d] -> (out [B,S,d], new_state {conv [B,K-1,d], h [B,d]}).
    Over 'model' the branches, the scan and the state run on this rank's
    columns (``rnn_hidden``); out joins the residual (``linear``)."""
    b, s, d = x.shape
    gate = gelu(linear(x, p["w_gate"], shard))
    u = linear(x, p["w_x"], shard)
    conv = shard.fit(p["conv"], -1, u.shape[-1])
    u, conv_state = _causal_conv(
        u, conv, None if state is None else state["conv"])
    u = shard.to(u, "rnn_hidden", (b, s, d))
    a = _decay(p, x, shard)
    i = sigmoid(linear(x, p["w_ig"], shard).float())
    h0 = None if state is None else state["h"]
    y, hT = kops.rglru(u.float() * i, a, h0)
    out = linear(y.to(x.dtype) * gate, p["w_out"], shard, residual=True)
    return out, {"conv": conv_state, "h": hT}


def rglru_state_init(cfg: ModelConfig, batch: int,
                     dtype: torch.dtype = torch.float32,
                     device=None) -> Dict[str, torch.Tensor]:
    d = cfg.d_model
    return {"conv": torch.zeros((batch, _CONV_K - 1, d), dtype=dtype,
                                device=device),
            "h": torch.zeros((batch, d), dtype=torch.float32, device=device)}


# -- RWKV-6 block -------------------------------------------------------------

def rwkv6_init(cfg: ModelConfig, dtype: torch.dtype) -> Params:
    d = cfg.d_model
    H = d // cfg.rwkv_head_dim
    s = d ** -0.5
    return {
        "w_r": Init((d, d), dtype, "normal", s),
        "w_k": Init((d, d), dtype, "normal", s),
        "w_v": Init((d, d), dtype, "normal", s),
        "w_w": Init((d, d), dtype, "normal", s * 0.1),
        "w_g": Init((d, d), dtype, "normal", s),
        "w_o": Init((d, d), dtype, "normal", s),
        "u": Init((H, cfg.rwkv_head_dim), torch.float32, "normal", 0.1),
        "mix": Init((5, d), torch.float32, "full", 0.5),  # r/k/v/w/g shifts
        "ln_scale": Init((d,), torch.float32, "full", 1.0),  # wkv group norm
    }


def _token_shift(x: torch.Tensor, prev: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    """x_{t-1} stream: shift right by one; decode passes ``prev`` [B,1,d]."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    return torch.cat([prev, x[:, :-1]], dim=1)


def rwkv6_block(cfg: ModelConfig, p: Params, x: torch.Tensor,
                state: Optional[Dict[str, torch.Tensor]] = None,
                shard: Sharder = NO_SHARD
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Time-mix block. x [B,S,d] -> (out, state {shift [B,1,d],
    wkv [B,H,Dk,Dv]}).

    r, k, v and w reach the kernel as [B,H,S,hd] views of the [B,S,d]
    projections (no copy: the kernel reads their strides), and its output
    comes back in v's layout, so the swap back is a view too. Over 'model'
    the recurrence runs on this rank's heads (``attn_heads``), ``u`` and
    the state on their cut; the shift state holds this rank's columns;
    out joins the residual (``linear``)."""
    b, s, d = x.shape
    hd = cfg.rwkv_head_dim
    H = d // hd
    prev = None if state is None else shard.fit(state["shift"], -1, d)
    xs = _token_shift(x, prev)
    mix = p["mix"].to(x.dtype)
    xr, xk, xv, xw, xg = (x * mix[i] + xs * (1 - mix[i]) for i in range(5))
    n = shard.local("attn_heads", (b, H, s, hd))[1]     # this rank's heads

    def proj(t, w):
        return shard.fit(linear(t, p[w], shard), -1, n * hd)

    r = proj(xr, "w_r").reshape(b, s, n, hd).transpose(1, 2)  # [B,H,S,hd]
    k = proj(xk, "w_k").reshape(b, s, n, hd).transpose(1, 2)
    v = proj(xv, "w_v").reshape(b, s, n, hd).transpose(1, 2)
    w = torch.exp(-torch.exp(proj(xw, "w_w").float() - 4.0))
    w = w.reshape(b, s, n, hd).transpose(1, 2)
    g = silu(proj(xg, "w_g"))
    r = shard(r, "attn_heads", (b, H, s, hd))
    s0 = None if state is None else state["wkv"]
    o, sT = kops.rwkv6(r, k, v, w, shard.fit(p["u"], 0, n), s0)
    o = o.transpose(1, 2).reshape(b, s, n * hd)
    # per-head group norm (population variance, as jnp.var), its row means
    # independent of the row count
    o32 = o.float().reshape(b, s, n, hd)
    centred = o32 - row_mean(o32)
    o32 = centred * torch.rsqrt(row_mean(centred * centred) + 1e-5)
    o = (o32.reshape(b, s, n * hd)
         * shard.fit(p["ln_scale"], -1, n * hd)).to(x.dtype)
    out = linear(o * g, p["w_o"], shard, residual=True)
    shift = x[:, -1:]
    shift = shard.fit(shift, -1, shard.cache_local("shift", shift.shape)[-1])
    return out, {"shift": shift, "wkv": sT}


def rwkv6_state_init(cfg: ModelConfig, batch: int,
                     dtype: torch.dtype = torch.float32,
                     device=None) -> Dict[str, torch.Tensor]:
    d, hd = cfg.d_model, cfg.rwkv_head_dim
    H = d // hd
    return {"shift": torch.zeros((batch, 1, d), dtype=dtype, device=device),
            "wkv": torch.zeros((batch, H, hd, hd), dtype=torch.float32,
                               device=device)}
