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


def _decay(p: Params, x: torch.Tensor) -> torch.Tensor:
    """a_t = exp(-c * softplus(lam) * sigmoid(W_rg x))  in (0, 1)."""
    c = 8.0
    r = sigmoid(linear(x, p["w_rg"]).float())
    lam = p["lam"]
    # jax.nn.softplus is logaddexp(x, 0)
    softplus = torch.logaddexp(lam, torch.zeros_like(lam))
    return torch.exp(-c * softplus * r)


def rglru_block(cfg: ModelConfig, p: Params, x: torch.Tensor,
                state: Optional[Dict[str, torch.Tensor]] = None,
                shard: Sharder = NO_SHARD
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x [B,S,d] -> (out [B,S,d], new_state {conv [B,K-1,d], h [B,d]})."""
    gate = gelu(linear(x, p["w_gate"]))
    u = linear(x, p["w_x"])
    u, conv_state = _causal_conv(
        u, p["conv"], None if state is None else state["conv"])
    u = shard(u, "rnn_hidden")
    a = _decay(p, x)
    i = sigmoid(linear(x, p["w_ig"]).float())
    h0 = None if state is None else state["h"]
    y, hT = kops.rglru(u.float() * i, a, h0)
    out = linear(y.to(x.dtype) * gate, p["w_out"])
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
    comes back in v's layout, so the swap back is a view too."""
    b, s, d = x.shape
    hd = cfg.rwkv_head_dim
    H = d // hd
    xs = _token_shift(x, None if state is None else state["shift"])
    mix = p["mix"].to(x.dtype)
    xr, xk, xv, xw, xg = (x * mix[i] + xs * (1 - mix[i]) for i in range(5))
    r = linear(xr, p["w_r"]).reshape(b, s, H, hd).transpose(1, 2)   # [B,H,S,hd]
    k = linear(xk, p["w_k"]).reshape(b, s, H, hd).transpose(1, 2)
    v = linear(xv, p["w_v"]).reshape(b, s, H, hd).transpose(1, 2)
    w = torch.exp(-torch.exp(linear(xw, p["w_w"]).float() - 4.0))
    w = w.reshape(b, s, H, hd).transpose(1, 2)
    g = silu(linear(xg, p["w_g"]))
    r = shard(r, "attn_heads")
    s0 = None if state is None else state["wkv"]
    o, sT = kops.rwkv6(r, k, v, w, p["u"], s0)
    o = o.transpose(1, 2).reshape(b, s, d)
    # per-head group norm (population variance, as jnp.var), its row means
    # independent of the row count
    o32 = o.float().reshape(b, s, H, hd)
    centred = o32 - row_mean(o32)
    o32 = centred * torch.rsqrt(row_mean(centred * centred) + 1e-5)
    o = (o32.reshape(b, s, d) * p["ln_scale"]).to(x.dtype)
    out = linear(o * g, p["w_o"])
    return out, {"shift": x[:, -1:], "wkv": sT}


def rwkv6_state_init(cfg: ModelConfig, batch: int,
                     dtype: torch.dtype = torch.float32,
                     device=None) -> Dict[str, torch.Tensor]:
    d, hd = cfg.d_model, cfg.rwkv_head_dim
    H = d // hd
    return {"shift": torch.zeros((batch, 1, d), dtype=dtype, device=device),
            "wkv": torch.zeros((batch, H, hd, hd), dtype=torch.float32,
                               device=device)}
