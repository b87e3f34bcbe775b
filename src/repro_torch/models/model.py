"""Decoder-only / encoder-decoder LM assembly for the port's architectures:
serving modes.

Port of the reference's ``models/model.py`` (``Model.prefill`` and
``Model.decode_step``, the stack unrolled as the reference serves it).
Layers are grouped into *super-blocks* of ``cfg.block_pattern`` period as
the reference groups them: the parameters of slot ``si`` of every
super-block stack along a leading axis (``scan_layers.slot{si}.*``), and
the remainder layers follow as a list (``rest_layers.{i}.*``). The
module's parameter names are the reference's parameter-tree paths joined
with dots (``scan_layers.slot0.mixer.w_x``, ``embed``, ...), so weights
carry across by name (:func:`repro_torch.core.convert.model_params_from_fields`).
Caches keep the reference's layout too: ``{"scan": {"slot{si}": {name:
[n_super, ...]}}, "rest": [per-layer dicts]}``.

Modes:
  prefill — full-sequence forward; returns last-token logits + caches
            (attention K/V right-aligned into ``cache_len`` slots, rolled
            for windowed layers; recurrent states carried).
  decode  — one token; K/V caches updated at slot ``pos % cache_len``
            for windowed layers. ``decode_step`` updates the caches in
            place and returns them (the reference's engine donates its
            cache the same way).

MoE layers (``cfg.num_experts``) replace the FFN with :func:`.moe.moe_apply`
(``Model(moe_dispatch=...)`` picks its ``einsum`` or ``scatter`` path, the
reference's two functions), beside a dense FFN where ``cfg.dense_residual``
is set (arctic-480b).

The caches hold K/V in ``cfg.kv_dtype`` (qwen1.5-32b's
``float8_e4m3fn``), cast as the reference's ``astype`` casts
(:func:`.layers.to_kv`). Prefill attends the K/V before the cast and decode
reads the cache, the reference's order, so under an fp8 cache prefill(S) +
decode_step is not prefill(S+1) bit for bit.

Encoder-decoder configs (``cfg.is_encdec``: whisper-large-v3) run an
encoder over precomputed frame embeddings (the reference's frontend stub)
once per prefill: ``encoder.layers.*`` stacked along a leading
``[encoder_layers]`` axis, ``encoder.pos_embed``, ``encoder.final_norm``.
As in the reference, each encoder layer is the decoder's layer function
(:meth:`Model.encoder_cfg`): causal self-attention with RoPE. Each
decoder layer adds cross-attention (``cross``, ``norm_cross``) over the
encoder's output: at prefill ``ck = enc_out @ wk``, ``cv = enc_out @ wv``
(no bias, no RoPE), attended without a mask and stored in the caches'
``ck``/``cv``; a decode step attends all ``encoder_seq`` cached slots.
:meth:`Model.prefill` takes the frames (``frames=``) and raises without
them.

Vision-language configs (``cfg.vision_patches``: internvl2-76b) take
precomputed patch embeddings (the reference's frontend stub): ``prefill(...,
patches=[B, P, d_model])`` and a training batch's ``"patches"`` go in front
of the token embeddings, cast to the model's dtype, and positions run over
both; decode steps continue at position ``P + S``.

Training (``"train"`` mode; the reference's ``Model.loss_fn``):
:meth:`Model.loss_fn` runs the whole sequence (patch prefix, encoder
frames) with causal attention and no cache, the final norm, drops the
prefix and takes a streaming cross-entropy over ``loss_chunk`` positions
at a time (:func:`_chunked_ce`; float32 logits, recomputed in the
backward, so no [B, S, V] tensor is kept). It is switched on by PyTorch's
own idiom, ``model.requires_grad_(True)`` (and ``model.train()``); serving
keeps its ``inference_mode``. With ``remat`` (the default, as the
reference's ``jax.checkpoint(..., nothing_saveable)``) each super-block,
each encoder layer and each loss chunk runs under
``torch.utils.checkpoint`` (non-reentrant) and is recomputed in the
backward. Every product goes through the ``matmul`` and
``flash_attention`` autograd Functions (:mod:`..kernels.ops`). A layer of
a stacked parameter is taken through :class:`_LayerOf`, whose gradient
accumulates in place into the stack's ``.grad``. The recurrent mixers'
kernels (``rglru``, ``rwkv6``) have no backward: ``loss_fn`` refuses such
configs on every device.

Sharding (the reference's ``Model(shard=...)``): ``shard`` is the
activations' hook, called by logical name at the reference's points
(:class:`.layers.Sharder`; a no-op by default). ``param_hook``, when a
mesh sets it (``repro_torch.distributed.MeshParams``), hands out each
parameter where the forward uses it, from the local shard this rank
holds: a stacked parameter layer by layer where the stack hands the layer
out (inside each remat super-block, so the recompute gathers again), the
embedding, the head and the remainder layers where they are used. In
training it is gathered whole. Serving (``prefill``, ``decode_step`` and
``init_cache`` enter the sharder's ``serving`` context) keeps it on its
'model' cut and computes there: the residual's sequence cut in prefill
where the hint cuts it (each block's input gathered after its norm, its
last product reduce-scattered back), heads, columns and experts on their
cuts, caches on ``cache_shardings``' cut (a cut along the slots decoded
by ``flash_decode``'s partials and merge), the logits gathered whole.
Without a hook a parameter is the module's own tensor, as before.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core.vectorsim import resolve_device
from .config import ModelConfig
from ..kernels import ops as kops
from .layers import (NO_SHARD, Init, Params, Sharder, apply_norm,
                     attention_apply, attn_init, cache_update, dtype_of,
                     ffn_apply, ffn_init, heads, init_norm, kv_for_heads,
                     linear, project_qkv, rope, to_kv)
from .moe import DISPATCHES, moe_apply, moe_init
from .recurrent import (rglru_block, rglru_init, rglru_state_init,
                        rwkv6_block, rwkv6_init, rwkv6_state_init)


# -- per-layer params -------------------------------------------------------

def _layer_init(cfg: ModelConfig, kind: str, cross: bool = False) -> Params:
    dt = dtype_of(cfg.dtype)
    p: Params = {"norm1": init_norm(cfg, cfg.d_model),
                 "norm2": init_norm(cfg, cfg.d_model)}
    if kind == "attn":
        p["mixer"] = attn_init(cfg, dt)
    elif kind == "rglru":
        p["mixer"] = rglru_init(cfg, dt)
    elif kind == "rwkv6":
        p["mixer"] = rwkv6_init(cfg, dt)
    else:
        raise ValueError(kind)
    if cross:
        p["cross"] = attn_init(cfg, dt)
        p["norm_cross"] = init_norm(cfg, cfg.d_model)
    if cfg.num_experts:
        p["moe"] = moe_init(cfg, dt)
    if not cfg.num_experts or cfg.dense_residual:
        p["ffn"] = ffn_init(cfg, cfg.d_model, cfg.d_ff, dt)
    return p


def _layer_cache_init(cfg: ModelConfig, kind: str, batch: int,
                      cache_len: int, device, cross_len: int = 0,
                      shard: Sharder = NO_SHARD) -> Dict[str, torch.Tensor]:
    """One layer's decode cache of ``batch`` rows: this rank's cut of each
    leaf (``shard.cache_local``; the whole leaf without a mesh)."""
    if kind == "attn":
        dt = dtype_of(cfg.kv_dtype)
        hkv, hd = cfg.num_kv_heads, cfg.hd
        eff = min(cache_len, cfg.window) if cfg.window else cache_len
        slots = {"k": eff, "v": eff}
        if cross_len:  # the encoder-decoder's cross-attention K/V
            slots.update(ck=cross_len, cv=cross_len)
        return {name: torch.zeros(shard.cache_local(name, (batch, hkv, n,
                                                           hd)),
                                  dtype=dt, device=device)
                for name, n in slots.items()}
    if kind == "rglru":
        state = rglru_state_init(cfg, batch, dtype_of(cfg.dtype), device)
    else:
        state = rwkv6_state_init(cfg, batch, dtype_of(cfg.dtype), device)
    return {k: t if shard.cache_local(k, t.shape) == tuple(t.shape)
            else t.new_zeros(shard.cache_local(k, t.shape))
            for k, t in state.items()}


class ParamTree(nn.Module):
    """Parameters built from a nested dict of :class:`.layers.Init` specs:
    a sub-dict becomes a submodule, a spec a parameter of shape ``lead +
    spec.shape`` (a stack of ``lead`` layers). Serving parameters carry no
    gradient."""

    def __init__(self, specs: Params, lead: Tuple[int, ...] = (),
                 device=None):
        super().__init__()
        self.specs: Dict[str, Init] = {}
        for name, spec in specs.items():
            if isinstance(spec, dict):
                self.add_module(name, ParamTree(spec, lead, device))
            else:
                self.specs[name] = spec
                self.register_parameter(name, nn.Parameter(torch.empty(
                    tuple(lead) + tuple(spec.shape), dtype=spec.dtype,
                    device=device), requires_grad=False))

    def tree(self, index: Optional[int] = None, take=None) -> Params:
        """Nested dict of the tensors (of layer ``index`` of a stack), each
        through ``take(p, index)`` where a mesh hands parameters out."""
        out: Params = {}
        for name, p in self.named_parameters(recurse=False):
            out[name] = (take(p, index) if take is not None
                         else p if index is None else _layer(p, index))
        for name, m in self.named_children():
            out[name] = m.tree(index, take)
        return out


class _LayerOf(torch.autograd.Function):
    """Layer ``index`` of a stacked parameter (a view of ``stack[index]``)
    whose gradient is added in place into that layer's slice of the
    stack's ``.grad`` (zeros at the first), and none flows through autograd:
    indexing would hand autograd a zero-filled copy of the whole stack for
    every layer (llama3-8b's FFN stacks are 3.76 GB each in bf16)."""

    @staticmethod
    def forward(ctx, stack, index):
        ctx.stack, ctx.index = stack, index
        return stack[index]

    @staticmethod
    def backward(ctx, g):
        stack = ctx.stack
        if stack.grad is None:
            stack.grad = torch.zeros_like(stack)
        stack.grad[ctx.index] += g
        return None, None


def _layer(p: torch.Tensor, index: int) -> torch.Tensor:
    """Layer ``index`` of the stacked parameter ``p``."""
    if p.requires_grad and torch.is_grad_enabled():
        return _LayerOf.apply(p, index)
    return p[index]


def _fill(p: torch.Tensor, spec: Init,
          generator: Optional[torch.Generator]) -> None:
    if spec.kind == "normal":
        p.normal_(generator=generator)
        p.mul_(spec.value)
    elif spec.kind == "full":
        p.fill_(spec.value)
    else:
        raise ValueError(spec.kind)


# -- one layer, serving modes --------------------------------------------------

def _self_attn_decode(cfg: ModelConfig, p: Params, x: torch.Tensor,
                      cache: Params, pos: int, shard: Sharder = NO_SHARD
                      ) -> Tuple[torch.Tensor, Params]:
    """x [B,1,d]; cache update at the rolling slot + one-token attention.
    Over 'model' the cache holds this rank's KV heads, or its run of
    slots of every head (:func:`_decode_attend`)."""
    b = x.shape[0]
    H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    q, k, v = project_qkv(cfg, p["mixer"], x, shard)
    s_cache = _slots(shard, cache, "k")
    full = (b, Hkv, s_cache, hd)
    kc = shard(cache["k"], "kv_cache", full)
    vc = shard(cache["v"], "kv_cache", full)
    q = _decode_heads(shard, q, kc, H, Hkv, hd)
    k = shard.fit(k, -1, kc.shape[1] * hd).reshape(b, 1, -1, hd)
    v = shard.fit(v, -1, kc.shape[1] * hd).reshape(b, 1, -1, hd)
    posb = torch.full((b, 1), pos, dtype=torch.int64, device=x.device)
    q = rope(q, posb, cfg.rope_theta)[:, 0]                          # [B,H,D]
    k = rope(k, posb, cfg.rope_theta)[:, 0]                          # [B,Hkv,D]
    v = v[:, 0]
    slot = pos % s_cache if cfg.window else min(pos, s_cache - 1)
    here = slot - shard.rank * kc.shape[2] if kc.shape[2] != s_cache \
        else slot                               # the slot in this rank's run
    if 0 <= here < kc.shape[2]:
        cache_update(kc, k, here)
        cache_update(vc, v, here)
    # rolling cache: every slot is valid once pos >= s_cache; eff_pos + 1
    # keys are live (decode_attention's mask kpos <= eff_pos), read in
    # position order (position p sits at slot p % s_cache), as the prefill
    # of one more token reads them
    eff_pos = min(pos, s_cache - 1) if cfg.window else pos
    length = torch.full((b,), eff_pos + 1, dtype=torch.int32,
                        device=x.device)
    end = torch.full((b,), pos + 1, dtype=torch.int32, device=x.device)
    out = _decode_attend(shard, q, kc, vc, length, end, s_cache)
    out = linear(out.reshape(b, 1, -1), p["mixer"]["wo"], shard,
                 residual=True)
    new_cache = dict(cache)
    new_cache["k"], new_cache["v"] = kc, vc
    return out, new_cache


def _slots(shard: Sharder, cache: Params, name: str) -> int:
    """The whole cache's slots of leaf ``name`` (``k`` or ``ck``): its own
    where it is whole; over 'model' the count its caches were made with
    (``shard.cache_slots``), which a cut along the slots hides."""
    return shard.cache_slots[name] if shard.tp else cache[name].shape[2]


def _decode_heads(shard: Sharder, q: torch.Tensor, kc: torch.Tensor, H: int,
                  Hkv: int, hd: int) -> torch.Tensor:
    """The query [B, 1, columns] as [B, 1, heads, hd]: the query heads of
    the cache's KV heads (this rank's where the cache holds a cut of them,
    else all)."""
    n = H if kc.shape[1] == Hkv else kc.shape[1] * (H // Hkv)
    return shard.fit(q, -1, n * hd).reshape(q.shape[0], 1, n, hd)


def _decode_attend(shard: Sharder, q: torch.Tensor, kc: torch.Tensor,
                   vc: torch.Tensor, length: torch.Tensor,
                   end: Optional[torch.Tensor], s_cache: int) -> torch.Tensor:
    """``flash_decode`` of q [B, Hq, D] over the cache: whole along the
    slots (whole, or this rank's KV heads) in one call; cut along them
    (this rank holds slots ``rank * L .. rank * L + L - 1`` of
    ``s_cache``), each rank's chunks' partials for every query head
    (``flash_decode_partial``), exchanged over 'model' and merged in the
    whole-cache kernel's chunk order (``flash_decode_merge``)."""
    L = kc.shape[2]
    if L == s_cache:
        return kops.flash_decode(q, kc, vc, length, end)
    part = kops.flash_decode_partial(q, kc, vc, length, end,
                                     shard.rank * L, s_cache)
    return kops.flash_decode_merge(shard.gather_parts(part), q, length, end,
                                   s_cache, L, kc.shape[1])


def _right_align_cache(cfg: ModelConfig, kt: torch.Tensor, vt: torch.Tensor,
                       cache_len: int, shard: Sharder = NO_SHARD) -> Params:
    """[B,Hkv,S,D] -> cache of ``min(cache_len, window)`` slots, with each
    absolute position p stored at slot p % len (rolling invariant)."""
    s = kt.shape[2]
    eff = min(cache_len, cfg.window) if cfg.window else cache_len
    if not cfg.window and s > eff:
        raise ValueError(
            f"full-attention prefill of {s} tokens needs cache_len >= {s}, "
            f"got {cache_len}")
    if s >= eff:
        k_sl, v_sl = kt[:, :, s - eff:], vt[:, :, s - eff:]
        if cfg.window:
            shift = (s - eff) % eff
            k_sl = torch.roll(k_sl, shift, dims=2)
            v_sl = torch.roll(v_sl, shift, dims=2)
    else:
        pad = (0, 0, 0, eff - s)
        k_sl = torch.nn.functional.pad(kt, pad)
        v_sl = torch.nn.functional.pad(vt, pad)
    kd = dtype_of(cfg.kv_dtype)
    full = (kt.shape[0], cfg.num_kv_heads, eff, cfg.hd)
    return {"k": shard.to(to_kv(k_sl, kd).contiguous(), "kv_cache", full),
            "v": shard.to(to_kv(v_sl, kd).contiguous(), "kv_cache", full)}


def _cross_attn(cfg: ModelConfig, p: Params, x: torch.Tensor,
                mode: str, cache: Optional[Params],
                enc_out: Optional[torch.Tensor], new_cache: Params,
                shard: Sharder = NO_SHARD) -> torch.Tensor:
    """Decoder cross-attention of ``x`` [B, S, d] over the encoder's keys
    and values (``p`` the layer's ``cross`` weights; no bias, no RoPE, no
    mask). Prefill projects ``enc_out`` [B, Se, d] and stores ``ck``/``cv``
    [B, Hkv, Se, D] in ``new_cache`` (cast to ``kv_dtype``; the attention
    reads them before the cast, as the reference's does); a decode step
    reads all Se cached slots, which it leaves as they are. ``"train"``
    mode attends as prefill and stores nothing. The output joins the
    residual (:func:`.layers.linear`)."""
    b, s, _ = x.shape
    H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    q = linear(x, p["wq"], shard)
    if mode == "decode":
        se = _slots(shard, cache, "ck")
        full = (b, Hkv, se, hd)
        ck = shard(cache["ck"], "kv_cache", full)
        cv = shard(cache["cv"], "kv_cache", full)
        q = _decode_heads(shard, q, ck, H, Hkv, hd)[:, 0]
        length = torch.full((b,), se, dtype=torch.int32, device=x.device)
        out = _decode_attend(shard, q, ck, cv, length, None, se)
    else:
        se = enc_out.shape[1]
        q = shard(heads(shard, q, "attn_heads", H, hd).transpose(1, 2),
                  "attn_heads", (b, H, s, hd))               # [B, H, S, D]
        ck, cv = (shard(heads(shard, linear(enc_out, p[w], shard),
                              "attn_kv", Hkv, hd).transpose(1, 2),
                        "attn_kv", (b, Hkv, se, hd))
                  for w in ("wk", "wv"))
        ks, vs = kv_for_heads(shard, ck, cv, H, Hkv, q.shape[1])
        out = kops.flash_attention(q, ks, vs, causal=False).transpose(1, 2)
        if mode == "prefill":
            kd = dtype_of(cfg.kv_dtype)
            full = (b, Hkv, se, hd)
            new_cache["ck"] = shard.to(to_kv(ck, kd).contiguous(),
                                       "kv_cache", full)
            new_cache["cv"] = shard.to(to_kv(cv, kd).contiguous(),
                                       "kv_cache", full)
    return linear(out.reshape(b, s, -1), p["wo"], shard, residual=True)


def _layer_apply(cfg: ModelConfig, kind: str, p: Params, x: torch.Tensor,
                 positions: torch.Tensor, mode: str, cache: Optional[Params],
                 pos: Optional[int], cache_len: int,
                 moe_dispatch: str = "einsum",
                 enc_out: Optional[torch.Tensor] = None,
                 shard: Sharder = NO_SHARD
                 ) -> Tuple[torch.Tensor, Optional[Params]]:
    """One layer in ``mode`` ``"prefill"``, ``"decode"`` or ``"train"``
    (the whole sequence, causal, no cache: training, and the encoder's
    layers)."""
    # over 'model' in prefill the residual x may hold this rank's run of
    # the sequence (Megatron-SP): each block's input is gathered whole
    # after its norm, and its last product comes back cut as x is
    full_s = positions.shape[1]
    h = shard.fit(apply_norm(cfg, p["norm1"], x), 1, full_s)
    new_cache = None
    if kind == "attn":
        if mode == "decode":
            out, new_cache = _self_attn_decode(cfg, p, h, cache, pos, shard)
        else:
            out, (kt, vt) = attention_apply(
                cfg, p["mixer"], h, positions, causal=True, window=cfg.window,
                shard=shard)
            if mode == "prefill":
                new_cache = _right_align_cache(cfg, kt, vt, cache_len, shard)
    elif kind == "rglru":
        out, new_cache = rglru_block(cfg, p["mixer"], h, cache, shard)
    else:  # rwkv6
        out, new_cache = rwkv6_block(cfg, p["mixer"], h, cache, shard)
    x = x + out
    if "cross" in p:  # the encoder-decoder's decoder layers
        hx = shard.fit(apply_norm(cfg, p["norm_cross"], x), 1, full_s)
        x = x + _cross_attn(cfg, p["cross"], hx, mode, cache, enc_out,
                            new_cache, shard)
    h2 = shard.fit(apply_norm(cfg, p["norm2"], x), 1, full_s)
    if cfg.num_experts:
        out2 = moe_apply(cfg, p["moe"], h2, moe_dispatch, shard)
        if cfg.dense_residual:
            out2 = out2 + ffn_apply(cfg, p["ffn"], h2, shard)
    else:
        out2 = ffn_apply(cfg, p["ffn"], h2, shard)
    return shard(x + out2, "residual", (x.shape[0], full_s, x.shape[2])), \
        new_cache


# -- the model ---------------------------------------------------------------

class Model(nn.Module):
    """The model of one config, its parameters on ``device`` (``cuda``
    unless the caller names another; raises without a GPU).

    The parameters are allocated uninitialised and without gradients:
    :meth:`init` draws them (the reference's distributions and scales) or
    ``load_state_dict`` / ``convert.model_params_from_fields`` fills
    them; ``requires_grad_(True)`` makes them trainable. ``moe_dispatch``
    picks the MoE layers' path (``"einsum"``, the reference's default, or
    ``"scatter"``); ``remat`` recomputes each super-block, encoder layer
    and loss chunk in the backward; ``loss_chunk`` is the loss's sequence
    chunk; ``shard`` is the activations' hook (the reference's
    ``shard=``). ``param_hook`` (``None``: the module's own tensors) hands
    parameters out under a mesh (see the module docstring)."""

    def __init__(self, cfg: ModelConfig, device=None,
                 moe_dispatch: str = "einsum", remat: bool = True,
                 loss_chunk: int = 512, shard: Sharder = NO_SHARD):
        super().__init__()
        self.shard = shard
        self.param_hook = None
        if moe_dispatch not in DISPATCHES:
            raise ValueError(f"moe_dispatch must be one of {DISPATCHES}, "
                             f"got {moe_dispatch!r}")
        self.cfg = cfg
        self.moe_dispatch = moe_dispatch
        self.remat = remat
        self.loss_chunk = loss_chunk
        dev = resolve_device(device)
        dt = dtype_of(cfg.dtype)
        d, V = cfg.d_model, cfg.vocab_size
        self.specs = {"embed": Init((V, d), dt, "normal", d ** -0.5)}
        if not cfg.tied_embeddings:
            self.specs["lm_head"] = Init((d, V), dt, "normal", d ** -0.5)
        for name, spec in self.specs.items():
            self.register_parameter(name, nn.Parameter(torch.empty(
                spec.shape, dtype=spec.dtype, device=dev),
                requires_grad=False))
        self.final_norm = ParamTree(init_norm(cfg, d), device=dev)
        self.n_super = cfg.num_layers // cfg.pattern_period
        groups = self._group_layers()
        cross = cfg.is_encdec
        if self.n_super:
            self.scan_layers = nn.ModuleDict({
                slot: ParamTree(_layer_init(cfg, cfg.layer_kind(layers[0]),
                                            cross), (self.n_super,), dev)
                for slot, layers in groups["scan_layers"].items()})
        self.rest_layers = nn.ModuleList(
            ParamTree(_layer_init(cfg, cfg.layer_kind(li), cross), device=dev)
            for li in groups["rest_layers"])
        if cross:
            self.encoder = ParamTree({
                "pos_embed": Init((cfg.encoder_seq, d), dt, "normal", 0.02),
                "final_norm": init_norm(cfg, d)}, device=dev)
            self.encoder.add_module("layers", ParamTree(
                _layer_init(self.encoder_cfg(), "attn"),
                (cfg.encoder_layers,), dev))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def _param(self, p: torch.Tensor) -> torch.Tensor:
        """An unstacked parameter as the forward uses it (whole)."""
        return p if self.param_hook is None else self.param_hook(p, None)

    # ---- init ----
    def init(self, generator: Optional[torch.Generator] = None) -> "Model":
        """Draw every parameter in place, in the reference's distributions
        and scales (normal times the fan-in scale; norms, decays and mixes
        at their constants), from ``generator`` (on the model's device)."""
        for mod in self.modules():
            if isinstance(mod, (Model, ParamTree)):
                for name, spec in mod.specs.items():
                    _fill(getattr(mod, name), spec, generator)
        return self

    def encoder_cfg(self) -> ModelConfig:
        """The encoder layers' config: ``encoder_heads`` query and KV heads,
        no window, no experts (the reference's ``Model.encoder_cfg``)."""
        cfg = self.cfg
        heads = cfg.encoder_heads or cfg.num_heads
        return dataclasses.replace(cfg, num_kv_heads=heads, num_heads=heads,
                                   block_pattern=("attn",), num_experts=0,
                                   window=None)

    def _group_layers(self) -> Params:
        """Layer index of every (super-block, slot) of the stack and of the
        remainder layers, the reference's grouping."""
        period = self.cfg.pattern_period
        return {"scan_layers": {f"slot{si}": [b * period + si
                                              for b in range(self.n_super)]
                                for si in range(period)} if self.n_super
                else {},
                "rest_layers": list(range(self.n_super * period,
                                          self.cfg.num_layers))}

    # ---- caches ----
    def init_cache(self, batch: int, cache_len: int) -> Params:
        """Zeroed decode caches of ``batch`` rows and ``cache_len`` slots
        (a window's fewer): over 'model' this rank's cut of each leaf."""
        with self._serving():
            return self._init_cache(batch, cache_len)

    def _init_cache(self, batch: int, cache_len: int) -> Params:
        cfg = self.cfg
        period = cfg.pattern_period
        cross_len = cfg.encoder_seq if cfg.is_encdec else 0
        self._note_slots(cache_len, cross_len)
        caches: Params = {"rest": [
            _layer_cache_init(cfg, cfg.layer_kind(li), batch, cache_len,
                              self.device, cross_len, self.shard)
            for li in self._group_layers()["rest_layers"]]}
        if self.n_super:
            caches["scan"] = {
                f"slot{si}": {
                    k: x[None].expand((self.n_super,) + x.shape).clone()
                    for k, x in _layer_cache_init(
                        cfg, cfg.block_pattern[si], batch, cache_len,
                        self.device, cross_len, self.shard).items()}
                for si in range(period)}
        return caches

    def _note_slots(self, cache_len: int, cross_len: int) -> None:
        """Tell a tensor-parallel sharder the whole slots of the caches
        being made (``MeshSharder.cache_slots``), which a decode step's
        cut along the slots does not show."""
        if self.shard.tp:
            cfg = self.cfg
            self.shard.cache_slots = {
                "k": min(cache_len, cfg.window) if cfg.window else cache_len,
                "ck": cross_len}

    def _serving(self):
        """The sharder's serving context (``MeshSharder.serving``: the
        weights and activations on their 'model' cuts); none without a
        mesh."""
        serving = getattr(self.shard, "serving", None)
        return serving() if serving is not None else contextlib.nullcontext()

    # ---- stack ----
    def _remat(self) -> bool:
        """Whether this forward recomputes its blocks in the backward."""
        return self.remat and torch.is_grad_enabled()

    def _run_stack(self, x: torch.Tensor, positions: torch.Tensor, mode: str,
                   caches: Optional[Params], pos: Optional[int],
                   cache_len: int, enc_out: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, Params]:
        cfg = self.cfg
        period = cfg.pattern_period
        decode = mode == "decode"
        new_scan: Dict[str, List[Params]] = {f"slot{si}": []
                                              for si in range(period)}
        take = self.param_hook
        if mode == "train":
            def superblock(x, bi):
                for si in range(period):
                    tree = self.scan_layers[f"slot{si}"].tree(bi, take)
                    x, _ = _layer_apply(cfg, cfg.block_pattern[si], tree, x,
                                        positions, mode, None, None, 0,
                                        self.moe_dispatch, enc_out,
                                        self.shard)
                return x

            for bi in range(self.n_super):
                x = (checkpoint(superblock, x, bi, use_reentrant=False)
                     if self._remat() else superblock(x, bi))
        else:
            for bi in range(self.n_super):
                for si in range(period):
                    slot = f"slot{si}"
                    c_in = None
                    if decode:
                        c_in = {k: t[bi]
                                for k, t in caches["scan"][slot].items()}
                    x, c_out = _layer_apply(
                        cfg, cfg.block_pattern[si],
                        self.scan_layers[slot].tree(bi, take), x, positions,
                        mode, c_in, pos, cache_len, self.moe_dispatch,
                        enc_out, self.shard)
                    if decode:  # write back into the stacked caches (the
                        # cross caches ck/cv come back as they went in)
                        for k, t in c_out.items():
                            if t is not c_in[k]:
                                c_in[k].copy_(t)
                    else:
                        new_scan[slot].append(c_out)
        rest = []
        for i, lp in enumerate(self.rest_layers):
            li = self.n_super * period + i
            c_in = caches["rest"][i] if decode else None
            x, c_out = _layer_apply(cfg, cfg.layer_kind(li), lp.tree(None, take),
                                    x, positions, mode, c_in, pos, cache_len,
                                    self.moe_dispatch, enc_out, self.shard)
            rest.append(c_out)
        if decode:
            caches["rest"] = rest
            return x, caches
        out: Params = {"rest": rest}
        if self.n_super and mode != "train":
            out["scan"] = {slot: {k: torch.stack([c[k] for c in cs])
                                  for k in cs[0]}
                           for slot, cs in new_scan.items()}
        return x, out

    def _encode(self, frames: torch.Tensor) -> torch.Tensor:
        """The encoder over frame embeddings ``frames`` [B, Se, d] (in the
        model's dtype): ``+ pos_embed[:Se]``, the encoder layers at
        positions 0..Se-1 (causal, rotary: the reference's layer function),
        the final norm. Unrolled, as the decoder is; each layer recomputed
        in the backward under ``remat``."""
        enc_cfg = self.encoder_cfg()
        enc = self.encoder
        b, se, d = frames.shape
        pos_embed = self._param(enc.pos_embed)
        # over 'model': this rank's columns of the sum, gathered whole, and
        # the residual's layout from the first layer on
        x = self.shard.fit(self.shard.fit(frames, -1, pos_embed.shape[1])
                           + pos_embed[None, :se], -1, d)
        x = self.shard.to(x, "residual", (b, se, d))
        positions = torch.arange(se, device=frames.device).expand(b, se)
        take = self.param_hook

        def layer(x, li):
            return _layer_apply(enc_cfg, "attn", enc.layers.tree(li, take), x,
                                positions, "train", None, None, 0,
                                shard=self.shard)[0]

        for li in range(self.cfg.encoder_layers):
            x = (checkpoint(layer, x, li, use_reentrant=False)
                 if self._remat() else layer(x, li))
        return self.shard.fit(apply_norm(self.cfg,
                                         enc.final_norm.tree(None, take), x),
                              1, se)

    def _head(self) -> torch.Tensor:
        if self.cfg.tied_embeddings:
            embed = self._param(self.embed)
            head = embed.T
            cut = getattr(embed, "tp_cut", None)
            if cut is not None:
                head.tp_cut = 1 - cut
            return head
        return self._param(self.lm_head)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, d] @ the head: [B, V], every column (gathered over 'model'
        where the head is cut along the vocabulary)."""
        return self.shard.fit(linear(x, self._head(), self.shard), -1,
                              self.cfg.vocab_size)

    def _inputs(self, tokens, patches=None, frames=None
                ) -> Tuple[torch.Tensor, int, Optional[torch.Tensor]]:
        """(embeddings [B, P + S, d] with a vision config's ``patches``
        [B, P, d] in front, cast to the model's dtype; P; the encoder's
        output over an encoder-decoder config's ``frames``)."""
        d = self.cfg.d_model
        x = self.shard.fit(self._param(self.embed)[tokens], -1, d)
        n_prefix = 0
        if self.cfg.vision_patches and patches is not None:
            pt = torch.as_tensor(patches, device=self.device).to(x.dtype)
            x = torch.cat([pt, x], 1)
            n_prefix = pt.shape[1]
        x = self.shard.to(x, "activations", x.shape)
        enc_out = None
        if self.cfg.is_encdec:
            if frames is None:
                raise ValueError(
                    f"{self.cfg.name} is an encoder-decoder: it needs "
                    f"frames [B, {self.cfg.encoder_seq}, "
                    f"{self.cfg.d_model}] (frame embeddings)")
            enc_out = self._encode(torch.as_tensor(
                frames, device=self.device).to(x.dtype))
        return x, n_prefix, enc_out

    # ---- public: train ----
    def loss_fn(self, batch: Dict[str, object]
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Next-token cross-entropy of ``batch`` (``tokens`` [B, S];
        optional ``labels``, ``loss_mask``, and a vision config's
        ``patches`` or an encoder-decoder's ``frames``), chunked over the
        sequence: (loss, {"loss", "tokens"}), the reference's. Gradients
        flow to the parameters that require them (a recurrent mixer's
        through its kernel's autograd Function and backward kernel)."""
        cfg = self.cfg
        dev = self.device
        tokens = torch.as_tensor(batch["tokens"], device=dev).long()
        b, s = tokens.shape
        x, n_prefix, enc_out = self._inputs(tokens, batch.get("patches"),
                                            batch.get("frames"))
        positions = torch.arange(x.shape[1], device=dev).expand(b, -1)
        x, _ = self._run_stack(x, positions, "train", None, None, 0, enc_out)
        x = apply_norm(cfg, self.final_norm.tree(None, self.param_hook), x)
        x = x[:, n_prefix:]                              # text positions only
        labels = batch.get("labels")
        labels = (torch.cat([tokens[:, 1:], tokens[:, :1]], 1)
                  if labels is None else
                  torch.as_tensor(labels, device=dev).long())
        mask = batch.get("loss_mask")
        mask = (torch.ones((b, s), dtype=torch.float32, device=dev)
                if mask is None else
                torch.as_tensor(mask, device=dev).float())
        loss, denom = _chunked_ce(x, self._head(), labels, mask,
                                  self.loss_chunk, self._remat(),
                                  self.shard.batch_sum)
        return loss, {"loss": self.shard.batch_sum(loss.detach()),
                      "tokens": denom}

    # ---- public: serving ----
    @torch.inference_mode()
    def prefill(self, tokens, cache_len: Optional[int] = None,
                patches=None, frames=None) -> Tuple[torch.Tensor, Params]:
        """tokens [B, S] -> (last-token logits [B, V], caches). A vision
        config takes ``patches`` [B, P, d_model], the frontend's patch
        embeddings, in front of the tokens (positions 0..P+S-1; decode
        continues at P+S). An encoder-decoder config takes ``frames`` [B,
        Se, d_model], the frontend's frame embeddings (cast to the model's
        dtype), and its caches hold the cross-attention's ``ck``/``cv`` of
        Se slots."""
        with self._serving():
            return self._prefill(tokens, cache_len, patches, frames)

    def _prefill(self, tokens, cache_len, patches, frames):
        tokens = torch.as_tensor(tokens, device=self.device).long()
        b = tokens.shape[0]
        x, n_prefix, enc_out = self._inputs(tokens, patches, frames)
        s = tokens.shape[1] + n_prefix
        positions = torch.arange(s, device=self.device).expand(b, s)
        cache_len = cache_len or s
        self._note_slots(cache_len, enc_out.shape[1] if enc_out is not None
                         else 0)
        x, caches = self._run_stack(x, positions, "prefill", None, None,
                                    cache_len, enc_out)
        norm = self.final_norm.tree(None, self.param_hook)
        if self.shard.tp:   # the last position, from the rank holding it
            x = apply_norm(self.cfg, norm, self.shard.last_token(x, s))
        else:
            x = apply_norm(self.cfg, norm, x)[:, -1]
        return self._logits(x), caches                           # [B, V]

    @torch.inference_mode()
    def decode_step(self, caches: Params, token, pos: int
                    ) -> Tuple[torch.Tensor, Params]:
        """token [B] int, pos int -> (logits [B, V], caches updated in
        place)."""
        with self._serving():
            token = torch.as_tensor(token, device=self.device).long()
            pos = int(pos)
            x = self.shard.fit(self._param(self.embed)[token[:, None]], -1,
                               self.cfg.d_model)
            x = self.shard.to(x, "activations", x.shape)       # [B, 1, d]
            positions = torch.full((x.shape[0], 1), pos, dtype=torch.int64,
                                   device=self.device)
            x, caches = self._run_stack(x, positions, "decode", caches, pos,
                                        0)
            x = apply_norm(self.cfg,
                           self.final_norm.tree(None, self.param_hook), x)
            return self._logits(x[:, 0]), caches


#: weight products of each mixer's block (``recurrent.py``: the RG-LRU
#: block's gate, x, decay, input and output projections; RWKV-6's r, k,
#: v, w, g and output)
MIXER_PRODUCTS = {"attn": 4, "rglru": 5, "rwkv6": 6}
#: the recurrent mixers: each launches its kernel forward and its backward
#: kernel once a layer
RECURRENT = ("rglru", "rwkv6")


def train_launches(cfg: ModelConfig, seq: int, loss_chunk: int = 512,
                   remat: bool = True) -> Dict[str, int]:
    """Kernel launches of one training step (:meth:`Model.loss_fn` and its
    backward) over ``seq`` text positions, by kernel: ``matmul``,
    ``flash_attention``, ``rglru``, ``rglru_bwd``, ``rwkv6``,
    ``rwkv6_bwd``. A weight product launches once forward and twice in the
    backward (dX and dW), a norm's row-mean product once forward and once
    backward (its other operand is a constant column), ``flash_attention``
    once forward (its backward is torch code), a recurrence once forward
    and its backward kernel once; under ``remat`` every forward inside a
    super-block, an encoder layer or a loss chunk launches once more in
    the recompute. Outside them: the remainder layers, the final norms.
    RWKV-6's per-head group norm is two row means over the head dim."""
    from .layers import row_mean_launches
    from .moe import moe_launches

    per_norm = ((1 if cfg.norm == "rmsnorm" else 2)
                * row_mean_launches(cfg.d_model))
    ffn = 3 if cfg.glu else 2
    cross = int(cfg.is_encdec)

    def layer(kind: str):
        """(weight products, row-mean products, attention calls, the
        recurrence's kernel or None)."""
        attn = kind == "attn"
        w = MIXER_PRODUCTS[kind] + (4 * cross if attn else 0)
        if cfg.num_experts:
            w += moe_launches(cfg) + ffn * cfg.dense_residual
        else:
            w += ffn
        r = per_norm * (2 + cross)
        if kind == "rwkv6":
            r += 2 * row_mean_launches(cfg.rwkv_head_dim)
        return (w, r, int(attn) * (1 + cross),
                kind if kind in RECURRENT else None)

    re = int(remat)
    period = cfg.pattern_period
    n_super = cfg.num_layers // period
    inside = [layer(cfg.block_pattern[si])
              for si in range(period)] * n_super
    outside = [layer(cfg.layer_kind(li))
               for li in range(n_super * period, cfg.num_layers)]
    if cfg.is_encdec:
        enc = (4 + ffn, 2 * per_norm, 1, None)
        inside += [enc] * cfg.encoder_layers
        outside.append((0, per_norm, 0, None))  # the encoder's final norm
    outside.append((0, per_norm, 0, None))      # the final norm
    chunks = -(-seq // min(loss_chunk, seq))
    inside.append((chunks, 0, 0, None))         # the loss chunks' head
    out = dict.fromkeys(("matmul", "flash_attention") + tuple(
        f"{k}{s}" for k in RECURRENT for s in ("", "_bwd")), 0)
    for group, extra in ((inside, re), (outside, 0)):
        for w, r, a, rec in group:
            out["matmul"] += w * (3 + extra) + r * (2 + extra)
            out["flash_attention"] += a * (1 + extra)
            if rec is not None:
                out[rec] += 1 + extra
                out[f"{rec}_bwd"] += 1
    return out


def _ce_chunk(xc: torch.Tensor, head: torch.Tensor, lc: torch.Tensor,
              mc: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One chunk's summed masked cross-entropy and mask count: logits
    ``xc @ head`` in the model's dtype, then float32."""
    logits = linear(xc, head).float()                    # [B, chunk, V]
    lse = torch.logsumexp(logits, -1)
    gold = logits.gather(-1, lc[..., None])[..., 0]
    return ((lse - gold) * mc).sum(), mc.sum()


def _chunked_ce(x: torch.Tensor, head: torch.Tensor, labels: torch.Tensor,
                mask: torch.Tensor, chunk: int, remat: bool,
                count=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Streaming softmax cross-entropy over sequence chunks of ``chunk``
    positions (the last padded with zero rows, label 0 and mask 0, as the
    reference pads): (sum of masked CE / max(mask count, 1), mask count).
    Under ``remat`` each chunk's logits are recomputed in the backward, so
    no [B, chunk, V] tensor outlives its chunk. ``count`` maps this rank's
    mask count to the whole batch's (a sum over the ranks that hold other
    rows: their losses then add up to the whole batch's loss); none, the
    rows here are the batch."""
    b, s, d = x.shape
    chunk = min(chunk, s)
    n = -(-s // chunk)
    pad = n * chunk - s
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
        labels = torch.nn.functional.pad(labels, (0, pad))
        mask = torch.nn.functional.pad(mask, (0, pad))
    tot = cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n):
        part = (x[:, i * chunk:(i + 1) * chunk], head,
                labels[:, i * chunk:(i + 1) * chunk],
                mask[:, i * chunk:(i + 1) * chunk])
        ce, c = (checkpoint(_ce_chunk, *part, use_reentrant=False)
                 if remat else _ce_chunk(*part))
        tot, cnt = tot + ce, cnt + c
    if count is not None:
        cnt = count(cnt)
    return tot / torch.clamp_min(cnt, 1.0), cnt
