"""Mixture-of-Experts FFN: top-k routing with a capacity per token group.

Port of the reference's ``models/moe.py``. Tokens are re-grouped to
``group_len`` before dispatch (GShard style), and each expert holds
``capacity`` slots per group. A (token, choice) pair takes its expert's
next slot in the order of the group's tokens, then of the token's choices;
a pair past the last slot is dropped. Left-padding tokens are routed and
counted like any other, as the reference routes them.

Two dispatch paths, each computing its reference path's function:

  * ``einsum`` (the default): every kept expert is weighted by the *sum of
    the token's kept gates*, the reference's combine einsum summing the
    choice axis away (``src/repro/models/moe.py:81-82``; ROADMAP Queue 3
    item 17). With nothing dropped the gates sum to 1, so the token gets
    the plain sum of its experts' outputs. Added in ascending expert order,
    as the contraction over (expert, slot) meets them.
  * ``scatter``: the gate-weighted sum of the kept experts, in top-k order.

Both dispatch by index where the reference multiplies one-hot tensors: a
slot holds at most one token, so gathering each slot's token is exact.
Every slot of every expert is computed, as the reference's einsum computes
every slot, so no host sync decides which experts are busy: one ``linear``
per expert and product on the expert's weight view and its slot rows.

Every step keeps a row's value independent of the number of rows, so in
bf16 prefill(S) + decode_step equals prefill(S+1) bit for bit wherever
nothing is dropped (capacity factor E/k; drops depend on the group, so at
the shipped 1.25 neither the reference nor the port holds it). The float32
router product goes through the float32 ``matmul``, torch's softmax over
the short expert axis takes each row alone (one warp a row on the card),
top-k is a stable sort (ties go to the lower expert, as
``jax.lax.top_k``), and the combine adds in float32 in a fixed order and
rounds once to x's dtype.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .config import ModelConfig
from .layers import NO_SHARD, Init, Params, Sharder, _act, linear

DISPATCHES = ("einsum", "scatter")


def moe_init(cfg: ModelConfig, dtype: torch.dtype) -> Params:
    """The router stays float32 in every model, as the reference's."""
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    s_in, s_out = d ** -0.5, ff ** -0.5
    p = {"router": Init((d, E), torch.float32, "normal", s_in),
         "w_up": Init((E, d, ff), dtype, "normal", s_in),
         "w_down": Init((E, ff, d), dtype, "normal", s_out)}
    if cfg.glu:
        p["w_gate"] = Init((E, d, ff), dtype, "normal", s_in)
    return p


def group_len(cfg: ModelConfig, s: int) -> int:
    """Dispatch group size: the largest divisor of ``s`` up to the target
    (3/8 of d_ff, clamped to 128..1024)."""
    target = max(min(3 * cfg.d_ff // 8, 1024), 128)
    g = min(target, s)
    while s % g:
        g -= 1
    return g


def capacity(cfg: ModelConfig, gl: int) -> int:
    """Slots per expert and group: ceil(gl * top_k * capacity_factor / E),
    at least 1 (the reference's float arithmetic)."""
    return max(int(-(-gl * cfg.top_k * cfg.capacity_factor
                     // cfg.num_experts)), 1)


def _ordered_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum over the (short) last dim of ``t``, left to right."""
    total = t[..., 0]
    for j in range(1, t.shape[-1]):
        total = total + t[..., j]
    return total


class Routing(NamedTuple):
    """Each (group, token, choice) of a routing, choices best first."""
    idx: torch.Tensor    # [bn, gl, k] int64: the chosen expert
    gates: torch.Tensor  # [bn, gl, k] float32: normalised gate, 0 if dropped
    slot: torch.Tensor   # [bn, gl, k] int64: the pair's place in its expert
    kept: torch.Tensor   # [bn, gl, k] bool: slot < capacity


def route(cfg: ModelConfig, router: torch.Tensor, xg: torch.Tensor,
          cap: int) -> Routing:
    """Top-k routing of ``xg`` [bn, gl, d] with ``cap`` slots per expert
    and group."""
    bn, gl, d = xg.shape
    E, k = cfg.num_experts, cfg.top_k
    logits = linear(xg.float(), router)                         # [bn,gl,E]
    probs, idx = torch.sort(torch.softmax(logits, -1), dim=-1,
                            descending=True, stable=True)
    probs, idx = probs[..., :k], idx[..., :k]
    gates = probs / torch.clamp_min(_ordered_sum(probs), 1e-9)[..., None]
    # place of each pair within its expert: pairs before it (token-major,
    # then choice order) that chose the same expert
    onehot = torch.zeros((bn, gl * k, E), dtype=torch.int32,
                         device=xg.device)
    onehot.scatter_(-1, idx.reshape(bn, gl * k, 1), 1)
    before = torch.cumsum(onehot, 1) - onehot
    slot = before.gather(-1, idx.reshape(bn, gl * k, 1)).reshape(
        bn, gl, k).long()
    kept = slot < cap
    return Routing(idx, torch.where(kept, gates, 0.0), slot, kept)


def _hint5(shard: Sharder, t: torch.Tensor, b: int, ns: int, cap: int,
           name: str, E: int) -> torch.Tensor:
    """``shard`` asked about the expert-major slot rows ``t`` [E or this
    rank's experts, b * ns * cap, f] in the reference's [B, N, E, C, f]
    layout (a view each way; ``E`` the whole count)."""
    e, _, f = t.shape
    v = t.view(e, b, ns, cap, f).permute(1, 2, 0, 3, 4)
    return shard(v, name, (b, ns, E, cap, f)).permute(2, 0, 1, 3, 4
                                                       ).reshape(e, -1, f)


def moe_apply(cfg: ModelConfig, p: Params, x: torch.Tensor,
              dispatch: str = "einsum",
              shard: Sharder = NO_SHARD) -> torch.Tensor:
    """x [B, S, d] -> [B, S, d]. Over 'model', where the rules cut the
    experts (``w_up``'s ``tp_cut``), each rank routes every token alike
    and computes its run of experts' slots; the combine sums this rank's
    experts' share in float32, reduced over 'model' (``shard.reduce``)
    and rounded once; the output joins the residual
    (:func:`.layers.linear`)."""
    if dispatch not in DISPATCHES:
        raise ValueError(f"moe dispatch must be one of {DISPATCHES}, got "
                         f"{dispatch!r}")
    b, s, d = x.shape
    E, k = cfg.num_experts, cfg.top_k
    gl = group_len(cfg, s)
    cap = capacity(cfg, gl)
    bn = b * (s // gl)
    rows = bn * cap                                  # slot rows per expert
    dev = x.device
    xg = x.reshape(bn, gl, d)
    r = route(cfg, p["router"], xg, cap)
    # this rank's experts e0 .. e0 + n - 1 (all of them but over 'model')
    n = p["w_up"].shape[0]
    e0 = shard.rank * n if n != E else 0
    # each pair's slot row, expert-major ([n, bn, cap]) among this rank's
    # experts; a dropped pair, or one of another rank's experts, points
    # past the last slot, at a row of zeros
    group = torch.arange(bn, device=dev).view(bn, 1, 1)
    if n == E:
        mine, idx = r.kept, r.idx
    else:
        mine, idx = r.kept & (r.idx >= e0) & (r.idx < e0 + n), r.idx - e0
    dest = torch.where(mine, (idx * bn + group) * cap + r.slot, n * rows)
    # the token in each slot (bn * gl, a row of zeros, when empty); only
    # the discarded last entry is written more than once
    held = torch.full((n * rows + 1,), bn * gl, dtype=torch.int64,
                      device=dev)
    held[dest.reshape(-1)] = torch.arange(
        bn * gl, device=dev).repeat_interleave(k)
    zero = x.new_zeros((1, d))
    xin = torch.cat([xg.reshape(bn * gl, d), zero])[held[:-1]].view(
        n, rows, d)
    xin = _hint5(shard, xin, b, s // gl, cap, "moe_expert_in5", E)
    # one view per expert (unbind: in training one gradient node stacks
    # the experts' gradients, where indexing each would add a zero-filled
    # copy of the whole stack per expert)
    w_up, w_down = p["w_up"].unbind(0), p["w_down"].unbind(0)
    up = torch.cat([linear(xin[e], w_up[e]) for e in range(n)])
    if cfg.glu:
        w_gate = p["w_gate"].unbind(0)
        gate = torch.cat([linear(xin[e], w_gate[e]) for e in range(n)])
        h = _act(cfg, gate) * up
    else:
        h = _act(cfg, up)
    h = _hint5(shard, h.view(n, rows, -1), b, s // gl, cap, "moe_hidden5", E)
    out = torch.cat([linear(h[e], w_down[e]) for e in range(n)] + [zero])
    if dispatch == "einsum":
        dest = dest.gather(-1, r.idx.argsort(-1))    # ascending experts
        w = [_ordered_sum(r.gates).to(x.dtype).float()[..., None]] * k
    else:
        g = r.gates.to(x.dtype).float()
        w = [g[..., j, None] for j in range(k)]
    got = out[dest]                                      # [bn, gl, k, d]
    acc = w[0] * got[:, :, 0].float()
    for j in range(1, k):
        acc = acc + w[j] * got[:, :, j].float()
    if getattr(p["w_up"], "tp_cut", None) == 0:          # experts cut
        return shard.reduce(acc.reshape(b, s, d), x.dtype, residual=True)
    return shard.to_residual(acc.to(x.dtype).reshape(b, s, d))


def moe_launches(cfg: ModelConfig) -> int:
    """``matmul`` launches of one :func:`moe_apply`: the router product
    and two or three products per expert."""
    return 1 + cfg.num_experts * (3 if cfg.glu else 2)
