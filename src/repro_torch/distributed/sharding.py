"""Sharding rules (DP / TP / EP / SP over a mesh), and parameters held as
local shards over a ``torch.distributed`` mesh.

Port of the reference's ``distributed/sharding.py``. The rules are the
reference's, line for line: they map each parameter, cache, batch and
named activation to a partition spec (:class:`P`, one entry a dim: ``None``,
an axis name or a tuple of axis names) over any mesh object with
``.shape`` and ``.axis_names``. Batch shards over (pod, data); weights TP
over 'model' (output-dim preferred, input-dim fallback); MoE experts EP
over 'model' with expert-FFN FSDP over 'data'; decode KV caches shard
kv-heads over 'model' when divisible, otherwise the *sequence* dim. Every
rule checks divisibility and degrades to replication instead of failing.
ZeRO-1: optimizer state specs add the 'data' axis on the largest
still-unsharded divisible dim of each parameter.

The port's parameter names are the reference's tree paths joined with
dots (``scan_layers.slot0.mixer.w_x``); the whole-tree functions take those
names and key the rules on the same path elements, and on the same
``scan_layers`` / ``encoder/layers`` stacking (the leading layer dim is
never sharded).

Where XLA places values by these specs, the port computes with them
itself (:class:`MeshParams`): each rank holds its parameters' local
shards (:class:`NamedSharding`) and computes its own rows of the batch.

Training gathers each weight whole where the model uses it (its gradient
reduce-scattered back), the layout XLA picks for the dense configs (see
:meth:`ShardingRules.batch_dim`): 'model' dims are computed replicated.

Serving (``Model.prefill``, ``decode_step``, ``init_cache``), where the
batch leaves 'model' free, computes on the 'model' cuts as the reference's
hints place them (:class:`MeshSharder` under ``serving``): each weight
stays on its rule's cut (only a rule's own 'data' cut is gathered); a
``P(None, 'model')`` product gives this rank's columns, a ``P('model',
None)`` one takes its columns of x and gives float32 partials, summed over
'model' in rank order (an all-gather of the partials, or an all-to-all
where the residual's sequence is cut: Megatron-SP in prefill) and rounded
once; heads, KV heads, RNN columns and experts run on their cuts; decode
caches hold their KV heads or their run of slots (``flash_decode``'s
partials and merge), the recurrent states their columns or heads. Each
named point brings its tensor to the hint's spec (:meth:`MeshSharder.to`)
and checks it; the logits are gathered whole. The collectives over a group
of one rank are the identity: the (1, 1) mesh serves bit for bit as the
unsharded model.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..kernels.cost import note_collective, quiet
from ..models.config import ModelConfig
from ..models.layers import Sharder

Params = Dict[str, Any]


class P(tuple):
    """A partition spec: one entry per leading dim, each ``None`` (whole),
    an axis name, or a tuple of axis names (the dim split over their
    product, row-major in the tuple's order); dims past the spec are
    whole. The reference's ``PartitionSpec``."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self):
        return "P" + tuple.__repr__(self)


def _axes(entry) -> Tuple[str, ...]:
    """The axis names of one spec entry."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _axis_size(mesh, name: str) -> int:
    return mesh.shape[name] if name in mesh.axis_names else 1


def batch_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _div(n: int, k: int) -> bool:
    return k > 0 and n % k == 0


@dataclasses.dataclass
class ShardingRules:
    """Computes partition specs for one (cfg, mesh) pair.

    ``fold_model=False`` keeps 'model' out of the batch axes (pure
    TP + Megatron-SP residual sharding instead of the FSDP-flavored
    batch-over-all-chips default)."""

    cfg: ModelConfig
    mesh: Any
    fold_model: bool = True
    # Gather TOKENS across 'data' inside the expert einsums instead of
    # gathering the ff-sharded expert weights: the expert compute grid
    # becomes (E x ff) = (model x data) and activations are broadcast
    # over 'data'.
    moe_token_gather: bool = False
    # Weight-stationary 2D sharding: every weight matrix [in, out] shards
    # in->'data', out->'model'.
    w2d: bool = False

    def __post_init__(self):
        self.m = _axis_size(self.mesh, "model")
        self.d = _axis_size(self.mesh, "data")
        self.b_axes = batch_axes(self.mesh)
        self.b = int(np.prod([_axis_size(self.mesh, a) for a in self.b_axes]))

    # -- generic 2D weight: prefer output-dim TP, fall back to input-dim --
    def w2(self, a: int, b: int, prefer_out: bool = True) -> P:
        if self.w2d and _div(a, self.d) and _div(b, self.m):
            return P("data", "model")        # weight-stationary 2D tiles
        if prefer_out and _div(b, self.m):
            return P(None, "model")
        if _div(a, self.m):
            return P("model", None)
        if _div(b, self.m):
            return P(None, "model")
        return P(None, None)

    def batch_dim(self, n: int):
        """Greedy (pod, data[, model]) sharding of the batch dim.

        Non-MoE archs fold 'model' into the batch axes when it divides:
        tokens per rank drop by its size and attention is rank-local
        (weights stay 'model'-sharded and are gathered per layer, which is
        what the port does for every config). MoE archs keep 'model' for
        expert parallelism."""
        cand = list(self.b_axes)
        if self.fold_model and not self.cfg.num_experts:
            cand.append("model")
        axes = []
        rem = n
        for a in cand:
            s = _axis_size(self.mesh, a)
            if s > 1 and rem % s == 0:
                axes.append(a)
                rem //= s
            else:
                break
        if not axes:
            return None
        return tuple(axes) if len(axes) > 1 else axes[0]

    # -- named activation hints (used by MeshSharder) --
    def hint(self, name: str, shape: Tuple[int, ...]) -> Optional[P]:
        bd = self.batch_dim(shape[0]) if shape else None
        bd_axes = (bd,) if isinstance(bd, str) else (bd or ())

        def free(axis: str) -> bool:
            return axis not in bd_axes

        if name in ("activations", "residual"):        # [B, S, d]
            seq_ok = (len(shape) == 3 and free("model")
                      and shape[1] > 1 and _div(shape[1], self.m))
            return P(bd, "model" if seq_ok else None, None)
        if name == "ffn_hidden":                       # [B, S, ff]
            return P(bd, None, "model" if free("model")
                     and _div(shape[-1], self.m) else None)
        if name == "rnn_hidden":                       # [B, S, d]
            return P(bd, None, "model" if free("model")
                     and _div(shape[-1], self.m) else None)
        if name in ("attn_heads", "attn_kv"):          # [B, H, S, D]
            h = shape[1]
            return P(bd, "model" if free("model") and _div(h, self.m)
                     else None, None, None)
        if name == "kv_cache":                         # [B, Hkv, S, D]
            hkv, s = shape[1], shape[2]
            if free("model") and _div(hkv, self.m):
                return P(bd, "model", None, None)
            if free("model") and _div(s, self.m):
                return P(bd, None, "model", None)
            return P(bd, None, None, None)
        if name == "moe_expert_in5":                   # [B, N, E, C, d]
            e = shape[2]
            e_ok = free("model") and _div(e, self.m)
            if self.moe_token_gather and self._moe_ffn_fsdp():
                return P(None, None, "model" if _div(e, self.m) else None,
                         None, None)
            return P(bd, None, "model" if e_ok else None, None, None)
        if name == "moe_hidden5":                      # [B, N, E, C, ff]
            e, ff = shape[2], shape[4]
            if self.moe_token_gather and self._moe_ffn_fsdp():
                return P(None, None, "model" if _div(e, self.m) else None,
                         None, "data" if _div(ff, self.d) else None)
            return P(bd, None, "model" if free("model") and _div(e, self.m)
                     else None, None,
                     "data" if free("data") and _div(ff, self.d)
                     and self._moe_ffn_fsdp() else None)
        return None

    def _moe_ffn_fsdp(self) -> bool:
        """Shard expert-FFN hidden over 'data' only for very large MoEs."""
        cfg = self.cfg
        if not cfg.num_experts:
            return False
        moe_bytes = cfg.num_experts * cfg.d_model * cfg.d_ff * (3 if cfg.glu else 2) * 2
        return moe_bytes * cfg.num_layers > 64e9   # > 64 GB of expert weights

    # -- parameter tree --------------------------------------------------
    def param_spec(self, path: str, shape: Tuple[int, ...]) -> P:
        # specs computed on the trailing dims (layer-stacked leaves get
        # None prepended by the caller)
        last = path.split("/")[-1]
        if last in ("scale", "bias", "lam", "ln_scale"):
            return P(*(None,) * len(shape))
        if last == "pos_embed":
            return P(None, "model" if _div(shape[-1], self.m) else None)
        if last == "embed":
            return P(None, "model" if _div(shape[-1], self.m) else None)
        if last == "lm_head":
            return P(None, "model" if _div(shape[-1], self.m) else None)
        if last == "router":
            return P(None, None)
        if last == "u":                                 # rwkv bonus [H, hd]
            return P("model" if _div(shape[0], self.m) else None, None)
        if last == "mix":
            return P(None, None)
        if last == "conv":                              # [K, d]
            return P(None, "model" if _div(shape[-1], self.m) else None)
        if last in ("bq", "bk", "bv"):
            return P("model" if _div(shape[-1], self.m) else None)
        if last in ("w_up", "w_gate") and len(shape) == 3:   # MoE [E, d, ff]
            e, d_in, ff = shape
            if self.w2d and _div(e, self.m) and _div(d_in, self.d):
                return P("model", "data", None)   # weight-stationary tiles
            return P("model" if _div(e, self.m) else None, None,
                     "data" if self._moe_ffn_fsdp() and _div(ff, self.d) else None)
        if last == "w_down" and len(shape) == 3:             # MoE [E, ff, d]
            e, ff, _ = shape
            if self.w2d and _div(e, self.m) and _div(ff, self.d):
                return P("model", "data", None)
            return P("model" if _div(e, self.m) else None,
                     "data" if self._moe_ffn_fsdp() and _div(ff, self.d) else None,
                     None)
        if last in ("wo", "w_down", "w_out", "w_o"):         # [in, d]
            return self.w2(shape[0], shape[1], prefer_out=False)
        if len(shape) == 2:
            return self.w2(shape[0], shape[1], prefer_out=True)
        return P(*(None,) * len(shape))

    def zero_spec(self, spec: P, shape: Tuple[int, ...]) -> P:
        """Optimizer-state / inference-weight spec: add 'data' on the
        largest free divisible dim (ZeRO partitioning). No-op when the
        spec already uses 'data'."""
        parts = list(spec) + [None] * (len(shape) - len(spec))
        used = {a for p in parts if p is not None
                for a in ((p,) if isinstance(p, str) else p)}
        if "data" in used:
            return P(*parts)
        cand = [(shape[i], i) for i in range(len(shape))
                if parts[i] is None and _div(shape[i], self.d)]
        if cand:
            _, i = max(cand)
            parts[i] = "data"
        return P(*parts)


# -- collectives ----------------------------------------------------------------

# Each helper reports its collective to any counter counting the step
# (``kernels.cost.note_collective``: the output's bytes on this rank); the
# aten ops a backend runs inside one (gloo's copies) are the collective's,
# not counted apart (``kernels.cost.quiet``).

def _all_gather(out: torch.Tensor, inp: torch.Tensor, group) -> None:
    fn = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    with quiet():
        fn(out, inp, group=group)
    note_collective("all-gather", out, _group_size(group))


def _reduce_scatter(out: torch.Tensor, inp: torch.Tensor, group) -> None:
    fn = (getattr(dist, "reduce_scatter_single", None)
          or dist.reduce_scatter_tensor)
    with quiet():
        fn(out, inp, group=group)
    note_collective("reduce-scatter", out, _group_size(group))


def _all_to_all(out: torch.Tensor, inp: torch.Tensor, group) -> None:
    """Chunk j of ``inp`` (split along dim 0) to rank j; ``out``'s chunk
    j from rank j."""
    with quiet():
        dist.all_to_all_single(out, inp, group=group)
    note_collective("all-to-all", out, _group_size(group))


def all_reduce(t: torch.Tensor, group) -> None:
    """``dist.all_reduce`` of ``t`` in place over ``group``."""
    with quiet():
        dist.all_reduce(t, group=group)
    note_collective("all-reduce", t, _group_size(group))


def _group_size(group) -> int:
    return dist.get_world_size(group)


def _same_memory(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether ``a`` and ``b`` start at the same element of one storage
    (``data_ptr`` equality on a device, and on ``meta``, whose pointers
    are all 0)."""
    return (a.untyped_storage()._cdata == b.untyped_storage()._cdata
            and a.storage_offset() == b.storage_offset())


class NamedSharding:
    """A partition spec over a mesh, and this rank's part of a tensor
    laid out by it (the reference's ``NamedSharding``, with the data
    movement XLA does for it done here by ``torch.distributed``).

    A dim whose entry names axes is cut into equal chunks, one for each
    index of those axes (row-major in the entry's order); the ranks that
    differ only along axes the spec does not name hold the same chunk. The
    methods that move data need a :class:`repro_torch.launch.mesh.Mesh`;
    the layout ones need only ``.shape`` and ``.axis_names``."""

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = spec if isinstance(spec, P) else P(*spec)

    def __repr__(self):
        return f"NamedSharding({self.spec})"

    def entries(self, ndim: int) -> List[Tuple[str, ...]]:
        """The axis names of every dim of a tensor of ``ndim`` dims."""
        if len(self.spec) > ndim:
            raise ValueError(f"spec {self.spec} is longer than {ndim} dims")
        return [_axes(e) for e in self.spec] + [()] * (ndim - len(self.spec))

    def used(self, ndim: int) -> Tuple[str, ...]:
        """The axes the spec names, in mesh order."""
        names = {a for e in self.entries(ndim) for a in e}
        return tuple(a for a in self.mesh.axis_names if a in names)

    def counts(self, ndim: int) -> List[int]:
        return [math.prod(self.mesh.shape[a] for a in e)
                for e in self.entries(ndim)]

    def local_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        out = []
        for n, k in zip(shape, self.counts(len(shape))):
            if n % k:
                raise ValueError(f"dim {n} does not split into {k} chunks "
                                 f"({self.spec})")
            out.append(n // k)
        return tuple(out)

    def bounds(self, shape: Sequence[int], coords=None
               ) -> Tuple[Tuple[int, int], ...]:
        """[lo, hi) of every dim of the part the rank at ``coords`` (an
        axis -> index dict; this rank's by default) holds."""
        coords = self.mesh.coords if coords is None else coords
        loc = self.local_shape(shape)
        out = []
        for e, n in zip(self.entries(len(shape)), loc):
            i = 0
            for a in e:
                i = i * self.mesh.shape[a] + coords[a]
            out.append((i * n, (i + 1) * n))
        return tuple(out)

    def local(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's part of ``full`` (a view)."""
        return full[tuple(slice(lo, hi) for lo, hi in
                          self.bounds(full.shape))]

    def region(self, shape: Sequence[int]) -> "Region":
        return Region(self.mesh, shape, lambda c: self.bounds(shape, c))

    def _split(self, local_shape):
        """(the full tensor viewed with every sharded dim split into
        [axis sizes in the entry's order..., local size], the permutation
        of those dims that puts the named axes first in mesh order, then
        the local dims; the named axes)."""
        split, pos, local_dims = [], {}, []
        for e, n in zip(self.entries(len(local_shape)), local_shape):
            for a in e:
                pos[a] = len(split)
                split.append(self.mesh.shape[a])
            local_dims.append(len(split))
            split.append(n)
        used = self.used(len(local_shape))
        return split, [pos[a] for a in used] + local_dims, used

    @torch.no_grad()
    def gather(self, local: torch.Tensor,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The whole tensor from every rank's part (an all-gather over the
        group of the named axes). Along a group of one rank the collective
        runs in place and the result is ``local`` itself (or ``out``, when
        given, holding it)."""
        split, perm, used = self._split(local.shape)
        group = self.mesh.group(used)
        n = _group_size(group)
        flat = local.reshape(-1)
        if n == 1:
            if not local.is_contiguous():
                raise ValueError("gather needs a contiguous local part")
            _all_gather(flat, flat, group)
            if out is not None and not _same_memory(out, local):
                out.copy_(local)
                return out
            return local
        buf = torch.empty(n * flat.numel(), dtype=local.dtype,
                          device=local.device)
        _all_gather(buf, flat.contiguous(), group)
        got = buf.view([self.mesh.shape[a] for a in used] + list(local.shape))
        inv = [0] * len(perm)
        for i, p in enumerate(perm):
            inv[p] = i
        full_shape = [n_loc * k for n_loc, k in
                      zip(local.shape, self.counts(local.dim()))]
        if out is None:
            out = torch.empty(full_shape, dtype=local.dtype,
                              device=local.device)
        out.view(split).copy_(got.permute(inv))
        return out

    @torch.no_grad()
    def reduce(self, full: torch.Tensor, batch: Sequence[str]) -> torch.Tensor:
        """This rank's part of the sum of ``full`` over the ranks that
        hold other rows of the batch (the axes ``batch``), each rank's
        ``full`` counted once: a reduce-scatter over the named axes that
        are batch axes, the rank's own chunk along the named axes that are
        not (those ranks computed the same rows), an all-reduce over the
        batch axes the spec does not name. Along groups of one rank the
        collectives run in place on ``full``'s own memory."""
        loc = self.local_shape(full.shape)
        split, perm, used = self._split(loc)
        t = full.reshape(split).permute(perm)
        t = t[tuple(slice(None) if a in batch else self.mesh.coords[a]
                    for a in used)]
        keep = [a for a in used if a in batch]
        t = t.contiguous()
        group = self.mesh.group(keep)
        if _group_size(group) == 1:
            flat = t.view(-1)
            _reduce_scatter(flat, flat, group)
            out = t
        else:
            out = torch.empty(loc, dtype=full.dtype, device=full.device)
            _reduce_scatter(out.view(-1), t.view(-1), group)
        out = out.view(loc)
        all_reduce(out, self.mesh.group([a for a in batch if a not in used]))
        return out


class Region:
    """Where every rank's local tensor sits in a leaf of shape ``shape``:
    a box ([lo, hi) a dim) for each rank, from ``bounds(coords)``. Boxes
    may overlap where ranks hold the same elements (replicas, or the whole
    int8 blocks of a moment); they hold the same values there."""

    def __init__(self, mesh, shape: Sequence[int], bounds):
        self.mesh = mesh
        self.shape = tuple(int(n) for n in shape)
        self.boxes = [bounds(mesh.coords_of(r)) for r in range(mesh.size)]

    def box(self, rank: Optional[int] = None) -> Tuple[slice, ...]:
        b = self.boxes[self.mesh.rank if rank is None else rank]
        return tuple(slice(lo, hi) for lo, hi in b)

    def local_shape(self, rank: Optional[int] = None) -> Tuple[int, ...]:
        return tuple(s.stop - s.start for s in self.box(rank))

    def local(self, full: torch.Tensor) -> torch.Tensor:
        return full[self.box()]

    @torch.no_grad()
    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """The whole leaf on every rank (one all-gather over the mesh of
        each rank's box, padded to the largest)."""
        if tuple(local.shape) != self.local_shape():
            raise ValueError(f"local {tuple(local.shape)} is not this rank's "
                             f"box {self.local_shape()}")
        sizes = [math.prod(self.local_shape(r)) for r in range(self.mesh.size)]
        n = max(sizes)
        mine = torch.zeros(n, dtype=local.dtype, device=local.device)
        mine[:local.numel()] = local.reshape(-1)
        buf = torch.empty(n * self.mesh.size, dtype=local.dtype,
                          device=local.device)
        _all_gather(buf, mine, self.mesh.group(self.mesh.axis_names))
        full = torch.empty(self.shape, dtype=local.dtype, device=local.device)
        for r in range(self.mesh.size):
            full[self.box(r)] = buf[r * n:r * n + sizes[r]].view(
                self.local_shape(r))
        return full


class MeshSharder(Sharder):
    """The model's ``shard=`` hook over a mesh.

    ``global_batch`` is the whole batch's row count, set by the step that
    cut it (``None``: the rows here are every row); a tensor's rows must be
    that batch cut along ``rules.batch_dim`` of it. :meth:`batch_sum` sums
    the loss's token count over the ranks that hold other rows.

    Training (``tp`` False) computes every 'model' dim whole (its weights
    gathered whole by :class:`MeshParams`): a named point checks the rule's
    spec against that layout (the rows, and that every named dim divides)
    and returns ``x``.

    Serving (``Model.prefill``, ``decode_step`` and ``init_cache`` set
    ``tp`` through :meth:`serving` when the batch leaves 'model' free, as
    the reference's hints then cut over it) computes on the 'model' cuts:
    a dim is whole or this rank's 1/``m`` of it (rank-major chunks).
    :meth:`to` brings a tensor to a named point's hint spec
    (``ShardingRules.hint`` of its whole shape) by :meth:`fit` on each dim;
    ``__call__`` checks that every dim equals the spec's cut and raises
    otherwise; :meth:`reduce` sums row-parallel partials over 'model'. The
    collectives run over the 'model' group; along a group of one rank each
    is the identity and runs nothing."""

    def __init__(self, rules: ShardingRules):
        self.rules = rules
        self.global_batch: Optional[int] = None
        self.m = rules.m
        self.tp = False
        #: the whole slots of the caches last made (``Model.init_cache`` /
        #: ``prefill``): ``k`` the self-attention's, ``ck`` the
        #: cross-attention's, which a decode step reads against its local
        #: slots
        self.cache_slots: Dict[str, int] = {}

    @property
    def rank(self) -> int:
        return self.rules.mesh.coords.get("model", 0)

    def batch_axes(self) -> Tuple[str, ...]:
        if self.global_batch is None:
            return ()
        return _axes(self.rules.batch_dim(self.global_batch))

    @contextlib.contextmanager
    def serving(self):
        """``tp`` set while a serving call runs, where the batch leaves
        'model' free (otherwise the weights are gathered whole, as in
        training, and the rows carry 'model')."""
        prev = self.tp
        self.tp = "model" not in self.batch_axes()
        try:
            yield self.tp
        finally:
            self.tp = prev

    def _rows(self, name: str, shape: Tuple[int, ...]) -> Tuple[int, ...]:
        """``shape`` with the whole batch's rows, checked against the
        cut."""
        if self.global_batch is None:
            return shape
        cut = math.prod(self.rules.mesh.shape[a] for a in self.batch_axes())
        if shape[0] * cut != self.global_batch:
            raise ValueError(f"{name}: {shape[0]} rows here, the batch "
                             f"of {self.global_batch} was cut {cut} ways")
        return (self.global_batch,) + shape[1:]

    def _spec(self, name: str, full: Tuple[int, ...]):
        """(the hint's spec of ``full`` with the whole batch, the local
        shape of its 'model' dims, rows as ``full`` has them)."""
        whole = self._rows(name, tuple(full))
        spec = self.rules.hint(name, whole)
        if spec is None:
            return None, tuple(full)
        ent = NamedSharding(self.rules.mesh, spec).entries(len(full))
        return spec, tuple(n // self.m if "model" in e and i else n
                           for i, (n, e) in enumerate(zip(full, ent)))

    def __call__(self, x: torch.Tensor, name: str,
                 full: Optional[Tuple[int, ...]] = None) -> torch.Tensor:
        shape = tuple(x.shape)
        if not self.tp:
            whole = self._rows(name, shape)
            spec = self.rules.hint(name, whole)
            if spec is not None:   # every named dim divides
                NamedSharding(self.rules.mesh, spec).local_shape(whole)
            return x
        spec, want = self._spec(name, shape if full is None else full)
        if spec is not None and shape != want:
            raise ValueError(f"{name}: local {shape} is not the cut {want} "
                             f"of {tuple(full)} by {spec}")
        return x

    def to(self, x: torch.Tensor, name: str,
           full: Tuple[int, ...]) -> torch.Tensor:
        if self.tp:
            _, want = self._spec(name, tuple(full))
            for i in range(1, x.dim()):
                x = self.fit(x, i, want[i])
        return self(x, name, full)

    def local(self, name: str, full: Tuple[int, ...]) -> Tuple[int, ...]:
        if not self.tp:
            return tuple(full)
        return self._spec(name, tuple(full))[1]

    def cache_local(self, last: str, full: Tuple[int, ...]
                    ) -> Tuple[int, ...]:
        """The shape this rank holds of a decode-cache leaf named ``last``
        (``k``, ``v``, ``ck``, ``cv``, ``h``, ``conv``, ``shift``,
        ``wkv``) of whole shape ``full``, rows as ``full`` has them
        (:func:`cache_shardings`' specs, their 'model' dims cut)."""
        if not self.tp:
            return tuple(full)
        whole = self._rows(last, tuple(full))
        sh = cache_shardings(self.rules, {last: torch.empty(
            whole, device="meta")})[last]
        ent = sh.entries(len(full))
        return tuple(n // self.m if "model" in e and i else n
                     for i, (n, e) in enumerate(zip(full, ent)))

    def fit(self, x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
        dim %= x.dim()
        have = x.shape[dim]
        if have == n:
            return x
        if have == n * self.m:                  # this rank's cut
            return x.narrow(dim, self.rank * n, n).contiguous()
        if have * self.m == n:                  # gathered whole
            return _gather_dim(x, dim, self._group())
        raise ValueError(f"dim {dim} of {tuple(x.shape)} is neither {n} "
                         f"nor a 'model' cut of it ({self.m} ranks)")

    def reduce(self, part: torch.Tensor, dtype: torch.dtype,
               residual: bool = False) -> torch.Tensor:
        if self.m == 1:
            return part.to(dtype)
        seq = self._residual_rows(part.shape) if residual else None
        group = self._group()
        if seq is not None and seq * self.m == part.shape[1]:
            # a reduce-scatter along the sequence: rank j's rows of every
            # rank's partial, then summed in rank order
            send = part.unflatten(1, (self.m, seq)).movedim(1, 0).contiguous()
            got = torch.empty_like(send)
            _all_to_all(got, send, group)
        else:
            got = _gather_dim(part[None], 0, group)
        total = got[0]
        for j in range(1, self.m):
            total = total + got[j]
        out = total.to(dtype)
        return out if seq is None else self.fit(out, 1, seq)

    def _residual_rows(self, full: Tuple[int, ...]) -> int:
        """This rank's positions of the residual [B, S, d] (``full``, its
        sequence whole): all S, or the 'residual' hint's cut of them
        (prefill's Megatron-SP)."""
        return self.local("residual", tuple(full))[1]

    def to_residual(self, x: torch.Tensor) -> torch.Tensor:
        if not self.tp:
            return x
        return self.fit(x, 1, self._residual_rows(x.shape))

    def _group(self):
        return self.rules.mesh.group(("model",))

    def last_token(self, x: torch.Tensor, s: int) -> torch.Tensor:
        """The last of ``s`` positions of ``x`` [B, S or S/m, d] (its
        sequence whole or cut over 'model'): [B, d] on every rank."""
        if x.shape[1] == s:
            return x[:, -1]
        return _gather_dim(x[:, -1:].contiguous(), 1, self._group())[:, -1]

    def gather_parts(self, part: torch.Tensor) -> torch.Tensor:
        """Every 'model' rank's ``part`` (a flat buffer), [m, n] in rank
        order."""
        return _gather_dim(part[None], 0, self._group())

    def batch_sum(self, x: torch.Tensor) -> torch.Tensor:
        y = x.detach().clone()
        all_reduce(y, self.rules.mesh.group(self.batch_axes()))
        return y


def _gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``x`` of ``group`` concatenated along ``dim`` in rank
    order (an all-gather); ``x`` itself along a group of one rank."""
    n = _group_size(group)
    if n == 1:
        return x
    x = x.contiguous()
    buf = torch.empty((n,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    _all_gather(buf.view(-1), x.view(-1), group)
    return buf.movedim(0, dim).flatten(dim, dim + 1)


# -- whole-tree specs ----------------------------------------------------

def _path(name: str) -> str:
    """The reference's tree path of a dotted port name."""
    return name.replace(".", "/")


def _stacked(path: str) -> bool:
    return "scan_layers" in path or path.startswith("encoder/layers")


def _param_spec(rules: ShardingRules, name: str, shape, zero: bool) -> P:
    path = _path(name)
    shape = tuple(shape)
    stacked = _stacked(path)
    core = shape[1:] if stacked and len(shape) >= 1 else shape
    spec = rules.param_spec(path, core)
    if stacked:
        spec = P(None, *spec)
    if zero:
        spec = rules.zero_spec(spec, shape)
    return spec


def _shape(x) -> Tuple[int, ...]:
    return tuple(x.shape) if hasattr(x, "shape") else tuple(x)


def param_shardings(rules: ShardingRules, params: Params,
                    zero: bool = False) -> Dict[str, NamedSharding]:
    """NamedSharding of every parameter (``{dotted name: tensor or
    shape}``); a stacked leaf's leading layer dim is never sharded.
    ``zero=True`` additionally spreads each weight over 'data'."""
    return {k: NamedSharding(rules.mesh, _param_spec(rules, k, _shape(x),
                                                     zero))
            for k, x in params.items()}


def opt_state_shardings(rules: ShardingRules, params: Params
                        ) -> Dict[str, NamedSharding]:
    """ZeRO-1 specs for each parameter's optimizer moments."""
    return param_shardings(rules, params, zero=True)


def _tree_map(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn("/".join(path), tree)


def cache_shardings(rules: ShardingRules, cache: Params) -> Params:
    """Decode-cache tree (``Model.init_cache``'s layout): KV [.., B, Hkv,
    S, D] / recurrent states."""

    def spec_for(path, x) -> NamedSharding:
        shape = _shape(x)
        stacked = path.startswith("scan/")
        core = shape[1:] if stacked else shape
        last = path.split("/")[-1]
        if last in ("k", "v", "ck", "cv") and len(core) == 4:
            spec = rules.hint("kv_cache", core)
        elif last == "wkv" and len(core) == 4:          # [B, H, dk, dv]
            bd = rules.batch_dim(core[0])
            spec = P(bd, "model" if _div(core[1], rules.m) else None, None, None)
        elif last == "h" and len(core) == 2:            # [B, d]
            bd = rules.batch_dim(core[0])
            spec = P(bd, "model" if _div(core[1], rules.m) else None)
        elif last in ("conv", "shift") and len(core) == 3:
            bd = rules.batch_dim(core[0])
            spec = P(bd, None, "model" if _div(core[2], rules.m) else None)
        else:
            spec = P(*(None,) * len(core))
        if stacked:
            spec = P(None, *spec)
        return NamedSharding(rules.mesh, spec)

    return _tree_map(spec_for, cache)


def batch_shardings(rules: ShardingRules, batch: Params) -> Params:
    """Input batch: shard dim 0 over (pod, data)."""

    def spec_for(path, x) -> NamedSharding:
        shape = _shape(x)
        bd = rules.batch_dim(shape[0]) if shape else None
        return NamedSharding(rules.mesh,
                             P(bd, *(None,) * (max(len(shape), 1) - 1)))

    return _tree_map(spec_for, batch)


def replicated(mesh, tree: Params) -> Params:
    return _tree_map(lambda _, x: NamedSharding(
        mesh, P(*(None,) * len(_shape(x)))), tree)


# -- parameters held as local shards ------------------------------------------

class _Gather(torch.autograd.Function):
    """A parameter's whole value (of layer ``index`` of a stack) from this
    rank's local shard; the backward reduces the whole gradient to the
    shard's part (:meth:`NamedSharding.reduce`) and adds it into the
    shard's ``.grad`` in place, as ``_LayerOf`` adds a layer's."""

    @staticmethod
    def forward(ctx, local, sharding, index, batch):
        ctx.local, ctx.sharding, ctx.index, ctx.batch = (local, sharding,
                                                         index, batch)
        part = local.data if index is None else local.data[index]
        return sharding.gather(part)

    @staticmethod
    def backward(ctx, g):
        with torch.no_grad():
            red = ctx.sharding.reduce(g, ctx.batch)
            p = ctx.local
            if ctx.index is None:
                if p.grad is None:
                    if (red.untyped_storage()._cdata
                            == g.untyped_storage()._cdata):
                        red = red.clone()   # not autograd's own buffer
                    p.grad = red
                else:
                    p.grad += red
            else:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                p.grad[ctx.index] += red
        return None, None, None, None


class _Leaf:
    """One parameter's layout on this rank: its whole shape, its local
    shard's box (``param``), its moments' ZeRO box (``zero``: where
    float32 and bf16 moments are stored, exactly the reference's part) and
    the box int8 moments are stored over (``moment``: ``zero`` widened
    along the last dim to whole quantization blocks of the whole leaf,
    ``block`` elements)."""

    def __init__(self, shape, param: NamedSharding, opt: NamedSharding,
                 block: int):
        nd = len(shape)
        self.shape, self.param_sh, self.opt_sh, self.block = (
            tuple(shape), param, opt, block)
        self.param = param.bounds(shape)
        self.zero = opt.bounds(shape)
        lo, hi = self.zero[-1] if nd else (0, 0)
        self.moment = self.zero[:-1] + (
            (lo // block * block, -(-hi // block) * block),) if nd else ()
        pe, oe = param.entries(nd), opt.entries(nd)
        self.zero_dims = [i for i in range(nd) if oe[i] != pe[i]]
        self.last_axes = pe[-1] if nd else ()

    def box(self, int8: bool):
        """The moments' box: ``moment`` for int8 moments, else ``zero``."""
        return self.moment if int8 else self.zero

    def rel(self, box, outer) -> Tuple[slice, ...]:
        return tuple(slice(lo - o, hi - o) for (lo, hi), (o, _) in
                     zip(box, outer))


def _block(shape) -> int:
    """The int8 moments' block of a whole leaf (the optimizer's rule: 256,
    or the whole last dim where 256 does not divide it)."""
    from ..training.optimizer import _last_block
    return _last_block(shape) if len(shape) else 1


class MeshParams:
    """A model's parameters held as local shards over ``rules.mesh``, and
    the model's ``param_hook`` that hands each out whole.

    Constructing it cuts every parameter of ``model`` (drawn or not) to
    this rank's part by :func:`param_shardings` and installs the hook and,
    where the model has none, a :class:`MeshSharder`. The optimizer's
    moments follow :func:`opt_state_shardings` (ZeRO-1): float32 and bf16
    moments over exactly the reference's ZeRO part, int8 moments over
    whole blocks of the whole leaf (:class:`_Leaf`), so that quantization
    never depends on the mesh; the ranks whose boxes share a block hold
    and update it alike.

    A forward gathers each weight where the model takes it (a stacked
    leaf one layer at a time); the backward reduce-scatters each gathered
    gradient into the shard's ``.grad`` (:meth:`NamedSharding.reduce`:
    summed over the ranks holding other batch rows, counted once over the
    ranks repeating a batch). The collectives run whatever the group
    sizes, in place along groups of one rank."""

    def __init__(self, model, rules: ShardingRules):
        self.model, self.rules, self.mesh = model, rules, rules.mesh
        if not isinstance(model.shard, MeshSharder):
            model.shard = MeshSharder(rules)
        self.sharder = model.shard
        named = dict(model.named_parameters())
        shapes = {k: tuple(p.shape) for k, p in named.items()}
        self.param = param_shardings(rules, shapes)
        opt = opt_state_shardings(rules, shapes)
        self.leaves = {k: _Leaf(shapes[k], self.param[k], opt[k],
                                _block(shapes[k])) for k in named}
        self._names = {p: k for k, p in named.items()}
        self._layer = {k: NamedSharding(self.mesh, P(*sh.spec[1:]))
                       for k, sh in self.param.items()
                       if _stacked(_path(k))}
        self._cut()
        model.param_hook = self

    def _cut(self) -> None:
        with torch.no_grad():
            for k, p in self.model.named_parameters():
                leaf = self.leaves[k]
                if tuple(p.shape) != leaf.shape:
                    raise ValueError(f"{k} is already cut")
                part = p.data[tuple(slice(lo, hi) for lo, hi in leaf.param)]
                if part.shape != p.shape:
                    p.data = part.clone()

    def init(self, generator: Optional[torch.Generator] = None) -> None:
        """Draw the model's weights whole (the unsharded model's numbers,
        the same on every mesh) and keep this rank's parts."""
        with torch.no_grad():
            for k, p in self.model.named_parameters():
                p.data = torch.empty(self.leaves[k].shape, dtype=p.dtype,
                                     device=p.device)
        self.model.init(generator)
        self._cut()

    def __call__(self, p: torch.Tensor, index: Optional[int] = None
                 ) -> torch.Tensor:
        name = self._names[p]
        sh = self.param[name] if index is None else self._layer[name]
        if self.sharder.tp:
            return self._model_cut(p if index is None else p[index], sh)
        if p.requires_grad and torch.is_grad_enabled():
            return _Gather.apply(p, sh, index, self.sharder.batch_axes())
        with torch.no_grad():
            return sh.gather((p if index is None else p[index]).contiguous())

    def _model_cut(self, part: torch.Tensor, sh: NamedSharding
                   ) -> torch.Tensor:
        """A serving forward's weight: this rank's part gathered along
        every axis but 'model' (the reference's serving weights are not
        ZeRO-spread, so only a rule's own 'data' cut, arctic-480b's
        expert FFN, is gathered), kept on its 'model' cut, the cut dim in
        ``tp_cut`` (None: whole)."""
        ent = sh.entries(part.dim())
        other = [tuple(a for a in e if a != "model") for e in ent]
        if any(other):
            part = NamedSharding(self.mesh, P(*other)).gather(
                part.contiguous())
        else:
            part = part.view(part.shape)   # a tensor of its own to mark
        cut = [i for i, e in enumerate(ent) if "model" in e]
        part.tp_cut = cut[0] if cut else None
        return part

    def local_batch(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """This rank's rows of a whole batch (cut along
        ``rules.batch_dim`` of its row count), and the count set on the
        model's sharder."""
        b = int(next(iter(batch.values())).shape[0])
        self.sharder.global_batch = b
        sh = NamedSharding(self.mesh, P(self.rules.batch_dim(b)))
        return {k: sh.local(torch.as_tensor(v)) for k, v in batch.items()}

    # -- what the optimizer asks ------------------------------------------
    def moment_shape(self, name: str, int8: bool) -> Tuple[int, ...]:
        return tuple(hi - lo for lo, hi in self.leaves[name].box(int8))

    def block(self, name: str) -> int:
        return self.leaves[name].block

    def norm_owner(self, name: str) -> bool:
        """Whether this rank counts ``name``'s shard in the global norm:
        index 0 along every axis its spec does not name, so each element
        is counted once."""
        used = self.param[name].used(len(self.leaves[name].shape))
        return all(self.mesh.coords[a] == 0 for a in self.mesh.axis_names
                   if a not in used)

    def norm_sum(self, total: torch.Tensor) -> torch.Tensor:
        total = torch.as_tensor(total, dtype=torch.float32,
                                device=self.model.device).clone()
        all_reduce(total, self.mesh.group(self.mesh.axis_names))
        return total

    def update_view(self, name: str, p: torch.Tensor,
                    g: Optional[torch.Tensor], int8: bool):
        """(the parameter and gradient over the moments' box, a function
        that writes the updated values back and gathers them to every rank
        holding the shard). Views of ``p`` and ``g`` where the box lies
        inside the shard; otherwise (int8 moments' whole blocks reach past
        the shard along the last dim) gathered along it."""
        leaf = self.leaves[name]
        box = leaf.box(int8)
        nd = len(leaf.shape)
        outer = leaf.param
        if nd and not (outer[-1][0] <= box[-1][0]
                       and box[-1][1] <= outer[-1][1]):
            along = NamedSharding(self.mesh, P(*(None,) * (nd - 1),
                                               leaf.last_axes))
            p_ext = along.gather(p.contiguous())
            g = None if g is None else along.gather(g.contiguous())
            outer = outer[:-1] + ((0, leaf.shape[-1]),)
            pw = p_ext[leaf.rel(box, outer)]
        else:
            p_ext = p
            pw = p[leaf.rel(box, outer)]
        gw = None if g is None else g[leaf.rel(box, outer)]

        def finish():
            if p_ext is not p:
                p[leaf.rel(leaf.zero, leaf.param)] = \
                    p_ext[leaf.rel(leaf.zero, outer)]
            spec = [None] * nd
            for i in leaf.zero_dims:
                spec[i] = tuple(a for a in leaf.opt_sh.entries(nd)[i]
                                if a not in leaf.param_sh.entries(nd)[i])
            part = p[leaf.rel(leaf.zero, leaf.param)]
            NamedSharding(self.mesh, P(*spec)).gather(
                part if part.is_contiguous() else part.contiguous(), out=p)

        return pw, gw, finish

    # -- checkpoints --------------------------------------------------------
    def regions(self, opt_state) -> Tuple[Dict[str, Region], Any]:
        """Where this rank's parameters and optimizer state sit in the
        whole leaves: (a Region a parameter, the state's tree of Regions),
        for ``save``/``restore(shardings=)``."""
        params = {k: Region(self.mesh, leaf.shape,
                            lambda c, s=leaf.param_sh, sh=leaf.shape:
                            s.bounds(sh, c))
                  for k, leaf in self.leaves.items()}

        def moment(k, m):
            leaf = self.leaves[k]

            def box(c, scales=False):
                zb = leaf.opt_sh.bounds(leaf.shape, c)
                lo, hi = zb[-1]
                b = leaf.block
                if scales:   # [..., nb, 1]
                    return zb[:-1] + ((lo // b, -(-hi // b)), (0, 1))
                return zb[:-1] + ((lo // b * b, -(-hi // b) * b),)
            if isinstance(m, dict):
                nb = leaf.shape[-1] // leaf.block
                scale_shape = leaf.shape[:-1] + (nb, 1)
                return {part: Region(self.mesh, leaf.shape if part == "q"
                                     else scale_shape,
                                     lambda c, s=part != "q": box(c, s))
                        for part in m}
            return Region(self.mesh, leaf.shape,
                          lambda c: leaf.opt_sh.bounds(leaf.shape, c))

        step = Region(self.mesh, (), lambda c: ())
        opt = type(opt_state)(step=step,
                              m={k: moment(k, v) for k, v in opt_state.m.items()},
                              v={k: moment(k, v) for k, v in opt_state.v.items()})
        return params, opt
