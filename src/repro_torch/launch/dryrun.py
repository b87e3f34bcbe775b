"""Multi-pod dry run: trace every (arch x shape x mesh) cell on meta tensors.

Port of the reference's ``launch/dryrun.py``. For each cell this builds
the real step (the training step with the sharded AdamW update; prefill;
or one decode step on the cache) over the production mesh, runs it once
on ``meta`` tensors (shapes and dtypes, no memory, no kernel launched) and
records per-device memory, FLOPs, bytes, collectives and the roofline
terms to JSON.

The reference lowers each step under ``ShapeDtypeStruct`` inputs and
reads XLA's ``memory_analysis`` and ``cost_analysis``. Here the step runs
eagerly on ``meta`` under :class:`.counting.StepCounter`: the kernels'
wrappers take their ``meta`` branch (the card's preconditions and output
shapes; each call's operations and bytes from ``kernels.cost``), every
other aten op is counted by its FLOP formula and bytes, the collectives
at the distribution layer's helpers, the memory by the storages the step
allocates. The mesh is the production one (``launch.mesh.Mesh``, 256 or
512 ranks) over a process group of torch's ``fake`` backend, this process
standing as rank 0: its collectives return at once. Nothing touches a
GPU, so the dry run runs on any host.

The port computes the ``'model'`` dims replicated (``repro_torch.
distributed``): each rank holds its parameters' shards and its ZeRO-1
part of the moments, gathers each weight whole where it is used, and
computes its rows of the batch, with caches and activations local to
those rows. The per-device figures are that layout's. The step runs its
layers eagerly, so every layer is counted as it runs and the reference's
loop-trip probes (k = 0 and k = 1 super-blocks) are not needed:
``flops_raw``/``bytes_raw`` equal the totals. ``compile_s`` is the
trace's wall (the model built on meta, its parameters cut, one step).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b \\
        --shape train_4k --mesh single --out results/dryrun
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from ..configs.registry import (ARCHS, SHAPES, ShapeSpec, cell_applicable,
                                get_config)
from ..distributed.sharding import (MeshParams, MeshSharder, NamedSharding,
                                    P, ShardingRules, _stacked)
from ..models.config import ModelConfig
from ..models.layers import row_mean
from ..models.model import Model
from ..training.optimizer import AdamWConfig, _last_block, adamw_init
from ..training.train_loop import make_train_step, train_params
from .counting import StepCounter
from .mesh import PRODUCTION, Mesh
from .roofline import model_flops_estimate, roofline
from .specs import META, input_specs


def opt_config_for(cfg: ModelConfig) -> AdamWConfig:
    """Optimizer-state dtype policy: int8 moments for >100B-param models
    (arctic), bf16 for >40B (internvl2), fp32 otherwise (the reference's
    DESIGN.md §6)."""
    n = cfg.param_count()
    if n > 100e9:
        sd = "int8"
    elif n > 40e9:
        sd = "bfloat16"
    else:
        sd = "float32"
    return AdamWConfig(state_dtype=sd)


def opt_state_sharding_tree(rules: ShardingRules, opt_state,
                            shapes: Dict[str, tuple]):
    """Shardings of an ``AdamWState`` (the port's ``opt_state_shardings``
    over the trace's tree of moments; ``shapes`` maps each parameter to
    its whole shape).

    int8 moments are shape-preserving: ``q`` has the parameter's shape and
    takes the parameter's ZeRO spec verbatim; ``scale``/``lo`` ([..., nb,
    1] per last-dim block) take the spec minus its last axis."""

    def leaf(name: str, part: Optional[str]) -> NamedSharding:
        path = name.replace(".", "/")
        stacked = _stacked(path)
        shape = tuple(shapes[name])
        if part in ("scale", "lo"):
            shape = shape[:-1] + (shape[-1] // _last_block(shape), 1)
        core = shape[1:] if stacked else shape
        if part in (None, "q"):
            spec = rules.param_spec(path, core)
        else:   # scale/lo: [..., nb, 1] — drop sharding on trailing dims
            pspec = rules.param_spec(path, core[:-2] + (1,))
            spec = P(*(list(pspec)[:len(core) - 2] + [None, None])[:len(core)])
        if stacked:
            spec = P(None, *spec)
        return NamedSharding(rules.mesh, rules.zero_spec(spec, shape))

    def moments(tree):
        return {name: ({part: leaf(name, part) for part in m}
                       if isinstance(m, dict) else leaf(name, None))
                for name, m in tree.items()}

    return type(opt_state)(step=NamedSharding(rules.mesh, P()),
                           m=moments(opt_state.m), v=moments(opt_state.v))


def loss_chunk_for(cfg: ModelConfig, mesh) -> int:
    m = mesh.shape.get("model", 1)
    v_local = cfg.vocab_size / (m if cfg.vocab_size % m == 0 else 1)
    if v_local > 50000:
        return 128
    if v_local > 12000:
        return 256
    return 512


@dataclasses.dataclass
class CellResult:
    arch: str
    shape: str
    mesh: str
    ok: bool
    skipped: bool = False
    reason: str = ""
    compile_s: float = 0.0
    n_chips: int = 0
    memory: Dict[str, float] = dataclasses.field(default_factory=dict)
    cost: Dict[str, float] = dataclasses.field(default_factory=dict)
    collectives: Dict[str, int] = dataclasses.field(default_factory=dict)
    terms: Dict[str, Any] = dataclasses.field(default_factory=dict)
    variant: str = "baseline"
    #: kernel name -> calls, operations and bytes of the traced step
    kernels: Dict[str, Dict[str, int]] = dataclasses.field(
        default_factory=dict)


# -- the fake group -------------------------------------------------------

def _register_fake_backend() -> None:
    """Register torch's ``fake`` c10d backend (collectives that return at
    once, for one process standing as one rank of many), as
    ``torch.testing``'s helper does, without importing it."""
    from torch._C._distributed_c10d import FakeProcessGroup

    def create(common_opts, backend_opts):
        make = getattr(FakeProcessGroup, "_create_internal", None)
        if make is not None:
            return make(common_opts.group_rank, common_opts.group_size,
                        backend_opts)
        return FakeProcessGroup(common_opts.group_rank,
                                common_opts.group_size)

    dist.Backend.register_backend("fake", create, extended_api=True,
                                  devices=["cpu", "cuda"])


def fake_mesh(shape, axes) -> Mesh:
    """A :class:`.mesh.Mesh` of ``shape`` over a ``fake`` default group of
    its size, this process as rank 0. Raises if a group is up; the caller
    destroys the group (``dist.destroy_process_group``)."""
    if dist.is_initialized():
        raise RuntimeError("the dry run starts its own fake process group: "
                           "one is already initialised")
    _register_fake_backend()
    size = 1
    for s in shape:
        size *= int(s)
    dist.init_process_group("fake", rank=0, world_size=size,
                            store=dist.HashStore())
    try:
        return Mesh(shape, axes)
    except BaseException:
        dist.destroy_process_group()
        raise


# -- one traced step --------------------------------------------------------

def warm_norms(model: Model) -> None:
    """Make the norms' cached constant columns (``layers.row_mean``) on
    the model's device, as a real step after the first finds them: call
    before counting a step."""
    cfg = model.cfg
    widths = {cfg.d_model}
    if "rwkv6" in cfg.block_pattern:
        widths.add(cfg.rwkv_head_dim)
    with torch.no_grad():
        for n in widths:
            row_mean(torch.empty((1, n), device=model.device))


def trace_step(cfg: ModelConfig, shape: ShapeSpec, mesh=None,
               remat: bool = True, moe_dispatch: str = "einsum",
               ocfg: Optional[AdamWConfig] = None,
               loss_chunk: Optional[int] = None):
    """Build the real step of one cell on ``meta`` (its parameters held
    over ``mesh`` by the sharding rules, or whole on one device without
    one) and run it once under a :class:`.counting.StepCounter`. Returns
    (counter, memory fields). ``ocfg`` is the training step's optimizer
    (:func:`opt_config_for` by default), ``loss_chunk`` its loss chunk
    (:func:`loss_chunk_for` by default; 512 without a mesh). The decode
    step runs at the cache's last slot (a full cache: every slot live, as
    ``flash_decode``'s meta branch counts them)."""
    rules = layout = None
    shard = {}
    if mesh is not None:
        rules = ShardingRules(cfg, mesh)
        shard = {"shard": MeshSharder(rules)}
    if loss_chunk is None:
        loss_chunk = loss_chunk_for(cfg, mesh) if mesh is not None else 512
    model = Model(cfg, device=META, remat=remat, loss_chunk=loss_chunk,
                  moe_dispatch=moe_dispatch, **shard)
    if mesh is not None:
        layout = MeshParams(model, rules)
    specs = input_specs(model, shape)
    b, s = shape.global_batch, shape.seq_len
    warm_norms(model)
    if shape.kind == "train":
        ocfg = ocfg or opt_config_for(cfg)
        params = train_params(model)
        opt = adamw_init(params, ocfg, layout)
        step = make_train_step(model, ocfg)
        local = specs if layout is None else layout.local_batch(specs)
        with StepCounter(META, (params, opt, specs)) as counter:
            outputs = step(params, opt, specs)
        return counter, counter.memory((params, opt, local), outputs)
    params = dict(model.named_parameters())
    if shape.kind == "prefill":
        local = specs if layout is None else layout.local_batch(specs)
        kw = {k: v for k, v in local.items() if k != "tokens"}
        # VLM archs prepend the patch prefix: the cache covers it too
        cache_len = s + (cfg.vision_patches or 0)
        with StepCounter(META, (params, specs)) as counter:
            outputs = model.prefill(local["tokens"], cache_len=cache_len,
                                    **kw)
        return counter, counter.memory((params, local), outputs)
    rows = b
    if layout is not None:   # this rank's rows, cut along the batch dim
        rows = NamedSharding(mesh, P(rules.batch_dim(b))).local_shape(
            (b,))[0]
        layout.sharder.global_batch = b
    cache = model.init_cache(rows, s)
    token = specs["token"][:rows]
    with StepCounter(META, (params, cache, token)) as counter:
        outputs = model.decode_step(cache, token, s - 1)
    return counter, counter.memory((params, cache, token), outputs)


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             variant: str = "baseline",
             overrides: Optional[Dict[str, Any]] = None) -> CellResult:
    """One cell on its production mesh (``single``: 16 x 16, ``multi``: 2
    x 16 x 16) over a fake group started and destroyed here. ``overrides``
    may replace ``config`` and ``shape`` fields and set ``remat`` and
    ``moe_dispatch``."""
    shape = SHAPES[shape_name]
    cfg = get_config(arch)
    overrides = overrides or {}
    if overrides.get("config"):
        cfg = dataclasses.replace(cfg, **overrides["config"])
    if overrides.get("shape"):
        shape = dataclasses.replace(shape, **overrides["shape"])
    ok, why = cell_applicable(cfg, shape)
    if not ok:
        return CellResult(arch, shape_name, mesh_kind, ok=False, skipped=True,
                          reason=why, variant=variant)
    t0 = time.perf_counter()
    mesh = fake_mesh(*PRODUCTION[mesh_kind == "multi"])
    try:
        counter, mem = trace_step(
            cfg, shape, mesh, remat=overrides.get("remat", True),
            moe_dispatch=overrides.get("moe_dispatch", "einsum"))
        n_chips = mesh.size
    finally:
        dist.destroy_process_group()
    compile_s = time.perf_counter() - t0
    cost = counter.cost()
    coll = counter.collectives()
    tokens = shape.global_batch * (1 if shape.kind == "decode"
                                   else shape.seq_len)
    mf = model_flops_estimate(cfg.active_param_count(), tokens, shape.kind)
    terms = roofline(cost, coll, n_chips, model_flops=mf)
    return CellResult(arch, shape_name, mesh_kind, ok=True,
                      compile_s=compile_s, n_chips=n_chips, memory=mem,
                      cost=cost, collectives=coll, terms=terms.to_dict(),
                      variant=variant,
                      kernels=counter.summary()["kernels"])


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS)
    ap.add_argument("--shape", choices=tuple(SHAPES))
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--overrides", default=None,
                    help='JSON dict of overrides, e.g. '
                         '{"config": {"capacity_factor": 1.0}}')
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    meshes = ("single", "multi") if args.mesh == "both" else (args.mesh,)
    if args.all:
        cells = [(arch, shape) for arch in ARCHS for shape in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("give --arch and --shape, or --all")
        cells = [(args.arch, args.shape)]
    overrides = json.loads(args.overrides) if args.overrides else None

    for arch, shape in cells:
        for mesh_kind in meshes:
            tag = f"{arch}_{shape}_{mesh_kind}_{args.variant}"
            try:
                res = run_cell(arch, shape, mesh_kind, args.variant, overrides)
            except Exception as e:  # a failure here is a bug in the system
                res = CellResult(arch, shape, mesh_kind, ok=False,
                                 reason=f"{type(e).__name__}: {e}\n"
                                        f"{traceback.format_exc()[-2000:]}",
                                 variant=args.variant)
            path = os.path.join(args.out, tag + ".json")
            with open(path, "w") as f:
                json.dump(dataclasses.asdict(res), f, indent=1)
            status = ("SKIP" if res.skipped else "OK" if res.ok else "FAIL")
            dom = res.terms.get("dominant", "-") if res.ok else "-"
            hbm = res.memory.get("per_device_hbm_bytes", 0) / 2**30
            bound = res.terms.get("bound_s", 0.0)
            print(f"{status:4s} {tag:60s} compile={res.compile_s:6.1f}s "
                  f"hbm/dev={hbm:6.2f}GiB dominant={dom} "
                  f"bound={bound:.4g}s", flush=True)
            if not res.ok and not res.skipped:
                print(res.reason[-1500:], flush=True)


if __name__ == "__main__":
    main()
