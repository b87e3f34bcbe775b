"""The port's dry run (``repro_torch.launch.dryrun``, ``specs``,
``roofline``, ``counting``, the kernels' ``meta`` branches and cost
functions) against the reference's ``launch`` package.

The reference's specs and roofline are reached through
``test_torch_harness.reference()``; its ``dryrun`` module, which sets
``XLA_FLAGS`` when imported, only in a subprocess with 16 host devices
(``_subproc.run_py``) that installs the same ``enable_x64`` shim before
its imports. The port's traces run over ``fake`` process groups in this
process, each destroyed before its test ends.
"""
import dataclasses
import importlib
import json
import math
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs.registry import (ARCHS, SHAPES, ShapeSpec,
                                          get_config, get_smoke_config)
from repro_torch.distributed.sharding import cache_shardings
from repro_torch.kernels import cost, ops
from repro_torch.launch import dryrun as dr
from repro_torch.launch.counting import StepCounter
from repro_torch.launch.specs import META, input_specs
from repro_torch.models import Model
from repro_torch.models.model import train_launches
from repro_torch.training.optimizer import AdamWConfig, adamw_init
from repro_torch.training.train_loop import make_train_step, train_params

from ._subproc import run_py
from .test_torch_harness import ROOT, reference

# the package's ``roofline`` is the function, as in the reference
rl = importlib.import_module("repro_torch.launch.roofline")

#: the reference's small-mesh test shapes (tests/test_dryrun.py)
SMALL_SHAPES = {"train": ShapeSpec("train", 64, 16, "train"),
                "prefill": ShapeSpec("prefill", 64, 4, "prefill"),
                "decode": ShapeSpec("decode", 64, 8, "decode")}
SMALL_MESHES = {"(2, 8)": ((2, 8), ("data", "model")),
                "(2, 2, 4)": ((2, 2, 4), ("pod", "data", "model"))}
ARG_CELLS = [("llama3-8b", "train"), ("olmoe-1b-7b", "train"),
             ("whisper-large-v3", "train"), ("llama3-8b", "prefill"),
             ("llama3-8b", "decode"), ("rwkv6-1.6b", "decode"),
             ("olmoe-1b-7b", "prefill"), ("qwen1.5-32b", "decode"),
             ("recurrentgemma-9b", "decode"), ("olmoe-1b-7b", "decode"),
             ("whisper-large-v3", "decode")]

_REF_SCRIPT = """
import jax, jax.experimental
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64
import json, math, types
import numpy as np
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
import repro.launch.dryrun as dr
from repro.configs.registry import ARCHS, ShapeSpec, get_config, get_smoke_config
from repro.distributed.sharding import (MeshSharder, ShardingRules,
    batch_shardings, cache_shardings, param_shardings)
from repro.launch.specs import input_specs
from repro.models.model import Model
from repro.training.optimizer import AdamWConfig, adamw_init

SHAPES = {"train": ShapeSpec("train", 64, 16, "train"),
          "prefill": ShapeSpec("prefill", 64, 4, "prefill"),
          "decode": ShapeSpec("decode", 64, 8, "decode")}
MESHES = %(meshes)s
CELLS = %(cells)s


def mesh_of(key):
    dims, axes = MESHES[key]
    return Mesh(np.array(jax.devices()[:math.prod(dims)]).reshape(dims), axes)


def shard_bytes(tree, shardings):
    leaves = jax.tree_util.tree_leaves(tree)
    shs = jax.tree_util.tree_leaves(
        shardings, is_leaf=lambda x: isinstance(x, NamedSharding))
    assert len(leaves) == len(shs)
    return int(sum(math.prod(s.shard_shape(x.shape))
                   * jnp.dtype(x.dtype).itemsize
                   for x, s in zip(leaves, shs)))


def input_shard_bytes(arch, kind, key):
    # the input shardings _lower_and_compile gives each cell's step
    cfg, shape, mesh = get_smoke_config(arch), SHAPES[kind], mesh_of(key)
    rules = ShardingRules(cfg, mesh)
    model = Model(cfg, shard=MeshSharder(rules), use_pallas=False,
                  remat=True, loss_chunk=dr.loss_chunk_for(cfg, mesh),
                  scan_serving=True)
    with mesh:
        params = jax.eval_shape(model.init,
                                jax.ShapeDtypeStruct((2,), jnp.uint32))
        params_sh = param_shardings(rules, params)
        specs = input_specs(model, shape)
        if kind == "train":
            ocfg = dr.opt_config_for(cfg)
            opt = jax.eval_shape(lambda p: adamw_init(p, ocfg), params)
            opt_sh = dr.opt_state_sharding_tree(rules, opt, params_sh)
            return shard_bytes((params, opt, specs),
                               (params_sh, opt_sh,
                                batch_shardings(rules, specs)))
        if kind == "prefill":
            return shard_bytes((params, specs),
                               (params_sh, batch_shardings(rules, specs)))
        return shard_bytes(
            (params, specs["cache"], specs["token"], specs["pos"]),
            (params_sh, cache_shardings(rules, specs["cache"]),
             batch_shardings(rules, {"t": specs["token"]})["t"],
             NamedSharding(mesh, P())))


out = {"opt": {a: dr.opt_config_for(get_config(a)).state_dtype
               for a in ARCHS},
       "chunk": {}, "args": {}}
for kind, shape in (("single", {"data": 16, "model": 16}),
                    ("multi", {"pod": 2, "data": 16, "model": 16})):
    for a in ARCHS:
        out["chunk"][a + "|" + kind] = dr.loss_chunk_for(
            get_config(a), types.SimpleNamespace(shape=shape))
for arch, kind in CELLS:
    for key in MESHES:
        out["args"]["|".join((arch, kind, key))] = input_shard_bytes(
            arch, kind, key)
out["opt_specs"] = {}
for arch in ("llama3-8b", "olmoe-1b-7b"):
    cfg, mesh = get_smoke_config(arch), mesh_of("(2, 8)")
    rules = ShardingRules(cfg, mesh)
    model = Model(cfg, shard=MeshSharder(rules), use_pallas=False,
                  scan_serving=True)
    params = jax.eval_shape(model.init,
                            jax.ShapeDtypeStruct((2,), jnp.uint32))
    ocfg = AdamWConfig(state_dtype="int8")
    opt = jax.eval_shape(lambda p: adamw_init(p, ocfg), params)
    sh = dr.opt_state_sharding_tree(rules, opt,
                                    param_shardings(rules, params))
    flat = jax.tree_util.tree_flatten_with_path(
        sh, is_leaf=lambda x: isinstance(x, NamedSharding))[0]
    out["opt_specs"][arch] = {
        "/".join(str(getattr(k, "key", getattr(k, "name", k))) for k in kp):
        [list(e) if isinstance(e, tuple) else e for e in s.spec]
        for kp, s in flat}
compiled = dr._lower_and_compile(get_smoke_config("llama3-8b"),
                                 SHAPES["decode"], mesh_of("(2, 8)"))
out["xla_decode_args"] = int(
    compiled.memory_analysis().argument_size_in_bytes)
print("REF_JSON " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref_dryrun():
    """The reference dry run's numbers, computed once in a subprocess."""
    code = _REF_SCRIPT % {"meshes": repr(SMALL_MESHES),
                          "cells": repr(ARG_CELLS)}
    outp = run_py(code, devices=16, timeout=600)
    line = next(ln for ln in outp.splitlines() if ln.startswith("REF_JSON "))
    return json.loads(line[len("REF_JSON "):])


@pytest.fixture
def no_group():
    """The test starts with no process group and leaves none up."""
    assert not dist.is_initialized()
    yield
    assert not dist.is_initialized()


def _leaves(tree, path=()):
    """(path, leaf) pairs of a nested dict / list / tuple."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            yield from _leaves(x, path + (str(i),))
    else:
        yield path, tree


# -- specs ----------------------------------------------------------------

@pytest.mark.parametrize("shape_name", tuple(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal_the_reference(arch, shape_name):
    ref = reference()
    ref_model = ref.models.Model(ref.configs.get_config(arch))
    want = ref.launch_specs.input_specs(ref_model,
                                        ref.configs.SHAPES[shape_name])
    model = Model(get_config(arch), device=META)
    got = input_specs(model, SHAPES[shape_name])
    got_l, want_l = list(_leaves(got)), list(_leaves(want))
    assert [p for p, _ in got_l] == [p for p, _ in want_l]
    for (path, g), (_, w) in zip(got_l, want_l):
        assert g.device.type == "meta", path
        assert tuple(g.shape) == tuple(w.shape), path
        assert str(g.dtype).replace("torch.", "") == str(w.dtype), path


# -- policies, model FLOPs, roofline ------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_opt_config_and_loss_chunk_equal_the_reference(arch, ref_dryrun):
    assert (dr.opt_config_for(get_config(arch)).state_dtype
            == ref_dryrun["opt"][arch])
    for kind, shape in (("single", {"data": 16, "model": 16}),
                        ("multi", {"pod": 2, "data": 16, "model": 16})):
        mesh = types.SimpleNamespace(shape=shape)
        assert (dr.loss_chunk_for(get_config(arch), mesh)
                == ref_dryrun["chunk"][f"{arch}|{kind}"])


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_model_flops_estimate_equals_the_reference(kind):
    ref = reference().launch_roofline
    for arch in ARCHS:
        cfg = get_config(arch)
        for tokens in (1, 128, 256 * 4096):
            assert (rl.model_flops_estimate(cfg.active_param_count(),
                                            tokens, kind)
                    == ref.model_flops_estimate(cfg.active_param_count(),
                                                tokens, kind))


#: (per-device cost, collectives, chips, model FLOPs): the reference's own
#: TestRoofline case first
ROOFLINE_CASES = [
    ({"flops": 1e12, "bytes accessed": 1e9}, {"all-reduce": 5e8}, 256, 2e14),
    ({"flops": 4e15, "bytes accessed": 2e11}, {"all-gather": 1e6,
                                               "n_all-gather": 3}, 512, 1e18),
    ({"flops": 1e9, "bytes accessed": 6e12}, {}, 1, 5e8),
]


@pytest.mark.parametrize("case", range(len(ROOFLINE_CASES)))
def test_roofline_is_the_reference_on_the_h100_peaks(case):
    cost_d, coll, n, mf = ROOFLINE_CASES[case]
    ref = reference().launch_roofline
    want = ref.roofline(cost_d, coll, n_chips=n, model_flops=mf)
    got = rl.roofline(cost_d, coll, n_chips=n, model_flops=mf)
    assert (rl.PEAK_FLOPS, rl.HBM_BW, rl.LINK_BW) == (989e12, 3.35e12, 50e9)
    assert got.flops_global == want.flops_global
    assert got.bytes_global == want.bytes_global
    assert got.collective_global == want.collective_global
    assert got.compute_s == pytest.approx(
        want.compute_s * ref.PEAK_FLOPS / rl.PEAK_FLOPS, rel=1e-12)
    assert got.memory_s == pytest.approx(
        want.memory_s * ref.HBM_BW / rl.HBM_BW, rel=1e-12)
    assert got.collective_s == pytest.approx(
        want.collective_s * ref.LINK_BW / rl.LINK_BW, rel=1e-12)
    terms = {"compute": got.compute_s, "memory": got.memory_s,
             "collective": got.collective_s}
    assert got.dominant == max(terms, key=terms.get)
    assert got.bound_s == max(terms.values())
    assert got.roofline_fraction == pytest.approx(
        mf / (n * rl.PEAK_FLOPS) / got.bound_s, rel=1e-12)
    assert set(got.to_dict()) == set(want.to_dict())


def test_collective_bytes_keep_the_reference_dictionary():
    ref = reference().launch_roofline
    hlo = """
  %x = bf16[8,128]{1,0} all-gather(bf16[8,32]{1,0} %p), replica_groups={}
  %y = f32[16,16]{1,0} all-reduce(f32[16,16]{1,0} %q), to_apply=%add
  %z = (f32[4,8]{1,0}, f32[4,8]{1,0}) all-to-all(f32[4,8] %a, f32[4,8] %b)
  %w = bf16[2,4]{1,0} collective-permute-start(bf16[2,4] %c)
  %rs = f32[4]{0} reduce-scatter(f32[16] %d), dimensions={0}
"""
    issued = [("all-gather", 8 * 128 * 2), ("all-reduce", 16 * 16 * 4),
              ("all-to-all", 2 * 4 * 8 * 4), ("collective-permute", 2 * 4 * 2),
              ("reduce-scatter", 4 * 4)]
    assert rl.collective_bytes(issued) == ref.collective_bytes(hlo)


# -- the kernels' cost functions and meta branches -----------------------

def _bound_ms(ops_, nbytes, peak):
    return max(nbytes / rl.HBM_BW, ops_ / peak) * 1e3


@pytest.mark.parametrize("row", ["flash_decode fp8", "matmul f32",
                                 "rglru f32"])
def test_cost_functions_pin_perf_md_bound_rows(row):
    """Three rows of PERF.md §6's bound column."""
    if row == "flash_decode fp8":
        # qwen1.5-32b's [2, 40, 4112, 128], length 4097: 0.025059 ms
        n_ops, nbytes = cost.flash_decode((2, 40, 128), 40, torch.bfloat16,
                                          torch.float8_e4m3fn, 2 * 4097)
        assert nbytes == 83_947_520
        assert round(_bound_ms(n_ops, nbytes, rl.PEAK_FLOPS), 6) == 0.025059
    elif row == "matmul f32":
        n_ops, nbytes = cost.matmul(4096, 4096, 4096, torch.float32)
        assert n_ops == 2 * 4096 ** 3
        assert nbytes == 3 * 4096 ** 2 * 4
        # 2.051328 ms at the 67 TFLOP/s float32 peak (operations)
        assert round(_bound_ms(n_ops, nbytes, 67e12), 6) == 2.051328
    else:
        # [8, 2048, 4096] f32 from a nonzero h0: 0.240468 ms (bytes); x, a
        # and y alone are 805,306,368 B, h0 and h_T 262,144 more
        n_ops, nbytes = cost.rglru(8, 2048, 4096, True)
        assert nbytes == 805_306_368 + 2 * 8 * 4096 * 4 == 805_568_512
        assert round(_bound_ms(n_ops, nbytes, 67e12), 6) == 0.240468


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device=META)


@pytest.mark.parametrize("kernel", ["matmul", "flash_attention",
                                    "flash_decode", "rglru", "rwkv6",
                                    "rglru_bwd", "rwkv6_bwd"])
def test_meta_branch_shapes_counts_and_preconditions(kernel):
    """On meta a wrapper returns the kernel's output shapes and dtypes,
    reports its cost to a counter, launches nothing, and refuses what the
    card's kernel refuses."""
    f32 = torch.float32
    calls = {
        "matmul": (lambda: ops.matmul(_meta(8, 64), _meta(64, 32)),
                   [(8, 32)], None),
        "flash_attention": (
            lambda: ops.flash_attention(_meta(2, 4, 16, 64),
                                        _meta(2, 2, 16, 64),
                                        _meta(2, 2, 16, 64)),
            [(2, 4, 16, 64)],
            lambda: ops.flash_attention(_meta(1, 1, 4, 512),
                                        _meta(1, 1, 4, 512),
                                        _meta(1, 1, 4, 512))),
        "flash_decode": (
            lambda: ops.flash_decode(_meta(2, 4, 64), _meta(2, 2, 300, 64),
                                     _meta(2, 2, 300, 64),
                                     _meta(2, dtype=torch.int32)),
            [(2, 4, 64)], None),
        "rglru": (lambda: ops.rglru(_meta(2, 5, 8, dtype=f32),
                                    _meta(2, 5, 8, dtype=f32)),
                  [(2, 5, 8), (2, 8)],
                  lambda: ops.rglru(_meta(65536, 1, 8, dtype=f32),
                                    _meta(65536, 1, 8, dtype=f32))),
        "rwkv6": (lambda: ops.rwkv6(_meta(1, 2, 5, 64), _meta(1, 2, 5, 64),
                                    _meta(1, 2, 5, 64),
                                    _meta(1, 2, 5, 64, dtype=f32),
                                    _meta(2, 64, dtype=f32)),
                  [(1, 2, 5, 64), (1, 2, 64, 64)],
                  lambda: ops.rwkv6(_meta(1, 2, 5, 48), _meta(1, 2, 5, 48),
                                    _meta(1, 2, 5, 48),
                                    _meta(1, 2, 5, 48, dtype=f32),
                                    _meta(2, 48, dtype=f32))),
        "rglru_bwd": (lambda: ops.rglru_bwd(*(_meta(2, 5, 8, dtype=f32)
                                              for _ in range(4))),
                      [(2, 5, 8), (2, 5, 8), (2, 8)],
                      lambda: ops.rglru_bwd(*(_meta(65536, 1, 8, dtype=f32)
                                              for _ in range(4)))),
        "rwkv6_bwd": (lambda: ops.rwkv6_bwd(
            _meta(1, 2, 5, 64), _meta(1, 2, 5, 64), _meta(1, 2, 5, 64),
            _meta(1, 2, 5, 64, dtype=f32), _meta(2, 64, dtype=f32),
            _meta(1, 2, 5, 64)),
            [(1, 2, 5, 64)] * 4 + [(2, 64), (1, 2, 64, 64)],
            lambda: ops.rwkv6_bwd(
                _meta(1, 2, 5, 48), _meta(1, 2, 5, 48), _meta(1, 2, 5, 48),
                _meta(1, 2, 5, 48, dtype=f32), _meta(2, 48, dtype=f32),
                _meta(1, 2, 5, 48))),
    }
    run, shapes, refused = calls[kernel]
    ops.reset_launch_counts()
    with StepCounter(META) as counter:
        out = run()
    outs = out if isinstance(out, tuple) else (out,)
    assert [tuple(t.shape) for t in outs] == shapes
    assert all(t.device.type == "meta" for t in outs)
    assert ops.launch_counts()[kernel] == 0
    k = counter.kernels[kernel]
    assert k["calls"] == 1 and k["operations"] > 0 and k["bytes"] > 0
    if kernel == "flash_decode":   # meta counts every cache slot live
        assert k == {"calls": 1, **dict(zip(
            ("operations", "bytes"), cost.flash_decode(
                (2, 4, 64), 2, torch.bfloat16, torch.bfloat16, 2 * 300)))}
    if refused is not None:
        with pytest.raises(ValueError, match="kernel takes"):
            refused()


@pytest.mark.parametrize("arch", ["llama3-8b", "olmoe-1b-7b"])
def test_opt_state_sharding_tree_equals_the_reference(arch, ref_dryrun,
                                                      no_group):
    """int8 moments' specs on (2, 8): ``q`` the parameter's ZeRO spec,
    ``scale``/``lo`` without the last dim's axes, as the reference's."""
    mesh = dr.fake_mesh(*SMALL_MESHES["(2, 8)"])
    try:
        cfg = get_smoke_config(arch)
        model = Model(cfg, device=META)
        layout = dr.MeshParams(model, dr.ShardingRules(cfg, mesh))
        opt = adamw_init(train_params(model), AdamWConfig(state_dtype="int8"),
                         layout)
        shapes = {k: leaf.shape for k, leaf in layout.leaves.items()}
        tree = dr.opt_state_sharding_tree(layout.rules, opt, shapes)
    finally:
        dist.destroy_process_group()
    got = {"step": list(tree.step.spec)}
    for kind in ("m", "v"):
        for name, parts in getattr(tree, kind).items():
            for part, sh in parts.items():
                key = "/".join((kind, name.replace(".", "/"), part))
                got[key] = [list(e) if isinstance(e, tuple) else e
                            for e in sh.spec]
    assert got == ref_dryrun["opt_specs"][arch]


# -- argument bytes against the reference's input shardings --------------

def _reckoned(kind, layout, specs_shape, state_dtype):
    """The port's argument bytes less the reference's, reckoned leaf by
    leaf: int8 moments stored over whole quantization blocks of their
    whole leaf (``_Leaf.moment``) where the reference's ZeRO part is
    narrower (float32 and bf16 moments take exactly that part: ROADMAP
    Queue 3 item 26, so none here); each cache leaf the reference also
    cuts over 'model' (the port keeps the model dims whole on its rows);
    the decode step's ``pos``, a host int in the port and a 4-byte int32
    argument in the reference. Serving over a mesh whose batch leaves
    'model' free holds each cache leaf on the reference's cut (its KV
    heads, its slots, its columns), so there ``cache_cut`` is empty."""
    widened, cache_cut = {}, {}
    if kind == "train" and state_dtype == "int8":
        for name, leaf in layout.leaves.items():
            more = (math.prod(hi - lo for lo, hi in leaf.moment)
                    - math.prod(hi - lo for lo, hi in leaf.zero))
            if more:
                widened[name] = 2 * 4 * more
    if kind == "decode":
        b, s = specs_shape.global_batch, specs_shape.seq_len
        rows = dr.NamedSharding(layout.mesh, dr.P(
            layout.rules.batch_dim(b))).local_shape((b,))[0]
        local = layout.model.init_cache(rows, s)     # the trace's cache
        whole = Model(layout.model.cfg, device=META).init_cache(b, s)
        shs = cache_shardings(layout.rules, whole)
        for (path, c), (_, w), (_, sh) in zip(_leaves(local), _leaves(whole),
                                              _leaves(shs)):
            port = c.numel() * c.element_size()
            ref = math.prod(sh.local_shape(w.shape)) * w.element_size()
            if port != ref:
                cache_cut["/".join(path)] = port - ref
    pos = -4 if kind == "decode" else 0
    return widened, cache_cut, pos


@pytest.mark.parametrize("mesh_key", tuple(SMALL_MESHES))
@pytest.mark.parametrize("arch,kind", ARG_CELLS)
def test_argument_bytes_equal_the_reference_shards(arch, kind, mesh_key,
                                                   ref_dryrun, no_group,
                                                   monkeypatch):
    layouts = []
    real = dr.MeshParams

    def keep(*a, **kw):
        layouts.append(real(*a, **kw))
        return layouts[-1]

    monkeypatch.setattr(dr, "MeshParams", keep)
    mesh = dr.fake_mesh(*SMALL_MESHES[mesh_key])
    try:
        _, mem = dr.trace_step(get_smoke_config(arch), SMALL_SHAPES[kind],
                               mesh)
        cfg = get_smoke_config(arch)
        widened, cache_cut, pos = _reckoned(
            kind, layouts[0], SMALL_SHAPES[kind],
            dr.opt_config_for(cfg).state_dtype)
    finally:
        dist.destroy_process_group()
    want = ref_dryrun["args"][f"{arch}|{kind}|{mesh_key}"]
    got = mem["argument_size_in_bytes"]
    assert got == want + sum(widened.values()) + sum(cache_cut.values()) \
        + pos, (widened, cache_cut)
    # the smoke configs' moments are float32: exactly the reference's
    # ZeRO parts, so a train cell's arguments equal the reference's
    assert not widened
    if kind == "train":
        assert got == want
    if kind == "prefill":
        assert got == want
    if kind == "decode":
        # every cache leaf on the reference's cut (llama3-8b's 2 KV heads
        # cut along the 64 slots 8 ways, ...): only ``pos`` differs
        assert not cache_cut
        assert got == want + pos
    if (arch, kind, mesh_key) == ("llama3-8b", "decode", "(2, 8)"):
        # XLA's own argument_size_in_bytes of the compiled cell is the sum
        # of its input shards
        assert ref_dryrun["xla_decode_args"] == want


# -- the trace against a real step --------------------------------------

@pytest.mark.parametrize("arch", ["llama3-8b", "olmoe-1b-7b"])
def test_meta_trace_counts_a_real_cpu_step(arch, no_group):
    """The counter over a real CPU training step (the kernels' plain
    versions, each reported as a call) and over the meta trace of the same
    step: the same kernel calls, operations and bytes by kernel and the
    same aten FLOPs; the calls are ``train_launches`` of the step."""
    cfg = get_smoke_config(arch)
    shape = ShapeSpec("train", 48, 2, "train")
    ocfg = AdamWConfig(state_dtype="int8")
    traced, _ = dr.trace_step(cfg, shape, ocfg=ocfg, loss_chunk=32)

    model = Model(cfg, device="cpu", loss_chunk=32).init(
        torch.Generator().manual_seed(0))
    params = train_params(model)
    opt = adamw_init(params, ocfg)
    step = make_train_step(model, ocfg)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (2, 48)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(np.roll(toks, -1, 1)),
             "loss_mask": torch.ones((2, 48), dtype=torch.float32)}
    dr.warm_norms(model)
    with StepCounter("cpu", (params, opt, batch)) as real:
        step(params, opt, batch)
    assert real.kernels == traced.kernels
    want = train_launches(cfg, 48, loss_chunk=32)
    assert {k: v["calls"] for k, v in real.kernels.items()} == {
        k: n for k, n in want.items() if n}
    assert real.aten_flops == traced.aten_flops > 0
    assert real.collectives() == traced.collectives()


def test_meta_trace_takes_the_cards_kv_cast(monkeypatch, no_group):
    """qwen1.5-32b's smoke config with its production fp8 cache: the meta
    trace of a decode step counts what a real CPU step counts when torch's
    own bf16 cast is taken (the cast the card takes), and not what the
    float32-bit cast counts."""
    from repro_torch.models import layers

    cfg = dataclasses.replace(get_smoke_config("qwen1.5-32b"),
                              kv_dtype=get_config("qwen1.5-32b").kv_dtype)
    assert cfg.kv_dtype == "float8_e4m3fn"
    B, S = 2, 16
    traced, _ = dr.trace_step(cfg, ShapeSpec("decode", S, B, "decode"))

    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32))
    params = dict(model.named_parameters())
    dr.warm_norms(model)
    cpu = torch.device("cpu")
    real = {}
    for card_cast in (True, False):
        monkeypatch.setitem(layers._BF16_CAST_IS_XLA, cpu, card_cast)
        _, cache = model.prefill(toks[:, :-1], cache_len=S)
        with StepCounter(cpu, (params, cache, toks[:, -1])) as c:
            model.decode_step(cache, toks[:, -1], S - 1)
        real[card_cast] = c.summary()
    assert traced.summary() == real[True]
    assert traced.summary() != real[False]


# -- cells --------------------------------------------------------------

SMALL_CELLS = [("llama3-8b", "train"), ("olmoe-1b-7b", "train"),
               ("whisper-large-v3", "train"), ("llama3-8b", "decode"),
               ("rwkv6-1.6b", "decode"), ("llama3-8b", "prefill")]


@pytest.fixture
def small_production(monkeypatch):
    """run_cell on the reference test's small meshes, smoke configs and
    shapes."""
    monkeypatch.setattr(dr, "PRODUCTION", {
        False: SMALL_MESHES["(2, 8)"], True: SMALL_MESHES["(2, 2, 4)"]})
    monkeypatch.setattr(dr, "get_config", get_smoke_config)
    monkeypatch.setattr(dr, "SHAPES", SMALL_SHAPES)


@pytest.mark.parametrize("mesh_kind", ["single", "multi"])
@pytest.mark.parametrize("arch,kind", SMALL_CELLS)
def test_run_cell_small_mesh(arch, kind, mesh_kind, small_production,
                             no_group):
    res = dr.run_cell(arch, kind, mesh_kind)
    assert res.ok, res.reason
    assert res.n_chips == 16
    assert res.terms["flops_global"] > 0
    assert res.memory["per_device_hbm_bytes"] > 0
    assert res.cost["flops_raw"] == res.cost["flops"]
    assert res.cost["bytes_raw"] == res.cost["bytes accessed"]
    assert res.terms["dominant"] in ("compute", "memory", "collective")
    json.dumps(dataclasses.asdict(res))


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "rwkv6-1.6b"])
def test_recurrent_train_cells_fail_naming_item_14(arch, small_production,
                                                   no_group, tmp_path,
                                                   capsys):
    """The recurrent configs' train cells, which failed while their
    kernels had no backward (ROADMAP Queue 1 item 14), now trace: each
    counts its recurrence's forward (twice, under remat) and backward
    kernel once a layer, as ``train_launches`` does, through ``run_cell``
    and the command line alike."""
    res = dr.run_cell(arch, "train", "single")
    assert res.ok, res.reason
    assert not dist.is_initialized()
    mixer = "rglru" if arch == "recurrentgemma-9b" else "rwkv6"
    cfg = get_smoke_config(arch)
    want = train_launches(cfg, SMALL_SHAPES["train"].seq_len)
    assert res.kernels[mixer]["calls"] == want[mixer] > 0
    assert res.kernels[f"{mixer}_bwd"]["calls"] == want[f"{mixer}_bwd"] > 0
    assert res.kernels[f"{mixer}_bwd"]["operations"] > 0
    dr.main(["--arch", arch, "--shape", "train", "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert not out.startswith("FAIL"), out
    res = json.loads((tmp_path / f"{arch}_train_single_baseline.json")
                     .read_text())
    assert res["ok"] and not res["skipped"]


def test_production_decode_cell_on_256_fake_ranks(no_group):
    res = dr.run_cell("llama3-8b", "decode_32k", "single")
    assert res.ok and res.n_chips == 256
    cfg = get_config("llama3-8b")
    # 8 of the 128 rows on each rank (batch over data; 'model' left free),
    # the 8 KV heads' cache cut 16 ways along its 32,768 slots: a layer
    # takes this rank's partials over its 2,048 slots for every query head
    # and merges the pieces of all 16 ranks that hold keys: each full row's
    # 128 chunks, one on each rank (of the 2,048 / 256 + 1 = 9 entries a
    # rank keeps a row, the ninth stays empty where the window does not
    # roll)
    from repro_torch.kernels.ref import decode_local_chunks, decode_pieces
    assert decode_local_chunks(32768, 2048) == 9
    full = torch.full((8,), 32768, dtype=torch.int32)
    pieces = decode_pieces(full, None, 32768, 2048, range(0, 32768, 2048))
    assert pieces == 8 * 128
    assert res.kernels["flash_decode"]["calls"] == 2 * cfg.num_layers
    assert res.kernels["flash_decode"]["operations"] == cfg.num_layers * (
        4 * cfg.num_heads * cfg.hd * 8 * 2048
        + cost.flash_decode_merge((8, cfg.num_heads, cfg.hd),
                                  torch.bfloat16, pieces)[0])
    assert res.collectives["n_all-gather"] > 0
    assert res.memory["per_device_hbm_bytes"] > 0
    skipped = dr.run_cell("llama3-8b", "long_500k", "single")
    assert skipped.skipped and not skipped.ok


def test_run_cell_refuses_a_running_group(no_group):
    mesh = dr.fake_mesh((1, 1), ("data", "model"))
    try:
        assert mesh.size == 1
        with pytest.raises(RuntimeError, match="already initialised"):
            dr.run_cell("llama3-8b", "decode_32k", "single")
    finally:
        dist.destroy_process_group()


# -- package surface --------------------------------------------------------

def test_launch_package_exports_the_reference_names():
    import repro_torch.launch as launch

    from .test_torch_harness import _imported_modules

    for name in ("make_production_mesh", "make_test_mesh",
                 "collective_bytes", "roofline", "RooflineTerms",
                 "model_flops_estimate", "PEAK_FLOPS", "HBM_BW", "LINK_BW"):
        assert name in launch.__all__ and hasattr(launch, name)
    init = ROOT / "src" / "repro_torch" / "launch" / "__init__.py"
    assert not any("dryrun" in m for m in _imported_modules(init))
    assert "from .dryrun" not in init.read_text()


def test_port_sources_import_no_torch_testing():
    from .test_torch_harness import CHIP_SMOKE, PORT_DIR, _imported_modules

    for path in sorted(PORT_DIR.rglob("*.py")) + [CHIP_SMOKE]:
        for mod in _imported_modules(path):
            assert not mod.startswith("torch.testing"), (
                f"{path.relative_to(ROOT)} imports {mod}")
