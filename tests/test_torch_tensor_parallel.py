"""Tensor-parallel serving over 'model' (``repro_torch.distributed``:
``MeshSharder`` under ``serving``, ``MeshParams`` handing out each weight
on its 'model' cut; the model's column- and row-parallel products, heads,
experts and caches on the rules' cuts; ``ops.flash_decode_partial`` /
``flash_decode_merge`` over a cache cut along its slots).

- On ``gloo`` ranks (``tests/_torch_ranks.py``, one spawn for each world
  size) at meshes (1, 2), (2, 2) and (1, 4), the smoke configs of all ten
  architectures in float32, and a derived one (6 heads and 6 KV heads of
  16 at m = 4: the rule cuts the projections' 96 columns into 24, half a
  head, the heads stay whole): the prefill's and greedy decode steps'
  tokens equal to the unsharded port's, the logits within
  ``TP_OF_SCALE`` of their scale (the row-parallel products add their
  partials over K in another order) and the gathered
  caches within it too; every local cache leaf the cut
  ``cache_shardings`` gives.
- At (2, 2), against the reference's sharded ``prefill`` /
  ``decode_step`` (``tests/_subproc.py:run_py`` on 4 host devices, on the
  reference's weights) in float32: tokens equal, logits and caches within
  ``REF_OF_SCALE`` of their scale (the port's and XLA's sums in other
  orders, and the reference's decode attention a softmax over the whole
  cache where the port merges chunks).
- At world size 1 (mesh (1, 1)) in bf16: logits, tokens and caches bit for
  bit the unsharded port's.
- At 2 ranks in bf16: prefill(S) + decode_step == prefill(S + 1) bit for
  bit (the MoE configs at capacity factor E / k, where nothing drops, as
  the unsharded port holds it).
- The sequence-cut ``flash_decode`` plain versions: partials and merge bit
  for bit the whole-cache plain version where S and S / m are multiples
  of 256 (bf16, float32, fp8 caches, a rolled cache), within
  ``SPLIT_CHUNK_TOL`` where a chunk spans two ranks (float32) and within
  ``_order_close`` (bf16 and fp8 caches, rolled windows); on the card the
  same cases against the whole-cache kernel and the plain split version.
- ``MeshSharder`` raises on a tensor cut other than the rule says; the
  serving meta trace gathers no weight over 'model' and counts its
  collectives by kind.
"""
import dataclasses
import threading

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_smoke_config
from repro_torch.configs.registry import ARCHS
from repro_torch.distributed import (MeshSharder, NamedSharding,
                                     ShardingRules, cache_shardings)
from repro_torch.kernels import ops
from repro_torch.kernels.ref import ATTN_CHUNK
from repro_torch.models.layers import to_kv
from tests._subproc import run_py
from tests._torch_ranks import spawn

#: the sharded logits' and caches' widest gap to the unsharded port's, as
#: a share of their scale (float32; measured at most 1.3e-6)
TP_OF_SCALE = 5e-6
#: the sharded port's widest gap to the reference's sharded step, as a
#: share of the scale (float32; measured at most 1.4e-6)
REF_OF_SCALE = 5e-6
#: a chunk split between two ranks: its pieces merged in rank order
#: instead of one online softmax (float32)
SPLIT_CHUNK_TOL = dict(rtol=1e-5, atol=1e-6)
#: a split chunk's bf16 output: chip_smoke's attention tolerance, ATTN_RTOL
#: of max|v| plus one bf16 ulp of the output (the order's float32 roundings
#: can move the rounding to bf16 by one ulp)
ATTN_RTOL = 1e-5
BATCH, SEQ, CACHE, STEPS = 2, 16, 32, 2
#: the derived config where the output dims cut and the heads do not
DERIVED = {"num_heads": 6, "num_kv_heads": 6, "head_dim": 16}


def _run(arch, shape, dtype="float32", **kw):
    return dict(arch=arch, shape=shape, dtype=dtype, batch=BATCH, seq=SEQ,
                cache_len=CACHE, steps=STEPS, seed=0, **kw)


def _moe_no_drop(arch):
    cfg = get_smoke_config(arch)
    if not cfg.num_experts:
        return {}
    return {"capacity_factor": cfg.num_experts / cfg.top_k}


_REF_SCRIPT = r"""
import jax, jax.experimental
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64
import dataclasses, json
import numpy as np
import jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs.registry import get_smoke_config
from repro.models.model import Model
from repro.distributed.sharding import (ShardingRules, MeshSharder,
                                        param_shardings)

B, S, C, STEPS = %(b)d, %(s)d, %(c)d, %(steps)d
mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
bank = np.load(%(params)r)
ref_out = {}


def path(kp):
    return [str(getattr(k, "key", getattr(k, "idx", k))) for k in kp]


for arch in %(archs)r:
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32",
                              kv_dtype="float32")
    rules = ShardingRules(cfg, mesh)
    m = Model(cfg, shard=MeshSharder(rules), remat=False)
    params = jax.tree_util.tree_map_with_path(
        lambda kp, x: jnp.asarray(bank[arch + "/" + ".".join(path(kp))]),
        jax.eval_shape(m.init, jax.random.PRNGKey(0)))
    params = jax.device_put(params, param_shardings(rules, params))
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1))
    kw = {}
    if cfg.is_encdec:
        kw["frames"] = jnp.asarray(rng.normal(
            size=(B, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
    if cfg.vision_patches:
        kw["patches"] = jnp.asarray(rng.normal(
            size=(B, cfg.vision_patches, cfg.d_model)).astype(np.float32))
    n_prefix = cfg.vision_patches if "patches" in kw else 0
    with mesh:
        logits, cache = jax.jit(lambda p, t, kw: m.prefill(
            p, t, cache_len=C, **kw))(params, jnp.asarray(toks[:, :S],
                                                          jnp.int32), kw)
        out = [np.asarray(logits)]
        dec = jax.jit(m.decode_step)
        for i in range(STEPS):
            tok = jnp.argmax(logits, -1).astype(jnp.int32)
            logits, cache = dec(params, cache, tok,
                                jnp.int32(S + n_prefix + i))
            out.append(np.asarray(logits))
    ref_out[arch + "|logits"] = np.stack(out)
    for kp, x in jax.tree_util.tree_flatten_with_path(cache)[0]:
        ref_out[arch + "|cache|" + "/".join(path(kp))] = np.asarray(x)
np.savez(%(ref)r, **ref_out)
"""


def _weights(path):
    """The port's float32 smoke weights of every architecture (drawn from
    seed 0) to ``path``, ``arch/name`` keys: what the reference's sharded
    run and the (2, 2) ranks load."""
    from repro_torch.models import Model

    bank = {}
    for arch in ARCHS:
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32",
                                  kv_dtype="float32")
        model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
        bank.update({f"{arch}/{k}": p.numpy()
                     for k, p in model.named_parameters()})
    np.savez(path, **bank)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Every run, by (arch, mesh shape, kind): ``tp`` float32 on (1, 2),
    (2, 2) (on weights the reference's run shares) and (1, 4), bf16 at
    (1, 1); ``plus_one`` bf16 at (1, 2); ``derived`` at (1, 4); and the
    reference's (2, 2) results. Each world size is spawned once, all at
    once beside the reference's subprocess."""
    d = tmp_path_factory.mktemp("tp")
    pfile, rfile = str(d / "params.npz"), str(d / "ref.npz")
    _weights(pfile)
    out, errors = {}, []

    def go(key, fn):
        try:
            out[key] = fn()
        except BaseException as e:   # re-raised in the main thread
            errors.append(e)

    def ref():
        run_py(_REF_SCRIPT % dict(b=BATCH, s=SEQ, c=CACHE, steps=STEPS,
                                  archs=tuple(ARCHS), params=pfile,
                                  ref=rfile), devices=4, timeout=600)
        return dict(np.load(rfile))

    def world(n, runs):
        return lambda: spawn("serve", n, timeout=600, runs=runs,
                             weights=pfile)

    two = [_run(a, (1, 2)) for a in ARCHS] + [
        _run(a, (1, 2), "bfloat16", plus_one=True, overrides=_moe_no_drop(a))
        for a in ARCHS]
    one = [_run(a, (1, 1), "bfloat16") for a in ARCHS]
    four = [_run(a, (2, 2), ref=True) for a in ARCHS] + [
        _run(a, (1, 4)) for a in ARCHS] + [
        _run("qwen1.5-32b", (1, 4), overrides=DERIVED)]
    threads = [threading.Thread(target=go, args=k) for k in (
        ("ref", ref), (1, world(1, one)), (2, world(2, two)),
        (4, world(4, four)))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    runs = {}
    for n in (1, 2, 4):
        for run, got, want in out[n]:
            kind = ("plus_one" if run.get("plus_one") else "derived"
                    if run.get("overrides") == DERIVED else "tp")
            runs[run["arch"], tuple(run["shape"]), kind] = (run, got, want)
    return runs, out["ref"]


def _of_scale(a, b) -> float:
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).abs().max() / max(float(b.abs().max()), 1e-30))


def _local_cuts(run, got):
    """Each cache leaf's local shape against ``cache_shardings``' cut of
    the whole leaf (rows as the rank holds them)."""
    from repro_torch.models import Model

    cfg = dataclasses.replace(get_smoke_config(run["arch"]),
                              **run.get("overrides", {}))

    class Stub:
        axis_names = ("data", "model")

        def __init__(self, shape):
            self.shape = dict(zip(self.axis_names, shape))

    rules = ShardingRules(cfg, Stub(run["shape"]))
    whole = Model(cfg, device="meta").init_cache(run["batch"],
                                                 run["cache_len"])
    shs = cache_shardings(rules, whole)
    from tests._torch_ranks import _tree_leaves
    for (path, leaf), (_, sh) in zip(_tree_leaves(whole), _tree_leaves(shs)):
        key = "/".join(path)
        assert got["local_cache"][key] == sh.local_shape(leaf.shape), key


@pytest.mark.parametrize("mesh", [(1, 2), (2, 2), (1, 4)])
@pytest.mark.parametrize("arch", ARCHS)
def test_tensor_parallel_serving_matches_unsharded(served, arch, mesh):
    run, got, want = served[0][arch, mesh, "tp"]
    assert torch.equal(got["tokens"], want["tokens"])
    assert _of_scale(got["logits"], want["logits"]) <= TP_OF_SCALE
    assert sorted(got["cache"]) == sorted(want["cache"])
    for k, t in want["cache"].items():
        assert _of_scale(got["cache"][k], t) <= TP_OF_SCALE, k
    _local_cuts(run, got)


def test_output_dims_cut_where_the_heads_are_not(served):
    """6 heads of 16 at m = 4: the projections come out in 24-column cuts
    (gathered to every head), the cache cut along its 32 slots."""
    run, got, want = served[0]["qwen1.5-32b", (1, 4), "derived"]
    assert got["local_cache"]["scan/slot0/k"] == (2, BATCH, 6, CACHE // 4,
                                                  16)
    assert torch.equal(got["tokens"], want["tokens"])
    assert _of_scale(got["logits"], want["logits"]) <= TP_OF_SCALE
    for k, t in want["cache"].items():
        assert _of_scale(got["cache"][k], t) <= TP_OF_SCALE, k


@pytest.mark.parametrize("arch", ARCHS)
def test_matches_the_references_sharded_serving(served, arch):
    (run, got, _), ref = served[0][arch, (2, 2), "tp"], served[1]
    want = torch.from_numpy(ref[arch + "|logits"])
    assert torch.equal(got["tokens"], want.argmax(-1))
    assert _of_scale(got["logits"], want) <= REF_OF_SCALE
    for k, t in got["cache"].items():
        assert _of_scale(t, torch.from_numpy(ref[f"{arch}|cache|{k}"])) \
            <= REF_OF_SCALE, k


@pytest.mark.parametrize("arch", ARCHS)
def test_world_size_one_is_the_unsharded_port_bit_for_bit(served, arch):
    _, got, want = served[0][arch, (1, 1), "tp"]
    assert torch.equal(got["logits"], want["logits"])
    assert torch.equal(got["tokens"], want["tokens"])
    for k, t in want["cache"].items():
        assert torch.equal(got["cache"][k].view(torch.uint8),
                           t.view(torch.uint8)), k


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_prefill_and_decode_agree_bit_for_bit_at_two_ranks(served,
                                                                 arch):
    _, got, want = served[0][arch, (1, 2), "plus_one"]
    assert torch.equal(got["decode"], got["prefill"])
    assert torch.equal(want["decode"], want["prefill"])


# -- the sequence-cut flash_decode's plain versions -------------------------

def _draw(B, Hq, Hkv, S, D, q_dtype, kv_dtype, seed):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(B, Hq, D, generator=g).to(q_dtype)
    k, v = (to_kv(torch.randn(B, Hkv, S, D, generator=g).to(q_dtype),
                  kv_dtype) for _ in range(2))
    return q, k, v


def _split_decode(B, Hq, Hkv, S, D, m, q_dtype, kv_dtype, length, end,
                  seed):
    q, k, v = _draw(B, Hq, Hkv, S, D, q_dtype, kv_dtype, seed)
    length = torch.tensor(length, dtype=torch.int32)
    end = None if end is None else torch.tensor(end, dtype=torch.int32)
    L = S // m
    parts = torch.stack([
        ops.flash_decode_partial(q, k[:, :, r * L:(r + 1) * L],
                                 v[:, :, r * L:(r + 1) * L], length, end,
                                 r * L, S) for r in range(m)])
    return (ops.flash_decode_merge(parts, q, length, end, S, L, Hkv),
            ops.flash_decode(q, k, v, length, end))


#: (B, Hq, Hkv, S, D, m, q dtype, cache dtype, length, end): S / m a
#: multiple of 256
ALIGNED = {
    "bf16": (2, 8, 2, 512, 16, 2, torch.bfloat16, torch.bfloat16,
             [500, 257], None),
    "float32": (2, 8, 2, 512, 16, 2, torch.float32, torch.float32,
                [300, 512], None),
    "fp8": (2, 8, 8, 512, 16, 2, torch.bfloat16, torch.float8_e4m3fn,
            [512, 300], None),
    "rolled": (2, 4, 1, 512, 32, 2, torch.bfloat16, torch.bfloat16,
               [512, 512], [700, 600]),
}


@pytest.mark.parametrize("case", sorted(ALIGNED))
def test_sequence_cut_decode_plain_is_the_whole_cache_bit_for_bit(case):
    got, want = _split_decode(*ALIGNED[case], seed=1)
    assert torch.equal(got, want)


def test_sequence_cut_decode_plain_split_chunks_within_tolerance():
    """recurrentgemma-9b's rolled window at m = 16 in small: 128 slots a
    rank, each 256-position chunk split between two ranks."""
    got, want = _split_decode(3, 4, 1, 512, 16, 4, torch.float32,
                              torch.float32, [512, 512, 300],
                              [700, 513, 300], seed=2)
    assert 512 // 4 % ATTN_CHUNK
    torch.testing.assert_close(got, want, **SPLIT_CHUNK_TOL)


#: (B, Hq, Hkv, S, D, m, q dtype, cache dtype, length, end): S / m not a
#: multiple of 256 and the window rolled, so two runs split each chunk
#: (recurrentgemma-9b's 2,048-slot window at m = 16 in small: 1 KV head)
UNALIGNED = {
    "bf16": (3, 16, 1, 512, 32, 4, torch.bfloat16, torch.bfloat16,
             [512, 512, 300], [700, 513, 300]),
    "fp8": (2, 8, 2, 768, 16, 6, torch.bfloat16, torch.float8_e4m3fn,
            [768, 500], [1000, 777]),
}


def _order_close(got, want, v):
    """|got - want| <= ATTN_RTOL max|v| plus one bf16 ulp of the output."""
    err = (got.float() - want.float()).abs()
    bound = ATTN_RTOL * float(v.float().abs().max()) + torch.zeros_like(err)
    _, e = torch.frexp(torch.maximum(got.float().abs(), want.float().abs()))
    bound = bound + torch.ldexp(torch.ones_like(bound), e - 8)
    return got.dtype == want.dtype and bool((err <= bound).all())


@pytest.mark.parametrize("case", sorted(UNALIGNED))
def test_sequence_cut_decode_plain_unaligned_within_order_tolerance(case):
    B, Hq, Hkv, S, D, m, q_dtype, kv_dtype = UNALIGNED[case][:8]
    assert S // m % ATTN_CHUNK
    got, want = _split_decode(*UNALIGNED[case], seed=5)
    _, _, v = _draw(B, Hq, Hkv, S, D, q_dtype, kv_dtype, seed=5)
    assert _order_close(got, want, v)


# -- the sharder and the trace ----------------------------------------------

class _Mesh:
    axis_names = ("data", "model")
    shape = {"data": 1, "model": 4}
    coords = {"data": 0, "model": 1}


def test_mesh_sharder_raises_on_a_wrongly_cut_tensor():
    cfg = get_smoke_config("llama3-8b")   # 2 KV heads: the cache's slots
    sharder = MeshSharder(ShardingRules(cfg, _Mesh()))
    sharder.tp = True
    full = (2, 2, 32, 8)
    right = torch.zeros(2, 2, 8, 8)
    assert sharder(right, "kv_cache", full) is right
    for wrong in ((2, 2, 32, 8), (2, 1, 32, 8), (2, 2, 16, 8)):
        with pytest.raises(ValueError, match="kv_cache"):
            sharder(torch.zeros(wrong), "kv_cache", full)
    with pytest.raises(ValueError, match="activations"):
        sharder(torch.zeros(2, 16, 64), "activations", (2, 16, 64))
    assert sharder.local("attn_heads", (2, 8, 16, 8)) == (2, 2, 16, 8)
    assert sharder.local("attn_kv", (2, 2, 16, 8)) == (2, 2, 16, 8)


@pytest.fixture
def no_group():
    assert not dist.is_initialized()
    yield
    assert not dist.is_initialized()


@pytest.mark.parametrize("arch,kind", [("llama3-8b", "prefill"),
                                       ("qwen1.5-32b", "decode"),
                                       ("olmoe-1b-7b", "decode")])
def test_serving_trace_gathers_no_model_cut_weight(monkeypatch, no_group,
                                                   arch, kind):
    """The meta trace of a smoke config's serving step on (2, 4): no
    NamedSharding gather names 'model' (the weights stay on their cuts),
    and the step's collectives are counted by kind: all-gathers (the
    activations' columns, the row-parallel partials, the logits) and, in
    a prefill whose sequence the residual cuts, all-to-alls (the
    reduce-scatters)."""
    from repro_torch.configs.registry import ShapeSpec
    from repro_torch.launch import dryrun as dr

    gathered = []
    real = NamedSharding.gather

    def keep(self, local, out=None):
        gathered.append(tuple(self.spec))
        return real(self, local, out)

    monkeypatch.setattr(NamedSharding, "gather", keep)
    mesh = dr.fake_mesh((2, 4), ("data", "model"))
    try:
        counter, _ = dr.trace_step(get_smoke_config(arch),
                                   ShapeSpec(kind, 64, 4, kind), mesh)
    finally:
        dist.destroy_process_group()
    assert not [s for s in gathered
                if any("model" in (e if isinstance(e, tuple) else (e,))
                       for e in s)]
    coll = counter.collectives()
    assert coll["n_all-gather"] > 0
    if kind == "prefill":
        assert coll["n_all-to-all"] > 0


class _Production:
    axis_names = ("data", "model")
    shape = {"data": 16, "model": 16}


@pytest.mark.parametrize("arch", ARCHS)
def test_every_model_cut_of_the_full_configs_is_16_byte_aligned(arch):
    """At the production mesh's 16-way 'model' axis every weight the rules
    cut over it, held as a contiguous clone, has rows of a multiple of 16
    bytes (TMA's row stride), and so has a row-parallel product's input
    cut (the rows of x's own columns); a dim the rules cannot cut
    (whisper-large-v3's 51,866-wide head) stays whole."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import param_shardings
    from repro_torch.models import Model

    cfg = get_config(arch)
    params = dict(Model(cfg, device="meta").named_parameters())
    shs = param_shardings(ShardingRules(cfg, _Production()), params)
    cut = 0
    for name, p in params.items():
        ent = shs[name].entries(p.dim())
        dims = [i for i, e in enumerate(ent) if "model" in e]
        if not dims:
            continue
        cut += 1
        local = shs[name].local_shape(p.shape)
        assert local[-1] * p.element_size() % 16 == 0, name
        weight = name.split(".")[-1].startswith("w")
        if weight and dims[0] == p.dim() - 2:          # row-parallel
            assert local[-2] * p.element_size() % 16 == 0, name
    assert cut
    if arch == "whisper-large-v3":
        head = params["lm_head"]
        assert head.shape[-1] % 16 and shs["lm_head"].entries(2) == [(), ()]


def test_world_size_one_decode_trace_counts_a_real_cpu_step(no_group):
    """chip_smoke phase 11's check on the CPU: qwen1.5-32b's smoke
    config's tensor-parallel decode step over a (1, 1) ``gloo`` mesh,
    counted (the plain versions reported as the kernels' calls), equals its
    meta trace over a fake (1, 1) mesh in every count."""
    from repro_torch.configs.registry import ShapeSpec
    from repro_torch.distributed import MeshParams
    from repro_torch.launch import dryrun as dr
    from repro_torch.launch.counting import StepCounter
    from repro_torch.launch.mesh import Mesh, init_distributed
    from repro_torch.models import Model

    cfg = get_smoke_config("qwen1.5-32b")
    b, s = 4, 32
    traced, mem = None, None
    mesh = dr.fake_mesh((1, 1), ("data", "model"))
    try:
        traced, mem = dr.trace_step(cfg, ShapeSpec("decode", s, b, "decode"),
                                    mesh)
    finally:
        dist.destroy_process_group()
    init_distributed("cpu")
    try:
        rules = ShardingRules(cfg, Mesh((1, 1), ("data", "model")))
        model = Model(cfg, device="cpu", shard=MeshSharder(rules))
        MeshParams(model, rules).init(torch.Generator().manual_seed(0))
        model.shard.global_batch = b
        dr.warm_norms(model)
        cache = model.init_cache(b, s)
        token = torch.zeros((b,), dtype=torch.int32)
        params = dict(model.named_parameters())
        with StepCounter("cpu", (params, cache, token)) as counter:
            out = model.decode_step(cache, token, s - 1)
        real = counter.memory((params, out[1], token), out)
    finally:
        dist.destroy_process_group()
    assert traced.summary() == counter.summary()
    assert mem["argument_size_in_bytes"] == real["argument_size_in_bytes"]


# -- on the card (skipped without one; chip_smoke.py phase 10 runs them at
# -- the production shapes) -------------------------------------------------

def _on_card(case):
    B, Hq, Hkv, S, D, m, q_dtype, kv_dtype, length, end = case
    g = torch.Generator(device="cuda").manual_seed(3)
    q = torch.randn(B, Hq, D, generator=g, device="cuda").to(q_dtype)
    k, v = (to_kv(torch.randn(B, Hkv, S, D, generator=g, device="cuda")
                  .to(q_dtype), kv_dtype) for _ in range(2))
    length = torch.tensor(length, dtype=torch.int32, device="cuda")
    end = (None if end is None
           else torch.tensor(end, dtype=torch.int32, device="cuda"))
    L = S // m
    before = ops.flash_decode.launches
    parts = torch.stack([
        ops.flash_decode_partial(q, k[:, :, r * L:(r + 1) * L],
                                 v[:, :, r * L:(r + 1) * L], length, end,
                                 r * L, S) for r in range(m)])
    got = ops.flash_decode_merge(parts, q, length, end, S, L, Hkv)
    torch.cuda.synchronize()
    assert ops.flash_decode.launches == before + m + 1
    return got, ops.flash_decode(q, k, v, length, end)


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(ALIGNED))
def test_cuda_sequence_cut_decode_is_the_whole_cache_kernel(case):
    """bf16 q: bit for bit the whole-cache kernel; float32 q (whose kernel
    keeps one partial a run): within SPLIT_CHUNK_TOL."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (chip_smoke.py runs it)")
    got, want = _on_card(ALIGNED[case])
    if got.dtype == torch.bfloat16:
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    else:
        torch.testing.assert_close(got, want, **SPLIT_CHUNK_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(UNALIGNED))
def test_cuda_sequence_cut_decode_unaligned_rolled(case):
    """Chunks that two runs split (recurrentgemma-9b's case): within
    _order_close of the whole-cache kernel and of the plain split
    version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (chip_smoke.py runs it)")
    from repro_torch.kernels.ref import (flash_decode_merge_plain,
                                         flash_decode_partial_plain)

    B, Hq, Hkv, S, D, m, q_dtype, kv_dtype, length, end = UNALIGNED[case]
    g = torch.Generator(device="cuda").manual_seed(6)
    q = torch.randn(B, Hq, D, generator=g, device="cuda").to(q_dtype)
    k, v = (to_kv(torch.randn(B, Hkv, S, D, generator=g, device="cuda")
                  .to(q_dtype), kv_dtype) for _ in range(2))
    length = torch.tensor(length, dtype=torch.int32, device="cuda")
    end = torch.tensor(end, dtype=torch.int32, device="cuda")
    L = S // m
    before = ops.flash_decode.launches
    parts = torch.stack([
        ops.flash_decode_partial(q, k[:, :, r * L:(r + 1) * L],
                                 v[:, :, r * L:(r + 1) * L], length, end,
                                 r * L, S) for r in range(m)])
    got = ops.flash_decode_merge(parts, q, length, end, S, L, Hkv)
    torch.cuda.synchronize()
    assert ops.flash_decode.launches == before + m + 1
    plain = flash_decode_merge_plain(torch.stack([
        flash_decode_partial_plain(q, k[:, :, r * L:(r + 1) * L],
                                   v[:, :, r * L:(r + 1) * L], length, end,
                                   r * L, S) for r in range(m)]),
        q, length, end, S, L, Hkv)
    assert _order_close(got, ops.flash_decode(q, k, v, length, end), v)
    assert _order_close(got, plain, v)


@pytest.mark.gpu
def test_cuda_matmul_float32_partials_round_to_the_bf16_kernel():
    """A row-parallel product's float32 partials, rounded once, are the
    bf16 kernel's output bit for bit (one rank's sum is its partial)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (chip_smoke.py runs it)")
    g = torch.Generator(device="cuda").manual_seed(4)
    for m, k, n in ((8, 1712, 5120), (656, 320, 5120), (3, 72, 40)):
        x = torch.randn(m, k, generator=g, device="cuda").bfloat16()
        w = torch.randn(k, n, generator=g, device="cuda").bfloat16()
        part = ops.matmul(x, w, out_dtype=torch.float32)
        assert part.dtype == torch.float32
        assert torch.equal(part.to(torch.bfloat16), ops.matmul(x, w))
