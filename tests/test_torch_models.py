"""The port's model stack (``repro_torch.models``, ``repro_torch.configs``)
against the reference's (``repro.models``, ``repro.configs``).

The same seeded numpy inputs and the same weights (the reference's
parameter tree carried across by ``convert.model_params_from_fields``) go
through both. Tolerances:

- float32 configs (``dtype`` and ``kv_dtype`` float32): ``F32``, a
  relative and absolute 1e-5. Both sides compute the same float32
  expressions; XLA and torch differ in reduction order (norms, attention,
  matmuls) and by an ulp in ``exp``/``pow``/``tanh``, which stays near
  1e-6 of the logits (measured up to 4e-6 absolute on logits of size 3).
- bfloat16 configs: the reference suite's own tolerances
  (``tests/test_models.py``: rtol 2e-2, atol 2e-3; 3e-2 / 3e-3 for the
  rolling window). The port rounds to bf16 where XLA does (the
  activations are written as XLA expands them), so the smoke models'
  logits have come out equal; the tolerance allows for other XLA builds.

The smoke configs run: rwkv6 (2 layers, d 64, head 16), recurrentgemma
(5 layers, d 64, window 16: one super-block of rglru, rglru, attn and two
remainder rglru layers), and the dense llama3 (2 layers, d 64, 8 heads
over 2 KV heads, rmsnorm, SwiGLU), stablelm (layernorm, SwiGLU),
starcoder2 (layernorm, qkv bias, plain GELU FFN) and qwen (4 heads over 4
KV heads, qkv bias, rmsnorm, SwiGLU; here with a cache in its working
dtype; its fp8 cache is ``tests/test_torch_fp8_cache.py``'s), and the MoE
olmoe (8 experts, top-4) and arctic (8 experts, top-2, a dense residual
FFN, 8 heads over 2 KV heads), both at their shipped capacity factor 1.25
(pairs dropped) through the reference's default ``einsum`` dispatch; the
MoE layers alone are ``tests/test_torch_moe.py``'s.

The port's model runs its attention through the ``flash_attention`` /
``flash_decode`` kernels (their plain versions here: scores scaled after
the dot, p unrounded), where the reference's docstring puts its Pallas
kernels on the TPU (``src/repro/models/layers.py:155``). So the whole
model is held against the reference's model as it ships in float32, and
in bf16 with those kernels' function in place of ``chunked_attention`` /
``decode_attention`` (:func:`tpu_attention`: the reference's own oracles,
patched in for the call only). There the two agree bit for bit in bf16 at
every smoke config. Against the reference's ``chunked_attention``, which rounds
``q * scale`` and ``p`` to bf16, the bf16 logits part by one bf16 ulp of
a hidden value here and there: 16-20% of the dense smoke models' logits
fall outside the suite's tolerance, and recurrentgemma's too once its
attention is the kernel's. ``chunked_attention`` and ``decode_attention``
themselves are still held against the reference's below.
"""
import contextlib
import sys
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import (ARCHS, SHAPES, cell_applicable, get_config,
                                 get_smoke_config)
from repro_torch.configs.registry import NOT_PORTED
from repro_torch.core.convert import model_params_from_fields, \
    tensor_from_array
from repro_torch.models import Model, layers as TL, recurrent as TR
from tests.test_torch_harness import reference

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-3)
ROLLING_BF16 = dict(rtol=3e-2, atol=3e-3)
#: the bf16 port's widest logit gap to the shipped reference model, as a
#: share of the logits' scale (its attention rounds where the port's
#: kernels do not; see test_bf16_gap_to_the_shipped_reference_...)
GAP_OF_SCALE = 0.025
DTYPES = ("float32", "bfloat16")
#: every architecture the port serves
SERVED = ("rwkv6-1.6b", "recurrentgemma-9b", "llama3-8b", "stablelm-12b",
          "starcoder2-15b", "qwen1.5-32b", "olmoe-1b-7b", "arctic-480b")
#: the MoE ones among them
MOE = ("olmoe-1b-7b", "arctic-480b")
#: the encoder-decoder: its prefill takes frames, so the whole-model and
#: engine cases are ``tests/test_torch_encdec.py``'s; the vision-language
#: one: its patch prefix is ``tests/test_torch_vlm.py``'s
PORTED = SERVED + ("whisper-large-v3", "internvl2-76b")
#: the architectures whose mixers' kernels have no backward
RECURRENT = ("rwkv6-1.6b", "recurrentgemma-9b")


def tol(dtype):
    return F32 if dtype == "float32" else BF16


@pytest.fixture(scope="module")
def ref():
    return reference()


def smoke(arch, dtype):
    return dataclasses.replace(get_smoke_config(arch), dtype=dtype,
                               kv_dtype=dtype)


@pytest.fixture(scope="module")
def pair(ref):
    """(cfg, reference Model, reference params, port Model) per (arch,
    dtype), built once for the module."""
    built = {}

    def get(arch, dtype):
        if (arch, dtype) not in built:
            jax = ref.jax
            cfg = dataclasses.replace(ref.configs.get_smoke_config(arch),
                                      dtype=dtype, kv_dtype=dtype)
            jm = ref.models.Model(cfg, remat=False)
            params = jm.init(jax.random.PRNGKey(0))
            fields = jax.tree_util.tree_map(np.asarray, params)
            port = model_params_from_fields(smoke(arch, dtype), fields,
                                            device="cpu")
            built[arch, dtype] = (cfg, jm, params, port)
        return built[arch, dtype]

    return get


@contextlib.contextmanager
def tpu_attention(ref):
    """The reference's model with its Pallas attention kernels' function
    (``ref.kops.flash_attention`` / ``flash_decode`` on their oracle path)
    in place of ``chunked_attention`` / ``decode_attention`` (the layers'
    and the encoder-decoder's cross-attention's), restored on exit."""
    import jax.numpy as jnp

    layers_mod, model_mod = ref.layers, sys.modules["repro.models.model"]
    saved = (layers_mod.chunked_attention, model_mod.chunked_attention,
             model_mod.decode_attention)

    def prefill_attn(q, k, v, causal=True, window=None):
        return ref.kops.flash_attention(q, k, v, causal=causal,
                                        window=window)

    def decode_attn(q, k_cache, v_cache, pos, window=None):
        assert window is None  # the model passes no window here
        return ref.kops.flash_decode(
            q, k_cache, v_cache, jnp.full((q.shape[0],), pos + 1, jnp.int32))

    layers_mod.chunked_attention = prefill_attn
    model_mod.chunked_attention = prefill_attn  # the decoder's cross-attention
    model_mod.decode_attention = decode_attn
    try:
        yield
    finally:
        (layers_mod.chunked_attention, model_mod.chunked_attention,
         model_mod.decode_attention) = saved


def flat(tree, prefix=""):
    """{dotted path: numpy float32 array} of a nested dict/list tree of jax
    arrays or torch tensors."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}."))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flat(v, f"{prefix}{i}."))
    elif isinstance(tree, torch.Tensor):
        out[prefix[:-1]] = tree.float().numpy()
    else:
        out[prefix[:-1]] = np.asarray(tree.astype("float32"))
    return out


def assert_trees_close(port, want, where, **kw):
    a, b = flat(port), flat(want)
    assert sorted(a) == sorted(b), where
    for k in a:
        assert a[k].shape == b[k].shape, f"{where} {k}"
        np.testing.assert_allclose(a[k], b[k], err_msg=f"{where} {k}", **kw)


def to_jax(ref, x, dtype):
    import jax.numpy as jnp

    return jnp.asarray(x, jnp.float32).astype(dtype)


def as_port(x):
    return tensor_from_array(np.asarray(x))


# -- configs ------------------------------------------------------------------

@pytest.mark.parametrize("arch", PORTED)
def test_configs_and_param_counts_match_reference(ref, arch):
    for port_cfg, ref_cfg in ((get_config(arch), ref.configs.get_config(arch)),
                              (get_smoke_config(arch),
                               ref.configs.get_smoke_config(arch))):
        assert dataclasses.asdict(port_cfg) == dataclasses.asdict(ref_cfg)
        assert port_cfg.param_count() == ref_cfg.param_count()
        assert port_cfg.active_param_count() == ref_cfg.active_param_count()
        assert port_cfg.sub_quadratic == ref_cfg.sub_quadratic
        assert port_cfg.attn_layers == ref_cfg.attn_layers
        for name, shape in SHAPES.items():
            assert cell_applicable(port_cfg, shape) == \
                ref.configs.registry.cell_applicable(
                    ref_cfg, ref.configs.SHAPES[name])


def test_registry_lists_ported_archs_and_names_the_rest(ref):
    """Every reference architecture is ported: ``NOT_PORTED`` is empty."""
    assert set(ARCHS) == set(PORTED) == set(ref.configs.ARCHS)
    assert NOT_PORTED == {}
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in ref.configs.SHAPES.items()}
    with pytest.raises(KeyError):
        get_config("no-such-arch")


@pytest.mark.parametrize("arch", RECURRENT)
def test_model_refuses_unported_parts(ref, arch):
    """Nothing of a recurrent config is refused any more (training once
    was: its mixers' kernels had no backward). ``loss_fn`` trains it,
    its recurrences through their autograd Functions, and serving it
    runs."""
    m = Model(get_smoke_config(arch), device="cpu").init(
        torch.Generator().manual_seed(0))
    m.requires_grad_(True)
    batch = {"tokens": _tokens(m.cfg, 2, 8, 0)}
    loss, _ = m.loss_fn(batch)
    loss.backward()
    assert torch.isfinite(loss)
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in m.parameters())
    m.zero_grad(set_to_none=True)
    logits, _ = m.prefill(batch["tokens"], cache_len=8)
    assert torch.isfinite(logits).all()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", MOE)
def test_moe_configs_build_and_scatter_dispatch_matches_reference(
        ref, arch, dtype):
    """Both MoE configs build a port ``Model`` (full configs on the meta
    device), and ``moe_dispatch="scatter"`` gives the reference's
    ``Model(moe_dispatch="scatter")`` logits after prefill and two decode
    steps (bf16 with the kernels' attention, as above)."""
    import jax
    import jax.numpy as jnp

    # the full config's names, shapes and dtypes, against the reference's
    # parameter tree traced without allocating it
    full = Model(get_config(arch), device="meta")
    want = jax.eval_shape(ref.models.Model(ref.configs.get_config(arch)).init,
                          jax.random.PRNGKey(0))
    want = {jax.tree_util.keystr(path, simple=True, separator="."):
            (tuple(leaf.shape), str(leaf.dtype)) for path, leaf in
            jax.tree_util.tree_flatten_with_path(want)[0]}
    got = {n: (tuple(p.shape), str(p.dtype).replace("torch.", ""))
           for n, p in full.named_parameters()}
    assert got == want
    cfg = dataclasses.replace(ref.configs.get_smoke_config(arch),
                              dtype=dtype, kv_dtype=dtype)
    jm = ref.models.Model(cfg, remat=False, moe_dispatch="scatter")
    params = jm.init(jax.random.PRNGKey(4))
    port = model_params_from_fields(smoke(arch, dtype),
                                    jax.tree_util.tree_map(np.asarray,
                                                           params),
                                    device="cpu")
    port.moe_dispatch = "scatter"
    toks = _tokens(cfg, 2, 26, 12)
    with (tpu_attention(ref) if dtype == "bfloat16"
          else contextlib.nullcontext()):
        lj, cj = jm.prefill(params, jnp.asarray(toks[:, :24]), cache_len=32)
        lt, ct = port.prefill(torch.from_numpy(toks[:, :24]), cache_len=32)
        for p in ("prefill", 24, 25):
            if p != "prefill":
                lj, cj = jm.decode_step(params, cj, jnp.asarray(toks[:, p]),
                                        jnp.int32(p))
                lt, ct = port.decode_step(ct, torch.from_numpy(toks[:, p]),
                                          p)
            np.testing.assert_allclose(lt.float().numpy(),
                                       np.asarray(lj.astype(jnp.float32)),
                                       err_msg=f"{arch} {p}", **tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", PORTED)
def test_parameter_names_shapes_and_init_match_reference(pair, arch, dtype):
    cfg, _, params, port = pair(arch, dtype)
    want = flat(params)
    got = {n: p for n, p in port.named_parameters()}
    assert sorted(got) == sorted(want)
    for n, p in got.items():
        assert tuple(p.shape) == want[n].shape, n
    drawn = Model(smoke(arch, dtype), device="cpu").init(
        torch.Generator().manual_seed(0))
    for n, p in drawn.named_parameters():
        w = want[n]
        assert p.dtype == got[n].dtype, n
        if np.all(w == w.flat[0]):  # constants (norms, decay, mixes)
            assert torch.all(p.float() == float(w.flat[0])), n
        else:  # normal draws times the same scale
            np.testing.assert_allclose(float(p.float().std()),
                                       float(w.std()), rtol=0.35, err_msg=n)


def test_converter_rejects_mismatched_trees(pair):
    cfg, _, params, _ = pair("rwkv6-1.6b", "float32")
    import jax

    fields = jax.tree_util.tree_map(np.asarray, params)
    extra = dict(fields, bogus=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="unexpected"):
        model_params_from_fields(smoke("rwkv6-1.6b", "float32"), extra,
                                 device="cpu")
    wrong = dict(fields, embed=fields["embed"].astype(np.float64))
    with pytest.raises(ValueError, match="embed"):
        model_params_from_fields(smoke("rwkv6-1.6b", "float32"), wrong,
                                 device="cpu")


@pytest.mark.parametrize("arch", MOE)
def test_converter_carries_the_float32_router_of_a_bf16_model(pair, arch):
    """The MoE router stays float32 in a bf16 tree and carries across as
    float32, bit for bit; a router in bf16, or under another name, is
    refused."""
    import jax

    cfg, _, params, port = pair(arch, "bfloat16")
    fields = jax.tree_util.tree_map(np.asarray, params)
    router = fields["scan_layers"]["slot0"]["moe"]["router"]
    got = port.scan_layers["slot0"].moe.router
    assert router.dtype == np.float32 and got.dtype == torch.float32
    assert port.scan_layers["slot0"].moe.w_up.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.numpy(), router)

    def edited(**moe):
        slot = dict(fields["scan_layers"]["slot0"],
                    moe=dict(fields["scan_layers"]["slot0"]["moe"], **moe))
        return dict(fields, scan_layers=dict(fields["scan_layers"],
                                             slot0=slot))

    with pytest.raises(ValueError, match="router"):
        model_params_from_fields(smoke(arch, "bfloat16"), edited(
            router=router.astype(fields["embed"].dtype)), device="cpu")
    renamed = edited(gate=router)
    del renamed["scan_layers"]["slot0"]["moe"]["router"]
    with pytest.raises(ValueError, match="unexpected"):
        model_params_from_fields(smoke(arch, "bfloat16"), renamed,
                                 device="cpu")


# -- layers -------------------------------------------------------------------

#: RoPE head dims: stablelm-12b's 160 (a half width of 80, not a power of
#: two) and recurrentgemma-9b's 256
ROPE_DIMS = (160, 256)


def _rope_inputs(d, device="cpu"):
    rng = np.random.default_rng(d)
    x = torch.from_numpy(rng.normal(size=(2, 9, 3, d)).astype(np.float32))
    pos = torch.from_numpy(rng.integers(0, 512, (2, 9)))
    return x.to(device), pos.to(device)


@pytest.mark.parametrize("d", ROPE_DIMS + (16, 128))
def test_rope_frequencies_unchanged_on_the_cpu(d):
    """The exponents' divisor became a 0-dim tensor (ROADMAP Queue 3 item
    25): on the CPU the exponents, the frequencies and ``rope`` are bit for
    bit those of the division by the Python ``half`` (the reference's
    ``rope`` is held to it in ``test_norms_rope_and_ffn_match_reference``)."""
    half = d // 2
    old = -torch.arange(0, half, dtype=torch.float32) / half
    assert torch.equal(TL.rope_exponents(half, "cpu"), old)
    x, pos = _rope_inputs(d)
    ang = pos[..., None].float() * torch.pow(10000.0, old)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    want = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    assert torch.equal(TL.rope(x, pos, 10000.0), want)


@pytest.mark.gpu
@pytest.mark.parametrize("d", ROPE_DIMS)
def test_cuda_rope_equals_the_cpus(d):
    """On the card the exponents equal the CPU's bit for bit (the division
    by a Python ``half`` of 80 multiplies by its rounded reciprocal there),
    and so does ``rope`` within the float32 rounding of the card's own
    ``pow``, ``cos`` and ``sin``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (chip_smoke.py runs the port there)")
    half = d // 2
    assert torch.equal(TL.rope_exponents(half, "cuda").cpu(),
                       TL.rope_exponents(half, "cpu"))
    x, pos = _rope_inputs(d)
    got = TL.rope(x.cuda(), pos.cuda(), 10000.0).cpu()
    np.testing.assert_allclose(got.numpy(), TL.rope(x, pos, 10000.0).numpy(),
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("dtype", DTYPES)
def test_norms_rope_and_ffn_match_reference(ref, dtype):
    import jax.numpy as jnp

    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, 64)).astype(np.float32) * 3.0
    xj = to_jax(ref, x, getattr(jnp, dtype))
    xt = as_port(xj)
    scale = rng.normal(size=64).astype(np.float32) * 0.1
    bias = rng.normal(size=64).astype(np.float32) * 0.1
    L = ref.layers
    cases = [
        ("rmsnorm", L.rmsnorm(xj, jnp.asarray(scale)),
         TL.rmsnorm(xt, torch.from_numpy(scale))),
        ("layernorm", L.layernorm(xj, jnp.asarray(scale), jnp.asarray(bias)),
         TL.layernorm(xt, torch.from_numpy(scale), torch.from_numpy(bias)))]
    q = rng.normal(size=(2, 7, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 5000, (2, 7))
    qj = to_jax(ref, q, getattr(jnp, dtype))
    cases.append(("rope", L.rope(qj, jnp.asarray(pos), 10000.0),
                  TL.rope(as_port(qj), torch.from_numpy(pos), 10000.0)))
    for arch in ("rwkv6-1.6b", "recurrentgemma-9b"):  # gelu, plain and GLU
        cfg = smoke(arch, dtype)
        w = {k: to_jax(ref, rng.normal(size=s) * 0.2, getattr(jnp, dtype))
             for k, s in (("w_up", (64, 128)), ("w_gate", (64, 128)),
                          ("w_down", (128, 64)))}
        if not cfg.glu:
            del w["w_gate"]
        cases.append((f"ffn {arch}", L.ffn_apply(cfg, w, xj),
                      TL.ffn_apply(cfg, {k: as_port(v) for k, v in w.items()},
                                   xt)))
    # the weight product every projection takes (a strided layer view too)
    wl = to_jax(ref, rng.normal(size=(3, 64, 96)) * 0.2, getattr(jnp, dtype))
    cases.append(("linear", xj @ wl[1], TL.linear(xt, as_port(wl)[1])))
    cases.append(("linear transposed", xj @ wl[2, :, :64].T,
                  TL.linear(xt, as_port(wl)[2, :, :64].T)))
    silu_cfg = dataclasses.replace(smoke("rwkv6-1.6b", dtype), act="silu",
                                   glu=True)
    cases.append(("ffn silu", L.ffn_apply(silu_cfg, w, xj),
                  TL.ffn_apply(silu_cfg, {k: as_port(v) for k, v in
                                          w.items()}, xt)))
    for name, want, got in cases:
        assert got.dtype == as_port(want).dtype, name
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   err_msg=name, **tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hq,hkv,sq,sk,window,chunk", [
    (4, 4, 24, 24, None, 512), (4, 1, 24, 24, 16, 512),
    (4, 2, 5, 40, None, 8), (4, 1, 40, 40, 16, 16), (8, 1, 37, 37, 7, 8)])
def test_chunked_attention_matches_reference(ref, dtype, hq, hkv, sq, sk,
                                             window, chunk):
    """Causal, windowed, GQA/MQA, right-aligned queries (sq < sk), several
    query and key chunks with ragged padding."""
    import jax.numpy as jnp

    rng = np.random.default_rng(hq + sq + sk + chunk)
    jdt = getattr(jnp, dtype)
    q, k, v = (to_jax(ref, rng.normal(size=(2, h, s, 16)), jdt)
               for h, s in ((hq, sq), (hkv, sk), (hkv, sk)))
    want = ref.layers.chunked_attention(q, k, v, causal=True, window=window,
                                        q_chunk=chunk, kv_chunk=chunk)
    got = TL.chunked_attention(as_port(q), as_port(k), as_port(v),
                               causal=True, window=window, q_chunk=chunk,
                               kv_chunk=chunk)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               **tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hq,hkv,pos,window", [(4, 4, 9, None),
                                               (4, 1, 30, None),
                                               (8, 2, 30, 12)])
def test_decode_attention_and_cache_update_match_reference(ref, dtype, hq,
                                                           hkv, pos, window):
    import jax.numpy as jnp

    rng = np.random.default_rng(hq * 10 + pos)
    jdt = getattr(jnp, dtype)
    q = to_jax(ref, rng.normal(size=(2, hq, 16)), jdt)
    kc, vc = (to_jax(ref, rng.normal(size=(2, hkv, 32, 16)), jdt)
              for _ in range(2))
    new = to_jax(ref, rng.normal(size=(2, hkv, 16)), jdt)
    slot = pos % 32
    kj = ref.layers.cache_update(kc, new, jnp.int32(slot))
    kt = TL.cache_update(as_port(kc).clone(), as_port(new), slot)
    np.testing.assert_array_equal(kt.float().numpy(),
                                  np.asarray(kj.astype(jnp.float32)))
    want = ref.layers.decode_attention(q, kj, vc, jnp.int32(pos),
                                       window=window)
    got = TL.decode_attention(as_port(q), kt, as_port(vc), pos,
                              window=window)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               **tol(dtype))


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "recurrentgemma-9b"])
def test_recurrent_blocks_match_reference(ref, pair, arch, dtype, with_state):
    """``rwkv6_block`` / ``rglru_block`` outputs and states, prefill-style
    (no state) and decode-style (a carried state, one and several steps)."""
    import jax
    import jax.numpy as jnp

    cfg, _, params, port = pair(arch, dtype)
    jp = jax.tree_util.tree_map(lambda a: a[0],
                                params["scan_layers"]["slot0"]["mixer"])
    tp = port.scan_layers["slot0"].tree(0)["mixer"]
    jblock, tblock = {"rwkv6-1.6b": (ref.recurrent.rwkv6_block,
                                     TR.rwkv6_block),
                      "recurrentgemma-9b": (ref.recurrent.rglru_block,
                                            TR.rglru_block)}[arch]
    rng = np.random.default_rng(3)
    jdt = getattr(jnp, dtype)
    for s in ((1, 5) if with_state else (13,)):
        x = to_jax(ref, rng.normal(size=(2, s, cfg.d_model)), jdt)
        state = None
        if with_state:  # a state from a prefill of 6 other tokens
            x0 = to_jax(ref, rng.normal(size=(2, 6, cfg.d_model)), jdt)
            _, state = jblock(cfg, jp, x0)
        want, wstate = jblock(cfg, jp, x, state)
        got, gstate = tblock(smoke(arch, dtype), tp, as_port(x),
                             None if state is None else
                             {k: as_port(v) for k, v in state.items()})
        assert got.dtype == as_port(want).dtype
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   **tol(dtype))
        assert_trees_close(gstate, wstate, f"{arch} state", **tol(dtype))
        for k in gstate:
            assert gstate[k].dtype == as_port(wstate[k]).dtype, k


# -- the whole model ----------------------------------------------------------

def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", SERVED)
def test_prefill_and_decode_match_reference(ref, pair, arch, dtype):
    """prefill logits and caches (24 tokens into 32 cache slots: past
    recurrentgemma's 16-token window, so its cache is rolled), then two
    decode steps' logits and caches, against the reference's model: as it
    ships in float32, where ``chunked_attention`` rounds nothing; in bf16
    with its TPU attention kernels' function (:func:`tpu_attention`)."""
    import jax.numpy as jnp

    cfg, jm, params, port = pair(arch, dtype)
    toks = _tokens(cfg, 2, 26, 11)
    with (tpu_attention(ref) if dtype == "bfloat16"
          else contextlib.nullcontext()):
        lj, cj = jm.prefill(params, jnp.asarray(toks[:, :24]), cache_len=32)
        lt, ct = port.prefill(torch.from_numpy(toks[:, :24]), cache_len=32)
        assert lt.shape == (2, cfg.vocab_size)
        assert lt.dtype == as_port(lj).dtype
        np.testing.assert_allclose(lt.float().numpy(),
                                   np.asarray(lj.astype(jnp.float32)),
                                   **tol(dtype))
        assert_trees_close(ct, cj, f"{arch} prefill caches", **tol(dtype))
        for p in (24, 25):
            lj, cj = jm.decode_step(params, cj, jnp.asarray(toks[:, p]),
                                    jnp.int32(p))
            lt, ct = port.decode_step(ct, torch.from_numpy(toks[:, p]), p)
            np.testing.assert_allclose(lt.float().numpy(),
                                       np.asarray(lj.astype(jnp.float32)),
                                       err_msg=f"decode {p}", **tol(dtype))
            assert_trees_close(ct, cj, f"{arch} decode {p} caches",
                               **tol(dtype))


@pytest.mark.parametrize("arch", [a for a in SERVED if a not in MOE])
def test_bf16_gap_to_the_shipped_reference_is_attention_rounding(ref, pair,
                                                                 arch):
    """The bf16 port against the reference's model as it ships (its
    ``chunked_attention`` / ``decode_attention``, which round ``q * scale``
    and ``p`` to bf16 where the TPU kernels and the port do not): prefill
    and two decode steps give the same greedy tokens, and every logit lies
    within ``GAP_OF_SCALE`` of the step's largest logit, about 2.4 times
    the widest gap measured, 0.0106 (llama3-8b's prefill: 0.039 on logits
    up to 3.69). A wrong attention, state or position gives gaps of the
    logits' own scale. Prints the reading (``-s``): the share of logits
    beyond the suite's tolerance and the widest gap. The MoE configs miss
    ``GAP_OF_SCALE``: the same rounding moves near-tied expert choices
    (``tests/test_torch_moe.py::test_bf16_moe_gap_to_the_shipped_
    reference_goes_through_the_routing`` records it)."""
    import jax.numpy as jnp

    cfg, jm, params, port = pair(arch, "bfloat16")
    toks = _tokens(cfg, 2, 26, 11)
    lj, cj = jm.prefill(params, jnp.asarray(toks[:, :24]), cache_len=32)
    lt, ct = port.prefill(torch.from_numpy(toks[:, :24]), cache_len=32)
    readings = []
    for step in ("prefill", 24, 25):
        if step != "prefill":
            lj, cj = jm.decode_step(params, cj, jnp.asarray(toks[:, step]),
                                    jnp.int32(step))
            lt, ct = port.decode_step(ct, torch.from_numpy(toks[:, step]),
                                      step)
        want = np.asarray(lj.astype(jnp.float32))
        got = lt.float().numpy()
        gap = np.abs(got - want)
        beyond = float((gap > BF16["atol"] + BF16["rtol"] * np.abs(want))
                       .mean())
        readings.append(f"{step}: {beyond:.4f} of the logits beyond the "
                        f"suite's tolerance, max gap {gap.max():.4g} on "
                        f"logits up to {np.abs(want).max():.3g}")
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1),
                                      err_msg=f"{arch} {step}")
        assert gap.max() <= GAP_OF_SCALE * np.abs(want).max(), readings
    print(f"{arch} bf16 against the shipped reference: "
          + "; ".join(readings))


@pytest.mark.parametrize("arch", PORTED)
def test_init_cache_matches_reference(ref, pair, arch):
    cfg, jm, _, port = pair(arch, "bfloat16")
    want = jm.init_cache(3, 40)
    got = port.init_cache(3, 40)
    assert_trees_close(got, want, "init_cache", rtol=0, atol=0)
    for (k, g), w in zip(sorted(flat(got).items()),
                         (v for _, v in sorted(flat(want).items()))):
        assert g.shape == w.shape, k


@pytest.mark.parametrize("arch", SERVED)
def test_incremental_decode_matches_full_forward(arch):
    """prefill(S) + decode(S th token) == prefill(S+1) logits (the
    reference suite's test, on the port alone). The MoE configs at capacity
    factor E/k: at the shipped 1.25 a prefill drops pairs that a decode
    step never drops, in the reference too
    (``tests/test_torch_moe.py::test_capacity_drops_part_decode_from_
    prefill_in_both``)."""
    cfg = get_smoke_config(arch)
    if cfg.num_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=cfg.num_experts
                                  / cfg.top_k)
    m = Model(cfg, device="cpu").init(torch.Generator().manual_seed(1))
    b, s = 2, 24
    toks = torch.from_numpy(_tokens(cfg, b, s + 1, 2))
    ref_logits, _ = m.prefill(toks, cache_len=s + 8)
    _, cache = m.prefill(toks[:, :s], cache_len=s + 8)
    dec, _ = m.decode_step(cache, toks[:, s], s)
    np.testing.assert_allclose(dec.float().numpy(),
                               ref_logits.float().numpy(), **BF16)


@pytest.mark.parametrize("arch,s", [("llama3-8b", 24),
                                    ("recurrentgemma-9b", 12),
                                    ("recurrentgemma-9b", 40),
                                    ("stablelm-12b", 24),
                                    ("starcoder2-15b", 24)])
def test_bf16_decode_step_equals_prefill_of_one_more_token_bitwise(arch, s):
    """In bf16 on the CPU, prefill(S) + decode_step equals prefill(S+1) bit
    for bit: every row of the plain product, of the norms' row means and of
    the plain attention versions (fixed key tiles and chunks, fixed
    [PLAIN_ROWS, D] products) is summed as the row alone would be
    (ROADMAP Queue 3 item 10). recurrentgemma-9b within and past its
    16-token window (its cache rolled)."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="bfloat16",
                              kv_dtype="bfloat16")
    m = Model(cfg, device="cpu").init(torch.Generator().manual_seed(3))
    toks = torch.from_numpy(_tokens(cfg, 2, s + 1, 4))
    full, _ = m.prefill(toks, cache_len=s + 8)
    _, cache = m.prefill(toks[:, :s], cache_len=s + 8)
    dec, _ = m.decode_step(cache, toks[:, s], s)
    assert torch.equal(dec, full)


def test_rolling_window_decode_beyond_window():
    """recurrentgemma: decoding far past the window with a rolling cache
    matches a fresh prefill over the whole context."""
    cfg = get_smoke_config("recurrentgemma-9b")   # window 16
    m = Model(cfg, device="cpu").init(torch.Generator().manual_seed(5))
    total = 40
    toks = torch.from_numpy(_tokens(cfg, 1, total + 1, 6))
    logits, cache = m.prefill(toks[:, :8], cache_len=cfg.window)
    for p in range(8, total):
        logits, cache = m.decode_step(cache, toks[:, p], p)
    ref_logits, _ = m.prefill(toks[:, :total], cache_len=cfg.window)
    np.testing.assert_allclose(logits.float().numpy(),
                               ref_logits.float().numpy(), **ROLLING_BF16)


def test_full_attention_prefill_longer_than_cache_raises():
    cfg = dataclasses.replace(get_smoke_config("recurrentgemma-9b"),
                              window=None)
    m = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="cache_len"):
        m.prefill(torch.zeros((1, 20), dtype=torch.int64), cache_len=10)
