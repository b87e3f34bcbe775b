"""qwen1.5-32b's float8_e4m3fn KV cache in the port, against the reference.

The same seeded numpy inputs go through the port and the reference
(``tests/test_torch_harness.py:reference()``):

- the cast to the cache (``models.layers.to_kv``) against XLA's
  ``astype(float8_e4m3fn)``, bit for bit on all 65,536 bf16 patterns and on
  float32 values around 448, 464, 466, +-inf, NaN and the fp8 subnormals
  (torch's own ``.to`` saturates to +-448 where XLA gives NaN);
- ``flash_decode`` on fp8 caches (its plain version, what the wrapper runs
  for CPU tensors) against the reference's Pallas kernel in interpret mode
  on the same fp8 inputs, at the bf16 tolerance of
  ``tests/test_torch_attention.py`` (1e-5 (1 + |want|), plus one bf16 ulp
  of a bf16 output), and bit for bit against itself on the caches widened
  first (the widening is exact and nothing else is rounded);
- the qwen smoke model with an fp8 cache against the reference ``Model``
  under its TPU kernels' attention (``test_torch_models.tpu_attention``):
  bit for bit in bf16 (logits and caches as uint8 views), within ``F32``
  in float32 (XLA and torch sum the float32 products in other orders);
- the gap to the shipped reference, whose ``decode_attention`` rounds
  ``q * scale`` and ``p`` to fp8 under an fp8 cache (ROADMAP Queue 3 item
  15), as a recorded number. torch's own CPU cast is ROADMAP Queue 3 item
  14.

The CUDA kernel runs only on a GPU: its twins are marked ``gpu`` and skip
here; ``chip_smoke.py`` holds it on the card.
"""
import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.convert import model_params_from_fields, \
    tensor_from_array
from repro_torch.kernels import ops
from repro_torch.kernels.ref import flash_decode_plain
from repro_torch.models.layers import to_kv
from tests.test_torch_harness import reference
from tests.test_torch_models import flat, tpu_attention

FP8 = torch.float8_e4m3fn
ARCH = "qwen1.5-32b"
F32_TOL = 1e-5
F32 = dict(rtol=1e-5, atol=1e-5)
#: the bf16 fp8-cache model's widest logit gap to the shipped reference, as
#: a share of the step's largest logit: about twice the widest measured,
#: 0.0511 (decode step 24: 0.1406 on logits up to 2.75)
FP8_GAP_OF_SCALE = 0.10


@pytest.fixture(scope="module")
def ref():
    return reference()


def _u8(x):
    """A copy of the bits of an fp8 tensor or array (``torch.equal`` has no
    fp8 CPU kernel)."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.uint8).numpy().copy()
    return np.asarray(x).view(np.uint8)


def _xla_fp8(ref, x):
    """XLA's ``astype(float8_e4m3fn)`` of a float32 or bf16 numpy array, as
    uint8."""
    import jax.numpy as jnp

    return _u8(jnp.asarray(x).astype(jnp.float8_e4m3fn))


def _as_jax_fp8(x):
    """An fp8 torch tensor as a jax fp8 array (the same bits)."""
    import jax.numpy as jnp
    import ml_dtypes

    return jnp.asarray(_u8(x).view(ml_dtypes.float8_e4m3fn))


# -- the cast -----------------------------------------------------------------

def test_to_kv_equals_xla_astype_on_every_bf16_pattern(ref):
    """Bit for bit on all 65,536 bf16 patterns (finite values above 464,
    +-inf and NaN give NaN with the input's sign)."""
    import ml_dtypes

    pat = np.arange(65536, dtype=np.uint32).astype(np.uint16)
    x = torch.from_numpy(pat.view(np.int16)).view(torch.bfloat16)
    got = _u8(to_kv(x, FP8))
    want = _xla_fp8(ref, pat.view(ml_dtypes.bfloat16))
    np.testing.assert_array_equal(got, want)


def _edges(center, n=40):
    """float32 values around ``center``: it, its float32 neighbours, and
    steps of 1/8 ulp of e4m3 either side."""
    c = np.float32(center)
    vals = [c, np.nextafter(c, np.float32(np.inf)),
            np.nextafter(c, np.float32(-np.inf))]
    step = np.float32(max(abs(float(c)), 2.0 ** -9) / 64)
    vals += [c + np.float32(i) * step for i in range(-n, n + 1)]
    return np.array(vals, np.float32)


FLOAT32_SETS = {
    "around 448": _edges(448.0),
    "around 464 (the tie with 480)": _edges(464.0),
    "around 466": _edges(466.0),
    "inf and nan": np.array([np.inf, -np.inf, np.nan, 3.4e38, -3.4e38,
                             1e30, 65504.0], np.float32),
    "subnormals and their ties": np.concatenate(
        [_edges(2.0 ** -9), _edges(2.0 ** -10), _edges(3 * 2.0 ** -10),
         _edges(2.0 ** -6), _edges(2.0 ** -7 * 1.5),
         np.array([0.0, 1e-45, 1.2e-38, 7 * 2.0 ** -9], np.float32)]),
    "random magnitudes": (np.random.default_rng(0).standard_normal(200_000)
                          * np.exp2(np.random.default_rng(1).integers(
                              -20, 10, 200_000))).astype(np.float32),
}


@pytest.mark.parametrize("name", sorted(FLOAT32_SETS))
def test_to_kv_equals_xla_astype_on_float32_values(ref, name):
    """Bit for bit on float32 values and their negatives: one rounding to
    nearest even from the float32 value (464 is a tie and rounds to 448,
    the next float32 to NaN)."""
    x = FLOAT32_SETS[name]
    x = np.concatenate([x, -x])
    np.testing.assert_array_equal(_u8(to_kv(torch.from_numpy(x), FP8)),
                                  _xla_fp8(ref, x), err_msg=name)


def test_to_kv_takes_torchs_bf16_cast_only_where_it_is_xlas(ref,
                                                             monkeypatch):
    """A bf16 input takes torch's own cast on a device only where that cast
    gave XLA's bits on all 65,536 bf16 patterns (probed once a device); so
    the probe's verdict on the CPU is whatever this torch build's cast
    does, and a cast that passed it is taken as it is."""
    import ml_dtypes

    from repro_torch.models import layers

    pat = np.arange(65536, dtype=np.uint32).astype(np.uint16)
    x = torch.from_numpy(pat.view(np.int16)).view(torch.bfloat16)
    want = _xla_fp8(ref, pat.view(ml_dtypes.bfloat16))
    cpu = torch.device("cpu")
    assert layers._bf16_cast_is_xla(cpu) == bool(
        np.array_equal(_u8(x.to(FP8)), want))
    np.testing.assert_array_equal(_u8(layers._to_e4m3fn(x)), want)
    monkeypatch.setitem(layers._BF16_CAST_IS_XLA, cpu, True)
    np.testing.assert_array_equal(_u8(to_kv(x, FP8)), _u8(x.to(FP8)))
    monkeypatch.setitem(layers._BF16_CAST_IS_XLA, cpu, False)
    np.testing.assert_array_equal(_u8(to_kv(x, FP8)), want)


@pytest.mark.parametrize("src,dst", [(torch.float32, torch.bfloat16),
                                     (torch.bfloat16, torch.bfloat16),
                                     (torch.bfloat16, torch.float32),
                                     (torch.float32, torch.float32)])
def test_to_kv_is_a_plain_cast_for_other_cache_dtypes(src, dst):
    x = (torch.randn(4, 300, generator=torch.Generator().manual_seed(2))
         * 1000).to(src)
    got = to_kv(x, dst)
    assert got.dtype == dst and torch.equal(got, x.to(dst))


def test_tensor_from_array_carries_fp8_bits():
    """An ``ml_dtypes.float8_e4m3fn`` array crosses as its uint8 view, NaN,
    +-448, zeros and subnormals included, and back."""
    import ml_dtypes

    bits = np.arange(256, dtype=np.uint8)
    a = bits.view(ml_dtypes.float8_e4m3fn).reshape(16, 16)
    t = tensor_from_array(a)
    assert t.dtype == FP8 and tuple(t.shape) == (16, 16)
    np.testing.assert_array_equal(_u8(t).reshape(-1), bits)
    np.testing.assert_array_equal(
        t.float().numpy(), a.astype(np.float32))  # NaN where a has NaN


# -- flash_decode on fp8 caches ---------------------------------------------

def _fp8_cache(rng, shape, n_big=0):
    """An fp8 cache from seeded bf16 values (|x| of a few units), ``n_big``
    elements past 448 first (NaN after the cast)."""
    x = torch.from_numpy((rng.normal(size=shape) * 2.0).astype(np.float32))
    flat_x = x.view(-1)
    idx = rng.choice(flat_x.numel(), n_big, replace=False)
    flat_x[torch.from_numpy(idx)] = torch.tensor(
        [500.0, -1000.0, 470.0])[:n_big]
    return to_kv(x.to(torch.bfloat16), FP8)


def _assert_close(got, want, bf16, where=""):
    """|got - want| <= F32_TOL (1 + |want|), plus one bf16 ulp of the
    larger of the two in bf16 (``tests/test_torch_attention.py``'s)."""
    got = np.asarray(got, np.float32)
    bound = F32_TOL * (1.0 + np.abs(want))
    if bf16:
        _, e = np.frexp(np.maximum(np.abs(got), np.abs(want)))
        bound = bound + np.ldexp(1.0, e - 8)
    err = np.abs(got - want)
    assert np.all(err <= bound), (
        f"{where}: max err {err.max()}, worst ratio {(err / bound).max()}")


def _same_bits(a, b):
    """NaN where ``b`` has NaN, and the same bits elsewhere."""
    nan = torch.isnan(a)
    ints = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    return (a.dtype == b.dtype and torch.equal(nan, torch.isnan(b))
            and bool((a.view(ints) == b.view(ints))[~nan].all()))


#: (hq, hkv, s, d): qwen's MHA at its head dim, GQA, MQA
DECODE_CASES = [(4, 4, 40, 128), (8, 2, 70, 16), (4, 1, 300, 64)]


@pytest.mark.parametrize("qdt", ["bf16", "f32"])
@pytest.mark.parametrize("hq,hkv,s,d", DECODE_CASES)
def test_flash_decode_fp8_matches_reference_pallas_kernel(ref, hq, hkv, s,
                                                          d, qdt):
    """``ops.flash_decode`` on the CPU with fp8 K/V and a bf16 or float32
    q against the reference's Pallas ``flash_decode`` in interpret mode on
    the same fp8 inputs (it widens K and V to float32 and rounds nothing
    else), at the bf16 tolerance above; lengths 1, partial, full and past
    the cache."""
    import jax.numpy as jnp

    dt = {"bf16": torch.bfloat16, "f32": torch.float32}[qdt]
    rng = np.random.default_rng(hq * 100 + s + d)
    b = 4
    q = torch.from_numpy(rng.normal(size=(b, hq, d)).astype(np.float32)
                         ).to(dt)
    k8, v8 = (_fp8_cache(rng, (b, hkv, s, d)) for _ in range(2))
    length = np.array([1, s // 2 + 1, s, s + 7], np.int32)
    got = ops.flash_decode(q, k8, v8, torch.from_numpy(length))
    assert got.dtype == dt and got.shape == q.shape
    qj = jnp.asarray(q.float().numpy()).astype(
        jnp.bfloat16 if qdt == "bf16" else jnp.float32)
    kernel = ref.kops.flash_decode(qj, _as_jax_fp8(k8), _as_jax_fp8(v8),
                                   jnp.asarray(length), use_pallas=True)
    assert kernel.dtype == qj.dtype
    _assert_close(got.float().numpy(),
                  np.asarray(kernel.astype(jnp.float32)), qdt == "bf16",
                  f"fp8 K/V, {qdt} q")


@pytest.mark.parametrize("qdt", [torch.bfloat16, torch.float32])
def test_flash_decode_fp8_equals_itself_on_the_widened_caches(qdt):
    """Bit for bit (NaN where NaN): the fp8 caches against the same caches
    widened to q's dtype first, plain and rolled (``end``), with keys and
    values past 448 (NaN in the cache: a NaN key makes its rows NaN, a
    NaN value its column)."""
    rng = np.random.default_rng(31)
    q = torch.from_numpy(rng.normal(size=(4, 8, 32)).astype(np.float32)
                         ).to(qdt)
    k8, v8 = (_fp8_cache(rng, (4, 2, 300, 32), n_big=2) for _ in range(2))
    assert bool(torch.isnan(k8.float()).any())
    kw, vw = k8.to(qdt), v8.to(qdt)
    length = torch.tensor([0, 1, 157, 300], dtype=torch.int32)
    for end in (None, length + torch.tensor([0, 70, 300, 611],
                                            dtype=torch.int32)):
        got = ops.flash_decode(q, k8, v8, length, end)
        assert _same_bits(got, ops.flash_decode(q, kw, vw, length, end))
        assert _same_bits(got, flash_decode_plain(q, kw, vw, length, end))
    assert bool(torch.isnan(got).any()) and not bool(torch.isnan(got).all())


def test_flash_decode_fp8_on_the_cpu_launches_nothing():
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.normal(size=(2, 4, 16)).astype(np.float32))
    k8, v8 = (_fp8_cache(rng, (2, 4, 20, 16)) for _ in range(2))
    before = ops.launch_counts()
    ops.flash_decode(q.to(torch.bfloat16), k8, v8,
                     torch.tensor([3, 20], dtype=torch.int32))
    assert ops.launch_counts() == before


@pytest.mark.parametrize("case", ["e5m2", "fp8_q", "k8_v_bf16", "v8_k_bf16",
                                  "bf16_q_f32_kv", "f64_q_kv8",
                                  "attention_kv8"])
def test_fp8_rejections(case):
    """``flash_decode`` takes fp8 K/V only as float8_e4m3fn, both k and v,
    under a bf16 or float32 q; ``flash_attention`` takes none (prefill
    attends the K/V before the cast)."""
    q = torch.rand(2, 4, 16, dtype=torch.bfloat16)
    k = torch.rand(2, 2, 6, 16).to(FP8)
    v = torch.rand(2, 2, 6, 16).to(FP8)
    length = torch.tensor([3, 6], dtype=torch.int32)
    if case == "e5m2":
        k, v = k.float().to(torch.float8_e5m2), v.float().to(
            torch.float8_e5m2)
    elif case == "fp8_q":
        q = q.float().to(FP8)
    elif case == "k8_v_bf16":
        v = v.to(torch.bfloat16)
    elif case == "v8_k_bf16":
        k = k.to(torch.bfloat16)
    elif case == "bf16_q_f32_kv":
        k, v = k.float(), v.float()
    elif case == "f64_q_kv8":
        q = q.double()
    if case == "attention_kv8":
        with pytest.raises(TypeError):
            ops.flash_attention(q[:, :, None], k, v)
        return
    with pytest.raises(TypeError):
        ops.flash_decode(q, k, v, length)


# -- the qwen smoke model with an fp8 cache ---------------------------------

def _cfg(dtype):
    return dataclasses.replace(get_smoke_config(ARCH), dtype=dtype,
                               kv_dtype="float8_e4m3fn")


@pytest.fixture(scope="module")
def pair(ref):
    """(reference Model, its params, the port's Model holding them) for the
    qwen smoke config with an fp8 cache, per dtype."""
    built = {}

    def get(dtype):
        if dtype not in built:
            jax = ref.jax
            cfg = dataclasses.replace(ref.configs.get_smoke_config(ARCH),
                                      dtype=dtype,
                                      kv_dtype="float8_e4m3fn")
            jm = ref.models.Model(cfg, remat=False)
            params = jm.init(jax.random.PRNGKey(0))
            fields = jax.tree_util.tree_map(np.asarray, params)
            built[dtype] = (jm, params, model_params_from_fields(
                _cfg(dtype), fields, device="cpu"))
        return built[dtype]

    return get


def _tokens(b, s, seed):
    return np.random.default_rng(seed).integers(0, 256, (b, s)).astype(
        np.int32)


def _fp8_leaves(tree):
    """{path: uint8 bits} of the fp8 leaves of a cache tree (torch or
    jax)."""
    out = {}

    def walk(t, prefix):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{prefix}{k}.")
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                walk(v, f"{prefix}{i}.")
        else:
            assert str(t.dtype) == "float8_e4m3fn" or t.dtype == FP8, prefix
            out[prefix[:-1]] = _u8(t)
    walk(tree, "")
    return out


def _assert_caches_equal(a, want, where):
    """``a``: the port's cache bits (``_fp8_leaves``); ``want``: the
    reference's cache tree."""
    b = _fp8_leaves(want)
    assert sorted(a) == sorted(b), where
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{where} {k}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qwen_fp8_cache_matches_reference_model(ref, pair, dtype):
    """prefill logits and fp8 caches (24 tokens into 32 slots, compared as
    uint8), then two decode steps' logits and caches, against the
    reference's model with its TPU kernels' attention. bf16: bit for bit
    (the cache casts are XLA's, the kernels' functions round nothing
    more). float32: the caches bit for bit, the logits within ``F32`` (XLA
    and torch take float32 sums in other orders, ~2e-6 here)."""
    import jax.numpy as jnp

    jm, params, port = pair(dtype)
    toks = _tokens(2, 26, 11)
    with tpu_attention(ref):
        lj, cj = jm.prefill(params, jnp.asarray(toks[:, :24]), cache_len=32)
        lt, ct = port.prefill(torch.from_numpy(toks[:, :24]), cache_len=32)
        # the port's decode steps update its caches in place: keep each
        # step's bits
        steps = [("prefill", lt, lj, _fp8_leaves(ct), cj)]
        for p in (24, 25):
            lj, cj = jm.decode_step(params, cj, jnp.asarray(toks[:, p]),
                                    jnp.int32(p))
            lt, ct = port.decode_step(ct, torch.from_numpy(toks[:, p]), p)
            steps.append((f"decode {p}", lt, lj, _fp8_leaves(ct), cj))
    for where, got, want, gc, wc in steps:
        g, w = got.float().numpy(), np.asarray(want.astype(jnp.float32))
        assert got.dtype == {"float32": torch.float32,
                             "bfloat16": torch.bfloat16}[dtype]
        if dtype == "bfloat16":
            np.testing.assert_array_equal(g, w, err_msg=where)
        else:
            np.testing.assert_allclose(g, w, err_msg=where, **F32)
        _assert_caches_equal(gc, wc, where)


def test_qwen_fp8_init_cache_matches_reference(ref, pair):
    jm, _, port = pair("bfloat16")
    _assert_caches_equal(_fp8_leaves(port.init_cache(3, 40)),
                         jm.init_cache(3, 40), "init_cache")
    got = flat(port.init_cache(3, 40))
    assert all(v.shape[-2:] == (40, 16) for v in got.values())


def test_qwen_fp8_gap_to_the_shipped_reference_is_its_fp8_rounding(ref,
                                                                    pair):
    """The bf16 fp8-cache port against the reference's model as it ships:
    its ``decode_attention`` rounds ``q * scale`` and ``p`` to fp8 under an
    fp8 cache (ROADMAP Queue 3 item 15; its ``chunked_attention`` both to
    bf16, item 9),
    where the TPU kernels and the port round neither. Prefill and two
    decode steps give the same greedy tokens, and every logit lies within
    ``FP8_GAP_OF_SCALE`` of the step's largest logit. Prints the reading
    (``-s``): the widest gap and the share beyond the bf16 suite's
    tolerance (rtol 2e-2, atol 2e-3)."""
    import jax.numpy as jnp

    jm, params, port = pair("bfloat16")
    toks = _tokens(2, 26, 11)
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
        beyond = float((gap > 2e-3 + 2e-2 * np.abs(want)).mean())
        scale = np.abs(want).max()
        readings.append(f"{step}: max gap {gap.max():.4g} on logits up to "
                        f"{scale:.3g} ({gap.max() / scale:.4f} of the "
                        f"scale), {beyond:.4f} beyond the tolerance")
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1),
                                      err_msg=f"{step}")
        assert gap.max() <= FP8_GAP_OF_SCALE * scale, readings
    print(f"{ARCH} fp8 cache, bf16, against the shipped reference: "
          + "; ".join(readings))


def test_qwen_full_config_stores_its_cache_in_fp8():
    """The full config's cache dtype reaches the model's caches (on the
    meta device: no weights drawn)."""
    from repro_torch.models import Model

    cfg = get_config(ARCH)
    assert cfg.kv_dtype == "float8_e4m3fn" and cfg.dtype == "bfloat16"
    cache = Model(cfg, device="meta").init_cache(2, 8)["scan"]["slot0"]
    for name in ("k", "v"):
        assert cache[name].dtype == FP8
        assert tuple(cache[name].shape) == (64, 2, 40, 8, 128)


# -- on the card -----------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (chip_smoke.py runs it)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("qdt", [torch.bfloat16, torch.float32])
def test_cuda_flash_decode_fp8_equals_the_kernel_on_widened_caches(qdt):
    """The kernel on fp8 caches: bit for bit (NaN where NaN) the kernel on
    the caches widened to q's dtype, at qwen's MHA, GQA and MQA shapes,
    plain and rolled, 16-byte rows and not; within the card tolerance of
    the plain version."""
    dev = _cuda()
    rng = np.random.default_rng(53)
    for hq, hkv, s, d, width in [(40, 40, 192, 128, None),
                                 (40, 40, 2064, 128, None),
                                 (32, 8, 1100, 128, None),
                                 (16, 1, 600, 256, None),
                                 (8, 2, 300, 128, 136),
                                 (8, 2, 300, 40, None)]:
        q = torch.from_numpy(rng.normal(size=(4, hq, d)).astype(
            np.float32)).to(qdt).to(dev)
        k8, v8 = (_fp8_cache(rng, (4, hkv, s, width or d), n_big=2).to(
            dev)[..., :d] for _ in range(2))
        length = torch.tensor([0, 1, s // 2 + 1, s], dtype=torch.int32,
                              device=dev)
        for end in (None, length + torch.tensor(
                [0, 5, s + 3, 2 * s + 1], dtype=torch.int32, device=dev)):
            before = ops.flash_decode.launches
            got = ops.flash_decode(q, k8, v8, length, end)
            torch.cuda.synchronize()
            assert ops.flash_decode.launches == before + 1
            assert _same_bits(got, ops.flash_decode(q, k8.to(qdt),
                                                    v8.to(qdt), length, end))
            want = flash_decode_plain(q, k8, v8, length, end)
            nan = torch.isnan(got)
            assert torch.equal(nan, torch.isnan(want))
            err = (got.float() - want.float()).abs()[~nan]
            vf = v8.float()
            tol = 1e-5 * float(vf[torch.isfinite(vf)].abs().max())
            if qdt == torch.bfloat16:
                _, e = torch.frexp(torch.maximum(
                    got.float().abs(), want.float().abs())[~nan])
                tol = tol + torch.ldexp(torch.ones_like(err), e - 8)
            assert bool((err <= tol).all())


@pytest.mark.gpu
def test_cuda_to_kv_equals_the_cpu():
    """``to_kv`` on the card: the CPU's bits on all bf16 patterns and a
    float32 sample."""
    dev = _cuda()
    pat = np.arange(65536, dtype=np.uint32).astype(np.uint16)
    xb = torch.from_numpy(pat.view(np.int16)).view(torch.bfloat16)
    xf = torch.from_numpy(np.concatenate(list(FLOAT32_SETS.values())))
    for x in (xb, xf):
        np.testing.assert_array_equal(_u8(to_kv(x.to(dev), FP8).cpu()),
                                      _u8(to_kv(x, FP8)))


def test_chip_smoke_fp8_cases_run_on_the_cpu(monkeypatch):
    """chip_smoke's fp8 decode cases' inputs and checks, on the CPU at
    small shapes: ``fp8_caches`` seeds NaN, and ``kv8_check`` passes the
    plain version against itself and fails a changed bit."""
    import importlib.util

    from tests.test_torch_harness import CHIP_SMOKE

    spec = importlib.util.spec_from_file_location("chip_smoke_fp8",
                                                  CHIP_SMOKE)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    g = torch.Generator().manual_seed(1)
    k8, v8 = cs.fp8_caches(2, 3, 50, 16, torch.device("cpu"), g)
    assert int(torch.isnan(k8.float()).sum()) == cs.KV8_NAN_ELEMS
    q = torch.randn(2, 6, 16, generator=g).to(torch.bfloat16)
    length = torch.tensor([50, 20], dtype=torch.int32)
    got = ops.flash_decode(q, k8, v8, length)
    wid = ops.flash_decode(q, k8.to(torch.bfloat16), v8.to(torch.bfloat16),
                           length)
    cs.kv8_check("cpu", got, wid, flash_decode_plain(q, k8, v8, length), v8)
    fin = ~torch.isnan(got)
    bad = got.clone()
    bad[fin] = (bad[fin].float() * 1.5).to(torch.bfloat16)
    with pytest.raises(AssertionError):
        cs.kv8_check("cpu changed", bad, wid, wid, v8)
