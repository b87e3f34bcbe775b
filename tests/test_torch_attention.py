"""The port's attention kernels (``flash_attention``, ``flash_decode``) and
the row-independent weight product (``models.layers.linear``) against the
reference.

The same seeded numpy inputs go through the port's plain versions (what
the wrappers run for CPU tensors), the reference's oracles
(``ref.flash_attention_ref`` / ``ref.flash_decode_ref``) and the
reference's Pallas kernels in interpret mode (``kops.*(use_pallas=True)``,
as ``tests/test_kernels.py`` runs them; about 1.6 s a call, so the cases
are few and small). Tolerances:

- float32: a relative and absolute 1e-5. All three compute float32
  scores scaled after the dot and a softmax over them, in other summation
  orders; the reference kernel's own error against its oracle is 4.8e-7.
- bf16 (inputs and output): the three compute in float32 from the same
  bf16 values and round once, so they differ by at most one bf16 ulp of
  the output (2^-8 to 2^-7 of it), plus the float32 tolerance.

``flash_decode`` at ``length = 0`` is pinned: zeros from the plain version
and from the reference kernel, NaN from the reference's oracle. The CUDA
kernels run only on a GPU: their cases are marked ``gpu`` and skip here;
``chip_smoke.py`` holds them against the plain versions on the card.
"""
import importlib

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ref import flash_attention_plain, flash_decode_plain
from repro_torch.models.layers import linear, row_mean
from tests.test_torch_harness import reference

F32_TOL = 1e-5
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


@pytest.fixture(scope="module")
def ref():
    return reference()


def _normal(rng, shape, dtype):
    """Seeded normal values in ``dtype`` (a torch tensor) and the same
    values as a float32 numpy array."""
    t = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
        DTYPES[dtype])
    return t, t.float().numpy()


def _jax(x, dtype):
    import jax.numpy as jnp

    return jnp.asarray(x).astype({"f32": jnp.float32,
                                  "bf16": jnp.bfloat16}[dtype])


def _np(x):
    import jax.numpy as jnp

    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _assert_close(got, want, dtype, where=""):
    """|got - want| <= F32_TOL (1 + |want|), plus one bf16 ulp of the
    larger of the two in bf16."""
    got = np.asarray(got, np.float32)
    bound = F32_TOL * (1.0 + np.abs(want))
    if dtype == "bf16":
        _, e = np.frexp(np.maximum(np.abs(got), np.abs(want)))
        bound = bound + np.ldexp(1.0, e - 8)
    err = np.abs(got - want)
    assert np.all(err <= bound), (
        f"{where}: max err {err.max()}, worst ratio {(err / bound).max()}")


# -- flash_attention ------------------------------------------------------------

#: (hq, hkv, sq, sk, d, causal, window, dtype): MHA, GQA and MQA; sq = sk,
#: sq < sk (right-aligned), sq = 1; causal and not; no window and 16;
#: D 16 and 128; float32 and bf16; sizes off every block multiple
ATTN_CASES = [
    (4, 4, 24, 24, 16, True, None, "f32"),
    (8, 2, 37, 37, 16, True, 16, "bf16"),
    (16, 1, 13, 45, 16, True, 16, "f32"),
    (4, 4, 1, 29, 16, True, None, "bf16"),
    (8, 2, 20, 20, 128, False, None, "f32"),
    (16, 1, 33, 70, 128, True, None, "bf16"),
    (8, 2, 1, 40, 128, False, 16, "f32"),
    (4, 4, 50, 50, 16, False, 16, "bf16"),
    # whisper-large-v3's D = 64 over its 1,500 encoder positions: the
    # encoder's causal self-attention, the decoder's cross-attention (not
    # causal, Sq != Sk)
    (2, 2, 1500, 1500, 64, True, None, "bf16"),
    (4, 4, 7, 1500, 64, False, None, "bf16"),
    (2, 2, 40, 1500, 64, False, None, "f32"),
]


@pytest.mark.parametrize("hq,hkv,sq,sk,d,causal,window,dtype", ATTN_CASES)
def test_flash_attention_plain_matches_reference_oracle_and_pallas(
        ref, hq, hkv, sq, sk, d, causal, window, dtype):
    rng = np.random.default_rng(hq * 1000 + sq * 10 + sk + d)
    q, qn = _normal(rng, (2, hq, sq, d), dtype)
    k, kn = _normal(rng, (2, hkv, sk, d), dtype)
    v, vn = _normal(rng, (2, hkv, sk, d), dtype)
    got = flash_attention_plain(q, k, v, causal=causal, window=window)
    assert got.dtype == q.dtype and got.shape == q.shape
    args = [_jax(x, dtype) for x in (qn, kn, vn)]
    oracle = ref.kref.flash_attention_ref(*args, causal=causal,
                                          window=window)
    kernel = ref.kops.flash_attention(*args, causal=causal, window=window,
                                      use_pallas=True)
    g = got.float().numpy()
    _assert_close(g, _np(oracle), dtype, "oracle")
    _assert_close(g, _np(kernel), dtype, "pallas")


def test_flash_attention_rows_without_keys_give_zeros(ref):
    """sq > sk, causal: the first queries sit at negative positions and see
    no key. The plain version gives zeros there (the kernel's zero-
    denominator guard, with masked keys weighing nothing); the oracle's
    -inf softmax gives NaN. The other rows match the oracle."""
    rng = np.random.default_rng(5)
    q, qn = _normal(rng, (1, 4, 12, 16), "f32")
    k, kn = _normal(rng, (1, 2, 5, 16), "f32")
    v, vn = _normal(rng, (1, 2, 5, 16), "f32")
    got = flash_attention_plain(q, k, v, causal=True).numpy()
    oracle = _np(ref.kref.flash_attention_ref(
        *(_jax(x, "f32") for x in (qn, kn, vn)), causal=True))
    assert np.all(got[:, :, :7] == 0) and np.isnan(oracle[:, :, :7]).all()
    _assert_close(got[:, :, 7:], oracle[:, :, 7:], "f32")


#: (hq, hkv, s, d, causal, window): GQA causal across four chunks, a
#: window, MQA, not causal
ROW_CASES = [(8, 2, 1100, 16, True, None), (16, 1, 700, 32, True, 100),
             (4, 4, 300, 160, False, None), (12, 4, 530, 16, False, 70)]


@pytest.mark.parametrize("hq,hkv,s,d,causal,window", ROW_CASES)
def test_flash_attention_plain_rows_do_not_depend_on_sq(hq, hkv, s, d,
                                                        causal, window):
    """A suffix of query rows computed alone (right-aligned, so at the same
    positions) equals those rows of the full call bit for bit: every
    product is a fixed [PLAIN_ROWS, D] block against one key tile, so a
    row's result depends neither on Sq nor on its neighbours (ROADMAP
    Queue 3 item 10)."""
    rng = np.random.default_rng(hq * 31 + s + d)
    q = _normal(rng, (2, hq, s, d), "bf16")[0]
    k, v = (_normal(rng, (2, hkv, s, d), "bf16")[0] for _ in range(2))
    full = flash_attention_plain(q, k, v, causal=causal, window=window)
    for n in (1, 5, 64, 130):
        part = flash_attention_plain(q[:, :, -n:], k, v, causal=causal,
                                     window=window)
        assert torch.equal(part, full[:, :, -n:]), n


@pytest.mark.parametrize("cache", ["plain", "rolled"])
@pytest.mark.parametrize("g", [1, 4, 12, 16])
@pytest.mark.parametrize("d", [16, 160])
def test_flash_decode_plain_equals_the_last_row_of_prefill(d, g, cache):
    """``flash_decode_plain`` of the newest query over a cache equals, bit
    for bit, the last row of ``flash_attention_plain``'s causal prefill
    over the same keys: a plain cache of 800 keys, or a rolled cache
    holding a 850-key window of 1100 (position P at slot P % 850); either
    way the live keys cross at least three ATTN_CHUNK boundaries. Two batch
    rows at different lengths."""
    rng = np.random.default_rng(d * 100 + g * 7 + len(cache))
    hkv = 2 if g < 16 else 1
    S, window = (800, None) if cache == "plain" else (1100, 850)
    n = S if window is None else window
    for b_len in (S, S - 77):  # the second: a shorter prompt alone
        q = _normal(rng, (1, hkv * g, b_len, d), "bf16")[0]
        k, v = (_normal(rng, (1, hkv, b_len, d), "bf16")[0]
                for _ in range(2))
        full = flash_attention_plain(q, k, v, causal=True, window=window)
        live = min(n, b_len)
        if cache == "plain":
            kc = torch.cat([k, torch.zeros_like(k[:, :, :5])], 2)
            vc = torch.cat([v, torch.zeros_like(v[:, :, :5])], 2)
            got = flash_decode_plain(q[:, :, -1], kc, vc,
                                     torch.tensor([b_len], dtype=torch.int32))
        else:
            slots = torch.tensor([p % n for p in range(b_len - live, b_len)])
            kc = torch.zeros_like(k[:, :, :n]) if b_len >= n else \
                torch.zeros((1, hkv, n, d), dtype=k.dtype)
            vc = torch.zeros_like(kc)
            kc[:, :, slots] = k[:, :, b_len - live:]
            vc[:, :, slots] = v[:, :, b_len - live:]
            got = flash_decode_plain(
                q[:, :, -1], kc, vc, torch.tensor([live], dtype=torch.int32),
                torch.tensor([b_len], dtype=torch.int32))
        assert torch.equal(got, full[:, :, -1]), b_len


@pytest.mark.parametrize("sq", [1, 7, 96])
def test_flash_decode_plain_equals_every_row_of_a_non_causal_prefill(sq):
    """Cross-attention (whisper-large-v3: D = 64, 1,500 encoder keys, all
    live): ``flash_decode_plain`` of any query row over the whole cache
    equals that row of ``flash_attention_plain``'s non-causal prefill bit
    for bit, so a decode step's cross-attention is its prefill row's."""
    rng = np.random.default_rng(sq)
    q = _normal(rng, (2, 4, sq, 64), "bf16")[0]
    k, v = (_normal(rng, (2, 4, 1500, 64), "bf16")[0] for _ in range(2))
    full = flash_attention_plain(q, k, v, causal=False)
    length = torch.full((2,), 1500, dtype=torch.int32)
    for i in {0, sq // 2, sq - 1}:
        assert torch.equal(flash_decode_plain(q[:, :, i], k, v, length),
                           full[:, :, i]), i


def test_attention_constants_match_the_kernels():
    """The plain versions' key tile and chunk are the bf16 kernels'
    (``csrc/attention_mma.cuh``), and ``flash_decode.chunks(S)`` is the most
    chunks that the live keys of S slots can span."""
    import re
    from pathlib import Path

    from repro_torch.kernels.ref import ATTN_CHUNK, ATTN_TILE

    # the module (the package's own name is the ops wrapper)
    fd = importlib.import_module("repro_torch.kernels.flash_decode")

    src = (Path(fd.__file__).parent / "csrc" / "attention_mma.cuh"
           ).read_text()
    assert int(re.search(r"kTile = (\d+);", src).group(1)) == ATTN_TILE
    assert int(re.search(r"kChunk = (\d+);", src).group(1)) == ATTN_CHUNK
    assert fd.chunks(0) == 0
    for S in [*range(1, 600), 4112]:
        most = max((lo + S - 1) // ATTN_CHUNK - lo // ATTN_CHUNK + 1
                   for lo in range(ATTN_CHUNK))
        assert fd.chunks(S) == most, S
    length = torch.tensor([4097, 0, 300], dtype=torch.int32)
    end = torch.tensor([4097, 9, 1000], dtype=torch.int32)
    # 17 chunks, none, then positions 700..999 in chunks 2 and 3
    assert fd.blocks(length, end, 4112, 32, 8) == (3 * 18 * 8, 19 * 8)


# -- flash_decode ---------------------------------------------------------------

DECODE_CASES = [(4, 4, 40, 16, "f32"), (8, 2, 70, 16, "bf16"),
                (16, 1, 33, 128, "f32"), (8, 2, 300, 128, "bf16"),
                # whisper-large-v3's cross-attention cache (D = 64, 1,500
                # slots; length 1,500 is the model's call)
                (4, 4, 1500, 64, "bf16")]


@pytest.mark.parametrize("hq,hkv,s,d,dtype", DECODE_CASES)
def test_flash_decode_plain_matches_reference_oracle_and_pallas(
        ref, hq, hkv, s, d, dtype):
    """Mixed lengths per row: 1, partial, full, and past the cache (the
    kernel clamps to S)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(hq * 100 + s + d)
    b = 4
    q, qn = _normal(rng, (b, hq, d), dtype)
    k, kn = _normal(rng, (b, hkv, s, d), dtype)
    v, vn = _normal(rng, (b, hkv, s, d), dtype)
    length = np.array([1, s // 2 + 1, s, s + 7], np.int32)
    got = flash_decode_plain(q, k, v, torch.from_numpy(length))
    assert got.dtype == q.dtype and got.shape == q.shape
    args = [_jax(x, dtype) for x in (qn, kn, vn)]
    kernel = ref.kops.flash_decode(*args, jnp.asarray(length),
                                   use_pallas=True)
    g = got.float().numpy()
    _assert_close(g, _np(kernel), dtype, "pallas")
    # the oracle masks j < length without clamping to S: equal for length
    # <= S
    oracle = ref.kref.flash_decode_ref(*args, length=jnp.asarray(
        np.minimum(length, s)))
    _assert_close(g, _np(oracle), dtype, "oracle")


def test_flash_decode_length_zero_gives_zeros(ref):
    """``length = 0``: zeros from the plain version and from the reference
    kernel (interpret mode); NaN from the reference's oracle."""
    import jax.numpy as jnp

    rng = np.random.default_rng(9)
    q, qn = _normal(rng, (2, 8, 16), "f32")
    k, kn = _normal(rng, (2, 2, 24, 16), "f32")
    v, vn = _normal(rng, (2, 2, 24, 16), "f32")
    length = np.array([0, 24], np.int32)
    got = flash_decode_plain(q, k, v, torch.from_numpy(length)).numpy()
    args = [_jax(x, "f32") for x in (qn, kn, vn)]
    kernel = _np(ref.kops.flash_decode(*args, jnp.asarray(length),
                                       use_pallas=True))
    oracle = _np(ref.kref.flash_decode_ref(*args, length=jnp.asarray(
        length)))
    assert np.all(got[0] == 0) and np.all(kernel[0] == 0)
    assert np.isnan(oracle[0]).all()
    _assert_close(got[1], kernel[1], "f32")
    _assert_close(got[1], oracle[1], "f32")


def test_flash_decode_end_reads_a_rolled_cache_in_position_order():
    """With ``end``, row b's live keys are the last ``length[b]`` positions
    before ``end[b]``, position P at slot P % S (the model's rolling
    cache): the same as the first ``length`` slots of the cache unrolled
    into position order."""
    rng = np.random.default_rng(11)
    S = 24
    q, _ = _normal(rng, (4, 8, 16), "f32")
    k, _ = _normal(rng, (4, 2, S, 16), "f32")
    v, _ = _normal(rng, (4, 2, S, 16), "f32")
    end = torch.tensor([7, 24, 40, 61], dtype=torch.int32)
    length = torch.tensor([7, 24, 24, 10], dtype=torch.int32)
    got = ops.flash_decode(q, k, v, length, end)
    for b in range(4):
        n, e = int(length[b]), int(end[b])
        order = torch.tensor([p % S for p in range(e - n, e)])
        kb, vb = k[b:b + 1, :, order], v[b:b + 1, :, order]
        want = flash_decode_plain(q[b:b + 1], kb, vb,
                                  torch.tensor([n], dtype=torch.int32))
        np.testing.assert_allclose(got[b:b + 1].numpy(), want.numpy(),
                                   rtol=F32_TOL, atol=F32_TOL)
    # end = length gives the first length slots, as without end
    assert torch.equal(ops.flash_decode(q, k, v, length, length),
                       ops.flash_decode(q, k, v, length))


def test_flash_decode_matches_decode_attention():
    """The model's decode path: ``flash_decode`` with ``length = pos + 1``
    computes ``decode_attention``'s mask ``kpos <= pos`` (float32, where
    the latter's bf16 roundings do not apply)."""
    from repro_torch.models.layers import decode_attention

    rng = np.random.default_rng(13)
    q, _ = _normal(rng, (3, 8, 32), "f32")
    k, _ = _normal(rng, (3, 2, 40, 32), "f32")
    v, _ = _normal(rng, (3, 2, 40, 32), "f32")
    for pos in (0, 17, 39):
        length = torch.full((3,), pos + 1, dtype=torch.int32)
        np.testing.assert_allclose(
            ops.flash_decode(q, k, v, length).numpy(),
            decode_attention(q, k, v, pos).numpy(), rtol=F32_TOL,
            atol=F32_TOL)


# -- wrappers ---------------------------------------------------------------------

def test_attention_wrappers_on_cpu_run_plain_versions_and_count_nothing():
    rng = np.random.default_rng(17)
    before = ops.launch_counts()
    # the model's layout: [B, H, S, D] views of [B, S, H, D] tensors
    q, k, v = (_normal(rng, (2, 11, h, 16), "bf16")[0].transpose(1, 2)
               for h in (8, 2, 2))
    assert not q.is_contiguous()
    got = ops.flash_attention(q, k, v, causal=True, window=4)
    assert torch.equal(got, flash_attention_plain(q, k, v, causal=True,
                                                  window=4))
    qd = q[:, :, 0]
    length = torch.tensor([3, 0], dtype=torch.int32)
    got = ops.flash_decode(qd, k, v, length)
    assert torch.equal(got, flash_decode_plain(qd, k, v, length))
    assert bool((got[1] == 0).all())
    assert ops.launch_counts() == before


@pytest.mark.parametrize("case", ["heads", "head_dim", "dtype_f64",
                                  "mixed", "batch", "kv_shapes",
                                  "last_stride", "window_zero", "not_tensor",
                                  "device", "three_d"])
def test_flash_attention_wrapper_rejects_bad_arguments(case):
    q, k, v = torch.rand(2, 4, 5, 8), torch.rand(2, 2, 6, 8), \
        torch.rand(2, 2, 6, 8)
    kw = {}
    if case == "heads":
        k, v = torch.rand(2, 3, 6, 8), torch.rand(2, 3, 6, 8)
    elif case == "head_dim":
        k, v = torch.rand(2, 2, 6, 4), torch.rand(2, 2, 6, 4)
    elif case == "dtype_f64":
        q, k, v = q.double(), k.double(), v.double()
    elif case == "mixed":
        v = v.to(torch.bfloat16)
    elif case == "batch":
        k, v = torch.rand(3, 2, 6, 8), torch.rand(3, 2, 6, 8)
    elif case == "kv_shapes":
        v = torch.rand(2, 2, 7, 8)
    elif case == "last_stride":
        q = torch.rand(2, 4, 8, 5).transpose(2, 3)
    elif case == "window_zero":
        kw = {"window": 0}
    elif case == "not_tensor":
        q = q.numpy()
    elif case == "device":
        k = k.to("meta")
    elif case == "three_d":
        q = q[0]
    with pytest.raises((TypeError, ValueError)):
        ops.flash_attention(q, k, v, **kw)


@pytest.mark.parametrize("case", ["heads", "length_dtype", "length_shape",
                                  "length_missing", "mixed", "head_dim",
                                  "four_d", "length_device", "end_dtype",
                                  "end_shape"])
def test_flash_decode_wrapper_rejects_bad_arguments(case):
    q, k, v = torch.rand(2, 4, 8), torch.rand(2, 2, 6, 8), \
        torch.rand(2, 2, 6, 8)
    length = torch.tensor([3, 6], dtype=torch.int32)
    end = None
    if case == "end_dtype":
        end = torch.tensor([3, 6])
    elif case == "end_shape":
        end = torch.tensor([3, 6, 9], dtype=torch.int32)
    if case == "heads":
        q = torch.rand(2, 5, 8)
    elif case == "length_dtype":
        length = length.long()
    elif case == "length_shape":
        length = torch.tensor([3], dtype=torch.int32)
    elif case == "length_missing":
        length = None
    elif case == "mixed":
        q = q.to(torch.bfloat16)
    elif case == "head_dim":
        q = torch.rand(2, 4, 4)
    elif case == "four_d":
        q = q[:, :, None]
    elif case == "length_device":
        length = length.to("meta")
    with pytest.raises((TypeError, ValueError)):
        ops.flash_decode(q, k, v, length, end)


# -- the weight product -------------------------------------------------------------

def test_linear_is_matmul_of_the_flattened_rows():
    """``linear`` flattens the leading dims into the rows of ``matmul``
    (the plain float32 product rounded once here), reads a strided weight
    view as it is, and each row comes out as it does alone."""
    rng = np.random.default_rng(19)
    x, _ = _normal(rng, (2, 7, 24), "bf16")
    w = _normal(rng, (3, 24, 40), "bf16")[0][1]    # a layer of a stack
    got = linear(x, w)
    assert got.shape == (2, 7, 40) and got.dtype == torch.bfloat16
    want = (x.float().reshape(14, 24) @ w.float()).to(torch.bfloat16)
    assert torch.equal(got.reshape(14, 40), want)
    before = ops.matmul.launches
    assert torch.equal(linear(x, w.T.contiguous().T), got)
    assert ops.matmul.launches == before


@pytest.mark.parametrize("m", [1, 8, 40, 656])
def test_row_mean_rows_do_not_depend_on_the_row_count(m):
    """The norms' row mean (``x @ ones / n`` through ``matmul``) gives each
    row the same bits whatever the row count, and the mean to float32
    rounding."""
    rng = np.random.default_rng(m + 5)
    x = torch.from_numpy(rng.normal(size=(m, 3, 2048)).astype(np.float32))
    full = row_mean(x)
    assert full.shape == (m, 3, 1)
    for i in range(m):
        assert torch.equal(row_mean(x[i:i + 1])[0], full[i]), i
    torch.testing.assert_close(full, x.double().mean(-1, keepdim=True)
                               .float(), rtol=1e-5, atol=1e-6)


# -- on the card -----------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (chip_smoke.py runs it)")
    return torch.device("cuda")


def _card_close(got, want, v):
    """chip_smoke's tolerance: 1e-5 max|v|, plus one bf16 ulp in bf16."""
    err = (got.float() - want.float()).abs()
    bound = 1e-5 * float(v.float().abs().max()) + torch.zeros_like(err)
    if got.dtype == torch.bfloat16:
        _, e = torch.frexp(torch.maximum(got.float().abs(),
                                         want.float().abs()))
        bound = bound + torch.ldexp(torch.ones_like(bound), e - 8)
    return bool((err <= bound).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cuda_flash_attention_matches_plain_version(dtype):
    dev = _cuda()
    rng = np.random.default_rng(43)
    for hq, hkv, sq, sk, d, causal, window, _ in ATTN_CASES + [
            (16, 1, 300, 300, 256, True, 64, None),
            (32, 8, 130, 130, 128, True, None, None),
            (4, 4, 90, 40, 32, True, None, None),
            # across chunks: sq < sk, a window, head dims 160 and 36 (no
            # 16-byte rows: plain loads), not causal
            (32, 8, 520, 1100, 128, True, None, None),
            (16, 1, 800, 800, 256, True, 300, None),
            (32, 8, 600, 600, 160, True, None, None),
            (4, 2, 150, 700, 36, False, None, None)]:
        q, k, v = (_normal(rng, (2, s, h, d), dtype)[0].to(dev)
                   .transpose(1, 2) for h, s in ((hq, sq), (hkv, sk),
                                                 (hkv, sk)))
        before = ops.flash_attention.launches
        got = ops.flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        assert ops.flash_attention.launches == before + 1
        want = flash_attention_plain(q, k, v, causal=causal, window=window)
        assert _card_close(got, want, v)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cuda_flash_decode_matches_plain_version(dtype):
    dev = _cuda()
    rng = np.random.default_rng(47)
    from repro_torch.kernels import build

    fd = importlib.import_module("repro_torch.kernels.flash_decode")
    lib = build.load("flash_decode")  # the grid the C side takes
    for S in (0, 1, 255, 256, 257, 4112):
        assert lib.flash_decode_chunks(S) == fd.chunks(S), S
    for hq, hkv, s, d, _ in DECODE_CASES + [(16, 1, 2048, 256, None),
                                            (32, 8, 4112, 128, None),
                                            (48, 4, 900, 128, None),
                                            (32, 8, 1100, 160, None),
                                            (8, 2, 600, 36, None)]:
        q, k, v = (_normal(rng, shape, dtype)[0].to(dev) for shape in (
            (4, hq, d), (4, hkv, s, d), (4, hkv, s, d)))
        length = torch.tensor([0, 1, s // 2 + 1, s], dtype=torch.int32,
                              device=dev)
        before = ops.flash_decode.launches
        got = ops.flash_decode(q, k, v, length)
        torch.cuda.synchronize()
        assert ops.flash_decode.launches == before + 1
        assert bool((got[0] == 0).all())
        assert _card_close(got, flash_decode_plain(q, k, v, length), v)
        # a rolled cache read in position order
        end = length + torch.tensor([0, 5, s + 3, 2 * s + 1],
                                    dtype=torch.int32, device=dev)
        got = ops.flash_decode(q, k, v, length, end)
        assert _card_close(got, flash_decode_plain(q, k, v, length, end), v)


@pytest.mark.gpu
def test_cuda_decode_equals_attention_of_the_last_row():
    """The kernels' shared arithmetic: flash_decode of a query over keys
    0..S-1 (and over a rolled cache holding a window of them) equals, bit
    for bit, flash_attention's last row of a causal (windowed) prefill of
    S tokens. The bf16 kernels hold a query row in another row slot of
    the mma instruction (decode: the group's heads; prefill: the row's
    place in its tile), so this also checks that the slot does not change
    a row's bits. llama3-8b's long cache (4097 keys over 17 chunks), G = 4
    at D = 160, starcoder2-15b's G = 12, recurrentgemma-9b's G = 16 past
    its 2048-key window, and D = 36 (plain loads)."""
    dev = _cuda()
    rng = np.random.default_rng(53)
    for hq, hkv, S, d, window in [(32, 8, 83, 128, None),
                                  (16, 1, 300, 256, 100),
                                  (8, 2, 1000, 64, None),
                                  (32, 8, 4097, 128, None),
                                  (32, 8, 700, 160, None),
                                  (48, 4, 900, 128, None),
                                  (16, 1, 2304, 256, 2048),
                                  (8, 2, 600, 36, None)]:
        q, k, v = (_normal(rng, (2, h, S, d), "bf16")[0].to(dev)
                   for h in (hq, hkv, hkv))
        full = ops.flash_attention(q, k, v, causal=True, window=window)
        n = S if window is None else min(S, window)
        length = torch.full((2,), n, dtype=torch.int32, device=dev)
        end = torch.full((2,), S, dtype=torch.int32, device=dev)
        # the cache of the last n positions, position P at slot P % n
        slots = torch.tensor([p % n for p in range(S - n, S)], device=dev)
        kc = torch.empty_like(k[:, :, :n])
        vc = torch.empty_like(v[:, :, :n])
        kc[:, :, slots], vc[:, :, slots] = k[:, :, S - n:], v[:, :, S - n:]
        got = ops.flash_decode(q[:, :, -1], kc, vc, length, end)
        torch.cuda.synchronize()
        diff = got != full[:, :, -1]
        assert not bool(diff.any()), (
            f"{(hq, hkv, S, d, window)}: {int(diff.sum())} of "
            f"{diff.numel()} differ, max "
            f"{float((got.float() - full[:, :, -1].float()).abs().max())}")


@pytest.mark.gpu
def test_cuda_cross_decode_equals_every_row_of_a_non_causal_prefill():
    """whisper-large-v3's cross-attention on the card: flash_decode of a
    query over all 1,500 encoder keys (D = 64, 20 heads) equals, bit for
    bit, that row of flash_attention's non-causal prefill, at the serve
    batch's prompt rows and the transcription batch's 4."""
    dev = _cuda()
    rng = np.random.default_rng(59)
    for b, sq in ((8, 95), (4, 4)):
        q = _normal(rng, (b, sq, 20, 64), "bf16")[0].to(dev).transpose(1, 2)
        k, v = (_normal(rng, (b, 1500, 20, 64), "bf16")[0].to(dev)
                .transpose(1, 2).contiguous() for _ in range(2))
        full = ops.flash_attention(q, k, v, causal=False)
        length = torch.full((b,), 1500, dtype=torch.int32, device=dev)
        for i in range(sq):
            got = ops.flash_decode(q[:, :, i], k, v, length)
            diff = got != full[:, :, i]
            assert not bool(diff.any()), (b, sq, i, int(diff.sum()))


@pytest.mark.gpu
@pytest.mark.parametrize("m", [8, 40, 656, 8192])
def test_cuda_row_mean_rows_do_not_depend_on_the_row_count(m):
    """On the card too: the norms' row means, bit for bit against the row
    alone (torch's own mean and var are not, at these shapes)."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(m, 2048, device=dev, generator=g) * 3
    full = row_mean(x * x)
    for i in range(m):
        assert torch.equal(row_mean(x[i:i + 1] * x[i:i + 1])[0], full[i]), i


@pytest.mark.gpu
def test_cuda_row_mean_takes_more_rows_than_a_grid_dimension():
    """65,600 rows of d = 4096 (a long prefill's norm): the first level is
    [4,198,400, 64] @ ones, past the 65,535 row tiles that one grid
    dimension but the first can number. Rows near both ends and across the
    range equal the row alone, and the mean is the float64 one to float32
    rounding."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn(65600, 4096, device=dev, generator=g)
    full = row_mean(x)
    rows = [*range(64), *range(64, 65536, 997), *range(65536, 65600)]
    for i in rows:
        assert torch.equal(row_mean(x[i:i + 1])[0], full[i]), i
    torch.testing.assert_close(full, x.double().mean(-1, keepdim=True)
                               .float(), rtol=1e-5, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("m", [8, 40, 656, 8192])
@pytest.mark.parametrize("k,n", [(4096, 14336), (14336, 4096)])
def test_cuda_linear_rows_do_not_depend_on_the_row_count(k, n, m):
    """Every row of ``linear(x[:M], w)`` equals ``linear(x[i:i+1], w)`` bit
    for bit in bf16, at a decode step's, a smoke batch's, the serve
    batch's prefill and the long batch's row counts (each a different
    block plan of the kernel): what makes prefill(S) + decode_step equal
    prefill(S+1) on the card."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(m, k, device=dev, generator=g).to(torch.bfloat16)
    w = (torch.randn(k, n, device=dev, generator=g) * k ** -0.5).to(
        torch.bfloat16)
    full = linear(x, w)
    for i in range(x.shape[0]):
        assert torch.equal(linear(x[i:i + 1], w)[0], full[i]), i
