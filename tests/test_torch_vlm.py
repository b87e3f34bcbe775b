"""The port's vision-patch prefix and its training forward and backward
(``Model.prefill(patches=)``, ``Model.loss_fn``, the ``matmul`` and
``flash_attention`` autograd Functions) against the reference's.

The same seeded numpy inputs and the same weights (the reference's
parameter tree carried across by ``convert.model_params_from_fields``) go
through both. Tolerances:

- prefill logits with the patch prefix: ``test_torch_models.F32`` (a
  relative and absolute 1e-5) in float32; in bf16 the reference's model
  with its TPU kernels' attention (``test_torch_models.tpu_attention``),
  bit for bit as the other smoke models are.
- ``loss_fn`` in float32: the loss within a relative 1e-5, each gradient
  within 1e-4 of its leaf's largest magnitude (measured: ~2e-6; XLA and
  torch sum in other orders, the port's attention backward recomputes the
  probabilities from the forward's output, and XLA differentiates its
  chunked online softmax).
- the autograd Functions against autograd through their plain versions:
  a relative 1e-5 of each gradient's scale in float32 (the backward is
  the same math in another order), 2e-2 in bf16 (one bf16 rounding of
  each gradient).
"""
import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.convert import model_params_from_fields
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.kernels import ops, ref as kref
from repro_torch.models import Model
from repro_torch.models.model import train_launches
from repro_torch.training import train_params
from tests.test_torch_harness import reference
from tests.test_torch_models import F32, RECURRENT, flat, tpu_attention

VLM = "internvl2-76b"
#: configs whose loss and gradients are held against the reference
TRAINED = (VLM, "llama3-8b", "olmoe-1b-7b", "whisper-large-v3")
GRAD_OF_SCALE = 1e-4
LOSS_RTOL = 1e-5


@pytest.fixture(scope="module")
def ref():
    return reference()


def build(ref, arch, dtype="float32", seed=0):
    """(cfg, reference Model, its params, the port's Model), the same
    weights."""
    import jax

    cfg = dataclasses.replace(ref.configs.get_smoke_config(arch),
                              dtype=dtype, kv_dtype=dtype)
    jm = ref.models.Model(cfg)
    params = jm.init(jax.random.PRNGKey(seed))
    port_cfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype,
                                   kv_dtype=dtype)
    port = model_params_from_fields(
        port_cfg, jax.tree_util.tree_map(np.asarray, params), device="cpu")
    return cfg, jm, params, port


def patches(cfg, b, seed):
    return np.random.default_rng(seed).normal(
        0, 0.02, (b, cfg.vision_patches, cfg.d_model)).astype(np.float32)


def tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


# -- serving with the patch prefix --------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_with_patches_matches_reference(ref, dtype):
    import jax.numpy as jnp

    cfg, jm, params, port = build(ref, VLM, dtype)
    toks, pt = tokens(cfg, 2, 12, 1), patches(cfg, 2, 2)
    cache_len = cfg.vision_patches + 16
    with (tpu_attention(ref) if dtype == "bfloat16"
          else contextlib.nullcontext()):
        want, wcache = jm.prefill(params, jnp.asarray(toks), cache_len,
                                  patches=jnp.asarray(pt))
    got, gcache = port.prefill(torch.from_numpy(toks), cache_len,
                               patches=torch.from_numpy(pt))
    w = np.asarray(want.astype(jnp.float32))
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got.float().numpy(), w)
    else:
        np.testing.assert_allclose(got.numpy(), w, **F32)
        a, b = flat(gcache), flat(wcache)
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_allclose(a[k], b[k], err_msg=k, **F32)
    # the prefix is there: without it the logits differ
    alone, _ = port.prefill(torch.from_numpy(toks), cache_len)
    assert not torch.equal(alone, got)


@pytest.mark.parametrize("s", [5, 12])
def test_decode_after_patch_prefix_equals_prefill_of_one_more_token(s):
    """bf16: prefill(S) with the prefix + decode_step at position P + S ==
    prefill(S+1) with the same prefix, bit for bit (every product's rows
    independent of the row count)."""
    cfg = get_smoke_config(VLM)
    m = Model(cfg, device="cpu").init(torch.Generator().manual_seed(3))
    toks = torch.from_numpy(tokens(cfg, 2, s + 1, 4))
    pt = torch.from_numpy(patches(cfg, 2, 5))
    cache_len = cfg.vision_patches + s + 4
    full, _ = m.prefill(toks, cache_len, patches=pt)
    _, cache = m.prefill(toks[:, :s], cache_len, patches=pt)
    dec, _ = m.decode_step(cache, toks[:, s], cfg.vision_patches + s)
    assert torch.equal(dec, full)


# -- training: loss and gradients against the reference ---------------------

@pytest.mark.parametrize("arch", TRAINED + RECURRENT)
def test_loss_and_gradients_match_reference(ref, arch):
    import jax
    import jax.numpy as jnp

    cfg, jm, params, port = build(ref, arch)
    batch = SyntheticLM(port.cfg, DataConfig(seq_len=24, global_batch=2)
                        ).batch(0)
    (want, _), grads = jax.value_and_grad(jm.loss_fn, has_aux=True)(
        params, jax.tree_util.tree_map(jnp.asarray, batch))
    tp = train_params(port)
    loss, mets = port.loss_fn(batch)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want),
                               rtol=LOSS_RTOL)
    assert float(mets["tokens"]) == float(batch["loss_mask"].sum())
    wg = flat(grads)
    assert sorted(wg) == sorted(tp)
    for name, p in tp.items():
        w = wg[name]
        g = (np.zeros_like(w) if p.grad is None else p.grad.numpy())
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g - w).max())
        assert err <= GRAD_OF_SCALE * scale, (name, err, scale)


#: the bf16 gap to the shipped reference, a reading: its chunked attention
#: rounds ``q * scale`` and ``p`` to bf16 and the port's kernels do not
#: (ROADMAP Queue 3 item 9). Measured: the loss 7e-5 to 1.3e-3 apart
#: (relative), the dense configs' gradients 1.8-2.8% of each leaf's
#: largest magnitude; olmoe's gradients 45% (a different bf16 hidden
#: state flips expert choices, so whole expert gradients move: a reading)
BF16_LOSS_GAP = 5e-3
BF16_GRAD_GAP = 5e-2


@pytest.mark.parametrize("arch", TRAINED)
def test_bf16_gap_to_the_shipped_reference_is_attention_rounding(ref, arch):
    import jax
    import jax.numpy as jnp

    cfg, jm, params, port = build(ref, arch, "bfloat16")
    batch = SyntheticLM(port.cfg, DataConfig(seq_len=24, global_batch=2)
                        ).batch(0)
    (want, _), grads = jax.value_and_grad(jm.loss_fn, has_aux=True)(
        params, jax.tree_util.tree_map(jnp.asarray, batch))
    tp = train_params(port)
    loss, _ = port.loss_fn(batch)
    loss.backward()
    assert abs(float(loss.detach()) - float(want)) <= BF16_LOSS_GAP * abs(
        float(want))
    wg = flat(grads)
    gap = max(float(np.abs(p.grad.float().numpy() - wg[k]).max())
              / max(float(np.abs(wg[k]).max()), 1e-30)
              for k, p in tp.items() if p.grad is not None)
    assert np.isfinite(gap)
    if not port.cfg.num_experts:
        assert gap <= BF16_GRAD_GAP, gap


def test_patch_prefix_is_dropped_from_the_loss(ref):
    """The loss covers the text positions only; the patches still shape it
    through attention, and their embeddings take no gradient."""
    cfg, _, _, port = build(ref, VLM)
    batch = SyntheticLM(port.cfg, DataConfig(seq_len=16, global_batch=2)
                        ).batch(1)
    tp = train_params(port)
    pt = torch.from_numpy(batch["patches"]).requires_grad_(True)
    loss, mets = port.loss_fn(dict(batch, patches=pt))
    loss.backward()
    assert float(mets["tokens"]) == 2 * 15
    assert pt.grad is not None and float(pt.grad.abs().max()) > 0
    other, _ = port.loss_fn(dict(batch, patches=batch["patches"] * 2))
    assert float(other) != float(loss)
    assert all(p.grad is not None for n, p in tp.items()
               if "cross" not in n)


#: kernel name -> the plain version the CPU runs in its place
PLAINS = {"matmul": "matmul_plain",
          "flash_attention": "flash_attention_plain",
          "rglru": "rglru_plain", "rglru_bwd": "rglru_backward_plain",
          "rwkv6": "rwkv6_plain", "rwkv6_bwd": "rwkv6_backward_plain"}


@pytest.mark.parametrize("arch", ["llama3-8b", VLM, "olmoe-1b-7b",
                                  "whisper-large-v3", *RECURRENT])
@pytest.mark.parametrize("remat", [True, False])
def test_train_launches_counts_every_product(monkeypatch, arch, remat):
    """``train_launches`` against the kernel calls of one loss and backward,
    counted through the plain versions the CPU runs in their place: the
    products, attention, and the recurrences' forwards and backwards."""
    counts = dict.fromkeys(PLAINS, 0)

    def counted(name, fn):
        def run(*a, **k):
            counts[name] += 1
            return fn(*a, **k)
        return run

    for name, plain in PLAINS.items():
        monkeypatch.setattr(ops, plain, counted(name, getattr(ops, plain)))
    cfg = get_smoke_config(arch)
    m = Model(cfg, device="cpu", remat=remat, loss_chunk=8).init(
        torch.Generator().manual_seed(0))
    m.requires_grad_(True)
    loss, _ = m.loss_fn(SyntheticLM(cfg, DataConfig(20, 2)).batch(0))
    loss.backward()
    assert counts == train_launches(cfg, 20, 8, remat)


def test_remat_gives_the_same_gradients():
    cfg = get_smoke_config("llama3-8b")
    batch = SyntheticLM(cfg, DataConfig(24, 2)).batch(2)
    grads = []
    for remat in (True, False):
        m = Model(cfg, device="cpu", remat=remat, loss_chunk=8).init(
            torch.Generator().manual_seed(5))
        tp = train_params(m)
        loss, _ = m.loss_fn(batch)
        loss.backward()
        grads.append({k: p.grad.clone() for k, p in tp.items()})
    for k in grads[0]:
        assert torch.equal(grads[0][k], grads[1][k]), k


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_configs_refuse_training_on_every_device(arch):
    """Once refused (their kernels had no backward), the recurrent configs
    now train on every device: the full config on the meta device and the
    CPU's smoke config each take a loss and its backward, every trainable
    parameter gets a gradient of its shape, finite on the CPU."""
    for cfg, dev in ((get_config(arch), "meta"),
                     (get_smoke_config(arch), "cpu")):
        m = Model(cfg, device=dev)
        if dev == "cpu":
            m.init(torch.Generator().manual_seed(0))
        tp = train_params(m)
        loss, _ = m.loss_fn({"tokens": np.zeros((1, 4), np.int32)})
        loss.backward()
        assert loss.device.type == dev
        for name, p in tp.items():
            assert p.grad is not None and p.grad.shape == p.shape, name
            if dev == "cpu":
                assert torch.isfinite(p.grad).all(), name


def test_serving_stays_out_of_autograd():
    """prefill and decode_step run under inference mode even on a trainable
    model: no graph, no gradient."""
    cfg = get_smoke_config("llama3-8b")
    m = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    train_params(m)
    logits, cache = m.prefill(torch.from_numpy(tokens(cfg, 2, 6, 0)), 8)
    assert not logits.requires_grad and logits.is_inference()
    assert all(p.grad is None for p in m.parameters())


# -- the autograd Functions ----------------------------------------------------

def _grads(fn, inputs, seed):
    """Gradients of sum(fn(*inputs) * w) for a seeded random w."""
    xs = [x.detach().clone().requires_grad_(x.requires_grad)
          for x in inputs]
    out = fn(*xs)
    w = torch.from_numpy(np.random.default_rng(seed).normal(
        0, 1, tuple(out.shape)).astype(np.float32)).to(out.device, out.dtype)
    (out.float() * w.float()).sum().backward()
    return out, [x.grad for x in xs]


def _close(got, want, rel):
    scale = max(float(want.float().abs().max()), 1e-30)
    assert float((got.float() - want.float()).abs().max()) <= rel * scale


@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("layout", ["dense", "x_transposed", "y_transposed",
                                    "y_frozen", "x_frozen"])
def test_matmul_function_gradients_match_autograd_of_plain(dtype, rel,
                                                           layout):
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(0, 1, (37, 70)).astype(np.float32))
    y = torch.from_numpy(rng.normal(0, 1, (70, 45)).astype(np.float32))
    x, y = x.to(dtype), y.to(dtype)
    if layout == "x_transposed":
        x = x.T.contiguous().T
    if layout == "y_transposed":
        y = y.T.contiguous().T
    x.requires_grad_(layout != "x_frozen")
    y.requires_grad_(layout != "y_frozen")
    out, got = _grads(ops.matmul, (x, y), 8)
    plain_out, want = _grads(kref.matmul_plain, (x, y), 8)
    assert torch.equal(out.detach(), plain_out.detach())
    for g, w, t in zip(got, want, (x, y)):
        if not t.requires_grad:
            assert g is None and w is None
            continue
        assert g.dtype == dtype and g.shape == t.shape
        _close(g, w, rel)


@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("hq,hkv,sq,sk,causal,window", [
    (4, 4, 16, 16, True, None),
    (8, 2, 16, 16, True, None),
    (8, 2, 9, 21, True, None),
    (4, 2, 20, 20, True, 6),
    (4, 1, 7, 300, False, None),
    (4, 2, 12, 5, True, None),       # Sq > Sk: rows with no live key
])
def test_flash_attention_function_gradients_match_autograd_of_plain(
        monkeypatch, dtype, rel, hq, hkv, sq, sk, causal, window):
    rng = np.random.default_rng(hq * 100 + sq + sk)
    d = 16
    q, k, v = (torch.from_numpy(rng.normal(0, 1, (2, h, s, d)).astype(
        np.float32)).to(dtype).requires_grad_(True)
        for h, s in ((hq, sq), (hkv, sk), (hkv, sk)))
    # small chunks of query rows, so the backward's chunking is exercised
    monkeypatch.setattr(ops, "BWD_SCORE_ELEMS", 2 * hq * sk * 3)

    def fa(fn):
        return lambda q, k, v: fn(q, k, v, causal=causal, window=window)

    out, got = _grads(fa(ops.flash_attention), (q, k, v), 9)
    plain_out, want = _grads(fa(kref.flash_attention_plain), (q, k, v), 9)
    assert torch.equal(out.detach(), plain_out.detach())
    for g, w in zip(got, want):
        assert g.dtype == dtype
        _close(g, w, rel)


def test_flash_attention_backward_matches_reference_autodiff(ref):
    """The torch backward against XLA's autodiff of the reference's
    ``chunked_attention`` (float32, GQA, causal, right-aligned queries)."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(11)
    q, k, v = (rng.normal(0, 1, (2, h, s, 32)).astype(np.float32)
               for h, s in ((8, 10), (2, 24), (2, 24)))
    w = rng.normal(0, 1, (2, 8, 10, 32)).astype(np.float32)

    def loss(q, k, v):
        return jnp.sum(ref.layers.chunked_attention(q, k, v, causal=True)
                       * w)

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    (ops.flash_attention(tq, tk, tv) * torch.from_numpy(w)).sum().backward()
    for g, wg in zip((tq.grad, tk.grad, tv.grad), want):
        _close(g, torch.from_numpy(np.array(wg)), 1e-5)


# -- on the card -----------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (chip_smoke.py runs it)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_cuda_matmul_function_launches_forward_and_two_backward(dtype, rel):
    """On the card the Function's forward and both backward products are
    kernel launches; the gradients equal the CPU's within the CPU test's
    tolerance."""
    dev = _cuda()
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.normal(0, 1, (300, 512)).astype(np.float32))
    y = torch.from_numpy(rng.normal(0, 1, (512, 384)).astype(np.float32))
    x, y = x.to(dtype), y.to(dtype)
    before = ops.matmul.launches
    out, got = _grads(ops.matmul, (x.to(dev).requires_grad_(True),
                                   y.to(dev).requires_grad_(True)), 13)
    torch.cuda.synchronize()
    assert ops.matmul.launches == before + 3
    _, want = _grads(kref.matmul_plain, (x.requires_grad_(True),
                                         y.requires_grad_(True)), 13)
    for g, w in zip(got, want):
        _close(g.cpu(), w, rel)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_cuda_flash_attention_function_gradients_match_cpu(dtype, rel):
    dev = _cuda()
    rng = np.random.default_rng(14)
    q, k, v = (torch.from_numpy(rng.normal(0, 1, (2, h, s, 64)).astype(
        np.float32)).to(dtype) for h, s in ((8, 200), (2, 300), (2, 300)))
    before = ops.flash_attention.launches
    _, got = _grads(lambda *a: ops.flash_attention(*a, window=128),
                    tuple(t.to(dev).requires_grad_(True) for t in (q, k, v)),
                    15)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == before + 1
    _, want = _grads(lambda *a: kref.flash_attention_plain(*a, window=128),
                     tuple(t.requires_grad_(True) for t in (q, k, v)), 15)
    for g, w in zip(got, want):
        _close(g.cpu(), w, rel)


@pytest.mark.gpu
def test_cuda_loss_and_gradients_match_cpu():
    """internvl2's smoke config in float32 with patches: the card's loss
    and gradients against the CPU's (IEEE float32 products), launches
    exactly ``train_launches``."""
    from repro_torch.core.precision import ieee_float32

    dev = _cuda()
    cfg = dataclasses.replace(get_smoke_config(VLM), dtype="float32",
                              kv_dtype="float32")
    cpu = Model(cfg, device="cpu").init(torch.Generator().manual_seed(6))
    card = Model(cfg, device=dev)
    card.load_state_dict(cpu.state_dict())
    batch = SyntheticLM(cfg, DataConfig(40, 2)).batch(3)
    grads = []
    for m in (card, cpu):
        tp = train_params(m)
        ops.reset_launch_counts()
        with ieee_float32():
            loss, _ = m.loss_fn(batch)
            loss.backward()
        if m is card:
            counts = ops.launch_counts()
        grads.append((float(loss.detach()), {k: p.grad.cpu()
                                             for k, p in tp.items()}))
    want = train_launches(cfg, 40)
    assert {k: counts[k] for k in want} == want
    np.testing.assert_allclose(grads[0][0], grads[1][0], rtol=LOSS_RTOL)
    for k, w in grads[1][1].items():
        _close(grads[0][1][k], w, GRAD_OF_SCALE)
