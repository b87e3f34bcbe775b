"""The port's encoder-decoder (``whisper-large-v3``: ``Model._encode``,
the decoder's cross-attention, the ``ck``/``cv`` caches) against the
reference's, at ``whisper-smoke`` (2 encoder + 2 decoder layers, d 64, 4
heads of 16, 24 frames).

The same seeded numpy inputs (tokens, frames drawn N(0, 0.02) as the
reference's data pipeline draws them) and the reference's parameter tree
(carried across by ``convert.model_params_from_fields``) go through both.
Tolerances are ``tests/test_torch_models.py``'s: ``F32`` in float32,
``BF16`` in bf16.

- float32: against the reference's ``Model`` as it ships.
- bf16: against the reference with its TPU attention kernels' function in
  place of ``chunked_attention`` / ``decode_attention``
  (``test_torch_models.tpu_attention``, as for the other configs) and its
  encoder unrolled (:func:`unrolled_encoder`: the same layer function,
  called once per layer). The shipped reference scans its encoder layers
  in one ``lax.scan``, and inside the scan body XLA keeps bf16
  intermediates in float32 where the op-by-op run rounds (the reason the
  reference's own serving modes unroll the decoder, its
  ``Model.scan_serving``). The port unrolls the encoder as it unrolls the
  decoder, so it rounds as the op-by-op run does; against the shipped
  model the gap is that scan's rounding plus the attention rounding of
  ROADMAP Queue 3 item 9 (:func:`test_bf16_gap_to_the_shipped_reference_
  is_attention_and_scan_rounding`).

As in the reference, the encoder's layers are the decoder's layer function:
causal self-attention with RoPE (whisper's encoder is bidirectional with
sinusoidal positions; ROADMAP Queue 3 records it).
"""
import contextlib
import dataclasses
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.convert import model_params_from_fields, \
    tensor_from_array
from repro_torch.models import Model
from repro_torch.models import model as TMM
from repro_torch.serving import InferenceEngine, Request
from tests.test_torch_harness import reference
from tests.test_torch_models import (BF16, F32, GAP_OF_SCALE, flat,
                                     tpu_attention)

ARCH = "whisper-large-v3"
DTYPES = ("float32", "bfloat16")
#: prompt tokens of the whole-model cases, and the cache they go into
S, CACHE = 12, 16


@pytest.fixture(scope="module")
def ref():
    return reference()


def tol(dtype):
    return F32 if dtype == "float32" else BF16


def smoke(dtype):
    return dataclasses.replace(get_smoke_config(ARCH), dtype=dtype,
                               kv_dtype=dtype)


@pytest.fixture(scope="module")
def pair(ref):
    """(reference Model, reference params, port Model) per dtype."""
    built = {}

    def get(dtype):
        if dtype not in built:
            jax = ref.jax
            cfg = dataclasses.replace(ref.configs.get_smoke_config(ARCH),
                                      dtype=dtype, kv_dtype=dtype)
            jm = ref.models.Model(cfg, remat=False)
            params = jm.init(jax.random.PRNGKey(0))
            port = model_params_from_fields(
                smoke(dtype), jax.tree_util.tree_map(np.asarray, params),
                device="cpu")
            built[dtype] = (jm, params, port)
        return built[dtype]

    return get


def inputs(b=2, s=S + 2, seed=0):
    """Tokens [b, s] and frames [b, 24, 64] (N(0, 0.02), the reference
    data pipeline's draw), float32."""
    cfg = get_smoke_config(ARCH)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    frames = rng.normal(0, 0.02, (b, cfg.encoder_seq, cfg.d_model)).astype(
        np.float32)
    return toks, frames


@contextlib.contextmanager
def unrolled_encoder(ref):
    """The reference's ``Model._encode`` with its layer scan unrolled: the
    same ``_layer_apply`` of each stacked layer in turn (restored on
    exit)."""
    import jax
    import jax.numpy as jnp

    mm = sys.modules["repro.models.model"]
    saved = mm.Model._encode

    def encode(self, params, frames):
        enc = params["encoder"]
        x = frames + enc["pos_embed"][None, :frames.shape[1]]
        positions = jnp.broadcast_to(jnp.arange(frames.shape[1]),
                                     frames.shape[:2])
        for li in range(self.cfg.encoder_layers):
            lp = jax.tree_util.tree_map(lambda a: a[li], enc["layers"])
            x, _ = mm._layer_apply(self.encoder_cfg(), "attn", lp, x,
                                   positions, "train", None, None, 0, None,
                                   self.shard, self.use_pallas,
                                   self.moe_dispatch)
        return ref.layers.apply_norm(self.cfg, enc["final_norm"], x)

    mm.Model._encode = encode
    try:
        yield
    finally:
        mm.Model._encode = saved


def as_reference(ref, dtype):
    """The reference as the port is held to it in ``dtype``: as it ships in
    float32; in bf16 with the kernels' attention and the encoder
    unrolled."""
    if dtype == "float32":
        return contextlib.nullcontext()
    stack = contextlib.ExitStack()
    stack.enter_context(tpu_attention(ref))
    stack.enter_context(unrolled_encoder(ref))
    return stack


def to_jax(x, dtype):
    import jax.numpy as jnp

    return jnp.asarray(x, jnp.float32).astype(getattr(jnp, dtype))


def close(got, want, where, dtype):
    import jax.numpy as jnp

    assert got.dtype == tensor_from_array(np.asarray(want)).dtype, where
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               err_msg=where, **tol(dtype))


# -- the encoder and one cross-attention layer ------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_encode_matches_reference(ref, pair, dtype):
    jm, params, port = pair(dtype)
    _, frames = inputs()
    with as_reference(ref, dtype):
        want = jm._encode(params, to_jax(frames, dtype))
    got = port._encode(torch.from_numpy(frames).to(port.embed.dtype))
    assert got.shape == (2, 24, 64)
    close(got, want, "encoder output", dtype)


@pytest.mark.parametrize("mode", ["prefill", "decode"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_cross_attention_layer_matches_reference(ref, pair, dtype, mode):
    """Decoder layer 0 (self-attention, cross-attention over an encoder
    output, FFN) in prefill mode (its k/v and ck/cv caches) and in decode
    mode over the caches a prefill left (one token at position S; the
    cross caches come back unchanged)."""
    import jax
    import jax.numpy as jnp

    jm, params, port = pair(dtype)
    mm = sys.modules["repro.models.model"]
    cfg = port.cfg
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, S, cfg.d_model)).astype(np.float32)
    enc = rng.normal(size=(2, cfg.encoder_seq, cfg.d_model)).astype(
        np.float32)
    jp = jax.tree_util.tree_map(lambda a: a[0],
                                params["scan_layers"]["slot0"])
    tp = port.scan_layers["slot0"].tree(0)
    pos = np.broadcast_to(np.arange(S), (2, S))
    with as_reference(ref, dtype):
        yj, cj = mm._layer_apply(jm.cfg, "attn", jp, to_jax(x, dtype),
                                 jnp.asarray(pos), "prefill", None, None,
                                 CACHE, to_jax(enc, dtype), jm.shard, False)
        yt, ct = TMM._layer_apply(
            cfg, "attn", tp, tensor_from_array(np.asarray(to_jax(x, dtype))),
            torch.from_numpy(pos.copy()), "prefill", None, None, CACHE,
            enc_out=tensor_from_array(np.asarray(to_jax(enc, dtype))))
        if mode == "decode":
            x1 = to_jax(rng.normal(size=(2, 1, cfg.d_model)), dtype)
            yj, cj = mm._layer_apply(jm.cfg, "attn", jp, x1,
                                     jnp.full((2, 1), S), "decode", cj,
                                     jnp.int32(S), 0, None, jm.shard, False)
            ck = ct["ck"]
            yt, ct = TMM._layer_apply(
                cfg, "attn", tp, tensor_from_array(np.asarray(x1)),
                torch.full((2, 1), S), "decode", ct, S, 0)
            assert ct["ck"] is ck
    close(yt, yj, f"{mode} output", dtype)
    assert sorted(ct) == sorted(cj) == ["ck", "cv", "k", "v"]
    for k in ct:
        close(ct[k], cj[k], f"{mode} cache {k}", dtype)


# -- the whole model ----------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_and_decode_match_reference(ref, pair, dtype):
    """prefill logits and caches (``k``, ``v``, ``ck``, ``cv``: S tokens
    into CACHE slots, Se = 24 cross slots), then two decode steps' logits
    and caches."""
    import jax.numpy as jnp

    jm, params, port = pair(dtype)
    toks, frames = inputs()
    with as_reference(ref, dtype):
        lj, cj = jm.prefill(params, jnp.asarray(toks[:, :S]), cache_len=CACHE,
                            frames=jnp.asarray(frames))
        lt, ct = port.prefill(torch.from_numpy(toks[:, :S]), cache_len=CACHE,
                              frames=torch.from_numpy(frames))
        assert lt.shape == (2, port.cfg.vocab_size)
        close(lt, lj, "prefill logits", dtype)
        want = flat(cj)
        got = flat(ct)
        assert sorted(got) == sorted(want) == [
            f"scan.slot0.{k}" for k in ("ck", "cv", "k", "v")]
        assert got["scan.slot0.ck"].shape == (2, 2, 4, 24, 16)
        for k in got:
            np.testing.assert_allclose(got[k], want[k], err_msg=k,
                                       **tol(dtype))
        for p in (S, S + 1):
            lj, cj = jm.decode_step(params, cj, jnp.asarray(toks[:, p]),
                                    jnp.int32(p))
            lt, ct = port.decode_step(ct, torch.from_numpy(toks[:, p]), p)
            close(lt, lj, f"decode {p}", dtype)
            want, got = flat(cj), flat(ct)
            for k in got:
                np.testing.assert_allclose(got[k], want[k],
                                           err_msg=f"decode {p} {k}",
                                           **tol(dtype))


def test_init_cache_holds_the_cross_caches(ref, pair):
    jm, _, port = pair("bfloat16")
    want, got = flat(jm.init_cache(3, 40)), flat(port.init_cache(3, 40))
    assert sorted(got) == sorted(want)
    for k in got:
        assert got[k].shape == want[k].shape, k
        assert not got[k].any(), k
    assert got["scan.slot0.ck"].shape == (2, 3, 4, 24, 16)


@pytest.mark.parametrize("s", [4, 12])
def test_bf16_decode_step_equals_prefill_of_one_more_token_bitwise(s):
    """In bf16 on the CPU, prefill(S) + decode_step equals prefill(S+1) bit
    for bit with the same frames: the encoder's output and ck/cv do not
    depend on the tokens, and the cross-attention's decode row (all Se
    slots) is its prefill row (every key live) in the plain versions'
    order. Two steps."""
    cfg = smoke("bfloat16")
    m = Model(cfg, device="cpu").init(torch.Generator().manual_seed(3))
    toks, frames = inputs(s=s + 2, seed=4)
    toks, frames = torch.from_numpy(toks), torch.from_numpy(frames)
    _, cache = m.prefill(toks[:, :s], cache_len=s + 8, frames=frames)
    for p in (s, s + 1):
        dec, cache = m.decode_step(cache, toks[:, p], p)
        full, _ = m.prefill(toks[:, :p + 1], cache_len=s + 8, frames=frames)
        assert torch.equal(dec, full), p


def test_bf16_gap_to_the_shipped_reference_is_attention_and_scan_rounding(
        ref, pair):
    """The bf16 port against the reference's model as it ships (its
    ``chunked_attention`` / ``decode_attention`` round ``q * scale`` and
    ``p`` to bf16, ROADMAP Queue 3 item 9; its encoder is one ``lax.scan``,
    whose body keeps bf16 intermediates in float32): prefill and two
    decode steps give the same greedy tokens, and every logit lies within
    ``GAP_OF_SCALE`` of the step's largest logit. Prints the reading
    (``-s``), and the gap with the kernels' attention patched in (the
    scan's share alone)."""
    import jax.numpy as jnp

    jm, params, port = pair("bfloat16")
    toks, frames = inputs(seed=2)
    lt, ct = port.prefill(torch.from_numpy(toks[:, :S]), cache_len=CACHE,
                          frames=torch.from_numpy(frames))
    port_logits = [lt.float().numpy()]
    for p in (S, S + 1):
        lt, ct = port.decode_step(ct, torch.from_numpy(toks[:, p]), p)
        port_logits.append(lt.float().numpy())
    readings = {}
    for name, ctx in (("shipped", contextlib.nullcontext()),
                      ("kernels' attention, scanned encoder",
                       tpu_attention(ref))):
        with ctx:
            lj, cj = jm.prefill(params, jnp.asarray(toks[:, :S]),
                                cache_len=CACHE, frames=jnp.asarray(frames))
            want = [np.asarray(lj.astype(jnp.float32))]
            for p in (S, S + 1):
                lj, cj = jm.decode_step(params, cj, jnp.asarray(toks[:, p]),
                                        jnp.int32(p))
                want.append(np.asarray(lj.astype(jnp.float32)))
        out = []
        for step, got, w in zip(("prefill", S, S + 1), port_logits, want):
            gap = np.abs(got - w)
            beyond = float((gap > BF16["atol"] + BF16["rtol"] * np.abs(w))
                           .mean())
            out.append(f"{step}: {beyond:.4f} beyond the suite's tolerance, "
                       f"max gap {gap.max():.4g} on logits up to "
                       f"{np.abs(w).max():.3g}")
            if name == "shipped":
                np.testing.assert_array_equal(got.argmax(-1), w.argmax(-1),
                                              err_msg=f"{step}")
                assert gap.max() <= GAP_OF_SCALE * np.abs(w).max(), out
        readings[name] = "; ".join(out)
    print(f"{ARCH} bf16 against the reference: " + " | ".join(
        f"{k}: {v}" for k, v in readings.items()))


def test_converter_names_match_the_full_configs_tree(ref):
    """The full config's parameter names, shapes and dtypes (a model on the
    meta device) are the reference's parameter tree traced without
    allocating it: ``encoder.layers.*`` stacked [32, ...],
    ``encoder.pos_embed`` [1500, 1280], each decoder layer's ``cross``
    (with the ``bq``/``bk``/``bv`` cross-attention never reads) and
    ``norm_cross``."""
    import jax

    full = Model(get_config(ARCH), device="meta")
    want = jax.eval_shape(ref.models.Model(ref.configs.get_config(ARCH)).init,
                          jax.random.PRNGKey(0))
    want = {jax.tree_util.keystr(path, simple=True, separator="."):
            (tuple(leaf.shape), str(leaf.dtype)) for path, leaf in
            jax.tree_util.tree_flatten_with_path(want)[0]}
    got = {n: (tuple(p.shape), str(p.dtype).replace("torch.", ""))
           for n, p in full.named_parameters()}
    assert got == want
    assert got["encoder.pos_embed"] == ((1500, 1280), "bfloat16")
    assert got["encoder.layers.mixer.wq"] == ((32, 1280, 1280), "bfloat16")
    assert got["scan_layers.slot0.cross.bk"] == ((32, 1280), "bfloat16")
    # 3.207 GB in bf16 (``param_count()``, 1,600,783,360, approximates:
    # no biases, norms or position table)
    assert sum(int(np.prod(s)) for s, _ in got.values()) == 1_603_486_720
    assert dataclasses.asdict(full.encoder_cfg()) == dataclasses.asdict(
        ref.models.Model(ref.configs.get_config(ARCH)).encoder_cfg())


def test_prefill_without_frames_raises(ref, pair):
    """The port's ``Model.prefill`` of an encoder-decoder config without
    frames raises a ValueError naming them, and so does its engine, which
    (like the reference's) calls prefill without frames; the reference's
    engine fails there too, on ``None.astype``."""
    jm, params, port = pair("float32")
    toks, _ = inputs()
    with pytest.raises(ValueError, match="frames"):
        port.prefill(torch.from_numpy(toks))
    reqs = [Request(0, toks[0], 2)]
    with pytest.raises(ValueError, match="frames"):
        InferenceEngine(port, cache_len=CACHE).generate_batch(reqs)
    with pytest.raises(AttributeError, match="astype"):
        ref.engine.InferenceEngine(jm, params, cache_len=CACHE
                                   ).generate_batch(reqs)
