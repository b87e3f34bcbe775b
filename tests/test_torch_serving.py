"""The port's serving engine (``repro_torch.serving.InferenceEngine``)
against the reference's (``repro.serving.engine.InferenceEngine``).

Four requests of mixed prompt lengths (left-padded to one batch) with
mixed token budgets go through both engines with the same weights (the
reference's parameter tree carried across). At a float32 config the
greedy tokens must be identical. At the bfloat16 config the first token
must be identical, and the prefill logits within the reference suite's
relative tolerance of the reference's ``Model.prefill`` run op by op:
``|port - ref| <= 2e-2 * (|ref| + max|ref|)``. The absolute part scales
with the logits: the rwkv6 recurrence sums over k in another order than
the reference's einsum, so a bf16 hidden value can round one ulp apart,
and that moves every logit by about one bf16 ulp of the logits' scale
(measured: 1.4% of rwkv6's logits beyond the suite's fixed atol 2e-3, by
at most 0.0088 on logits of size 2). Not of the reference engine's
jitted prefill: inside a jit
XLA keeps bf16 chains in float32 where the op-by-op run (and the port)
rounds, and the reference's jitted and op-by-op prefill logits themselves
differ beyond that tolerance in 16-43% of the smoke models' logits (up to
0.07 on logits of size 2). Later tokens may part where two logits come
within that rounding.
"""
import dataclasses
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.convert import model_params_from_fields
from repro_torch.models import Model
from repro_torch.serving import Completion, InferenceEngine, Request
from tests.test_torch_harness import reference

BF16_RTOL = 2e-2
LENGTHS = (5, 12, 9, 3)
NEW_TOKENS = (6, 4, 6, 2)
CACHE_LEN = 24


@pytest.fixture(scope="module")
def ref():
    return reference()


def _requests(vocab, seed, cls):
    rng = np.random.default_rng(seed)
    return [cls(i, rng.integers(0, vocab, n).astype(np.int32), m)
            for i, (n, m) in enumerate(zip(LENGTHS, NEW_TOKENS))]


def _engines(ref, arch, dtype):
    jax = ref.jax
    cfg = dataclasses.replace(ref.configs.get_smoke_config(arch),
                              dtype=dtype, kv_dtype=dtype)
    jm = ref.models.Model(cfg, remat=False)
    params = jm.init(jax.random.PRNGKey(3))
    port = model_params_from_fields(
        dataclasses.replace(get_smoke_config(arch), dtype=dtype,
                            kv_dtype=dtype),
        jax.tree_util.tree_map(np.asarray, params), device="cpu")
    return (cfg, ref.engine.InferenceEngine(jm, params, cache_len=CACHE_LEN),
            InferenceEngine(port, cache_len=CACHE_LEN))


def _padded(reqs):
    pmax = max(r.prompt_len for r in reqs)
    toks = np.zeros((len(reqs), pmax), np.int32)
    for i, r in enumerate(reqs):
        toks[i, pmax - r.prompt_len:] = r.tokens
    return toks


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "recurrentgemma-9b",
                                  "llama3-8b", "stablelm-12b",
                                  "starcoder2-15b", "qwen1.5-32b",
                                  "olmoe-1b-7b", "arctic-480b"])
def test_generate_batch_matches_reference_engine(ref, arch, dtype):
    cfg, jeng, teng = _engines(ref, arch, dtype)
    want = jeng.generate_batch(_requests(cfg.vocab_size, 7,
                                         ref.engine.Request))
    got = teng.generate_batch(_requests(cfg.vocab_size, 7, Request))
    assert [c.rid for c in got] == [c.rid for c in want]
    for g, w, n in zip(got, want, NEW_TOKENS):
        assert isinstance(g, Completion)
        assert g.tokens.dtype == np.int32 and g.tokens.shape == (n,)
        assert g.prefill_s > 0 and g.decode_s > 0
        if dtype == "float32":
            np.testing.assert_array_equal(g.tokens, w.tokens)
        else:
            assert g.tokens[0] == w.tokens[0]
    if dtype == "bfloat16":
        import jax.numpy as jnp

        toks = _padded(_requests(cfg.vocab_size, 7, Request))
        lj = np.asarray(jeng.model.prefill(
            jeng.params, jnp.asarray(toks), cache_len=CACHE_LEN)[0]
            .astype(jnp.float32))
        lt, _ = teng.model.prefill(torch.from_numpy(toks),
                                   cache_len=CACHE_LEN)
        np.testing.assert_allclose(lt.float().numpy(), lj, rtol=BF16_RTOL,
                                   atol=BF16_RTOL * np.abs(lj).max())


def test_generate_batch_pads_left_and_decodes_greedily():
    """The engine's tokens are the argmax chain of prefill + decode_step on
    the left-padded batch, each request cut to its own budget."""
    cfg = get_smoke_config("recurrentgemma-9b")
    m = Model(cfg, device="cpu").init(torch.Generator().manual_seed(2))
    reqs = _requests(cfg.vocab_size, 9, Request)
    got = InferenceEngine(m, cache_len=CACHE_LEN).generate_batch(reqs)
    toks = torch.from_numpy(_padded(reqs))
    logits, cache = m.prefill(toks, cache_len=CACHE_LEN)
    want = []
    for i in range(max(NEW_TOKENS)):
        tok = torch.argmax(logits, -1)
        want.append(tok)
        logits, cache = m.decode_step(cache, tok, toks.shape[1] + i)
    want = torch.stack(want, 1).numpy()
    for g, n, i in zip(got, NEW_TOKENS, range(len(reqs))):
        np.testing.assert_array_equal(g.tokens, want[i, :n])
    assert InferenceEngine(m).generate_batch([]) == []


def test_engine_model_needs_a_gpu_unless_told_cpu(monkeypatch):
    """A bare ``Model(cfg)`` runs on ``cuda`` and raises without a GPU:
    no silent CPU fallback."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        Model(get_smoke_config("recurrentgemma-9b"))
    assert Model(get_smoke_config("recurrentgemma-9b"),
                 device="cpu").device.type == "cpu"


def test_launch_serve_plans_whisper_as_the_reference_does(ref, monkeypatch):
    """``launch/serve.py --arch whisper-large-v3`` without
    ``--execute-smoke`` (the latency model and the plan) prints the
    reference launcher's baselines, with the reference's peak rates; with
    ``--execute-smoke`` the engine's prefill has no frames to give, and the
    port raises a ValueError naming them where the reference fails on
    ``None.astype``."""
    import functools

    from repro.launch import serve as rserve
    from repro_torch.launch import serve as pserve
    from repro_torch.serving import hybrid as ph
    from tests.test_torch_hybrid import _main_lines, ref_peaks

    argv = ["--arch", "whisper-large-v3", "--requests", "24"]
    monkeypatch.setattr(ph.ServingLatencyModel, "__init__",
                        functools.partialmethod(
                            ph.ServingLatencyModel.__init__, **ref_peaks()))
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    want = _main_lines(lambda argv: rserve.main(), None)
    got = _main_lines(pserve.main, argv + ["--device", "cpu"])
    assert got[0] == want[0] == "arch=whisper-large-v3 J=24 order=spt"
    # the schedule line rests on the two libraries' float32 ridge fits, so
    # only the baselines are held to the letter (as for llama3-8b)
    assert got[:3] == want[:3]
    assert got[3].startswith("hybrid     :") and "met=" in got[3]
    with pytest.raises(ValueError, match="frames"):
        pserve.main(argv + ["--execute-smoke", "--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["serve", "--execute-smoke"] + argv)
    with pytest.raises(AttributeError, match="astype"):
        rserve.main()
