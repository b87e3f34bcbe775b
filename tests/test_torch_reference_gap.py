"""The reference's own bf16 prefill/decode split on the CPU at full width.

``chip_smoke.py`` holds the card's bf16 decode step bit for bit against
prefill(S+1) and prints the port's CPU gap beside it. This file reads the
same gap for the JAX package's ``Model`` as it ships (op by op, on the
CPU), at chip_smoke's ``CPU_LAYERS`` depths, full widths and serve batch:
the reading against which the port's plain product was made
row-independent. The three cases take about two minutes and up to 22 GB
of host memory, too much beside the other suites, so they run only when
asked:

    REPRO_REFERENCE_GAP=1 PYTHONPATH=src JAX_PLATFORMS=cpu \
        python -m pytest -s tests/test_torch_reference_gap.py
"""
import dataclasses
import os

import numpy as np
import pytest

import chip_smoke as cs
from tests.test_torch_harness import reference

#: the reference's decode logits beyond INCR_TOL of prefill(S+1): at most
#: this share (what "the reference holds" means for the port's CPU gap)
REFERENCE_BEYOND = 0.05


@pytest.mark.slow
@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "recurrentgemma-9b",
                                  "llama3-8b"])
def test_reference_bf16_decode_against_prefill_at_full_width(arch):
    """prefill(S) + decode_step of the greedy tokens against prefill(S+1),
    bf16, for chip_smoke's serve batch: prints the share of logits beyond
    INCR_TOL and holds it to REFERENCE_BEYOND."""
    if os.environ.get("REPRO_REFERENCE_GAP") != "1":
        pytest.skip("full-width reference on the CPU (up to 22 GB of host "
                    "memory); set REPRO_REFERENCE_GAP=1 to run it")
    import jax
    import jax.numpy as jnp

    ref = reference()
    cfg = dataclasses.replace(ref.configs.get_config(arch),
                              num_layers=cs.CPU_LAYERS[arch],
                              dtype="bfloat16", kv_dtype="bfloat16")
    reqs = cs.serve_requests(cfg, cs.SERVE_REQUESTS, cs.SERVE_PROMPT,
                             cs.SERVE_NEW, cs.SERVE_SEED)
    toks = jnp.asarray(cs.padded(reqs))
    S = toks.shape[1]
    model = ref.models.Model(cfg, remat=False)
    params = model.init(jax.random.PRNGKey(0))
    logits, cache = model.prefill(params, toks, cache_len=cs.SERVE_CACHE)
    first = jnp.argmax(logits, -1).astype(jnp.int32)
    dec, _ = model.decode_step(params, cache, first, jnp.int32(S))
    full, _ = model.prefill(params, jnp.concatenate([toks, first[:, None]],
                                                    1),
                            cache_len=cs.SERVE_CACHE)
    d = np.asarray(dec.astype(jnp.float32))
    f = np.asarray(full.astype(jnp.float32))
    assert np.isfinite(d).all() and d.shape == (len(reqs), cfg.vocab_size)
    err = np.abs(d - f)
    beyond = err > cs.INCR_TOL["atol"] + cs.INCR_TOL["rtol"] * np.abs(f)
    print(f"reference {arch} at {cfg.num_layers} layers, bf16, CPU: "
          f"prefill({S}) + decode_step vs prefill({S + 1}): "
          f"{int(beyond.sum())} of {beyond.size} logits "
          f"({beyond.mean():.4f}) beyond rtol {cs.INCR_TOL['rtol']}, atol "
          f"{cs.INCR_TOL['atol']}; max abs diff {float(err.max())!r} on "
          f"logits up to {float(np.abs(f).max()):.3f}; bitwise equal "
          f"{bool((err == 0).all())}")
    assert beyond.mean() <= REFERENCE_BEYOND
