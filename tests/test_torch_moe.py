"""The port's MoE layers (``repro_torch.models.moe``) against the
reference's (``repro.models.moe``), on the smoke configs of olmoe-1b-7b
(8 experts, top-4) and arctic-480b (8 experts, top-2, dense residual).

The same seeded numpy inputs and the reference's parameter tree (carried
across by ``convert``) go through both. Expert choices and kept masks must
be equal exactly: the reference's choices are read from its own
``jax.lax.top_k`` call, its kept mask from those choices by the capacity
rule counted here in plain Python (token order, then choice order).
Outputs within ``F32`` / ``BF16`` of ``tests/test_torch_models.py``. Each
case runs at the shipped capacity factor 1.25 (pairs are dropped) and at
E/k, where every expert has a slot for every token of a group and nothing
is dropped.
"""
import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.convert import model_params_from_fields, \
    tensor_from_array
from repro_torch.models import Model
from repro_torch.models import moe as TM
from tests.test_torch_harness import reference
from tests.test_torch_models import BF16, F32, tpu_attention

ARCHS = ("olmoe-1b-7b", "arctic-480b")
DTYPES = ("float32", "bfloat16")
#: tokens per row of the layer tests: two groups of 80 at the smoke
#: configs' group target of 128
S = 160


@pytest.fixture(scope="module")
def ref():
    return reference()


def tol(dtype):
    return F32 if dtype == "float32" else BF16


def no_drops(cfg):
    """``cfg`` at capacity factor E/k: capacity equals the group length."""
    return dataclasses.replace(cfg, capacity_factor=cfg.num_experts
                               / cfg.top_k)


def smoke(arch, dtype, capacity="shipped"):
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype,
                              kv_dtype=dtype)
    return no_drops(cfg) if capacity == "E/k" else cfg


@contextlib.contextmanager
def recorded_top_k(ref):
    """Records every ``jax.lax.top_k`` result (values, indices) while the
    reference runs, restored on exit."""
    lax = ref.jax.lax
    orig, seen = lax.top_k, []

    def top_k(*args, **kw):
        out = orig(*args, **kw)
        seen.append(tuple(np.asarray(o) for o in out))
        return out

    lax.top_k = top_k
    try:
        yield seen
    finally:
        lax.top_k = orig


def kept_by_rule(idx, num_experts, cap):
    """Kept mask of ``idx`` [..., g, k]: a (token, choice) pair is kept when
    fewer than ``cap`` earlier pairs of its group, counted token by token
    and within a token choice by choice, chose its expert."""
    lead, (g, k) = idx.shape[:-2], idx.shape[-2:]
    flat = idx.reshape(-1, g, k)
    kept = np.zeros(flat.shape, bool)
    for grp in range(flat.shape[0]):
        count = np.zeros(num_experts, int)
        for t in range(g):
            for j in range(k):
                e = flat[grp, t, j]
                kept[grp, t, j] = count[e] < cap
                count[e] += 1
    return kept.reshape(*lead, g, k)


def layer_params(ref, cfg, seed=0):
    """The reference's ``moe_init`` tree (jax) and its port copy."""
    import jax

    dt = ref.jax.numpy.dtype(cfg.dtype)
    pj = ref.moe.moe_init(cfg, jax.random.PRNGKey(seed), dt)
    return pj, {k: tensor_from_array(np.asarray(v)) for k, v in pj.items()}


def hidden(cfg, b, s, seed):
    """Seeded [b, s, d] inputs as the reference's jax array and the port's
    tensor (the same values in the config's dtype). Every token shares one
    direction, as hidden states do, so the router favours some experts
    and a capacity of 1.25 drops pairs."""
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, cfg.d_model)) + 1.5 * rng.normal(
        size=cfg.d_model)
    xj = jnp.asarray(x, jnp.float32).astype(cfg.dtype)
    return xj, tensor_from_array(np.asarray(xj))


def expert_outputs(cfg, p, x):
    """Every expert's FFN of every token, in float64: [E, B, S, d]."""
    w = {k: v.double() for k, v in p.items() if k != "router"}
    x = x.double()
    out = []
    for e in range(cfg.num_experts):
        up = x @ w["w_up"][e]
        if cfg.glu:
            g = x @ w["w_gate"][e]
            h = g * torch.sigmoid(g) * up
        else:
            h = torch.nn.functional.gelu(up, approximate="tanh")
        out.append(h @ w["w_down"][e])
    return torch.stack(out)


# -- sizes --------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_group_len_and_capacity_match_reference(ref, arch):
    """Integer for integer, at both configs of each architecture, the
    shipped capacity factor and E/k, over every S from 1 to 4,200."""
    for cfg, rcfg in ((get_config(arch), ref.configs.get_config(arch)),
                      (get_smoke_config(arch),
                       ref.configs.get_smoke_config(arch))):
        for c, rc in ((cfg, rcfg), (no_drops(cfg), no_drops(rcfg))):
            got = [(TM.group_len(c, s), TM.capacity(c, TM.group_len(c, s)))
                   for s in range(1, 4201)]
            want = [(ref.moe.group_len(rc, s),
                     ref.moe.capacity(rc, ref.moe.group_len(rc, s)))
                    for s in range(1, 4201)]
            assert got == want, (cfg.name, c.capacity_factor)
    full = get_config("olmoe-1b-7b")
    # OLMoE's long batch on the card: 4080 tokens, drops at 1.25
    assert TM.group_len(full, 4080) == 340
    assert TM.capacity(full, 340) == 54
    assert TM.capacity(no_drops(full), 340) == 340


# -- one layer ----------------------------------------------------------------

@pytest.mark.parametrize("capacity", ["shipped", "E/k"])
@pytest.mark.parametrize("dispatch", ["einsum", "scatter"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_reference(ref, arch, dtype, dispatch, capacity):
    """Expert choices and kept masks equal exactly, outputs within the
    dtype's tolerance; drops happen at the shipped capacity and not at
    E/k."""
    cfg = smoke(arch, dtype, capacity)
    rcfg = dataclasses.replace(ref.configs.get_smoke_config(arch),
                               dtype=dtype, kv_dtype=dtype,
                               capacity_factor=cfg.capacity_factor)
    pj, pt = layer_params(ref, rcfg)
    xj, xt = hidden(cfg, 2, S, seed=7)
    with recorded_top_k(ref) as seen:
        want = ref.moe.moe_apply(rcfg, pj, xj, dispatch=dispatch)
    got = TM.moe_apply(cfg, pt, xt, dispatch)
    assert got.dtype == xt.dtype and got.shape == xt.shape

    gl = TM.group_len(cfg, S)
    cap = TM.capacity(cfg, gl)
    r = TM.route(cfg, pt["router"], xt.reshape(-1, gl, cfg.d_model), cap)
    (_, ridx), = seen
    np.testing.assert_array_equal(r.idx.numpy(), ridx.reshape(-1, gl,
                                                              cfg.top_k))
    kept = kept_by_rule(ridx, cfg.num_experts, cap)
    np.testing.assert_array_equal(r.kept.numpy(),
                                  kept.reshape(r.kept.shape))
    assert kept.all() == (capacity == "E/k")
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype("float32")),
                               **tol(dtype))


@pytest.mark.parametrize("dispatch", ["einsum", "scatter"])
@pytest.mark.parametrize("arch", ARCHS)
def test_one_expert_router_keeps_the_first_pairs_in_order(ref, arch,
                                                          dispatch):
    """A router that puts expert 0 first for every token keeps its first
    ``C`` tokens' pairs and drops the rest, counted in token order from the
    first row of the group: the left-padding rows (eight copies of one
    hidden state, as a pad token gives) take the first slots."""
    cfg = smoke(arch, "float32")
    rcfg = dataclasses.replace(ref.configs.get_smoke_config(arch),
                               dtype="float32", kv_dtype="float32")
    pj, pt = layer_params(ref, rcfg, seed=1)
    router = np.array(pj["router"])
    router[0] = 0.0
    router[0, 0] = 8.0  # a lead of 8-40: no probability underflows
    pj = dict(pj, router=ref.jax.numpy.asarray(router))
    pt = dict(pt, router=torch.from_numpy(router))
    x = np.random.default_rng(3).normal(size=(1, 48, cfg.d_model))
    x[:, :8] = x[:, :1]                     # the pads' hidden state
    x[..., 0] = np.abs(x[..., 0]) + 1.0     # expert 0's logit leads
    xj = ref.jax.numpy.asarray(x, "float32")
    xt = torch.from_numpy(x.astype(np.float32))
    with recorded_top_k(ref) as seen:
        want = ref.moe.moe_apply(rcfg, pj, xj, dispatch=dispatch)
    got = TM.moe_apply(cfg, pt, xt, dispatch)
    cap = TM.capacity(cfg, 48)
    (_, ridx), = seen
    assert (ridx[..., 0] == 0).all()
    r = TM.route(cfg, pt["router"], xt, cap)
    assert (r.idx[..., 0] == 0).all()
    expected = np.arange(48) < cap
    np.testing.assert_array_equal(r.kept[0, :, 0].numpy(), expected)
    np.testing.assert_array_equal(
        kept_by_rule(ridx, cfg.num_experts, cap).reshape(r.kept.shape),
        r.kept.numpy())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("capacity", ["shipped", "E/k"])
@pytest.mark.parametrize("arch", ARCHS)
def test_einsum_combine_weights_each_expert_by_the_summed_kept_gates(
        ref, arch, capacity):
    """ROADMAP Queue 3 item 17, recorded: in the reference and in the port,
    the ``einsum`` path gives each kept expert's output times the token's
    summed kept gates (the plain sum of its experts where nothing drops),
    and the ``scatter`` path the gate-weighted sum. The two differ."""
    cfg = smoke(arch, "float32", capacity)
    rcfg = dataclasses.replace(ref.configs.get_smoke_config(arch),
                               dtype="float32", kv_dtype="float32",
                               capacity_factor=cfg.capacity_factor)
    pj, pt = layer_params(ref, rcfg, seed=2)
    xj, xt = hidden(cfg, 2, S, seed=5)
    gl = TM.group_len(cfg, S)
    r = TM.route(cfg, pt["router"], xt.reshape(-1, gl, cfg.d_model),
                 TM.capacity(cfg, gl))
    ys = expert_outputs(cfg, pt, xt).reshape(cfg.num_experts, -1, gl,
                                             cfg.d_model)
    picked = torch.stack([ys[r.idx[..., j], torch.arange(ys.shape[1])[:, None],
                                torch.arange(gl)]
                          for j in range(cfg.top_k)], 2)  # [bn, gl, k, d]
    gates = r.gates.double()[..., None]
    kept = r.kept.double()[..., None]
    summed = (picked * kept).sum(2) * gates.sum(2)
    weighted = (picked * gates).sum(2)
    scale = float(weighted.abs().max())
    assert float((summed - weighted).abs().max()) > 0.1 * scale
    for dispatch, formula in (("einsum", summed), ("scatter", weighted)):
        want = formula.reshape(2, S, cfg.d_model).numpy()
        got = TM.moe_apply(cfg, pt, xt, dispatch)
        rgot = ref.moe.moe_apply(rcfg, pj, xj, dispatch=dispatch)
        for name, y in (("port", got.numpy()), ("reference",
                                                 np.asarray(rgot))):
            np.testing.assert_allclose(y, want, rtol=1e-5,
                                       atol=1e-5 * scale,
                                       err_msg=f"{name} {dispatch}")


def test_moe_apply_refuses_an_unknown_dispatch():
    cfg = smoke("olmoe-1b-7b", "float32")
    with pytest.raises(ValueError, match="dispatch"):
        TM.moe_apply(cfg, {}, torch.zeros((1, 4, cfg.d_model)), "gather")
    with pytest.raises(ValueError, match="moe_dispatch"):
        Model(cfg, device="cpu", moe_dispatch="gather")


def test_launch_count_of_one_layer():
    """``moe_launches``: the router product and one product per expert
    and weight, counted through the ``matmul`` wrapper."""
    from repro_torch.kernels import ops

    calls = []
    orig = ops.matmul

    def counting(x, y):
        calls.append((tuple(x.shape), tuple(y.shape)))
        return orig(x, y)

    for arch in ARCHS:
        cfg = smoke(arch, "float32")
        pt = {k: torch.randn(v.shape, generator=torch.Generator()
                             .manual_seed(0)) * 0.1
              for k, v in TM.moe_init(cfg, torch.float32).items()}
        calls.clear()
        ops.matmul = counting
        try:
            TM.moe_apply(cfg, pt, torch.randn(2, 10, cfg.d_model))
        finally:
            ops.matmul = orig
        assert len(calls) == TM.moe_launches(cfg)
        assert calls[0] == ((20, cfg.d_model), (cfg.d_model,
                                                cfg.num_experts))


# -- the whole model ----------------------------------------------------------

def _model_pair(ref, arch, dtype, capacity, dispatch, seed=0):
    import jax

    cfg = smoke(arch, dtype, capacity)
    rcfg = dataclasses.replace(ref.configs.get_smoke_config(arch),
                               dtype=dtype, kv_dtype=dtype,
                               capacity_factor=cfg.capacity_factor)
    jm = ref.models.Model(rcfg, remat=False, moe_dispatch=dispatch)
    params = jm.init(jax.random.PRNGKey(seed))
    port = model_params_from_fields(
        cfg, jax.tree_util.tree_map(np.asarray, params), device="cpu")
    port.moe_dispatch = dispatch
    return cfg, jm, params, port


@pytest.mark.parametrize("s", [24, 150])
@pytest.mark.parametrize("dispatch", ["einsum", "scatter"])
@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_decode_step_equals_prefill_of_one_more_token_at_e_over_k(
        arch, dispatch, s):
    """At capacity E/k nothing drops, and in bf16 prefill(S) + decode_step
    is prefill(S+1) bit for bit: routing, slots, expert products and the
    combine keep each row's value whatever the number of rows. S = 150
    makes two groups of 75; S + 1 = 151 is prime, groups of one."""
    cfg = smoke(arch, "bfloat16", "E/k")
    m = Model(cfg, device="cpu", moe_dispatch=dispatch).init(
        torch.Generator().manual_seed(3))
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, s + 1)))
    full, _ = m.prefill(toks, cache_len=s + 8)
    _, cache = m.prefill(toks[:, :s], cache_len=s + 8)
    dec, _ = m.decode_step(cache, toks[:, s], s)
    assert torch.equal(dec, full)


@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_drops_part_decode_from_prefill_in_both(ref, arch):
    """At the shipped capacity a prefill drops pairs that a decode step (a
    group of one token, one slot per expert) never drops, so prefill(S) +
    decode_step is not prefill(S+1) in the reference itself. The port
    gives the reference's logits on both sides (bf16, the kernels'
    attention) and so the same gap: within the serving suite's bf16
    tolerance, ``2e-2 * (|ref| + max|ref|)``, since a logit near 0 moves
    by more than the suite's fixed atol when one bf16 hidden value rounds
    one ulp apart (the two libraries sum a float32 product in different
    orders)."""
    import jax.numpy as jnp

    cfg, jm, params, port = _model_pair(ref, arch, "bfloat16", "shipped",
                                        "einsum")
    s = 32
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, s + 1))
    toks = toks.astype(np.int32)
    with tpu_attention(ref):
        _, cj = jm.prefill(params, jnp.asarray(toks[:, :s]),
                           cache_len=s + 8)
        dj, _ = jm.decode_step(params, cj, jnp.asarray(toks[:, s]),
                               jnp.int32(s))
        fj, _ = jm.prefill(params, jnp.asarray(toks), cache_len=s + 8)
    _, ct = port.prefill(torch.from_numpy(toks[:, :s]), cache_len=s + 8)
    dt, _ = port.decode_step(ct, torch.from_numpy(toks[:, s]), s)
    ft, _ = port.prefill(torch.from_numpy(toks), cache_len=s + 8)
    dj, fj = (np.asarray(a.astype(jnp.float32)) for a in (dj, fj))
    for got, want in ((dt, dj), (ft, fj)):
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2,
                                   atol=2e-2 * np.abs(want).max())
    gap = np.abs(dj - fj)
    assert (gap > BF16["atol"] + BF16["rtol"] * np.abs(fj)).any()
    np.testing.assert_allclose(np.abs(dt.float().numpy()
                                      - ft.float().numpy()).max(),
                               gap.max(), rtol=0.05)


@contextlib.contextmanager
def recorded_routes():
    """Records the expert choices of every port ``route`` call."""
    orig, seen = TM.route, []

    def route(*args, **kw):
        r = orig(*args, **kw)
        seen.append(r.idx.numpy().copy())
        return r

    TM.route = route
    try:
        yield seen
    finally:
        TM.route = orig


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_moe_gap_to_the_shipped_reference_goes_through_the_routing(
        ref, arch):
    """The bf16 MoE models against the reference as it ships (its
    ``chunked_attention`` / ``decode_attention`` round ``q * scale`` and
    ``p`` to bf16, the kernels and the port do not: ROADMAP Queue 3 item
    9). With the kernels' attention patched into the reference, every
    expert choice and every logit is the port's, bit for bit. As shipped,
    the attention's one-ulp moves flip near-tied expert choices, and a
    flipped choice moves a token by a whole expert's output: the gap
    passes the dense models' ``GAP_OF_SCALE`` (measured on these inputs:
    olmoe 0.0213-0.0530 of the logits' scale, arctic 0.0184-0.370 with
    another greedy token at its prefill). Prefill and two decode steps, as
    ``test_torch_models.py``'s gap test; prints the reading (``-s``)."""
    import jax
    import jax.numpy as jnp

    from tests.test_torch_models import GAP_OF_SCALE, _tokens

    cfg = smoke(arch, "bfloat16")
    rcfg = dataclasses.replace(ref.configs.get_smoke_config(arch),
                               dtype="bfloat16", kv_dtype="bfloat16")
    jm = ref.models.Model(rcfg, remat=False)
    params = jm.init(jax.random.PRNGKey(0))
    port = model_params_from_fields(
        cfg, jax.tree_util.tree_map(np.asarray, params), device="cpu")
    toks = _tokens(cfg, 2, 26, 11)

    def run(model_call):
        out = [model_call(None, None)]
        for step in (24, 25):
            out.append(model_call(out[-1][1], step))
        return [o[0] for o in out]

    def reference_steps(cache, step):
        if step is None:
            return jm.prefill(params, jnp.asarray(toks[:, :24]),
                              cache_len=32)
        return jm.decode_step(params, cache, jnp.asarray(toks[:, step]),
                              jnp.int32(step))

    def port_steps(cache, step):
        if step is None:
            return port.prefill(torch.from_numpy(toks[:, :24]),
                                cache_len=32)
        return port.decode_step(cache, torch.from_numpy(toks[:, step]),
                                step)

    with recorded_routes() as got_idx:
        got = [lt.float().numpy() for lt in run(port_steps)]
    with tpu_attention(ref), recorded_top_k(ref) as kernel_idx:
        kernels = [np.asarray(lj.astype(jnp.float32))
                   for lj in run(reference_steps)]
    with recorded_top_k(ref) as shipped_idx:
        shipped = [np.asarray(lj.astype(jnp.float32))
                   for lj in run(reference_steps)]
    assert len(got_idx) == len(kernel_idx) == len(shipped_idx) == 6
    for g, (_, k) in zip(got_idx, kernel_idx):
        np.testing.assert_array_equal(g, k.reshape(g.shape))
    for g, k in zip(got, kernels):
        np.testing.assert_array_equal(g, k)
    flipped = sum(int((g != s.reshape(g.shape)).sum())
                  for g, (_, s) in zip(got_idx, shipped_idx))
    gaps = [float(np.abs(g - w).max() / np.abs(w).max())
            for g, w in zip(got, shipped)]
    print(f"{arch} bf16 against the shipped reference: {flipped} expert "
          f"choices flipped; max gap of the logits' scale at prefill and "
          f"two decode steps {gaps}")
    assert flipped > 0
    assert max(gaps) > GAP_OF_SCALE
