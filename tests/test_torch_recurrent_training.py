"""The recurrences' backwards (``rglru_bwd``, ``rwkv6_bwd``) and their
autograd Functions (``ops.rglru``, ``ops.rwkv6`` under grad) against the
reference.

The same seeded numpy inputs go through the port's plain backwards
(``ref.rglru_backward_plain`` / ``rwkv6_backward_plain``: explicit loops in
reverse time, what the CPU's Functions run) and ``jax.vjp`` of the
reference's oracles (``ref.rglru_ref`` / ``rwkv6_ref``: XLA's autodiff of
their ``lax.scan``, which is how the reference trains these mixers).
Tolerances:

- float32 gradients within 1e-5 of each gradient's largest magnitude (the
  sums over the state run in other orders; measured ~1e-7);
- gradients returned in bf16 (r, k, v's) also within one bf16 ulp of the
  value: the float32 gradient's own rounding to bf16, which both packages
  do, may fall on either side of a tie;
- the Functions against torch autograd through the plain forwards: the
  same tolerances.

The CUDA kernels run only on a GPU: their cases are marked ``gpu`` and
skip without one (``chip_smoke.py`` phase 9 holds them at the training
shapes). There ``rglru_bwd`` equals its plain version bit for bit (every
operation elementwise), and ``rwkv6_bwd`` equals
``ref.rwkv6_backward_ordered`` (the kernel's fixed orders in torch) bit for
bit, and lies within the bound two summation orders of n float32 terms
can differ by, 2 (n - 1) 2^-24 times the sum of the terms' magnitudes
(``ref.sum_order_bound``; every term is the plain version's bit for bit),
plus one bf16 ulp for bf16 results, of the plain version. On the CPU,
``ref.rwkv6_backward_ordered`` is held within that bound of the plain
version and to the reference's autodiff.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.kernels import cost, ops
from repro_torch.kernels import ref as kref
from repro_torch.models import Model
from repro_torch.models.model import train_launches
from repro_torch.training import train_params
from tests.test_torch_harness import reference

GRAD_OF_SCALE = 1e-5


@pytest.fixture(scope="module")
def ref():
    return reference()


def _close(got, want, rel=GRAD_OF_SCALE, name=""):
    """Within ``rel`` of ``want``'s largest magnitude, plus one bf16 ulp of
    the value where ``got`` is bf16."""
    g = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                   dtype=np.float64)
    w = np.asarray(want, dtype=np.float64)
    assert g.shape == w.shape, (name, g.shape, w.shape)
    tol = rel * max(float(np.abs(w).max()), 1e-30)
    if isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16:
        _, e = np.frexp(np.maximum(np.abs(g), np.abs(w)))
        tol = tol + np.ldexp(1.0, e - 8)
    err = np.abs(g - w)
    assert (err <= tol).all(), (name, float(err.max()))


# -- RG-LRU ------------------------------------------------------------------

def _rglru_inputs(seed, B=2, T=37, D=19, a_one=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    a = rng.uniform(0.01, 0.999, (B, T, D)).astype(np.float32)
    if a_one:
        a[:, 5:9] = 1.0
        x[0, 5:9, :3] = 0.0
    return (x, a, rng.normal(size=(B, D)).astype(np.float32),
            rng.normal(size=(B, T, D)).astype(np.float32),
            rng.normal(size=(B, D)).astype(np.float32))


def _rglru_jax(ref, x, a, h0, dy, dhT):
    import jax.numpy as jnp

    args = (x, a) if h0 is None else (x, a, h0)
    _, vjp = ref.jax.vjp(lambda *t: ref.kref.rglru_ref(*t), *args)
    grads = vjp((jnp.asarray(dy), jnp.asarray(
        np.zeros_like(dy[:, 0]) if dhT is None else dhT)))
    return [np.asarray(g) for g in grads]


def _rglru_port(x, a, h0, dy, dhT):
    t = {k: None if v is None else torch.from_numpy(v)
         for k, v in dict(x=x, a=a, h0=h0, dy=dy, dhT=dhT).items()}
    y, _ = kref.rglru_plain(t["x"], t["a"], t["h0"])
    return kref.rglru_backward_plain(t["x"], t["a"], y, t["dy"], t["h0"],
                                     t["dhT"])


@pytest.mark.parametrize("with_dhT", [False, True])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("T", [1, 37, 64])
def test_rglru_backward_plain_matches_jax_grad(ref, T, with_h0, with_dhT):
    x, a, h0, dy, dhT = _rglru_inputs(T, T=T)
    h0 = h0 if with_h0 else None
    dhT = dhT if with_dhT else None
    want = _rglru_jax(ref, x, a, h0, dy, dhT)
    dx, da, dh0 = _rglru_port(x, a, h0, dy, dhT)
    _close(dx, want[0], name="dx")
    _close(da, want[1], name="da")
    if with_h0:
        _close(dh0, want[2], name="dh0")


def test_rglru_backward_at_a_equal_one_is_the_references(ref):
    """a_t = 1 exactly (a float32 value the decay reaches once its gate
    logit is below about -19.5): ``jax.grad`` of the oracle gives dx = 0
    and da = -inf * sign(g x), NaN where x = 0 (XLA's sqrt'(0) = inf times
    max's tie gradient 0.5). The plain backward, and so the CPU Function,
    gives exactly these values; pinned, as the reference computes it."""
    x, a, h0, dy, dhT = _rglru_inputs(3, a_one=True)
    want = _rglru_jax(ref, x, a, h0, dy, dhT)
    got = [g.numpy() for g in _rglru_port(x, a, h0, dy, dhT)]
    one = a == 1.0
    assert (want[0][one] == 0).all()
    assert np.isinf(want[1][one & (x != 0)]).all()
    assert np.isnan(want[1][one & (x == 0)]).all()
    np.testing.assert_array_equal(got[0][one], want[0][one])
    np.testing.assert_array_equal(got[1][one], want[1][one])
    for g, w in zip(got, want):
        _close(g[~one] if g.shape == one.shape else g,
               w[~one] if w.shape == one.shape else w)
    # the Function's backward is the plain backward
    xt, at = (torch.from_numpy(v).requires_grad_(True) for v in (x, a))
    y, hT = ops.rglru(xt, at, torch.from_numpy(h0))
    torch.autograd.backward((y, hT), (torch.from_numpy(dy),
                                      torch.from_numpy(dhT)))
    np.testing.assert_array_equal(xt.grad.numpy(), got[0])
    np.testing.assert_array_equal(at.grad.numpy(), got[1])


# -- RWKV-6 ------------------------------------------------------------------

def _rwkv6_inputs(seed, B=2, H=3, T=37, Dk=16, Dv=12):
    rng = np.random.default_rng(seed)
    r, k = (rng.normal(size=(B, H, T, Dk)).astype(np.float32) * 0.5
            for _ in range(2))
    v = rng.normal(size=(B, H, T, Dv)).astype(np.float32) * 0.5
    # decay logits past 8.6 give w = 0 exactly in float32
    z = rng.normal(size=(B, H, T, Dk)) * 3.0
    z[:, :, 3] = 12.0
    w = np.exp(-np.exp(z - 4.0)).astype(np.float32)
    u = (rng.normal(size=(H, Dk)) * 0.3).astype(np.float32)
    s0 = rng.normal(size=(B, H, Dk, Dv)).astype(np.float32)
    do = rng.normal(size=(B, H, T, Dv)).astype(np.float32)
    dsT = rng.normal(size=(B, H, Dk, Dv)).astype(np.float32)
    return r, k, v, w, u, s0, do, dsT


def _bf16(x):
    return torch.from_numpy(x).bfloat16()


@pytest.mark.parametrize("with_dsT", [False, True])
@pytest.mark.parametrize("with_s0", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rwkv6_backward_plain_matches_jax_grad(ref, dtype, with_s0,
                                               with_dsT):
    """T = 37, not a multiple of the kernel's 16-step chunk; a step whose
    decay is exactly 0 (the states are recomputed, never divided)."""
    import jax.numpy as jnp

    r, k, v, w, u, s0, do, dsT = _rwkv6_inputs(5)
    assert (w[:, :, 3] == 0).all()
    s0 = s0 if with_s0 else None
    dsT = dsT if with_dsT else None
    if dtype == "bfloat16":
        tr, tk, tv, tdo = (_bf16(t) for t in (r, k, v, do))
        r, k, v, do = (t.float().numpy() for t in (tr, tk, tv, tdo))
    else:
        tr, tk, tv, tdo = (torch.from_numpy(t) for t in (r, k, v, do))
    args = (r, k, v, w, u) + (() if s0 is None else (s0,))
    _, vjp = ref.jax.vjp(lambda *t: ref.kref.rwkv6_ref(*t), *args)
    want = vjp((jnp.asarray(do), jnp.asarray(
        np.zeros(r.shape[:2] + (r.shape[3], v.shape[3]), np.float32)
        if dsT is None else dsT)))
    got = kref.rwkv6_backward_plain(
        tr, tk, tv, torch.from_numpy(w), torch.from_numpy(u), tdo,
        None if s0 is None else torch.from_numpy(s0),
        None if dsT is None else torch.from_numpy(dsT))
    assert [g.dtype for g in got[:3]] == [tr.dtype] * 3
    assert all(g.dtype == torch.float32 for g in got[3:])
    for name, g, wnt in zip(("dr", "dk", "dv", "dw", "du", "ds0"), got,
                            want):
        _close(g, np.asarray(wnt), name=name)


#: the ordered version's heads: every Dk the kernel takes against one
#: column, a ragged last tile, one and two wide heads
ORDERED_HEADS = [(Dk, Dv) for Dk in (16, 32, 64) for Dv in (1, 60, 64, 128)]
_JAX_GRADS = {}


def _ordered_case(Dk, Dv, dtype, with_state):
    """Seeded inputs at T = 37 with a step of decay exactly 0: the port's
    torch tensors (r, k, v, do in ``dtype``) and the float32 numpy arrays
    the reference takes (bf16 values widened), s0 and dS_T as given or
    ``None``."""
    r, k, v, w, u, s0, do, dsT = _rwkv6_inputs(Dk + Dv, B=2, H=2, Dk=Dk,
                                               Dv=Dv)
    assert (w[:, :, 3] == 0).all()
    if dtype == "bfloat16":
        tr, tk, tv, tdo = (_bf16(t) for t in (r, k, v, do))
        r, k, v, do = (t.float().numpy() for t in (tr, tk, tv, tdo))
    else:
        tr, tk, tv, tdo = (torch.from_numpy(t) for t in (r, k, v, do))
    s0, dsT = (x if with_state else None for x in (s0, dsT))
    port = (tr, tk, tv, torch.from_numpy(w), torch.from_numpy(u), tdo,
            None if s0 is None else torch.from_numpy(s0),
            None if dsT is None else torch.from_numpy(dsT))
    return port, (r, k, v, w, u, do, s0, dsT)


@pytest.mark.parametrize("Dk,Dv", ORDERED_HEADS)
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rwkv6_backward_ordered_within_order_bound_of_plain(dtype,
                                                            with_state, Dk,
                                                            Dv):
    """``ref.rwkv6_backward_ordered`` (the CUDA kernel's orders, Dv padded
    as the kernel pads it) takes every term bit for bit as the plain
    version does, so dr, dk, dv, dw and du lie within the bound two
    summation orders allow (``ref.sum_order_bound``), and ds0, elementwise,
    is the plain version's bit for bit; the dtypes and shapes are its."""
    port, _ = _ordered_case(Dk, Dv, dtype, with_state)
    got = kref.rwkv6_backward_ordered(*port)
    *want, sums = kref.rwkv6_backward_plain(*port, term_sums=True)
    B, _, T, _ = port[0].shape
    for name, g, wnt, sm, n in zip(("dr", "dk", "dv", "dw", "du"), got,
                                   want, sums, (Dv, Dv, Dk, Dv, Dv + B * T)):
        assert g.dtype == wnt.dtype and g.shape == wnt.shape, name
        bound = kref.sum_order_bound(sm, n, g, wnt)
        assert bool(((g.float() - wnt.float()).abs() <= bound).all()), name
    assert got[5].dtype == torch.float32 and torch.equal(got[5], want[5])


@pytest.mark.parametrize("Dk,Dv", ORDERED_HEADS)
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rwkv6_backward_ordered_matches_jax_grad(ref, dtype, with_state, Dk,
                                                 Dv):
    """``ref.rwkv6_backward_ordered`` against ``jax.vjp`` of the
    reference's ``rwkv6_ref`` (src/repro/kernels/ref.py) at T = 37 with a
    step of decay exactly 0, within the tolerances of the plain version's
    test. The reference is handed s0 and dS_T as zeros where the port's
    call has none (one compiled gradient a head shape)."""
    import jax.numpy as jnp

    port, (r, k, v, w, u, do, s0, dsT) = _ordered_case(Dk, Dv, dtype,
                                                       with_state)
    fn = _JAX_GRADS.get(id(ref))
    if fn is None:
        def grads(*args):
            _, vjp = ref.jax.vjp(ref.kref.rwkv6_ref, *args[:6])
            return vjp(args[6:])
        fn = _JAX_GRADS[id(ref)] = ref.jax.jit(grads)
    state = np.zeros(r.shape[:2] + (Dk, Dv), np.float32)
    want = fn(*(jnp.asarray(x) for x in (
        r, k, v, w, u, state if s0 is None else s0, do,
        state if dsT is None else dsT)))
    got = kref.rwkv6_backward_ordered(*port)
    for name, g, wnt in zip(("dr", "dk", "dv", "dw", "du", "ds0"), got,
                            want):
        _close(g, np.asarray(wnt), name=name)


# -- the Functions against autograd of the plain forwards ---------------------

def _grads(fn, inputs, seed):
    """Gradients of sum(out_i * c_i) over fn's outputs for seeded c."""
    xs = [None if x is None else
          x.detach().clone().requires_grad_(x.requires_grad)
          for x in inputs]
    outs = fn(*xs)
    rng = np.random.default_rng(seed)
    total = sum((o.float() * torch.from_numpy(rng.normal(
        size=tuple(o.shape)).astype(np.float32))).sum() for o in outs)
    total.backward()
    return outs, [None if x is None else x.grad for x in xs]


def _counting(monkeypatch, name):
    calls = [0]
    plain = getattr(ops, name)

    def run(*a, **k):
        calls[0] += 1
        return plain(*a, **k)
    monkeypatch.setattr(ops, name, run)
    return calls


def test_rglru_function_matches_autograd_of_plain(monkeypatch):
    x, a, h0, _, _ = _rglru_inputs(8)
    ins = [torch.from_numpy(t).requires_grad_(True) for t in (x, a, h0)]
    calls = _counting(monkeypatch, "rglru_backward_plain")
    outs, got = _grads(ops.rglru, ins, 1)
    assert type(outs[0].grad_fn).__name__ == "_RGLRUFnBackward"
    assert outs[0].grad_fn is outs[1].grad_fn
    assert calls[0] == 1
    _, want = _grads(kref.rglru_plain, ins, 1)
    for g, w in zip(got, want):
        _close(g, w.numpy())
    # h_T alone: y's gradient reaches the backward as None
    _, only = _grads(lambda *t: ops.rglru(*t)[1:], ins, 2)
    _, only_w = _grads(lambda *t: kref.rglru_plain(*t)[1:], ins, 2)
    for g, w in zip(only, only_w):
        _close(g, w.numpy())


@pytest.mark.parametrize("layout", ["dense", "head_views"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rwkv6_function_matches_autograd_of_plain(monkeypatch, dtype,
                                                  layout):
    """``head_views``: r, k, v, w as [B, H, T, D] views of [B, T, H, D]
    tensors, as ``models/recurrent.py`` passes them; their gradients come
    back through the views."""
    r, k, v, w, u, s0, _, _ = _rwkv6_inputs(9, T=21)

    def leaf(x, dt):
        t = torch.from_numpy(x).to(dt)
        if layout == "head_views":
            t = t.transpose(1, 2).contiguous()
        return t.requires_grad_(True)

    leaves = [leaf(x, dtype) for x in (r, k, v)] + [leaf(w, torch.float32)]
    extra = [torch.from_numpy(u).requires_grad_(True),
             torch.from_numpy(s0).requires_grad_(True)]

    def views(fn):
        def run(*t):
            heads = [x.transpose(1, 2) if layout == "head_views" else x
                     for x in t[:4]]
            return fn(*heads, *t[4:])
        return run

    calls = _counting(monkeypatch, "rwkv6_backward_plain")
    outs, got = _grads(views(ops.rwkv6), leaves + extra, 3)
    assert type(outs[0].grad_fn).__name__ == "_RWKV6FnBackward"
    assert calls[0] == 1
    _, want = _grads(views(kref.rwkv6_plain), leaves + extra, 3)
    for g, wt in zip(got, want):
        _close(g, wt.float().numpy())


def test_functions_stay_out_of_serving():
    """Without grad mode, or with no operand requiring a gradient, the
    wrappers return plain tensors (no graph), as serving calls them."""
    x, a, h0, _, _ = _rglru_inputs(4)
    y, _ = ops.rglru(torch.from_numpy(x), torch.from_numpy(a))
    assert y.grad_fn is None
    with torch.no_grad():
        y, _ = ops.rglru(torch.from_numpy(x).requires_grad_(True),
                         torch.from_numpy(a))
    assert y.grad_fn is None
    r, k, v, w, u, _, _, _ = _rwkv6_inputs(4, T=5)
    o, _ = ops.rwkv6(*(torch.from_numpy(t) for t in (r, k, v, w, u)))
    assert o.grad_fn is None


# -- the cost model ------------------------------------------------------------

class _Recorder:
    def __init__(self):
        self.calls = []

    def kernel(self, name, operations, nbytes):
        self.calls.append((name, operations, nbytes))


@pytest.mark.parametrize("with_state", [False, True])
def test_backward_costs_equal_on_meta_and_the_cpu(with_state):
    """A meta call (the dry run's) and a CPU call through the plain version
    report the same operations and bytes of each backward, from
    ``kernels/cost.py``, and the CUDA wrapper's workspace is allocated on
    meta as on the card."""
    x, a, h0, dy, dhT = _rglru_inputs(6)
    r, k, v, w, u, s0, do, dsT = _rwkv6_inputs(6)
    cpu = {n: torch.from_numpy(t) for n, t in dict(
        x=x, a=a, h0=h0, dy=dy, dhT=dhT, r=r, k=k, v=v, w=w, u=u, s0=s0,
        do=do, dsT=dsT).items()}
    cpu["y"] = kref.rglru_plain(cpu["x"], cpu["a"], cpu["h0"])[0]
    seen = []
    for dev in ("cpu", "meta"):
        t = {n: x.to(dev) for n, x in cpu.items()}
        st = (lambda n: t[n] if with_state else None)
        rec = _Recorder()
        cost.COUNTERS.append(rec)
        try:
            ops.rglru_bwd(t["x"], t["a"], t["y"], t["dy"], st("h0"),
                          st("dhT"))
            outs = ops.rwkv6_bwd(t["r"], t["k"], t["v"], t["w"], t["u"],
                                 t["do"], st("s0"), st("dsT"))
        finally:
            cost.COUNTERS.remove(rec)
        assert [tuple(o.shape) for o in outs] == [
            r.shape, k.shape, v.shape, w.shape, u.shape, s0.shape]
        seen.append(rec.calls)
    assert seen[0] == seen[1]
    B, T, D = x.shape
    assert seen[0][0] == ("rglru_bwd", *cost.rglru_backward(
        B, T, D, with_state, with_state))
    assert seen[0][1] == ("rwkv6_bwd", *cost.rwkv6_backward(
        *r.shape, v.shape[-1], torch.float32, with_state, with_state))


@pytest.mark.parametrize("shape", [(4, 32, 1024, 64, 64), (2, 3, 37, 32, 60),
                                   (2, 3, 37, 64, 68)])
def test_rwkv6_backward_cost_is_the_gradients_need(shape):
    """``cost.rwkv6_backward`` counts what the gradients need (14 Dk Dv +
    11 Dk + 4 Dv operations a step; the inputs read and the gradients
    written once). The kernel's reading counts its design's work under its
    plan, over the P columns its threads hold: 18 Dk P elementwise, the
    tile sums, r u a thread group, du and the dot; its bytes add the
    per-(b, h) du partials and the checkpoints of its workspace written
    and read once."""
    from repro_torch.kernels.rwkv6 import (backward_geometry, backward_plan,
                                           workspace_floats)

    B, H, T, Dk, Dv = shape
    n = B * H * T
    ops_, nbytes = cost.rwkv6_backward(B, H, T, Dk, Dv, torch.bfloat16,
                                       False, False)
    assert ops_ == n * (14 * Dk * Dv + 11 * Dk + 4 * Dv)
    assert nbytes == (n * (4 * Dk + 3 * Dv) * 2 + n * Dk * 8 + 2 * H * Dk * 4
                      + B * H * Dk * Dv * 4)
    plan = backward_plan(Dk, Dv)
    k_ops, k_bytes = cost.rwkv6_backward_kernel(
        B, H, T, Dk, Dv, torch.bfloat16, False, False, *plan)
    P = backward_geometry(plan, Dk, Dv, 2).width
    dv4 = -(-Dv // 4) * 4
    groups = P // (4 * plan.tiles)
    assert k_ops == n * (18 * Dk * P + 3 * Dk * (3 * P // 4 + dv4 // 4 - 1)
                         + 3 * Dk * P // 2 + Dv * (Dk // 4 - 1) + Dk * groups
                         + 3 * Dk + 2 * Dv)
    assert k_bytes - nbytes == ((B - 1) * H * Dk * 4
                                + 2 * 4 * workspace_floats(B, H, T, Dk, Dv))


@pytest.mark.parametrize("Dk", [16, 32, 64])
def test_rwkv6_backward_plan_covers_every_column_once(Dk):
    """For every Dv the kernel takes, each compiled plan that fits holds
    every (row, column) of the state in exactly one thread, in a block of
    at most 512 threads (no cluster: one block a head) within the 232,448
    bytes of shared memory a block may take, in bf16 and float32; the
    plan is a function of Dk and Dv alone (never of B, H or T), its chunk
    keeps 64 states a thread, and the workspace holds one [Dk, P] state
    per chunk but the last."""
    import importlib
    import inspect

    rk = importlib.import_module("repro_torch.kernels.rwkv6")
    assert list(inspect.signature(rk.backward_plan).parameters) == [
        "Dk", "Dv"]
    for Dv in range(1, rk.MAX_DV + 1):
        plans = rk.backward_plans(Dk, Dv)
        assert plans[0] == rk.backward_plan(Dk, Dv)
        for plan in plans:
            assert plan in rk.BWD_PLANS
            assert rk.BWD_ROWS * rk.BWD_TILE * plan.tiles * plan.chunk == 64
            cells = rk.backward_cells(plan, Dk, Dv)
            assert sorted(cells) == [(i, j) for i in range(Dk)
                                     for j in range(Dv)], (Dk, Dv, plan)
            for itemsize in (2, 4):
                geo = rk.backward_geometry(plan, Dk, Dv, itemsize)
                assert geo.threads <= rk.BWD_MAX_THREADS
                assert geo.threads % 2 == 0          # row pairs side by side
                assert geo.smem <= rk.SMEM_MAX and geo.smem % 16 == 0
                assert geo.width % (4 * plan.tiles) == 0 and geo.width >= Dv
            for T in (1, 8, 9, 37):
                assert rk.workspace_floats(2, 3, T, Dk, Dv, plan) == (
                    6 * (-(-T // plan.chunk) - 1) * Dk * geo.width)


# -- on the card --------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (chip_smoke.py runs it)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("B,T,D", [(3, 37, 300), (4, 1, 4096), (2, 9, 17)])
def test_cuda_rglru_bwd_matches_plain_version(B, T, D):
    dev = _cuda()
    x, a, h0, dy, dhT = (torch.from_numpy(t).to(dev) for t in _rglru_inputs(
        T, B=B, T=T, D=D, a_one=T > 9))
    y, _ = ops.rglru(x, a, h0)
    for args in ((h0, dhT), (None, None)):
        yy = y if args[0] is not None else ops.rglru(x, a)[0]
        before = ops.rglru_bwd.launches
        got = ops.rglru_bwd(x, a, yy, dy, *args)
        torch.cuda.synchronize()
        assert ops.rglru_bwd.launches == before + 1
        want = kref.rglru_backward_plain(x, a, yy, dy, *args)
        for g, w in zip(got, want):   # NaN where x = 0 and a = 1 on both
            assert torch.equal(g.isnan(), w.isnan())
            assert torch.equal(torch.nan_to_num(g), torch.nan_to_num(w))


def _rwkv6_cuda_check(r, k, v, w, u, do, s0, dsT):
    """``ops.rwkv6_bwd`` on the card bit for bit ``ref.rwkv6_backward_
    ordered`` in all six outputs, and against the plain backward within
    the summation-order bound (``ref.sum_order_bound``)."""
    before = ops.rwkv6_bwd.launches
    got = ops.rwkv6_bwd(r, k, v, w, u, do, s0, dsT)
    torch.cuda.synchronize()
    assert ops.rwkv6_bwd.launches == before + 1
    ordered = kref.rwkv6_backward_ordered(r, k, v, w, u, do, s0, dsT)
    for name, g, o in zip(("dr", "dk", "dv", "dw", "du", "ds0"), got,
                          ordered):
        assert g.dtype == o.dtype and torch.equal(g, o), name
    *want, sums = kref.rwkv6_backward_plain(r, k, v, w, u, do, s0, dsT,
                                            term_sums=True)
    B, _, T, Dk = r.shape
    Dv = v.shape[-1]
    n_terms = (Dv, Dv, Dk, Dv, Dv + B * T)
    for name, g, wnt, sm, n in zip(("dr", "dk", "dv", "dw", "du"), got,
                                   want, sums, n_terms):
        assert g.dtype == wnt.dtype and g.shape == wnt.shape, name
        bound = kref.sum_order_bound(sm, n, g, wnt)
        assert bool(((g.float() - wnt.float()).abs() <= bound).all()), name
    assert torch.equal(got[5], want[5])   # ds0: elementwise, bit for bit


@pytest.mark.gpu
@pytest.mark.parametrize("Dk,Dv,T", [(64, 64, 37), (32, 60, 16), (16, 128, 5),
                                     (64, 1, 33)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_rwkv6_bwd_matches_plain_version(dtype, Dk, Dv, T):
    """Ragged T (not a multiple of the 16-step chunk), Dv not a multiple
    of four, r, k, v, w, do as head views of [B, T, H, D] tensors (the
    gradients then come back in the same layout), s0 and dS_T given or
    not."""
    dev = _cuda()
    r, k, v, w, u, s0, do, dsT = _rwkv6_inputs(Dk + Dv + T, B=2, H=3, T=T,
                                               Dk=Dk, Dv=Dv)

    def heads(x, dt):
        return torch.from_numpy(x).to(dev, dt).transpose(1, 2).contiguous() \
            .transpose(1, 2)

    rr, kk, vv, dd = (heads(x, dtype) for x in (r, k, v, do))
    ww = heads(w, torch.float32)
    uu, ss, dS = (torch.from_numpy(x).to(dev) for x in (u, s0, dsT))
    _rwkv6_cuda_check(rr, kk, vv, ww, uu, dd, ss, dS)
    _rwkv6_cuda_check(rr, kk, vv, ww, uu, dd, None, None)
    got = ops.rwkv6_bwd(rr, kk, vv, ww, uu, dd)
    assert [g.stride() for g in got[:4]] == [x.stride()
                                             for x in (rr, kk, vv, ww)]


@pytest.mark.gpu
@pytest.mark.parametrize("Dk,Dv", [(64, 64), (64, 60), (64, 1)])
def test_cuda_rwkv6_bwd_plans_agree(Dk, Dv):
    """Every compiled plan that fits a head (``rwkv6.backward_plans``: one
    column tile a thread with an 8-step chunk, two with a 4-step chunk)
    gives all six outputs bit for bit alike, on head views at a ragged T,
    from s0 with dS_T."""
    import importlib

    rk = importlib.import_module("repro_torch.kernels.rwkv6")
    dev = _cuda()
    r, k, v, w, u, s0, do, dsT = (torch.from_numpy(x).to(dev) for x in
                                  _rwkv6_inputs(7, T=37, Dk=Dk, Dv=Dv))
    outs = []
    for plan in rk.backward_plans(Dk, Dv):
        B, H, T, _ = r.shape
        o = (torch.empty_like(r), torch.empty_like(k), torch.empty_like(v),
             torch.empty_like(w), torch.empty((B, H, Dk), device=dev),
             torch.empty_like(s0))
        work = torch.empty((rk.workspace_floats(B, H, T, Dk, Dv, plan),),
                           device=dev)
        rk.launch_backward(r, k, v, w, u, do, s0, dsT, *o, work, _plan=plan)
        outs.append(o)
    torch.cuda.synchronize()
    assert len(outs) == 2
    assert all(torch.equal(x, y) for x, y in zip(*outs))


@pytest.mark.gpu
def test_cuda_functions_launch_one_forward_and_one_backward():
    """Under grad each Function launches its forward kernel once and its
    backward kernel once: nothing goes through a plain loop."""
    dev = _cuda()
    x, a, h0, _, _ = _rglru_inputs(2)
    ins = [torch.from_numpy(t).to(dev).requires_grad_(True)
           for t in (x, a, h0)]
    ops.reset_launch_counts()
    y, hT = ops.rglru(*ins)
    (y.sum() + hT.sum()).backward()
    torch.cuda.synchronize()
    r, k, v, w, u, _, _, _ = _rwkv6_inputs(2, Dk=64, Dv=64)
    ins = [torch.from_numpy(t).to(dev).requires_grad_(True)
           for t in (r, k, v, w, u)]
    o, sT = ops.rwkv6(*ins)
    (o.sum() + sT.sum()).backward()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert {n: counts[n] for n in ("rglru", "rglru_bwd", "rwkv6",
                                   "rwkv6_bwd")} == dict.fromkeys(
        ("rglru", "rglru_bwd", "rwkv6", "rwkv6_bwd"), 1)
    assert all(x.grad is not None and torch.isfinite(x.grad).all()
               for x in ins)


#: the card's one-step gradients against the CPU's, of each leaf's scale,
#: a limit for each config set above its reading (NVIDIA H100 80GB HBM3):
#: recurrentgemma-9b's were within 1e-5; rwkv6-1.6b's were 1.6e-5 (its
#: ``embed``): its kernels sum in other orders than the plain loops, and
#: its per-head group norm over 16 columns (the smoke config) amplifies
#: that: on the CPU the forward's order alone (``ref.rwkv6_ordered`` for
#: ``rwkv6_plain``) moves its gradients by 6e-6 of scale
CARD_GRAD_OF_SCALE = {"rwkv6-1.6b": 5e-5, "recurrentgemma-9b": 1e-5}


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "recurrentgemma-9b"])
def test_cuda_recurrent_loss_and_gradients_match_cpu(arch):
    """The smoke config in float32: the card's loss against the CPU's
    (IEEE float32 products) within a relative 1e-5, each gradient within
    ``CARD_GRAD_OF_SCALE[arch]`` of its scale, launches exactly
    ``train_launches``."""
    from repro_torch.core.precision import ieee_float32

    dev = _cuda()
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32",
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
        grads.append((float(loss.detach()), {n: p.grad.cpu()
                                             for n, p in tp.items()}))
    want = train_launches(cfg, 40)
    assert {n: counts[n] for n in want} == want
    np.testing.assert_allclose(grads[0][0], grads[1][0], rtol=1e-5)
    worst = max((float((grads[0][1][n] - g).abs().max())
                 / max(float(g.abs().max()), 1e-30), n)
                for n, g in grads[1][1].items())
    print(f"{arch}: card against CPU, loss {grads[0][0]!r} and "
          f"{grads[1][0]!r}, largest gradient gap {worst[0]:.3e} of scale "
          f"({worst[1]})")
    for n, g in grads[1][1].items():
        _close(grads[0][1][n], g.numpy(), CARD_GRAD_OF_SCALE[arch], name=n)
