"""The port's ``acd_evict``, ``fifo_dispatch`` and ``matmul`` against the
reference's two versions of each.

The same seeded numpy inputs go through the port's plain PyTorch version
(``acd_evict_plain`` / ``fifo_dispatch_plain``, what the wrappers run for
CPU tensors), the reference's oracle (``ref.acd_evict_ref`` /
``ref.fifo_dispatch_ref``) and the reference's Pallas kernel in interpret
mode. All three must agree bit for bit (``acd_evict`` in float64 and in
float32, ``fifo_dispatch`` in float64 with the cold-start model off and
on; ``matmul`` within a stated float32 tolerance, and bit for bit on the
matrix app's integer ``x @ x.T``). The CUDA kernels themselves run only on
a GPU: their cases here are
marked ``gpu`` and skip without one; ``chip_smoke.py`` holds them against
the plain versions on the card.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ref import (acd_evict_plain, fifo_dispatch_plain,
                                     matmul_plain, rglru_plain, rwkv6_plain)
from tests.test_torch_harness import reference

DTYPES = {"f64": (np.float64, torch.float64), "f32": (np.float32,
                                                     torch.float32)}


@pytest.fixture(scope="module")
def ref():
    return reference()


def _inputs(rng, b, j, np_dtype, p_mask=0.8):
    P = rng.lognormal(0.0, 0.6, (b, j))
    # thresholds in the contested range so the sweeps actually evict
    thresh = rng.uniform(0.0, 0.5 * j, (b, j)) * float(P.mean())
    mask = rng.random((b, j)) < p_mask
    return P.astype(np_dtype), thresh.astype(np_dtype), mask


def _reference_versions(ref, P, thresh, mask):
    """(oracle, Pallas-interpret) results of the reference, as numpy."""
    jax = ref.jax
    import jax.numpy as jnp

    with jax.enable_x64(P.dtype == np.float64):
        args = (jnp.asarray(P), jnp.asarray(thresh), jnp.asarray(mask))
        oracle = np.asarray(ref.kref.acd_evict_ref(*args))
        kernel = np.asarray(ref.acd_sweep.acd_evict(*args, interpret=True))
    return oracle, kernel


def _plain(P, thresh, mask):
    return acd_evict_plain(torch.from_numpy(P), torch.from_numpy(thresh),
                           torch.from_numpy(mask)).numpy()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("b,j", [(1, 8), (4, 64), (30, 64), (3, 512),
                                 (2, 4096)])
def test_plain_matches_reference_oracle_and_pallas(ref, dtype, b, j):
    rng = np.random.default_rng(b * 1000 + j)
    P, thresh, mask = _inputs(rng, b, j, DTYPES[dtype][0])
    got = _plain(P, thresh, mask)
    oracle, kernel = _reference_versions(ref, P, thresh, mask)
    np.testing.assert_array_equal(got, oracle)
    np.testing.assert_array_equal(got, kernel)
    assert got.any() and not got[~mask].any()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_empty_mask_evicts_nothing(ref, dtype):
    rng = np.random.default_rng(3)
    P, _, _ = _inputs(rng, 2, 16, DTYPES[dtype][0])
    thresh = np.zeros_like(P)
    mask = np.zeros(P.shape, dtype=bool)
    got = _plain(P, thresh, mask)
    oracle, kernel = _reference_versions(ref, P, thresh, mask)
    assert not got.any() and not oracle.any() and not kernel.any()


def _brute_acd(P, thresh, mask):
    """Iterated remove-first-violator-and-resweep fixpoint (the DES's
    literal cascade) — what the one-pass recurrence telescopes into."""
    J = len(P)
    ev = np.zeros(J, bool)
    while True:
        s, viol = 0.0, None
        for i in range(J):
            if mask[i] and not ev[i]:
                if s > thresh[i]:
                    viol = i
                    break
                s += P[i]
        if viol is None:
            return ev
        ev[viol] = True


def test_matches_iterated_cascade(ref):
    rng = np.random.default_rng(7)
    for _ in range(10):
        j = int(rng.integers(4, 40))
        P = rng.lognormal(0.0, 0.8, j)
        thresh = rng.uniform(0.0, P.sum() * 0.6, j)
        mask = rng.random(j) < 0.7
        want = _brute_acd(P, thresh, mask)
        got = _plain(P[None], thresh[None], mask[None])[0]
        np.testing.assert_array_equal(got, want)
        oracle, kernel = _reference_versions(ref, P[None], thresh[None],
                                             mask[None])
        np.testing.assert_array_equal(oracle[0], want)
        np.testing.assert_array_equal(kernel[0], want)


def test_near_ties_follow_the_sequential_sum(ref):
    """Thresholds set exactly at the running kept sum, and one ulp either
    side: ``s > thresh`` must see the sequentially associated sum."""
    rng = np.random.default_rng(11)
    P = rng.lognormal(0.0, 0.5, (3, 64))
    s = np.concatenate([np.zeros((3, 1)), np.cumsum(P, axis=1)[:, :-1]],
                       axis=1)  # numpy's cumsum is sequential
    thresh = np.stack([s[0], np.nextafter(s[1], -np.inf),
                       np.nextafter(s[2], np.inf)])
    # no subnormal thresholds: XLA on the CPU flushes them to zero
    thresh[1, 0] = 0.0
    mask = np.ones(P.shape, dtype=bool)
    got = _plain(P, thresh, mask)
    oracle, kernel = _reference_versions(ref, P, thresh, mask)
    np.testing.assert_array_equal(got, oracle)
    np.testing.assert_array_equal(got, kernel)
    assert not got[0].any() and not got[2].any() and got[1, 1]


def test_wrapper_on_cpu_runs_plain_version_and_counts_nothing():
    rng = np.random.default_rng(5)
    P, thresh, mask = _inputs(rng, 4, 33, np.float64)
    before = ops.acd_evict.launches
    got = ops.acd_evict(torch.from_numpy(P), torch.from_numpy(thresh),
                        torch.from_numpy(mask))
    assert got.dtype == torch.bool and got.shape == (4, 33)
    np.testing.assert_array_equal(got.numpy(), _plain(P, thresh, mask))
    assert ops.acd_evict.launches == before


@pytest.mark.parametrize("case", ["mixed_dtype", "int_P", "mask_dtype",
                                  "one_d", "shape", "strided", "device"])
def test_wrapper_rejects_bad_arguments(case):
    P = torch.rand(3, 8, dtype=torch.float64)
    thresh = torch.rand(3, 8, dtype=torch.float64)
    mask = torch.ones(3, 8, dtype=torch.bool)
    if case == "mixed_dtype":
        thresh = thresh.float()
    elif case == "int_P":
        P, thresh = P.long(), thresh.long()
    elif case == "mask_dtype":
        mask = mask.to(torch.uint8)
    elif case == "one_d":
        P, thresh, mask = P[0], thresh[0], mask[0]
    elif case == "shape":
        thresh = thresh[:, :7].contiguous()
    elif case == "strided":
        P = torch.rand(8, 3, dtype=torch.float64).t()
    elif case == "device":
        P, thresh, mask = (x.to("meta") for x in (P, thresh, mask))
    with pytest.raises((TypeError, ValueError)):
        ops.acd_evict(P, thresh, mask)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cuda_kernel_matches_plain_version(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (chip_smoke.py runs it)")
    rng = np.random.default_rng(9)
    P, thresh, mask = _inputs(rng, 30, 4097, DTYPES[dtype][0])
    before = ops.acd_evict.launches
    got = ops.acd_evict(*(torch.from_numpy(x).cuda()
                          for x in (P, thresh, mask)))
    torch.cuda.synchronize()
    assert ops.acd_evict.launches == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(), _plain(P, thresh, mask))


# -- fifo_dispatch ----------------------------------------------------------

FIFO_OUT = ("prov", "seg", "wait", "cold", "start", "end", "extra")


def _fifo_rows(rng, B, J, P, C, n_pub, cold):
    """B rows of the reference kernel test's inputs (``_dispatch_inputs``
    of ``tests/test_kernels.py``) sharing one ``capped``/``wu`` [P]."""
    n_pub = np.broadcast_to(np.asarray(n_pub), (B,)).astype(np.int32)
    order = np.stack([np.concatenate([rng.permutation(n),
                                      np.arange(n, J)])
                      for n in n_pub]).astype(np.int32)
    locpub = np.zeros((B, J), bool)
    for b, n in enumerate(n_pub):
        locpub[b, order[b, :n]] = True
    ready = rng.uniform(0.0, 5.0, (B, P, J))
    dur = rng.lognormal(0.0, 0.5, (B, P, J))
    selc = rng.uniform(0.0, 2.0, (B, P, J))
    occ = rng.uniform(0.0, 0.3, (B, P, J))
    seg = rng.integers(0, 4, (B, P, J)).astype(np.int32)
    capped = rng.random(P) < 0.7
    wu = rng.uniform(0.1, 1.0, P)
    sclk0 = rng.uniform(0.0, 3.0, (B, P, C))
    sidle0 = np.where(rng.random((B, P, C)) < (0.5 if cold else 0.0),
                      -np.inf, sclk0)
    return dict(order=order, locpub=locpub, n_pub=n_pub, ready=ready,
                dur=dur, selc=selc, occ=occ, seg=seg, capped=capped, wu=wu,
                sclk0=sclk0, sidle0=sidle0, keep_alive=0.75)


_FIFO_ARGS = ("order", "n_pub", "ready", "dur", "selc", "occ", "seg",
              "capped", "wu", "sclk0", "sidle0")
#: the reference kernel also takes the public mask (it reads only order
#: and n_pub)
_FIFO_REF_ARGS = ("order", "locpub") + _FIFO_ARGS[1:]


def _fifo_plain(x, cold, device="cpu"):
    args = [torch.from_numpy(np.ascontiguousarray(x[k])).to(device)
            for k in _FIFO_ARGS]
    return [o.cpu().numpy() for o in fifo_dispatch_plain(
        *args, x["keep_alive"], cold=cold)]


def _fifo_reference(ref, x, cold):
    """(oracle, Pallas-interpret) outputs of the reference, row by row,
    stacked to [B, J] numpy arrays."""
    jax = ref.jax
    import jax.numpy as jnp

    from repro.kernels import dispatch

    oracle, kernel = [], []
    with jax.enable_x64(True):
        for b in range(x["order"].shape[0]):
            row = [jnp.asarray(x[k] if k in ("capped", "wu") else x[k][b])
                   for k in _FIFO_REF_ARGS]
            oracle.append([np.asarray(o) for o in ref.kref.fifo_dispatch_ref(
                *row, x["keep_alive"], cold=cold)])
            kernel.append([np.asarray(o) for o in dispatch.fifo_dispatch(
                *row, x["keep_alive"], cold=cold, interpret=True)])
    return ([np.stack([r[i] for r in oracle]) for i in range(7)],
            [np.stack([r[i] for r in kernel]) for i in range(7)])


def _assert_fifo_equal(got, want, where=""):
    for name, g, w in zip(FIFO_OUT, got, want):
        assert g.shape == w.shape, f"{where} {name}: {g.shape} != {w.shape}"
        np.testing.assert_array_equal(g, w, err_msg=f"{where} {name}")


@pytest.mark.parametrize("cold", [False, True])
@pytest.mark.parametrize("j,p,c,n_pub", [(8, 2, 2, 8), (24, 3, 4, 17),
                                         (64, 4, 2, 50)])
def test_fifo_plain_matches_reference_oracle_and_pallas(ref, cold, j, p, c,
                                                        n_pub):
    rng = np.random.default_rng(j * 100 + p * 10 + c + cold)
    x = _fifo_rows(rng, 3, j, p, c, n_pub, cold)
    got = _fifo_plain(x, cold)
    oracle, kernel = _fifo_reference(ref, x, cold)
    _assert_fifo_equal(got, oracle, "oracle")
    _assert_fifo_equal(got, kernel, "pallas")
    assert got[2].any()  # some queueing wait


@pytest.mark.parametrize("cold", [False, True])
def test_fifo_ragged_rows_and_edge_counts(ref, cold):
    """Rows of one batch with n_pub = 0, J and in between: the chain of
    each row stops at its own count."""
    rng = np.random.default_rng(17 + cold)
    x = _fifo_rows(rng, 4, 13, 3, 2, np.array([0, 13, 5, 1]), cold)
    got = _fifo_plain(x, cold)
    oracle, kernel = _fifo_reference(ref, x, cold)
    _assert_fifo_equal(got, oracle, "oracle")
    _assert_fifo_equal(got, kernel, "pallas")
    assert all(not o[0].any() for o in got)  # n_pub = 0: zero fill


def test_fifo_chain_advances_clocks_sequentially(ref):
    """All jobs to one capped provider with one slot: starts chain end to
    end in visit order (pure FIFO queueing)."""
    rng = np.random.default_rng(4)
    x = _fifo_rows(rng, 2, 6, 1, 1, 6, False)
    x["capped"] = np.ones(1, bool)
    x["occ"] = np.zeros_like(x["occ"])
    got = _fifo_plain(x, False)
    oracle, kernel = _fifo_reference(ref, x, False)
    _assert_fifo_equal(got, oracle, "oracle")
    _assert_fifo_equal(got, kernel, "pallas")
    start, end = got[4], got[5]
    for b in range(2):
        order = x["order"][b]
        for a, nxt in zip(order[:-1], order[1:]):
            assert start[b, nxt] >= end[b, a]


def test_fifo_n_pub_truncates(ref):
    rng = np.random.default_rng(8)
    x = _fifo_rows(rng, 2, 12, 2, 2, 12, False)
    x["n_pub"] = np.array([5, 5], np.int32)
    got = _fifo_plain(x, False)
    oracle, kernel = _fifo_reference(ref, x, False)
    _assert_fifo_equal(got, oracle, "oracle")
    _assert_fifo_equal(got, kernel, "pallas")
    tail = x["order"][:, 5:]
    for o in got:
        assert (np.take_along_axis(o, tail, axis=1) == 0).all()


@pytest.mark.parametrize("cold", [False, True])
@pytest.mark.parametrize("case", ["tied_clocks", "infeasible_provider",
                                  "all_inf_column", "never_used_slots",
                                  "uncapped_provider"])
def test_fifo_edge_cases(ref, cold, case):
    """Ties take the first index in both argmins; an infeasible provider
    (selc = inf) is never chosen while another is feasible, and an all-inf
    column picks provider 0; never-used slots (idle -inf) are cold; an
    uncapped provider never waits and never turns cold."""
    rng = np.random.default_rng(23 + cold)
    x = _fifo_rows(rng, 3, 16, 3, 3, 16, cold)
    x["capped"] = np.array([True, True, False])
    if case == "tied_clocks":
        x["sclk0"][:] = 1.0
        x["sidle0"][:] = 1.0
        x["selc"][:, 1] = x["selc"][:, 0]
        x["occ"][:, 1] = x["occ"][:, 0]
        x["ready"][:, 1] = x["ready"][:, 0]
        x["wu"][1] = x["wu"][0]
    elif case == "infeasible_provider":
        x["selc"][:, 0] = np.inf
    elif case == "all_inf_column":
        x["selc"][:, :, ::3] = np.inf
    elif case == "never_used_slots":
        x["sidle0"][:] = -np.inf
    got = _fifo_plain(x, cold)
    oracle, kernel = _fifo_reference(ref, x, cold)
    _assert_fifo_equal(got, oracle, "oracle")
    _assert_fifo_equal(got, kernel, "pallas")
    prov, wait, cold_o = got[0], got[2], got[3]
    if case == "infeasible_provider":
        assert not (prov == 0).any()
    if case == "all_inf_column":
        assert (prov[:, ::3] == 0).all()
    if case == "never_used_slots" and cold:
        assert cold_o.any()
    if case == "tied_clocks":
        # the first visited job sees providers 0 and 1 tied: 0 wins
        first = x["order"][:, 0]
        assert (prov[np.arange(3), first] != 1).all()
    assert (wait[prov == 2] == 0).all() and not cold_o[prov == 2].any()


def test_fifo_wrapper_on_cpu_runs_plain_version_and_counts_nothing():
    rng = np.random.default_rng(6)
    x = _fifo_rows(rng, 3, 20, 3, 2, 11, True)
    before = ops.fifo_dispatch.launches
    args = [torch.from_numpy(x[k]) for k in _FIFO_ARGS]
    got = ops.fifo_dispatch(*args, x["keep_alive"], cold=True)
    assert [o.dtype for o in got] == [
        torch.int32, torch.int32, torch.float64, torch.bool, torch.float64,
        torch.float64, torch.float64]
    _assert_fifo_equal([o.numpy() for o in got], _fifo_plain(x, True))
    assert ops.fifo_dispatch.launches == before
    assert set(ops.launch_counts()) == {"acd_evict", "fifo_dispatch",
                                        "matmul", "flash_attention",
                                        "flash_decode", "rglru", "rglru_bwd",
                                        "rwkv6", "rwkv6_bwd"}


@pytest.mark.parametrize("case", ["order_dtype", "ready_dtype", "seg_dtype",
                                  "capped_shape", "sclk_shape", "strided",
                                  "device", "keep_alive"])
def test_fifo_wrapper_rejects_bad_arguments(case):
    rng = np.random.default_rng(1)
    x = _fifo_rows(rng, 2, 8, 2, 2, 8, False)
    args = {k: torch.from_numpy(x[k]) for k in _FIFO_ARGS}
    ka = x["keep_alive"]
    if case == "order_dtype":
        args["order"] = args["order"].long()
    elif case == "ready_dtype":
        args["ready"] = args["ready"].float()
    elif case == "seg_dtype":
        args["seg"] = args["seg"].long()
    elif case == "capped_shape":
        args["capped"] = torch.ones(3, dtype=torch.bool)
    elif case == "sclk_shape":
        args["sclk0"] = args["sclk0"][:, :1].contiguous()
    elif case == "strided":
        args["dur"] = args["dur"].transpose(1, 2).contiguous().transpose(1, 2)
    elif case == "device":
        args["occ"] = args["occ"].to("meta")
    elif case == "keep_alive":
        ka = torch.tensor(0.75)
    with pytest.raises((TypeError, ValueError)):
        ops.fifo_dispatch(*(args[k] for k in _FIFO_ARGS), ka)


@pytest.mark.gpu
@pytest.mark.parametrize("cold", [False, True])
def test_cuda_fifo_kernel_matches_plain_version(cold):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (chip_smoke.py runs it)")
    rng = np.random.default_rng(12)
    x = _fifo_rows(rng, 30, 4097, 3, 2,
                   rng.integers(0, 4098, 30), cold)
    before = ops.fifo_dispatch.launches
    got = ops.fifo_dispatch(*(torch.from_numpy(x[k]).cuda()
                              for k in _FIFO_ARGS), x["keep_alive"],
                            cold=cold)
    torch.cuda.synchronize()
    assert ops.fifo_dispatch.launches == before + 1
    _assert_fifo_equal([o.cpu().numpy() for o in got], _fifo_plain(x, cold))


# -- matmul -----------------------------------------------------------------

MATMUL_SHAPES = [(1, 1, 1), (8, 8, 8), (130, 257, 65), (127, 129, 131),
                 (64, 200, 3)]


def _mm_inputs(rng, m, k, n):
    return (rng.normal(size=(m, k)).astype(np.float32),
            rng.normal(size=(k, n)).astype(np.float32))


def _mm_bound(x, y):
    """The float32 tolerance of any summation order:
    ``|got - want| <= 1e-5 * (|x| @ |y|)`` elementwise."""
    return 1e-5 * (np.abs(x.astype(np.float64)) @ np.abs(y.astype(np.float64)))


def _reference_matmul(ref, x, y):
    """(oracle, Pallas-interpret) results of the reference, as float32."""
    import jax.numpy as jnp

    xj, yj = jnp.asarray(x), jnp.asarray(y)
    oracle = ref.kref.matmul_ref(xj, yj)
    kernel = ref.matmul(xj, yj, interpret=True)
    return (np.asarray(oracle.astype(jnp.float32)),
            np.asarray(kernel.astype(jnp.float32)))


@pytest.mark.parametrize("m,k,n", MATMUL_SHAPES)
def test_matmul_plain_matches_reference_f32(ref, m, k, n):
    rng = np.random.default_rng(m * 7 + k * 3 + n)
    x, y = _mm_inputs(rng, m, k, n)
    got = matmul_plain(torch.from_numpy(x), torch.from_numpy(y))
    assert got.dtype == torch.float32 and got.shape == (m, n)
    oracle, kernel = _reference_matmul(ref, x, y)
    bound = _mm_bound(x, y)
    assert (np.abs(got.numpy() - oracle) <= bound).all()
    assert (np.abs(got.numpy() - kernel) <= bound).all()


@pytest.mark.parametrize("m,k,n", [(130, 257, 65), (16, 64, 32)])
def test_matmul_plain_matches_reference_bf16(ref, m, k, n):
    """bf16 in, float32 accumulation, bf16 out: the float32 sums agree to
    the order tolerance, so the rounded outputs differ by at most one bf16
    ulp (2^-7 of the value)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(m + k + n)
    x, y = _mm_inputs(rng, m, k, n)
    xb, yb = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, y))
    got = matmul_plain(xb, yb)
    assert got.dtype == torch.bfloat16
    xf, yf = xb.float().numpy(), yb.float().numpy()  # the bf16 values
    xj = jnp.asarray(xf).astype(jnp.bfloat16)
    yj = jnp.asarray(yf).astype(jnp.bfloat16)
    oracle = np.asarray(ref.kref.matmul_ref(xj, yj).astype(jnp.float32))
    kernel = np.asarray(ref.matmul(xj, yj, interpret=True)
                        .astype(jnp.float32))
    g = got.float().numpy()
    bound = 2.0 ** -7 * np.abs(oracle) + _mm_bound(xf, yf)
    assert (np.abs(g - oracle) <= bound).all()
    assert (np.abs(g - kernel) <= bound).all()


@pytest.mark.parametrize("n", [8, 72, 96])
def test_matmul_integer_gram_is_exact(ref, n):
    """The matrix app's MM: ``x @ x.T`` of integers 0-9 has integer
    partial sums below 2^24, so it is exact in float32 in any order."""
    import jax.numpy as jnp

    rng = np.random.default_rng(n)
    x = rng.integers(0, 10, (n, n)).astype(np.float32)
    xt = torch.from_numpy(x)
    got = ops.matmul(xt, xt.T).numpy()
    want = (x.astype(np.int64) @ x.T.astype(np.int64)).astype(np.float32)
    np.testing.assert_array_equal(got, want)
    oracle, kernel = _reference_matmul(ref, x, x.T.copy())
    np.testing.assert_array_equal(got, oracle)
    np.testing.assert_array_equal(got, kernel)
    np.testing.assert_array_equal(
        got, np.asarray(ref.kops.matmul(jnp.asarray(x), jnp.asarray(x).T)))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("m", [1, 8, 40, 130, 656])
def test_matmul_plain_rows_do_not_depend_on_the_row_count(m, dtype):
    """Every row of ``matmul_plain(x[:M], y)`` equals the row computed
    alone, bit for bit, as the kernel's rows do: what lets the CPU's bf16
    prefill(S) + decode_step equal prefill(S+1) where the plain attention
    agrees."""
    rng = np.random.default_rng(m)
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    x, y = (torch.from_numpy(a).to(tdt) for a in _mm_inputs(rng, m, 1536,
                                                              384))
    full = matmul_plain(x, y)
    assert full.shape == (m, 384) and full.dtype == tdt
    for i in range(m):
        assert torch.equal(matmul_plain(x[i:i + 1], y)[0], full[i]), i


def test_matmul_wrapper_on_cpu_runs_plain_version_and_counts_nothing():
    rng = np.random.default_rng(21)
    x, y = _mm_inputs(rng, 33, 17, 9)
    before = ops.matmul.launches
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    got = ops.matmul(xt, yt)
    np.testing.assert_array_equal(got.numpy(), matmul_plain(xt, yt).numpy())
    # strided views are taken as they are
    got_t = ops.matmul(yt.T, xt.T)
    np.testing.assert_array_equal(got_t.numpy(),
                                  matmul_plain(yt.T, xt.T).numpy())
    assert ops.matmul.launches == before
    assert ops.launch_counts()["matmul"] == before


@pytest.mark.parametrize("case", ["f64", "int", "mixed", "one_d", "inner",
                                  "device", "not_tensor"])
def test_matmul_wrapper_rejects_bad_arguments(case):
    x = torch.rand(4, 5)
    y = torch.rand(5, 3)
    if case == "f64":
        x, y = x.double(), y.double()
    elif case == "int":
        x, y = x.int(), y.int()
    elif case == "mixed":
        y = y.to(torch.bfloat16)
    elif case == "one_d":
        x = x[0]
    elif case == "inner":
        y = torch.rand(4, 3)
    elif case == "device":
        y = y.to("meta")
    elif case == "not_tensor":
        y = y.numpy()
    with pytest.raises((TypeError, ValueError)):
        ops.matmul(x, y)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_cuda_matmul_kernel_matches_plain_version(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (chip_smoke.py runs it)")
    rng = np.random.default_rng(31)
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    for m, k, n in MATMUL_SHAPES + [(496, 496, 496)]:
        x, y = (torch.from_numpy(a).to(tdt).cuda()
                for a in _mm_inputs(rng, m, k, n))
        before = ops.matmul.launches
        got = ops.matmul(x, y)
        torch.cuda.synchronize()
        assert ops.matmul.launches == before + 1
        want = matmul_plain(x.cpu(), y.cpu()).float().numpy()
        bound = _mm_bound(x.float().cpu().numpy(), y.float().cpu().numpy())
        if dtype == "bf16":
            bound = bound + 2.0 ** -7 * np.abs(want)
        assert (np.abs(got.float().cpu().numpy() - want) <= bound).all()
    xi = torch.from_numpy(rng.integers(0, 10, (496, 496)).astype(
        np.float32)).cuda()
    np.testing.assert_array_equal(ops.matmul(xi, xi.T).cpu().numpy(),
                                  matmul_plain(xi.cpu(), xi.cpu().T).numpy())


# -- the bf16 kernel's tile plan ---------------------------------------------

#: row counts the plan must treat alike: a lone row, a decode step, a
#: smoke batch, the serve batch's prefill rows, the long batch's
PLAN_ROWS = (1, 8, 40, 656, 8192)
#: whisper-large-v3's encoder rows (and its cross wk / wv rows): 8 and 32
#: segments of 1,500 frames
ENCODER_ROWS = (12000, 48000)
#: ragged products: odd widths, K not a multiple of 16, N below one tile
PLAN_RAGGED = [(257, 65, (65, 1)), (129, 131, (1, 129)), (40, 256, (256, 1)),
               (1, 1, (1, 1)), (4096, 7, (7, 1))]


def _mm_module():
    import importlib

    return importlib.import_module("repro_torch.kernels.matmul")


def _served_products(arch):
    """(K, N, y strides) of each 2-D parameter of ``arch``'s full config
    as ``layers.linear`` reads it (a layer view of its stack, N
    contiguous), of each expert's weights (a view of its [E, K, N] stack),
    of the encoder's layers and the decoder's cross-attention, and of its
    head (the tied embedding's transpose)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model, _layer_init
    from repro_torch.models.moe import moe_init

    cfg = get_config(arch)

    def leaves(tree):
        for v in tree.values():
            yield from (leaves(v) if isinstance(v, dict) else (v,))

    layers = [_layer_init(cfg, kind, cfg.is_encdec)
              for kind in {cfg.layer_kind(i) for i in range(cfg.num_layers)}]
    if cfg.is_encdec:
        layers.append(_layer_init(
            Model(cfg, device="meta").encoder_cfg(), "attn"))
    out = set()
    for layer in layers:
        for spec in leaves(layer):
            if len(spec.shape) == 2:
                K, N = spec.shape
                out.add((K, N, (N, 1)))
    if cfg.num_experts:
        for spec in moe_init(cfg, torch.bfloat16).values():
            K, N = spec.shape[-2:]
            out.add((K, N, (N, 1)))
    d, V = cfg.d_model, cfg.vocab_size
    out.add((d, V, (1, d)) if cfg.tied_embeddings else (d, V, (V, 1)))
    return sorted(out)


def _plans_across_rows(products, rows=PLAN_ROWS):
    for K, N, strides in products:
        plans = [_mm_module().tile_plan(M, N, K, strides) for M in rows]
        # what fixes each element's sum beyond the module's constant X, BK
        # and K order: y's layout, from its strides, never from M
        assert len({p.b_major for p in plans}) == 1, (K, N, plans)
        assert plans[0].b_major == ("k" if strides[0] == 1 and not (
            strides[1] == 1 and N > 1) else "mn")
        for M, p in zip(rows, plans):
            # M chooses only the block rows and instructions per step
            assert p.warpgroups == (1 if M <= 64 else 2)
            assert p.n_instr in _mm_module().N_INSTR
            if M <= 64:
                assert p.n_instr == 1


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "recurrentgemma-9b",
                                  "llama3-8b", "stablelm-12b",
                                  "starcoder2-15b", "olmoe-1b-7b",
                                  "arctic-480b", "whisper-large-v3"])
def test_bf16_tile_plan_arithmetic_does_not_depend_on_the_row_count(arch):
    """At every served width the plan's y layout is the same for M in
    PLAN_ROWS, and for whisper-large-v3 also at its encoder's rows (X, BK
    and the K order are the module's constants); it differs only in block
    rows and instructions per step."""
    rows = PLAN_ROWS + (ENCODER_ROWS if arch == "whisper-large-v3" else ())
    products = _served_products(arch)
    if arch == "whisper-large-v3":  # d 1280; the 51,866-wide head
        assert (1280, 51866, (51866, 1)) in products
        assert (1280, 1280, (1280, 1)) in products  # cross wk / wv
    _plans_across_rows(products, rows)


def test_bf16_tile_plan_ragged_shapes():
    _plans_across_rows(PLAN_RAGGED)
    mm = _mm_module()
    # the tied head's transpose is held K-major
    assert mm.tile_plan(8, 256000, 4096, (1, 4096)).b_major == "k"
    # the serve batch's prefill takes four instructions per step
    assert mm.tile_plan(656, 4096, 14336, (4096, 1)).n_instr == 4


#: bf16 products of the kernel's staging paths: (label, M, K, N, y layout):
#: layer views of a stacked [2, K, N] (MN-major y),
#: a transposed [N, K].T (K-major y, the tied head's layout), 514- and
#: 103,732-byte row strides (no TMA: thread-staged), K not a multiple of 16
BF16_CASES = [("layer view", 656, 4096, 1024, "stack"),
              ("layer view decode", 8, 2048, 2048, "stack"),
              ("transposed", 8, 4096, 4000, "T"),
              ("transposed prefill", 300, 512, 1000, "T"),
              ("unaligned stride", 130, 257, 65, "dense"),
              # whisper-large-v3's head: a 103,732-byte row stride (no
              # TMA), N & 3 = 2 (no vector stores)
              ("whisper head", 32, 1280, 51866, "dense"),
              ("ragged K", 100, 40, 256, "stack")]


@pytest.mark.gpu
@pytest.mark.parametrize("case", BF16_CASES, ids=[c[0] for c in BF16_CASES])
def test_cuda_bf16_matmul_layouts_and_staging_paths(case):
    """The bf16 kernel within check_matmul's bound of the plain version for
    each y layout and staging path, and its TMA and thread-staged paths
    bit for bit equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (chip_smoke.py runs it)")
    _, M, K, N, layout = case
    rng = np.random.default_rng(M + K + N)
    x = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32))
    if layout == "stack":
        y = torch.from_numpy(rng.normal(size=(2, K, N)).astype(np.float32))
    else:
        y = torch.from_numpy(rng.normal(size=(N, K) if layout == "T"
                                        else (K, N)).astype(np.float32))
    x, y = x.to(torch.bfloat16).cuda(), y.to(torch.bfloat16).cuda()
    y = y[1] if layout == "stack" else (y.T if layout == "T" else y)
    got = ops.matmul(x, y)
    threads = torch.empty_like(got)
    _mm_module().launch(x, y, threads, _by_threads=True)
    torch.cuda.synchronize()
    want = matmul_plain(x.cpu(), y.cpu()).float().numpy()
    bound = (_mm_bound(x.float().cpu().numpy(), y.float().cpu().numpy())
             + 2.0 ** -7 * np.abs(want))
    assert (np.abs(got.float().cpu().numpy() - want) <= bound).all()
    assert torch.equal(got, threads)


# -- rglru and rwkv6 (the model stack's recurrences) -------------------------

REC_DTYPES = ("f32", "bf16")
#: plain version against the reference's oracle and Pallas kernel in
#: float32: both loop over time with the same elementwise association, but
#: XLA's CPU backend may contract ``a * h + g`` into a fused multiply-add,
#: so values agree to a few float32 ulps, not bit for bit
REC_F32 = dict(rtol=1e-5, atol=1e-6)
#: bf16 outputs round float32 values that agree to REC_F32: they may
#: differ by one bf16 ulp (2^-7 of the value at most)
REC_BF16 = dict(rtol=2.0 ** -7, atol=1e-6)


def _tol(dtype):
    return REC_F32 if dtype == "f32" else REC_BF16


def _to_torch(x):
    """A reference array (any float dtype) as a torch tensor of its type."""
    from repro_torch.core.convert import tensor_from_array

    return tensor_from_array(np.asarray(x))


def _rglru_inputs(rng, b, t, d, dtype, with_h0):
    """(x, a, h0) as jax arrays: x, a in ``dtype``, h0 float32 or None."""
    import jax.numpy as jnp

    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype]
    x = jnp.asarray(rng.normal(size=(b, t, d)).astype(np.float32), jdt)
    a = jnp.asarray(rng.uniform(0.2, 0.99, (b, t, d)).astype(np.float32),
                    jdt)
    h0 = (jnp.asarray(rng.normal(size=(b, d)).astype(np.float32))
          if with_h0 else None)
    return x, a, h0


def _assert_close(got, want, dtype, what=""):
    g = got.float().numpy()
    w = np.asarray(want.astype("float32"))
    np.testing.assert_allclose(g, w, err_msg=what, **_tol(dtype))


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("dtype", REC_DTYPES)
@pytest.mark.parametrize("b,t,d", [(1, 16, 8), (3, 50, 16), (4, 33, 32)])
def test_rglru_plain_matches_reference_oracle_and_pallas(ref, b, t, d,
                                                         dtype, with_h0):
    rng = np.random.default_rng(b * 100 + t + d)
    x, a, h0 = _rglru_inputs(rng, b, t, d, dtype, with_h0)
    y, hT = rglru_plain(_to_torch(x), _to_torch(a),
                        None if h0 is None else _to_torch(h0))
    assert y.dtype == _to_torch(x).dtype and hT.dtype == torch.float32
    y_o, h_o = ref.kref.rglru_ref(x, a, h0)
    # T = 50 and 33 are no multiple of the kernel's 16-step time block
    y_k, h_k = ref.kops.rglru(x, a, h0, use_pallas=True, bb=2, bt=16)
    for name, (yy, hh) in (("oracle", (y_o, h_o)), ("pallas", (y_k, h_k))):
        _assert_close(y, yy, dtype, f"y vs {name}")
        np.testing.assert_allclose(hT.numpy(), np.asarray(hh), **REC_F32,
                                   err_msg=f"h_T vs {name}")


def test_rglru_plain_continuation_is_exact(ref):
    """[0:t1] then [t1:T] from the carried state equals the whole scan bit
    for bit (the same elementwise operations), and the reference's
    continuation to REC_F32."""
    rng = np.random.default_rng(17)
    x, a, h0 = _rglru_inputs(rng, 2, 40, 8, "f32", True)
    xt, at, h0t = _to_torch(x), _to_torch(a), _to_torch(h0)
    y, hT = rglru_plain(xt, at, h0t)
    y1, h1 = rglru_plain(xt[:, :13], at[:, :13], h0t)
    y2, h2 = rglru_plain(xt[:, 13:], at[:, 13:], h1)
    assert torch.equal(torch.cat([y1, y2], 1), y) and torch.equal(h2, hT)
    _, r1 = ref.kops.rglru(x[:, :13], a[:, :13], h0, use_pallas=True, bt=8)
    r2, rh = ref.kops.rglru(x[:, 13:], a[:, 13:], r1, use_pallas=True, bt=8)
    _assert_close(y2, r2, "f32")
    np.testing.assert_allclose(h2.numpy(), np.asarray(rh), **REC_F32)


def _rwkv6_inputs(rng, b, h, t, dk, dv, dtype, with_s0):
    """(r, k, v, w, u, s0) as jax arrays: r, k, v in ``dtype``, the rest
    float32 (s0 None unless asked for)."""
    import jax.numpy as jnp

    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype]

    def normal(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    r, k = (jnp.asarray(normal(b, h, t, dk, scale=0.5), jdt)
            for _ in range(2))
    v = jnp.asarray(normal(b, h, t, dv, scale=0.5), jdt)
    w = jnp.asarray(rng.uniform(0.3, 0.98, (b, h, t, dk)).astype(np.float32))
    u = jnp.asarray(normal(h, dk, scale=0.3))
    s0 = jnp.asarray(normal(b, h, dk, dv)) if with_s0 else None
    return r, k, v, w, u, s0


def _rwkv6_torch(args):
    return [None if x is None else _to_torch(x) for x in args]


@pytest.mark.parametrize("with_s0", [False, True])
@pytest.mark.parametrize("dtype", REC_DTYPES)
@pytest.mark.parametrize("b,h,t,dk,dv", [(1, 1, 16, 8, 8), (2, 2, 40, 16, 16),
                                         (1, 3, 21, 16, 8)])
def test_rwkv6_plain_matches_reference_oracle_and_pallas(ref, b, h, t, dk, dv,
                                                         dtype, with_s0):
    rng = np.random.default_rng(b * 1000 + h * 100 + t + dk + dv)
    args = _rwkv6_inputs(rng, b, h, t, dk, dv, dtype, with_s0)
    o, sT = rwkv6_plain(*_rwkv6_torch(args))
    assert o.dtype == _to_torch(args[2]).dtype and sT.dtype == torch.float32
    o_o, s_o = ref.kref.rwkv6_ref(*args)
    # T = 40 and 21 are no multiple of the kernel's 16-step time block
    o_k, s_k = ref.kops.rwkv6(*args, use_pallas=True, bt=16)
    for name, (oo, ss) in (("oracle", (o_o, s_o)), ("pallas", (o_k, s_k))):
        _assert_close(o, oo, dtype, f"o vs {name}")
        np.testing.assert_allclose(sT.numpy(), np.asarray(ss), **REC_F32,
                                   err_msg=f"S_T vs {name}")
    if dtype == "f32":  # the rounding bound the card's checks use
        bound = 2 * (dk - 1) * 2.0 ** -24 * rwkv6_plain(
            *_rwkv6_torch(args), term_sums=True)[2].numpy()
        assert (np.abs(o.numpy() - np.asarray(o_o)) <= bound).all()


def test_rwkv6_plain_continuation_is_exact(ref):
    rng = np.random.default_rng(23)
    args = _rwkv6_inputs(rng, 1, 2, 24, 8, 8, "f32", True)
    r, k, v, w, u, s0 = _rwkv6_torch(args)
    o, sT = rwkv6_plain(r, k, v, w, u, s0)
    o1, s1 = rwkv6_plain(r[:, :, :11], k[:, :, :11], v[:, :, :11],
                         w[:, :, :11], u, s0)
    o2, s2 = rwkv6_plain(r[:, :, 11:], k[:, :, 11:], v[:, :, 11:],
                         w[:, :, 11:], u, s1)
    assert torch.equal(torch.cat([o1, o2], 2), o) and torch.equal(s2, sT)
    jr, jk, jv, jw, ju, js0 = args
    _, q1 = ref.kops.rwkv6(jr[:, :, :11], jk[:, :, :11], jv[:, :, :11],
                           jw[:, :, :11], ju, js0, use_pallas=True, bt=4)
    q2, qs = ref.kops.rwkv6(jr[:, :, 11:], jk[:, :, 11:], jv[:, :, 11:],
                            jw[:, :, 11:], ju, q1, use_pallas=True, bt=4)
    _assert_close(o2, q2, "f32")
    np.testing.assert_allclose(s2.numpy(), np.asarray(qs), **REC_F32)


def test_recurrence_wrappers_on_cpu_run_plain_versions_and_count_nothing():
    rng = np.random.default_rng(29)
    x, a, h0 = (_to_torch(z) for z in _rglru_inputs(rng, 2, 9, 8, "f32",
                                                    True))
    before = ops.launch_counts()
    y, hT = ops.rglru(x, a, h0)
    yp, hp = rglru_plain(x, a, h0)
    assert torch.equal(y, yp) and torch.equal(hT, hp)
    # the model's head-split views pass as they are
    args = _rwkv6_torch(_rwkv6_inputs(rng, 2, 3, 7, 8, 8, "bf16", True))
    r, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2)
               for t in args[:3])
    assert not r.is_contiguous()
    o, sT = ops.rwkv6(r, k, v, *args[3:])
    op, sp = rwkv6_plain(*args)
    assert torch.equal(o, op) and torch.equal(sT, sp)
    assert ops.launch_counts() == before


@pytest.mark.parametrize("case", ["f64", "bf16", "a_shape", "h0_shape",
                                  "two_d", "strided", "device", "not_tensor",
                                  "empty"])
def test_rglru_wrapper_rejects_bad_arguments(case):
    x, a, h0 = torch.rand(2, 5, 4), torch.rand(2, 5, 4), torch.rand(2, 4)
    if case == "f64":
        x = x.double()
    elif case == "bf16":
        a = a.to(torch.bfloat16)
    elif case == "a_shape":
        a = a[:, :4].contiguous()
    elif case == "h0_shape":
        h0 = torch.rand(2, 5)
    elif case == "two_d":
        x, a = x[0], a[0]
    elif case == "strided":
        x = torch.rand(2, 4, 5).transpose(1, 2)
    elif case == "device":
        h0 = h0.to("meta")
    elif case == "not_tensor":
        x = x.numpy()
    elif case == "empty":
        x, a = x[:, :0], a[:, :0]
    with pytest.raises((TypeError, ValueError)):
        ops.rglru(x, a, h0)


@pytest.mark.parametrize("case", ["f64", "mixed", "w_bf16", "u_shape",
                                  "s0_shape", "v_batch", "last_stride",
                                  "s0_strided", "device", "three_d"])
def test_rwkv6_wrapper_rejects_bad_arguments(case):
    B, H, T, D = 2, 3, 5, 4
    r, k, v, w = (torch.rand(B, H, T, D) for _ in range(4))
    u, s0 = torch.rand(H, D), torch.rand(B, H, D, D)
    if case == "f64":
        r, k, v = r.double(), k.double(), v.double()
    elif case == "mixed":
        v = v.to(torch.bfloat16)
    elif case == "w_bf16":
        w = w.to(torch.bfloat16)
    elif case == "u_shape":
        u = torch.rand(H, D + 1)
    elif case == "s0_shape":
        s0 = torch.rand(B, H, D, D + 1)
    elif case == "v_batch":
        v = torch.rand(B + 1, H, T, D)
    elif case == "last_stride":
        k = torch.rand(B, H, D, T).transpose(2, 3)
    elif case == "s0_strided":
        s0 = s0.transpose(2, 3)
    elif case == "device":
        u = u.to("meta")
    elif case == "three_d":
        r = r[0]
    with pytest.raises((TypeError, ValueError)):
        ops.rwkv6(r, k, v, w, u, s0)


@pytest.mark.gpu
def test_cuda_rglru_kernel_matches_plain_version():
    """Bit for bit: both round every elementwise operation on its own."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (chip_smoke.py runs it)")
    rng = np.random.default_rng(37)
    for b, t, d in [(1, 1, 1), (3, 50, 300), (8, 129, 4096)]:
        x, a, h0 = (_to_torch(z).cuda() for z in _rglru_inputs(
            rng, b, t, d, "f32", True))
        before = ops.rglru.launches
        y, hT = ops.rglru(x, a, h0)
        torch.cuda.synchronize()
        assert ops.rglru.launches == before + 1
        yp, hp = rglru_plain(x, a, h0)
        assert torch.equal(y, yp) and torch.equal(hT, hp)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", REC_DTYPES)
def test_cuda_rwkv6_kernel_matches_plain_version(dtype):
    """S_T bit for bit (the state update is elementwise); o within the
    float32 rounding of two summation orders over k, 2 (Dk - 1) 2^-24
    sum_k |terms|, plus one bf16 ulp of the value in bf16."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (chip_smoke.py runs it)")
    rng = np.random.default_rng(41)
    for b, h, t, dk, dv in [(1, 1, 1, 16, 16), (2, 3, 45, 32, 32),
                            (2, 4, 70, 64, 64), (1, 2, 33, 64, 40)]:
        args = [None if z is None else _to_torch(z).cuda() for z in
                _rwkv6_inputs(rng, b, h, t, dk, dv, dtype, True)]
        before = ops.rwkv6.launches
        o, sT = ops.rwkv6(*args)
        torch.cuda.synchronize()
        assert ops.rwkv6.launches == before + 1
        op, sp, sums = rwkv6_plain(*args, term_sums=True)
        assert torch.equal(sT, sp)
        bound = 2 * (dk - 1) * 2.0 ** -24 * sums
        if dtype == "bf16":
            _, e = torch.frexp(torch.maximum(o.float().abs(),
                                             op.float().abs()))
            bound = bound + torch.ldexp(torch.ones_like(bound), e - 8)
        assert bool(((o.float() - op.float()).abs() <= bound).all())


# -- the float32 kernel's tile plan ------------------------------------------

def _f32_row_mean_products(rows, n):
    """(M, K, N, strides) of ``layers.row_mean``'s float32 products over
    ``rows`` rows of ``n`` columns: ``[rows * n / 64, 64] @ [64, 1]`` then
    ``[rows, n / 64] @ [n / 64, 1]``, or one ``[rows, n] @ [n, 1]``."""
    from repro_torch.models.layers import ROW_GROUP, row_mean_launches

    if row_mean_launches(n) == 2:
        g = n // ROW_GROUP
        return [(rows * g, ROW_GROUP, 1, (ROW_GROUP, 1, 1, 1)),
                (rows, g, 1, (g, 1, 1, 1))]
    return [(rows, n, 1, (n, 1, 1, 1))]


def _f32_products():
    """Every float32 product shape the MM stage, the norms' row means, the
    MoE routers and chip_smoke give the kernel: (label, M, K, N,
    strides)."""
    from repro_torch.configs import get_config

    out = []
    for n in (344, 400, 496):  # the matrix app's x @ x.T, x.T a view
        out.append((f"MM stage n={n}", n, n, n, (n, 1, 1, n)))
    for n in (496, 1024, 4096):  # chip_smoke's timed squares
        out.append((f"square {n}", n, n, n, (n, 1, n, 1)))
    out += [("ragged", 130, 257, 65, (257, 1, 65, 1)),
            ("transposed views", 200, 300, 150, (1, 200, 1, 300)),
            ("lone", 1, 1, 1, (1, 1, 1, 1))]
    for arch in ("rwkv6-1.6b", "recurrentgemma-9b", "llama3-8b",
                 "stablelm-12b", "starcoder2-15b", "olmoe-1b-7b",
                 "arctic-480b"):
        d = get_config(arch).d_model
        for rows in (1, 8, 656, 8192, 65600):
            for M, K, N, strides in _f32_row_mean_products(rows, d):
                out.append((f"{arch} row_mean rows={rows}", M, K, N,
                            strides))
    # the float32 router [tokens, d] @ [d, E]: one token, a decode step,
    # the serve batch's prefill and olmoe's 2 x 4080-token long batch
    for arch, tokens in (("olmoe-1b-7b", (1, 8, 656, 8160)),
                         ("arctic-480b", (1, 8, 656))):
        cfg = get_config(arch)
        d, E = cfg.d_model, cfg.num_experts
        for rows in tokens:
            out.append((f"{arch} router rows={rows}", rows, d, E,
                        (d, 1, E, 1)))
    return out


F32_PRODUCTS = _f32_products()


@pytest.mark.parametrize("case", F32_PRODUCTS,
                         ids=[f"{c[0]} {c[1]}x{c[2]}x{c[3]}"
                              for c in F32_PRODUCTS])
def test_f32_tile_plan_grid_fits(case):
    """Every product the float32 kernel is given maps to a plan whose grid
    launches (at least one block, at most 2^31 - 1 on one grid dimension),
    N <= SKINNY_N to the skinny kernel and nothing else."""
    _, M, K, N, strides = case
    mm = _mm_module()
    plan = mm.tile_plan_f32(M, N, K, strides)
    assert (plan.regime == "skinny") == (N <= mm.SKINNY_N)
    assert plan.regime == "skinny" or plan.block in mm.F32_CONFIGS
    assert 1 <= mm.f32_blocks(M, N, plan) <= 2 ** 31 - 1
    assert plan.x_load in mm.X_LOADS and plan.y_load in mm.Y_LOADS


def test_f32_tile_plan_is_a_function_of_shape_and_strides():
    """The same shape and strides give the same plan, whatever else holds
    (no state, no device); each operand loads along its unit stride, with
    16-byte copies where the strides allow them."""
    mm = _mm_module()
    for _, M, K, N, strides in F32_PRODUCTS:
        assert mm.tile_plan_f32(M, N, K, strides) == mm.tile_plan_f32(
            int(M), int(N), int(K), tuple(int(s) for s in strides))
    # the matrix app's x @ x.T: x 16 bytes along k, x.T (strides (1, n))
    # 4 bytes along k
    plan = mm.tile_plan_f32(496, 496, 496, (496, 1, 1, 496))
    assert (plan.x_load, plan.y_load) == ("vec_k", "k")
    # a column-major x 16 bytes along m, a dense y 16 bytes along n
    plan = mm.tile_plan_f32(4096, 4096, 4096, (1, 4096, 4096, 1))
    assert (plan.x_load, plan.y_load) == ("vec_m", "vec_n")
    # 4-byte copies where a stride breaks the 16-byte steps
    plan = mm.tile_plan_f32(130, 65, 257, (257, 1, 65, 1))
    assert (plan.x_load, plan.y_load) == ("k", "n")
    assert mm.tile_plan_f32(496, 496, 130, (1, 130, 1, 130)) == mm.F32Plan(
        "small", (32, 64), "m", "k")
    # the row means: x rows with 16-byte copies along k, unless a row's
    # stride breaks the 16-byte steps
    assert mm.tile_plan_f32(512, 1, 64, (64, 1, 1, 1)).x_load == "vec_k"
    assert mm.tile_plan_f32(8, 1, 66, (66, 1, 1, 1)).x_load == "k"
    assert mm.tile_plan_f32(8, 1, 64, (1, 8, 1, 1)).x_load == "m"


def test_f32_tile_plan_reaches_each_regime():
    """Large products take the 64 x 128 tile, the MM stage's squares and
    every other product too small for two waves of it the 32 x 64 tile,
    N <= 8 the skinny kernel; every configuration is reached."""
    mm = _mm_module()
    seen = set()
    for _, M, K, N, strides in F32_PRODUCTS + [
            ("", 8, 4096, 14336, (4096, 1, 14336, 1)),
            ("", 100, 64, 200, (64, 1, 200, 1))]:
        plan = mm.tile_plan_f32(M, N, K, strides)
        seen.add("skinny" if plan.regime == "skinny" else plan.block)
        if plan.regime == "small":
            assert plan.block == mm.F32_SMALL
            assert (_cdiv(M, mm.F32_LARGE[0]) * _cdiv(N, mm.F32_LARGE[1])
                    < 2 * mm.SMS)
    assert seen == set(mm.F32_CONFIGS)
    assert mm.tile_plan_f32(4096, 4096, 4096,
                            (4096, 1, 4096, 1)).regime == "large"
    for n in (344, 496):
        assert mm.tile_plan_f32(n, n, n, (n, 1, 1, n)).block == (32, 64)
    assert mm.tile_plan_f32(524288, 1, 64, (64, 1, 1, 1)).regime == "skinny"


@pytest.mark.parametrize("M,K,N", [(4096, 4096, 4096), (496, 496, 496),
                                   (524288, 64, 1), (8, 64, 3)])
def test_f32_plans_force_every_configuration(M, K, N):
    """``f32_plans`` gives the plan's own choice first, then each other
    configuration once (the skinny kernel only for N <= SKINNY_N), every
    one staging each operand as the strides allow."""
    mm = _mm_module()
    strides = (K, 1, N, 1)
    plans = mm.f32_plans(M, N, K, strides)
    assert plans[0] == mm.tile_plan_f32(M, N, K, strides)
    keys = ["skinny" if p.regime == "skinny" else p.block for p in plans]
    assert len(set(keys)) == len(keys)
    assert set(keys) == {k for k in mm.F32_CONFIGS
                         if k != "skinny" or N <= mm.SKINNY_N}
    for p in plans:
        assert (p.x_load, p.y_load) == mm.f32_loads(p.regime == "skinny",
                                                    strides)


def _cdiv(a, b):
    return -(-a // b)


def _f32_cases(dev):
    """(label, x, y) per regime of the float32 kernel, with ragged edges
    and transposed views, on ``dev``."""
    g = torch.Generator(device="cpu").manual_seed(41)

    def normal(*shape):
        return torch.randn(*shape, generator=g).to(dev)

    return [("large", normal(2100, 301), normal(301, 2093)),
            ("large transposed", normal(301, 2100).T, normal(2093, 301).T),
            ("small", normal(496, 496), normal(496, 496).T),
            ("small ragged", normal(130, 257), normal(257, 65)),
            ("small column-major x", normal(257, 130).T, normal(257, 65)),
            ("skinny N=1", normal(1000, 70), normal(70, 1)),
            ("skinny N=3 transposed x", normal(70, 1000).T, normal(70, 3)),
            ("skinny N=8", normal(777, 64), normal(8, 64).T)]


def _needs_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (chip_smoke.py runs it)")


@pytest.mark.gpu
@pytest.mark.parametrize("case", [c[0] for c in _f32_cases("cpu")])
def test_cuda_f32_matmul_regimes(case):
    """Each regime against the plain version within check_matmul's float32
    bound, and every configuration forced on the same product bit for bit
    equal to the plan's own choice (one ascending fmaf chain each)."""
    _needs_gpu()
    _, x, y = next(c for c in _f32_cases("cuda") if c[0] == case)
    got = ops.matmul(x, y)
    want = matmul_plain(x.cpu(), y.cpu()).numpy()
    bound = _mm_bound(x.cpu().numpy(), y.cpu().numpy())
    torch.cuda.synchronize()
    assert (np.abs(got.cpu().numpy() - want) <= bound).all()
    for plan in _mm_module().f32_plans(x.shape[0], y.shape[1], x.shape[1],
                                       x.stride() + y.stride()):
        out = torch.empty_like(got)
        _mm_module().launch(x, y, out, _f32_plan=plan)
        torch.cuda.synchronize()
        assert torch.equal(out, got), plan


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["decode", "prefill"])
def test_cuda_f32_row_mean_products(case):
    """The norms' two N = 1 products at llama3-8b's width: 8 tokens (a
    decode step) and the serve batch's 656 prefill rows, against the
    plain version and the float64 mean."""
    _needs_gpu()
    from repro_torch.models.layers import row_mean

    rows = {"decode": 8, "prefill": 656}[case]
    g = torch.Generator(device="cpu").manual_seed(rows)
    x = (torch.randn(rows, 4096, generator=g) * 3).cuda()
    for M, K, N, _ in _f32_row_mean_products(rows, 4096):
        a = torch.randn(M, K, generator=g).cuda()
        b = torch.rand(K, N, generator=g).cuda()
        got = ops.matmul(a, b)
        torch.cuda.synchronize()
        bound = _mm_bound(a.cpu().numpy(), b.cpu().numpy())
        want = matmul_plain(a.cpu(), b.cpu()).numpy()
        assert (np.abs(got.cpu().numpy() - want) <= bound).all()
    mean = row_mean(x * x)
    want = (x.double() ** 2).mean(-1, keepdim=True)
    assert float((mean.double() - want).abs().max()) <= 1e-5 * float(
        want.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("n", [344, 496])
def test_cuda_f32_integer_gram_bitwise(n):
    """The matrix app's x @ x.T on the card, bit for bit the CPU's."""
    _needs_gpu()
    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.integers(0, 10, (n, n)).astype(np.float32))
    got = ops.matmul(x.cuda(), x.cuda().T).cpu()
    np.testing.assert_array_equal(got.numpy(),
                                  matmul_plain(x, x.T).numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("regime", ["skinny", (64, 128), (32, 64)])
def test_cuda_f32_rows_do_not_depend_on_the_row_count(regime):
    """A row computed alone equals the same row inside 8, 656 and 8192-row
    products, bit for bit, with the product forced onto each
    configuration (the row alone takes the plan's own)."""
    _needs_gpu()
    mm = _mm_module()
    g = torch.Generator(device="cpu").manual_seed(43)
    N = 1 if regime == "skinny" else 96
    y = torch.randn(4096 if N == 1 else 1000, N, generator=g).cuda()
    K = y.shape[0]
    for M in (8, 656, 8192):
        x = torch.randn(M, K, generator=g).cuda()
        strides = x.stride() + y.stride()
        plan = (mm.F32Plan("skinny", (mm.SKINNY_ROWS, N),
                           *mm.f32_loads(True, strides))
                if regime == "skinny" else
                mm.F32Plan("large" if regime == mm.F32_LARGE else "small",
                           regime, *mm.f32_loads(False, strides)))
        full = torch.empty(M, N, device="cuda")
        mm.launch(x, y, full, _f32_plan=plan)
        for i in sorted({0, 1, M // 2, M - 1}):
            assert torch.equal(ops.matmul(x[i:i + 1], y)[0], full[i]), (M, i)


# -- acd_evict's edge inputs and the compacted chain --------------------------

#: (label, J, mask share, edit) of the edge inputs
ACD_EDGES = [("share 0", 300, 0.0, None), ("share 0.05", 2049, 0.05, None),
             ("share 0.5", 1000, 0.5, None), ("share 0.8", 2048, 0.8, None),
             ("share 1", 1031, 1.0, None),
             ("long unmasked runs", 2500, 0.8, "runs"),
             ("zero and -0.0 demands", 700, 0.8, "zeros"),
             ("+-inf and NaN thresholds", 700, 0.8, "nonfinite"),
             ("J=1", 1, 1.0, None), ("J=31", 31, 0.8, None)]


def _acd_edge(label, J, share, edit, np_dtype, b=3):
    rng = np.random.default_rng(J * 10 + int(share * 100))
    P, thresh, mask = _inputs(rng, b, J, np_dtype, share)
    if edit == "runs":  # whole stretches of unmasked jobs
        for lo in range(0, J, 600):
            mask[:, lo:lo + 300] = False
    elif edit == "zeros":
        P[:, ::3] = 0.0
        P[:, 1::3] = -0.0
    elif edit == "nonfinite":
        thresh[:, ::5] = np.inf
        thresh[:, 1::5] = -np.inf
        thresh[:, 2::5] = np.nan
    return P, thresh, mask


def _compacted(P, thresh, mask):
    """The kernel's argument, in plain Python: visit the masked jobs only,
    and at each compute the add beside the compare, then select, so an
    evicted job adds nothing (not 0.0). Values in the array's dtype."""
    out = np.zeros(mask.shape, dtype=bool)
    for b in range(P.shape[0]):
        s = P.dtype.type(0.0)
        for j in np.flatnonzero(mask[b]):
            ev = s > thresh[b, j]
            kept = s + P[b, j]
            s = s if ev else kept
            out[b, j] = ev
    return out


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("edge", ACD_EDGES, ids=[e[0] for e in ACD_EDGES])
def test_acd_edge_inputs_match_reference(ref, edge, dtype):
    """The reference's Pallas kernel (interpret mode) and oracle against
    the plain version on the edge inputs the CUDA kernel's compaction
    must survive: mask shares 0 to 1, long unmasked runs, demands of 0.0
    and -0.0, +-inf and NaN thresholds, tiny rows."""
    P, thresh, mask = _acd_edge(*edge, DTYPES[dtype][0])
    got = _plain(P, thresh, mask)
    oracle, kernel = _reference_versions(ref, P, thresh, mask)
    np.testing.assert_array_equal(got, oracle)
    np.testing.assert_array_equal(got, kernel)
    assert not got[~mask].any()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("edge", ACD_EDGES, ids=[e[0] for e in ACD_EDGES])
def test_acd_masked_only_compaction_gives_the_same_bits(edge, dtype):
    """The plain loop over every job (an unmasked or evicted job adding
    0.0) and the compacted chain over the masked jobs only (adding
    nothing) give the same evict mask: what the CUDA kernel rests on."""
    P, thresh, mask = _acd_edge(*edge, DTYPES[dtype][0])
    np.testing.assert_array_equal(_compacted(P, thresh, mask),
                                  _plain(P, thresh, mask))


#: J of the CUDA edge cases: one job, a ragged warp, one tile and one past
#: it, four tiles and one past them, eight tiles
ACD_CUDA_J = (1, 31, 2048, 2049, 4097, 8192)


@pytest.mark.gpu
@pytest.mark.parametrize("J", ACD_CUDA_J)
def test_cuda_acd_evict_edge_cases(J):
    """The CUDA kernel bit for bit against the plain version at every
    mask share and edge input, float64 and float32."""
    _needs_gpu()
    for label, _, share, edit in ACD_EDGES:
        for np_dtype, _ in DTYPES.values():
            P, thresh, mask = _acd_edge(label, J, share, edit, np_dtype)
            got = ops.acd_evict(*(torch.from_numpy(a).cuda()
                                  for a in (P, thresh, mask)))
            torch.cuda.synchronize()
            np.testing.assert_array_equal(got.cpu().numpy(),
                                          _plain(P, thresh, mask),
                                          err_msg=f"{label} J={J}")


# -- rwkv6's redesign: the launch plan and the kernel's order of the k-sum ----

#: (B, H, Dv, SMs) the plan is checked at: rwkv6-1.6b's serve batch and
#: long batch on the H100, one head, ragged widths, few SMs
RWKV_PLAN_CASES = [(8, 32, 64, 132), (2, 32, 64, 132), (1, 1, 64, 132),
                   (1, 2, 40, 132), (3, 5, 100, 16), (8, 32, 128, 132),
                   (1, 1, 8, 132), (64, 64, 64, 132), (2, 3, 127, 7)]


def _rk_module():
    import importlib

    return importlib.import_module("repro_torch.kernels.rwkv6")


@pytest.mark.parametrize("case", RWKV_PLAN_CASES)
def test_rwkv6_launch_plan_covers_every_column_once(case):
    """Every plan (the own one and each forced column count) computes each
    column of 0 .. Dv - 1 exactly once, leaves no block without a column,
    and fits the kernel's block size."""
    rk = _rk_module()
    B, H, Dv, n_sm = case
    for plan in rk.plans(B, H, Dv, n_sm):
        assert plan.cols in rk.COLS
        cols = rk.plan_columns(plan, Dv)
        assert sorted(cols) == list(range(Dv)), plan
        width = rk.LANES * plan.cols * plan.groups
        assert (plan.splits - 1) * width < Dv <= plan.splits * width, plan
        assert plan.groups <= rk.MAX_GROUPS, plan


def test_rwkv6_launch_plan_does_not_depend_on_T():
    """The plan is a function of (B, H, Dv, SM count): a prefill of any
    length and the decode steps after it run under one plan."""
    import inspect

    rk = _rk_module()
    assert list(inspect.signature(rk.launch_plan).parameters) == [
        "B", "H", "Dv", "n_sm"]
    # what the launch passes: the shapes' B, H and Dv, whatever T is
    for T in (1, 7, 82, 4096):
        r = torch.empty(2, 32, T, 64)
        v = torch.empty(2, 32, T, 64)
        assert rk.launch_plan(r.shape[0], r.shape[1], v.shape[-1]) == \
            rk.launch_plan(2, 32, 64)


def test_rwkv6_launch_plan_fills_the_card():
    """Few heads split their columns over blocks so every SM gets work;
    many heads keep one block a head and two columns a lane. Every plan
    that can gives each scheduler two warps."""
    rk = _rk_module()
    long = rk.launch_plan(2, 32, 64, 132)       # the long batch: 64 heads
    serve = rk.launch_plan(8, 32, 64, 132)      # the serve batch: 256
    assert long.splits > 1 and 64 * long.splits >= 128
    assert serve.splits == 1 and serve.cols == 2 and long.cols == 1
    for plan, heads in ((long, 64), (serve, 256)):
        warps = heads * plan.splits * plan.groups * rk.ROW_GROUPS
        assert warps >= 2 * rk.SCHEDULERS * 132 or plan.cols == 1


def _rwkv6_case(rng, b, h, t, dk, dv, dtype, with_s0):
    return [None if z is None else _to_torch(z) for z in
            _rwkv6_inputs(rng, b, h, t, dk, dv, dtype, with_s0)]


def _rwkv6_ordered_np(r, k, v, w, u, s0):
    """The kernel's order in scalar float32 numpy, one (b, h, t, j) at a
    time: group q sums its Dk / 4 consecutive rows ascending from 0.0,
    then (p0 + p1) + (p2 + p3)."""
    f = np.float32
    r, k, v, w, u = (np.asarray(x, np.float32) for x in (r, k, v, w, u))
    B, H, T, Dk = r.shape
    Dv = v.shape[-1]
    S = (np.zeros((B, H, Dk, Dv), np.float32) if s0 is None
         else np.array(s0, np.float32))
    o = np.zeros((B, H, T, Dv), np.float32)
    for b in range(B):
        for hh in range(H):
            for t in range(T):
                for j in range(Dv):
                    p = []
                    for q in range(4):
                        acc = f(0.0)
                        for kk in range(q * Dk // 4, (q + 1) * Dk // 4):
                            kv = f(k[b, hh, t, kk] * v[b, hh, t, j])
                            a = f(S[b, hh, kk, j] + f(u[hh, kk] * kv))
                            acc = f(acc + f(a * r[b, hh, t, kk]))
                        p.append(acc)
                    o[b, hh, t, j] = f(f(p[0] + p[1]) + f(p[2] + p[3]))
                kv = k[b, hh, t][:, None] * v[b, hh, t][None, :]
                S[b, hh] = w[b, hh, t][:, None] * S[b, hh] + kv
    return o, S


def test_rwkv6_ordered_is_the_stated_order():
    """``ref.rwkv6_ordered`` is the order the kernel's header states,
    scalar by scalar."""
    from repro_torch.kernels.ref import rwkv6_ordered

    rng = np.random.default_rng(51)
    r, k, v, w, u, s0 = _rwkv6_case(rng, 1, 2, 3, 16, 5, "f32", True)
    o, sT = rwkv6_ordered(r, k, v, w, u, s0)
    o_np, s_np = _rwkv6_ordered_np(r, k, v, w, u, s0)
    np.testing.assert_array_equal(o.numpy(), o_np)
    np.testing.assert_array_equal(sT.numpy(), s_np)


@pytest.mark.parametrize("dtype", REC_DTYPES)
@pytest.mark.parametrize("b,h,t,dk,dv", [(1, 1, 1, 16, 16), (2, 3, 45, 32, 32),
                                         (2, 2, 37, 64, 64),
                                         (1, 2, 33, 64, 40)])
def test_rwkv6_ordered_within_the_plain_bound(ref, b, h, t, dk, dv, dtype):
    """The kernel's order of the k-sum against the plain version (torch's
    order) and the reference's oracle: S_T bit for bit, o within 2 (Dk -
    1) 2^-24 sum_k |terms| (plus one bf16 ulp of the value in bf16), the
    bound the card's checks hold the kernel to."""
    from repro_torch.kernels.ref import rwkv6_ordered

    rng = np.random.default_rng(b * 100 + t + dk + dv)
    jargs = _rwkv6_inputs(rng, b, h, t, dk, dv, dtype, True)
    args = [_to_torch(z) for z in jargs]
    o, sT = rwkv6_ordered(*args)
    op, sp, sums = rwkv6_plain(*args, term_sums=True)
    assert o.dtype == op.dtype and torch.equal(sT, sp)
    bound = 2 * (dk - 1) * 2.0 ** -24 * sums
    if dtype == "bf16":
        _, e = torch.frexp(torch.maximum(o.float().abs(), op.float().abs()))
        bound = bound + torch.ldexp(torch.ones_like(bound), e - 8)
    assert bool(((o.float() - op.float()).abs() <= bound).all())
    o_o = torch.from_numpy(np.asarray(ref.kref.rwkv6_ref(*jargs)[0]
                                      .astype("float32")))
    if dtype == "bf16":  # one bf16 ulp of either value
        _, e = torch.frexp(torch.maximum(o.float().abs(), o_o.abs()))
        bound = 2 * (dk - 1) * 2.0 ** -24 * sums + torch.ldexp(
            torch.ones_like(bound), e - 8)
    assert bool(((o.float() - o_o).abs() <= bound).all())


@pytest.mark.parametrize("dtype", REC_DTYPES)
@pytest.mark.parametrize("dk", [16, 32, 64])
def test_rwkv6_ordered_continuation_is_bitwise(dk, dtype):
    """prefill(S) in the kernel's order, then one step from its S_T, gives
    o and S_T bit for bit equal to prefill(S + 1): the order of the sum
    depends on no length."""
    from repro_torch.kernels.ref import rwkv6_ordered

    rng = np.random.default_rng(dk)
    S = 29
    r, k, v, w, u, s0 = _rwkv6_case(rng, 2, 3, S + 1, dk, dk, dtype, False)
    o_full, s_full = rwkv6_ordered(r, k, v, w, u)
    o_pre, s_pre = rwkv6_ordered(r[:, :, :S], k[:, :, :S], v[:, :, :S],
                                 w[:, :, :S], u)
    o_step, s_step = rwkv6_ordered(r[:, :, S:], k[:, :, S:], v[:, :, S:],
                                   w[:, :, S:], u, s_pre)
    assert torch.equal(torch.cat([o_pre, o_step], 2), o_full)
    assert torch.equal(s_step, s_full)


# -- fifo_dispatch's redesign: the workers' precompute ------------------------

def _fifo_offer(x):
    from repro_torch.kernels.ref import fifo_uncapped_offer

    return [t.numpy() for t in fifo_uncapped_offer(
        *(torch.from_numpy(np.ascontiguousarray(x[k]))
          for k in ("ready", "dur", "selc", "occ", "wu")))]


@pytest.mark.parametrize("cold", [False, True])
@pytest.mark.parametrize("case", ["mixed", "all_uncapped", "inf_wu",
                                  "nan_ready", "neg_zero_ready"])
def test_fifo_uncapped_precompute_matches_the_chain(cold, case):
    """The key, penalty, start and end the kernel's workers precompute for
    an uncapped provider are what the chain gives a job that lands there:
    the plain version's outputs for such jobs, bit for bit (NaN where 0 *
    inf makes one), and with every provider uncapped the chain's provider
    is the first argmin of the precomputed keys."""
    rng = np.random.default_rng(61 + cold)
    x = _fifo_rows(rng, 4, 40, 3, 2, 40, cold)
    x["capped"] = np.array([True, False, False])
    if case == "all_uncapped":
        x["capped"][:] = False
    elif case == "inf_wu":
        x["wu"][1] = np.inf
    elif case == "nan_ready":
        x["ready"][:, :, ::5] = np.nan
    elif case == "neg_zero_ready":
        x["ready"][:, :, ::2] = -0.0
    prov, _, wait, cold_o, start, end, extra = _fifo_plain(x, cold)
    key, pen, st, en = _fifo_offer(x)
    b, j = np.nonzero(~x["capped"][prov])
    assert b.size  # some jobs land on an uncapped provider
    p = prov[b, j]
    np.testing.assert_array_equal(extra[b, j], pen[b, p, j])
    np.testing.assert_array_equal(start[b, j], st[b, p, j])
    np.testing.assert_array_equal(end[b, j], en[b, p, j])
    assert not wait[b, j].any() and not cold_o[b, j].any()
    if case == "inf_wu":  # 0 * inf: NaN key, the first NaN wins
        assert np.isnan(key[:, 1]).all() and (prov == 1).all()
        assert np.isnan(extra).all() and np.isnan(start).all()
    if case == "all_uncapped":
        first = np.zeros_like(prov)
        for bb in range(prov.shape[0]):
            for jj in range(prov.shape[1]):
                kk = key[bb, :, jj]
                nan = np.flatnonzero(np.isnan(kk))
                first[bb, jj] = nan[0] if nan.size else int(np.argmin(kk))
        np.testing.assert_array_equal(prov, first)


@pytest.mark.parametrize("cold,case", [(False, "nan_ready"),
                                       (True, "nan_ready"),
                                       (False, "inf_wu_uncapped")])
def test_fifo_nonfinite_inputs_match_reference(ref, cold, case):
    """The plain version against the reference's oracle and Pallas kernel
    on the inputs the precompute must carry through: NaN ready times, and
    an infinite wu on an uncapped provider (0 * inf = NaN) where the
    reference keeps that product (not under cold starts: see the next
    test)."""
    rng = np.random.default_rng(71 + cold)
    x = _fifo_rows(rng, 3, 24, 3, 2, 24, cold)
    x["capped"] = np.array([True, False, True])
    if case == "inf_wu_uncapped":
        x["wu"][1] = np.inf
    else:
        x["ready"][:, :, ::3] = np.nan
    got = _fifo_plain(x, cold)
    oracle, kernel = _fifo_reference(ref, x, cold)
    _assert_fifo_equal(got, oracle, "oracle")
    _assert_fifo_equal(got, kernel, "pallas")


def test_fifo_infinite_wu_under_cold_starts_follows_the_des(ref):
    """Under cold starts an uncapped provider's cold flag is False and its
    warm-up term 0 * inf is NaN in the DES (``_start_public_capped``:
    ``selc + occ * (wait + cold * wu)`` in numpy), in the plain version
    and in the kernel: its key is NaN and, the first NaN, it takes every
    job. The reference's XLA runs (oracle and Pallas interpret) give 0
    there instead, and price the other providers: a property of the
    reference, pinned here (ROADMAP Queue 3 item 12)."""
    rng = np.random.default_rng(72)
    x = _fifo_rows(rng, 3, 24, 3, 2, 24, True)
    x["capped"] = np.array([True, False, True])
    x["wu"][1] = np.inf
    got = _fifo_plain(x, True)
    assert (got[0] == 1).all() and np.isnan(got[4]).all()
    # the DES's expression for the first job of each row, in numpy
    for b in range(3):
        j = x["order"][b, 0]
        wait = np.where(x["capped"], np.maximum(
            0.0, x["sclk0"][b].min(1) - x["ready"][b, :, j]), 0.0)
        cold = np.zeros(3, bool)
        key = x["selc"][b, :, j] + x["occ"][b, :, j] * (wait + cold * x["wu"])
        assert int(np.argmin(key)) == 1 and np.isnan(key[1])
    oracle, kernel = _fifo_reference(ref, x, True)
    for out in (oracle, kernel):
        assert np.isfinite(out[4]).all() and not (out[0] == 1).all()


# -- the redesigned kernels on the card ---------------------------------------

#: (label, B, H, T, Dk, Dv, dtype, from s0)
RWKV_CUDA_CASES = [
    ("split columns [2, 32, 70, 64]", 2, 32, 70, 64, 64, "bf16", True),
    ("ragged Dv=40", 3, 4, 37, 64, 40, "bf16", True),
    ("T=1 from s0", 8, 32, 1, 64, 64, "bf16", True),
    ("T across the chunk ring", 2, 6, 16 * 7 + 5, 32, 32, "f32", True),
    ("Dk=16 f32 from zeros", 2, 3, 20, 16, 16, "f32", False),
    ("Dv=36, rows not 16-byte pieces", 2, 3, 19, 64, 36, "bf16", True),
]


def _rwkv6_cuda(args, **kw):
    return [None if a is None else a.cuda() for a in args]


@pytest.mark.gpu
@pytest.mark.parametrize("case", RWKV_CUDA_CASES, ids=[c[0] for c in
                                                      RWKV_CUDA_CASES])
def test_cuda_rwkv6_redesign_cases(case):
    """S_T bit for bit against the plain version, o bit for bit against
    ``ref.rwkv6_ordered`` (the kernel's stated order) and within the
    plain version's bound, under the own plan and every forced plan alike;
    one launch counted."""
    _needs_gpu()
    rk = _rk_module()
    _, b, h, t, dk, dv, dtype, with_s0 = case
    rng = np.random.default_rng(b * 1000 + t + dv)
    args = _rwkv6_cuda(_rwkv6_case(rng, b, h, t, dk, dv, dtype, with_s0))
    before = ops.rwkv6.launches
    o, sT = ops.rwkv6(*args)
    torch.cuda.synchronize()
    assert ops.rwkv6.launches == before + 1
    from repro_torch.kernels.ref import rwkv6_ordered

    om, sm = rwkv6_ordered(*args)
    op, sp, sums = rwkv6_plain(*args, term_sums=True)
    assert torch.equal(sT, sp) and torch.equal(sT, sm)
    assert torch.equal(o, om)
    bound = 2 * (dk - 1) * 2.0 ** -24 * sums
    if dtype == "bf16":
        _, e = torch.frexp(torch.maximum(o.float().abs(), op.float().abs()))
        bound = bound + torch.ldexp(torch.ones_like(bound), e - 8)
    assert bool(((o.float() - op.float()).abs() <= bound).all())
    for plan in rk.plans(b, h, dv, torch.cuda.get_device_properties(
            0).multi_processor_count):
        o2, s2 = torch.empty_like(o), torch.empty_like(sT)
        rk.launch(*args, o2, s2, _plan=plan)
        torch.cuda.synchronize()
        assert torch.equal(o2, o) and torch.equal(s2, sT), plan


@pytest.mark.gpu
def test_cuda_rwkv6_unaligned_views():
    """Views whose rows do not start on 16 bytes (an offset of one element)
    take the element-by-element staging and give the same bits."""
    _needs_gpu()
    rng = np.random.default_rng(83)
    args = _rwkv6_cuda(_rwkv6_case(rng, 2, 3, 21, 32, 32, "bf16", True))
    o, sT = ops.rwkv6(*args)
    shifted = []
    for a in args[:4]:
        buf = torch.empty(a.numel() + 1, dtype=a.dtype, device="cuda")
        view = buf[1:].view(a.shape)
        view.copy_(a)
        shifted.append(view)
    o2, s2 = ops.rwkv6(*shifted, *args[4:])
    torch.cuda.synchronize()
    assert torch.equal(o2, o) and torch.equal(s2, sT)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", REC_DTYPES)
def test_cuda_rwkv6_continuation_is_bitwise(dtype):
    """prefill(S), then one step from its S_T, equals prefill(S + 1) bit
    for bit in o and S_T on the card (the model's decode step)."""
    _needs_gpu()
    rng = np.random.default_rng(89)
    S = 82
    r, k, v, w, u, _ = _rwkv6_cuda(_rwkv6_case(rng, 8, 32, S + 1, 64, 64,
                                               dtype, False))
    o_full, s_full = ops.rwkv6(r, k, v, w, u)
    o_pre, s_pre = ops.rwkv6(r[:, :, :S], k[:, :, :S], v[:, :, :S],
                             w[:, :, :S], u)
    o_step, s_step = ops.rwkv6(r[:, :, S:], k[:, :, S:], v[:, :, S:],
                               w[:, :, S:], u, s_pre)
    torch.cuda.synchronize()
    assert torch.equal(torch.cat([o_pre, o_step], 2), o_full)
    assert torch.equal(s_step, s_full)


#: (label, B, P, J, C, n_pub or None, edit)
FIFO_CUDA_CASES = [
    ("infinite wu on an uncapped provider", 4, 3, 300, 2, None, "inf_wu"),
    ("NaN ready", 4, 3, 300, 2, None, "nan_ready"),
    ("P x C = 3 x 3, pool in shared memory", 7, 3, 1000, 3, None, None),
    ("P x C = 3 x 4, pool in shared memory", 6, 3, 700, 4, None, None),
    ("P = 5", 3, 5, 400, 2, None, None),
    ("P = 4, C = 1", 3, 4, 400, 1, None, None),
    ("n_pub = 0", 4, 3, 512, 2, 0, None),
    ("rows shorter than one tile", 5, 3, 50, 2, None, None),
    ("order entries outside [0, J) and repeated", 4, 3, 600, 2, None,
     "bad_order"),
    ("a long row, J = 2^19 + 3", 1, 1, (1 << 19) + 3, 1, 700, None),
]


@pytest.mark.gpu
@pytest.mark.parametrize("cold", [False, True])
@pytest.mark.parametrize("case", FIFO_CUDA_CASES,
                         ids=[c[0] for c in FIFO_CUDA_CASES])
def test_cuda_fifo_redesign_cases(case, cold):
    """The CUDA kernel bit for bit against the plain version in all seven
    outputs on the inputs the register pool, the workers' precompute, the
    zero fill and the general pool path must each survive."""
    _needs_gpu()
    _, B, P, J, C, n_pub, edit = case
    rng = np.random.default_rng(J + P * 10 + C)
    x = _fifo_rows(rng, B, J, P, C,
                   rng.integers(0, J + 1, B) if n_pub is None else n_pub,
                   cold)
    x["capped"][0] = True
    if edit == "inf_wu":
        x["capped"][1] = False
        x["wu"][1] = np.inf
    elif edit == "nan_ready":
        x["ready"][:, :, ::7] = np.nan
    elif edit == "bad_order":
        x["order"][:, ::9] = -1
        x["order"][:, 1::9] = J + 5
        x["order"][:, 2::9] = x["order"][:, 3::9]
    got = ops.fifo_dispatch(*(torch.from_numpy(np.ascontiguousarray(x[k]))
                              .cuda() for k in _FIFO_ARGS),
                            x["keep_alive"], cold=cold)
    torch.cuda.synchronize()
    if edit == "bad_order":
        # the kernel skips entries outside [0, J): the plain version on
        # each row's valid entries among its first n_pub
        for b in range(B):
            head = x["order"][b, :x["n_pub"][b]]
            valid = head[(head >= 0) & (head < J)]
            x["order"][b] = 0
            x["order"][b, :valid.size] = valid
            x["n_pub"][b] = valid.size
    _assert_fifo_equal([o.cpu().numpy() for o in got], _fifo_plain(x, cold))
