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
                                        "flash_decode", "rglru", "rwkv6"}


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
#: ragged products: odd widths, K not a multiple of 16, N below one tile
PLAN_RAGGED = [(257, 65, (65, 1)), (129, 131, (1, 129)), (40, 256, (256, 1)),
               (1, 1, (1, 1)), (4096, 7, (7, 1))]


def _mm_module():
    import importlib

    return importlib.import_module("repro_torch.kernels.matmul")


def _served_products(arch):
    """(K, N, y strides) of each 2-D parameter of ``arch``'s full config
    as ``layers.linear`` reads it (a layer view of its stack, N
    contiguous) and of its head (the tied embedding's transpose)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import _layer_init

    cfg = get_config(arch)

    def leaves(tree):
        for v in tree.values():
            yield from (leaves(v) if isinstance(v, dict) else (v,))

    out = set()
    for kind in {cfg.layer_kind(i) for i in range(cfg.num_layers)}:
        for spec in leaves(_layer_init(cfg, kind)):
            if len(spec.shape) == 2:
                K, N = spec.shape
                out.add((K, N, (N, 1)))
    d, V = cfg.d_model, cfg.vocab_size
    out.add((d, V, (1, d)) if cfg.tied_embeddings else (d, V, (V, 1)))
    return sorted(out)


def _plans_across_rows(products):
    for K, N, strides in products:
        plans = [_mm_module().tile_plan(M, N, K, strides) for M in PLAN_ROWS]
        # what fixes each element's sum beyond the module's constant X, BK
        # and K order: y's layout, from its strides, never from M
        assert len({p.b_major for p in plans}) == 1, (K, N, plans)
        assert plans[0].b_major == ("k" if strides[0] == 1 and not (
            strides[1] == 1 and N > 1) else "mn")
        for M, p in zip(PLAN_ROWS, plans):
            # M chooses only the block rows and instructions per step
            assert p.warpgroups == (1 if M <= 64 else 2)
            assert p.n_instr in _mm_module().N_INSTR
            if M <= 64:
                assert p.n_instr == 1


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "recurrentgemma-9b",
                                  "llama3-8b", "stablelm-12b",
                                  "starcoder2-15b"])
def test_bf16_tile_plan_arithmetic_does_not_depend_on_the_row_count(arch):
    """At every served width the plan's y layout is the same for M in
    PLAN_ROWS (X, BK and the K order are the module's constants); it
    differs only in block rows and instructions per step."""
    _plans_across_rows(_served_products(arch))


def test_bf16_tile_plan_ragged_shapes():
    _plans_across_rows(PLAN_RAGGED)
    mm = _mm_module()
    # the tied head's transpose is held K-major
    assert mm.tile_plan(8, 256000, 4096, (1, 4096)).b_major == "k"
    # the serve batch's prefill takes four instructions per step
    assert mm.tile_plan(656, 4096, 14336, (4096, 1)).n_instr == 4


#: bf16 products of the kernel's staging paths: (label, M, K, N, y layout):
#: layer views of a stacked [2, K, N] (MN-major y),
#: a transposed [N, K].T (K-major y, the tied head's layout), a 514-byte
#: row stride (no TMA: thread-staged), K not a multiple of 16
BF16_CASES = [("layer view", 656, 4096, 1024, "stack"),
              ("layer view decode", 8, 2048, 2048, "stack"),
              ("transposed", 8, 4096, 4000, "T"),
              ("transposed prefill", 300, 512, 1000, "T"),
              ("unaligned stride", 130, 257, 65, "dense"),
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
