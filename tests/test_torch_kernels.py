"""The port's ``acd_evict`` against the reference's two versions.

The same seeded numpy inputs go through the port's plain PyTorch version
(``acd_evict_plain``, what the wrapper runs for CPU tensors), the
reference's oracle (``ref.acd_evict_ref``) and the reference's Pallas
kernel in interpret mode. All three must agree bit for bit, in float64
and in float32. The CUDA kernel itself runs only on a GPU: its case here
is marked ``gpu`` and skips without one; ``chip_smoke.py`` holds it
against the plain version on the card.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ref import acd_evict_plain
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
