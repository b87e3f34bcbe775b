"""Matrix Processing application (compute-heavy ETL): MM -> LU.

Stage MM multiplies the input matrix by its transpose through
:func:`repro_torch.kernels.ops.matmul`: the hand-written CUDA kernel on the
card, its plain version on the CPU (``x.T`` is passed as a view). Stage LU
computes an LU decomposition of the product with partial pivoting
(``torch.linalg.lu_factor``, TF32 off on the card) and returns the packed
factors. Inputs are
random integer matrices of dimension 350..500 (Sec. V-A); ``scale``
shrinks dims for fast tests.
"""
from __future__ import annotations

from typing import Any, List, Tuple

import numpy as np
import torch

from ..core.dag import matrix_app
from ..core.precision import ieee_float32
from ..core.vectorsim import resolve_device
from ..kernels import ops
from .base import AppSpec

_DIM_LO, _DIM_HI = 350, 500


def _mm_stage(ins: List[Any]):
    x = ins[0].to(torch.float32)
    return ops.matmul(x, x.T)


@ieee_float32()
def _lu_stage(ins: List[Any]):
    x = ins[0].to(torch.float32)
    # right-looking LU with partial pivoting, as in scipy.lu: the packed
    # unit-lower L and upper U (the pivots are dropped, as the reference's
    # stage drops them)
    lu, _ = torch.linalg.lu_factor(x)
    return lu


def make_spec(scale: float = 1.0, replicas: int = 2,
              device=None) -> AppSpec:
    dev = resolve_device(device)
    lo = max(int(_DIM_LO * scale), 8)
    hi = max(int(_DIM_HI * scale), lo + 8)

    def make_job(rng: np.random.Generator) -> Tuple[Any, np.ndarray]:
        n = int(rng.integers(lo, hi + 1))
        n = (n // 8) * 8  # dims bucketed to multiples of 8, as the reference
        m = rng.integers(0, 10, (n, n)).astype(np.int32)
        csv_bytes = float(n * n * 2.5)       # CSV text encoding of ints
        return (torch.from_numpy(m).to(dev),
                np.array([csv_bytes, float(n * n)]))

    return AppSpec(
        dag=matrix_app(replicas=replicas),
        make_job=make_job,
        stage_fns=(_mm_stage, _lu_stage),
        # private replicas pinned at 1.0 CPU/512MB; Lambda at 2048MB (~1.8 vCPU)
        public_speed=(1.7, 1.7),
        zip_factor=(1.0, 1.0),
        time_scale=40.0,
        device=dev,
    )
