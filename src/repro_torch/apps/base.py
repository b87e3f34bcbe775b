"""Application substrate: real PyTorch stage programs + trace generation.

Each canonical application (Sec. V-A) is an :class:`AppSpec`: the DAG, a
job generator, and one PyTorch function per stage, run on the spec's
device (``cuda`` unless the caller names another). Traces are gathered
by *executing* the stages and timing them (on the card, a stage's time
ends with ``torch.cuda.synchronize``); public-cloud latencies are
synthesized from the measured compute via per-stage speed ratios + Lambda
startup jitter, as in the reference.

The numpy random stream is drawn in the reference's order (the job, then
per stage the overhead, the public jitter and the size jitter), so with
the same clock the two packages give the same traces.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..core.dag import AppDAG
from ..core.perfmodel import (AppPerfModel, FeatureBuilder,
                              default_feature_builder, fit_app_perf_model)
from ..core.vectorsim import resolve_device

# stage_fn(inputs: list of predecessor outputs (or [job_input] at sources))
#   -> output tensor, or a tuple/list of them
StageFn = Callable[[List[Any]], Any]


@dataclasses.dataclass
class AppSpec:
    dag: AppDAG
    # job generator: numpy rng -> (job input on ``device``, features [D])
    make_job: Callable[[np.random.Generator], Tuple[Any, np.ndarray]]
    stage_fns: Sequence[StageFn]
    # public-cloud synthesis: P_pub = P_priv_compute / speed + startup
    public_speed: Sequence[float]
    public_startup_s: float = 0.050
    public_jitter: float = 0.05          # lognormal sigma on public latency
    overhead_range_s: Tuple[float, float] = (0.015, 0.020)  # Sec. IV-B
    zip_factor: Sequence[float] | None = None  # output "zip" compression per stage
    feature_builder: FeatureBuilder = default_feature_builder
    # measured compute is dilated into the paper's latency regime (the
    # reference's factors, kept as they are)
    time_scale: float = 1.0
    # where the stages run and the models fit: ``cuda`` unless the caller
    # names another (resolved in ``__post_init__``; raises without a GPU)
    device: torch.device | str | None = None

    def __post_init__(self) -> None:
        self.device = resolve_device(self.device)

    @property
    def name(self) -> str:
        return self.dag.name


def _leaves(tree: Any) -> List[Any]:
    if isinstance(tree, (list, tuple)):
        return [leaf for x in tree for leaf in _leaves(x)]
    return [tree]


def _nbytes(tree: Any) -> int:
    return sum(x.numel() * x.element_size() for x in _leaves(tree))


def _unwrap(out: Any) -> Tuple[Any, float]:
    """A stage may return (data, encoded_bytes) for content-dependent
    output sizes (e.g. jpeg-like entropy coding); plain outputs use
    raw tensor bytes."""
    if isinstance(out, tuple) and len(out) == 2 and isinstance(out[1], (int, float)):
        return out[0], float(out[1])
    return out, float(_nbytes(out))


def _block(tree: Any) -> Any:
    """Wait until every CUDA tensor of ``tree`` is computed (a stage's
    output may carry its encoded byte count beside the tensor)."""
    devs = {x.device for x in _leaves(tree)
            if isinstance(x, torch.Tensor) and x.device.type == "cuda"}
    for dev in devs:
        torch.cuda.synchronize(dev)
    return tree


def run_job(spec: AppSpec, job_input: Any) -> Dict[int, Any]:
    """Execute one job through the DAG; returns per-stage outputs."""
    outputs: Dict[int, Any] = {}
    for k in spec.dag.topo_order():
        preds = spec.dag.predecessors(k)
        ins = [outputs[p] for p in preds] if preds else [job_input]
        outputs[k], _ = _unwrap(_block(spec.stage_fns[k](ins)))
    return outputs


def generate_traces(spec: AppSpec, n_jobs: int, seed: int = 0,
                    time_fn: Callable[[], float] = time.perf_counter,
                    warmup: bool = True,
                    ) -> Dict[str, np.ndarray]:
    """Run ``n_jobs`` jobs, timing every stage (the paper's training runs).

    ``warmup`` executes each (stage, input shapes) signature once untimed
    first: the paper considers *warm starts only* (Sec. V-A.2), and this
    also keeps the kernels' first build, library loads and algorithm
    searches out of the measured latencies.

    Returns the trace dict consumed by :func:`fit_app_perf_model`:
    base_features [N,D], private/public/outsize/overhead [N,M].
    """
    rng = np.random.default_rng(seed)
    M = spec.dag.num_stages
    base_feats: List[np.ndarray] = []
    priv = np.zeros((n_jobs, M))
    pub = np.zeros((n_jobs, M))
    outsz = np.zeros((n_jobs, M))
    overhead = np.zeros((n_jobs, M))
    zf = np.asarray(spec.zip_factor if spec.zip_factor is not None else [1.0] * M)
    warmed: set = set()  # (stage, input-shape) signatures already run
    for j in range(n_jobs):
        job_input, feats = spec.make_job(rng)
        base_feats.append(np.asarray(feats, dtype=np.float64))
        _block(job_input)  # the host-to-device copy stays out of the timing
        outputs: Dict[int, Any] = {}
        for k in spec.dag.topo_order():
            preds = spec.dag.predecessors(k)
            ins = [outputs[p] for p in preds] if preds else [job_input]
            sig = (k, tuple(tuple(x.shape) for x in _leaves(ins)))
            if warmup and sig not in warmed:
                _block(spec.stage_fns[k](ins))
                warmed.add(sig)
            t0 = time_fn()
            raw = _block(spec.stage_fns[k](ins))
            compute_s = max(time_fn() - t0, 1e-6) * spec.time_scale
            outputs[k], nbytes = _unwrap(raw)
            ov = rng.uniform(*spec.overhead_range_s)
            overhead[j, k] = ov
            priv[j, k] = compute_s + ov
            pub[j, k] = (compute_s / spec.public_speed[k]
                         + spec.public_startup_s
                         ) * rng.lognormal(0.0, spec.public_jitter)
            outsz[j, k] = max(nbytes * zf[k] * rng.lognormal(0.0, 0.02), 1.0)
    return {
        "base_features": np.stack(base_feats),
        "private": priv,
        "public": pub,
        "outsize": outsz,
        "overhead": overhead,
    }


def fit_models(spec: AppSpec, traces: Dict[str, np.ndarray],
               **kwargs) -> AppPerfModel:
    """The app's perf models, fitted on the spec's device unless
    ``device=`` names another."""
    kwargs.setdefault("device", spec.device)
    return fit_app_perf_model(spec.dag, traces,
                              feature_builder=spec.feature_builder, **kwargs)


def split_traces(traces: Dict[str, np.ndarray], n_train: int
                 ) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """Train/test split in trace order (paper: 774/150, 800/200, 800/200)."""
    tr = {k: v[:n_train] for k, v in traces.items()}
    te = {k: v[n_train:] for k, v in traces.items()}
    return tr, te
