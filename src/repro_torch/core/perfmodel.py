"""Performance models (Sec. IV-B): closed-form ridge regression in PyTorch.

The scheduler needs, per stage k and job j:
  * P^private_{k,j}: private-cloud latency  = ridge(features) + overhead
  * P^public_{k,j}:  public-cloud latency   = ridge(features)
  * output size of stage k (features of downstream stages)

The paper fits these with scikit-learn ridge + 5-fold grid search; this
module solves the normal equations in torch, batched over (lambda x fold),
on the device the caller names (``cuda`` unless given). It computes in
float32, the reference's ``jnp.result_type(float)`` with 64-bit types off,
and draws the cross-validation folds with the reference's permutation
(:mod:`.prng`), so both pick the same penalty. Its products run in IEEE
float32 on the card (:func:`.precision.ieee_float32`), as the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import prng
from .dag import AppDAG
from .precision import ieee_float32
from .vectorsim import resolve_device

DTYPE = torch.float32
DEFAULT_LAMS = (1e-3, 1e-2, 1e-1, 1.0, 10.0, 100.0)


def _as_tensor(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=DTYPE)
    return torch.as_tensor(np.asarray(x), dtype=DTYPE, device=device)


# -- ridge core ----------------------------------------------------------

@dataclasses.dataclass
class RidgeModel:
    """Standardized ridge regressor  y ~ ((x - mu)/sigma) . w + b, its
    float32 tensors on one device (``lam``: the penalty it was fitted
    with, where known)."""

    w: torch.Tensor      # [D]
    b: torch.Tensor      # []
    mu: torch.Tensor     # [D]
    sigma: torch.Tensor  # [D]
    lam: Optional[float] = None

    @property
    def device(self) -> torch.device:
        return self.w.device

    @ieee_float32()
    def predict(self, X) -> torch.Tensor:
        """Predictions [N] (float32, on the model's device) for ``X``
        [N, D] or [D]."""
        X = torch.atleast_2d(_as_tensor(X, self.device))
        Z = (X - self.mu) / self.sigma
        return Z @ self.w + self.b


def _standardize(X: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    mu = X.mean(dim=0)
    # the population std, as X.std(axis=0) in numpy and jnp
    sigma = torch.clamp(X.std(dim=0, correction=0), min=1e-12)
    return (X - mu) / sigma, mu, sigma


@ieee_float32()
def fit_ridge(X, y, lam: float = 1.0, device=None) -> RidgeModel:
    """Closed-form ridge with unpenalized intercept, on ``device``
    (``cuda`` unless given)."""
    dev = resolve_device(device)
    X = _as_tensor(X, dev)
    y = _as_tensor(y, dev)
    Z, mu, sigma = _standardize(X)
    yc = y - y.mean()
    D = Z.shape[1]
    A = Z.T @ Z + lam * torch.eye(D, dtype=Z.dtype, device=dev)
    w = torch.linalg.solve(A, Z.T @ yc)
    return RidgeModel(w=w, b=y.mean(), mu=mu, sigma=sigma, lam=float(lam))


def _cv_mse_one(Z, y, lam, fold_mask):
    """MSE on one held-out fold, training on the rest (mask=1 -> held out).

    Batched: ``lam`` [L] and ``fold_mask`` [F, N] give an [L, F] grid."""
    keep = 1.0 - fold_mask                                  # [F, N]
    D = Z.shape[1]
    Zw = Z * keep[:, :, None]                               # [F, N, D]
    yw = y * keep
    ybar = yw.sum(dim=1) / torch.clamp(keep.sum(dim=1), min=1.0)  # [F]
    yc = (y - ybar[:, None]) * keep                         # [F, N]
    eye = torch.eye(D, dtype=Z.dtype, device=Z.device)
    A = Zw.transpose(1, 2) @ Zw                             # [F, D, D]
    A = A[None] + lam[:, None, None, None] * eye            # [L, F, D, D]
    rhs = (Zw.transpose(1, 2) @ yc[:, :, None])             # [F, D, 1]
    w = torch.linalg.solve(A, rhs.expand(A.shape[0], *rhs.shape))
    pred = (Z @ w)[..., 0] + ybar[:, None]                  # [L, F, N]
    err = (pred - y) ** 2 * fold_mask
    return err.sum(dim=-1) / torch.clamp(fold_mask.sum(dim=-1), min=1.0)


def fold_ids(n: int, k: int = 5, seed: int = 0) -> np.ndarray:
    """The reference's CV fold of each of ``n`` rows: row ``perm[i]`` goes
    to fold ``i % k``, ``perm`` being
    ``jax.random.permutation(PRNGKey(seed), n)``."""
    fid = np.zeros(n, dtype=np.int64)
    fid[prng.permutation(seed, n)] = np.arange(n) % k
    return fid


@ieee_float32()
def grid_search_ridge(
    X,
    y,
    lams: Sequence[float] = DEFAULT_LAMS,
    k: int = 5,
    seed: int = 0,
    fold_id: Optional[np.ndarray] = None,
    device=None,
) -> Tuple[RidgeModel, float]:
    """The paper's grid search with k-fold CV, batched over (lambda x
    fold). Folds come from ``fold_id`` [N] when given, else from the
    reference's permutation of ``seed``. Returns (model fit on all data
    with the best lambda, best lambda) on ``device`` (``cuda`` unless
    given)."""
    dev = resolve_device(device)
    X = _as_tensor(X, dev)
    y = _as_tensor(y, dev)
    n = X.shape[0]
    Z, _, _ = _standardize(X)
    fid = fold_ids(n, k, seed) if fold_id is None else fold_id
    fid = torch.as_tensor(np.array(fid, dtype=np.int64), device=dev)
    masks = torch.stack([(fid == f).to(Z.dtype) for f in range(k)])  # [k, n]
    lams_arr = torch.as_tensor(np.asarray(lams, dtype=np.float32),
                               device=dev)
    mse = _cv_mse_one(Z, y, lams_arr, masks).mean(dim=1)     # [L]
    best = float(lams_arr[int(torch.argmin(mse))])
    return fit_ridge(X, y, best, device=dev), best


def mape(y_true, y_pred) -> float:
    """Mean Absolute Percentage Error (%), as reported in Sec. V-B."""
    y_true = np.asarray(y_true, dtype=np.float64)
    y_pred = np.asarray(y_pred, dtype=np.float64)
    denom = np.maximum(np.abs(y_true), 1e-12)
    return float(np.mean(np.abs(y_true - y_pred) / denom) * 100.0)


# -- per-application model sets -------------------------------------------

# feature_builder(k, base_features[J,D0], insize[J]) -> X_k[J,Dk]
FeatureBuilder = Callable[[int, np.ndarray, Optional[np.ndarray]], np.ndarray]


def default_feature_builder(k: int, base: np.ndarray,
                            insize: Optional[np.ndarray]) -> np.ndarray:
    """Source stages see raw job features; downstream stages see the
    predicted input size prepended to the raw features (Sec. IV-B: latency
    models of later stages are parameterized by predicted data properties)."""
    if insize is None:
        return base
    return np.concatenate([insize[:, None], base], axis=1)


@dataclasses.dataclass
class StageModels:
    private: RidgeModel            # latency (s) in the private cloud
    public: RidgeModel             # latency (s) in the public cloud
    outsize: Optional[RidgeModel]  # output size (bytes) from stage features
    overhead_s: float = 0.0        # framework overhead (mean over traces)
    upload: Optional[RidgeModel] = None    # upload latency (s) vs bytes
    download: Optional[RidgeModel] = None  # download latency (s) vs bytes


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


@dataclasses.dataclass
class AppPerfModel:
    """All models for one application + DAG-aware feature propagation."""

    dag: AppDAG
    stages: List[StageModels]
    feature_builder: FeatureBuilder = default_feature_builder

    def predict(self, base_features: np.ndarray) -> Dict[str, np.ndarray]:
        """Propagate predictions through the DAG.

        Returns numpy float64 P_private [J,M], P_public [J,M] (seconds),
        sizes [J,M] (predicted output bytes), upload/download [J,M] (s);
        each model's float32 prediction is clamped in float32 first, as in
        the reference.
        """
        base = np.atleast_2d(np.asarray(base_features, dtype=np.float64))
        J, M = base.shape[0], self.dag.num_stages
        P_priv = np.zeros((J, M))
        P_pub = np.zeros((J, M))
        sizes = np.zeros((J, M))
        up = np.zeros((J, M))
        down = np.zeros((J, M))
        for k in self.dag.topo_order():
            preds = self.dag.predecessors(k)
            if preds:
                insize_k = np.sum([sizes[:, p] for p in preds], axis=0)
            else:
                insize_k = None
            X_k = self.feature_builder(k, base, insize_k)
            sm = self.stages[k]
            P_priv[:, k] = np.maximum(
                _np(sm.private.predict(X_k)) + sm.overhead_s, 1e-4)
            P_pub[:, k] = np.maximum(_np(sm.public.predict(X_k)), 1e-4)
            if sm.outsize is not None:
                sizes[:, k] = np.maximum(_np(sm.outsize.predict(X_k)), 1.0)
            elif insize_k is not None:
                sizes[:, k] = insize_k  # pass-through
            else:
                sizes[:, k] = base[:, 0]  # convention: feature 0 = input bytes
            if sm.upload is not None:
                up[:, k] = np.maximum(
                    _np(sm.upload.predict(sizes[:, k:k + 1])), 0.0)
            if sm.download is not None:
                down[:, k] = np.maximum(
                    _np(sm.download.predict(sizes[:, k:k + 1])), 0.0)
        return {"P_private": P_priv, "P_public": P_pub, "sizes": sizes,
                "upload": up, "download": down}


def fit_app_perf_model(
    dag: AppDAG,
    traces: Dict[str, np.ndarray],
    lams: Sequence[float] = DEFAULT_LAMS,
    feature_builder: FeatureBuilder = default_feature_builder,
    link_gbps: float = 1.0,
    link_base_s: float = 0.02,
    device=None,
) -> AppPerfModel:
    """Fit every stage model from execution traces, on ``device``
    (``cuda`` unless given).

    ``traces`` keys: base_features [N,D0], private [N,M], public [N,M],
    outsize [N,M], overhead [N,M] (optional).  Upload/download latencies are
    synthesized from a linear link model (bytes/bandwidth + base), matching
    the paper's regularized-ridge treatment of transfer latencies.
    """
    dev = resolve_device(device)
    base = np.asarray(traces["base_features"], dtype=np.float64)
    priv = np.asarray(traces["private"], dtype=np.float64)
    pub = np.asarray(traces["public"], dtype=np.float64)
    outs = np.asarray(traces["outsize"], dtype=np.float64)
    overhead = np.asarray(traces.get("overhead", np.zeros_like(priv)))
    M = dag.num_stages
    stage_models: List[StageModels] = []
    # true input sizes per stage for feature building during training
    insizes: Dict[int, Optional[np.ndarray]] = {}
    for k in dag.topo_order():
        preds = dag.predecessors(k)
        insizes[k] = (np.sum([outs[:, p] for p in preds], axis=0) if preds else None)
    # transfer models: fit on synthetic (bytes -> s) pairs spanning observed sizes
    span = np.linspace(max(outs.min(), 1.0), outs.max() + 1.0, 64)[:, None]
    lat = span[:, 0] / (link_gbps * 1e9 / 8.0) + link_base_s
    xfer, _ = grid_search_ridge(span, lat, lams, device=dev)
    for k in range(M):
        X_k = feature_builder(k, base, insizes[k])
        ov = float(np.mean(overhead[:, k]))
        m_priv, _ = grid_search_ridge(X_k, priv[:, k] - ov, lams, device=dev)
        m_pub, _ = grid_search_ridge(X_k, pub[:, k], lams, device=dev)
        m_out, _ = grid_search_ridge(X_k, outs[:, k], lams, device=dev)
        stage_models.append(StageModels(
            private=m_priv, public=m_pub, outsize=m_out, overhead_s=ov,
            upload=xfer, download=xfer))
    return AppPerfModel(dag=dag, stages=stage_models, feature_builder=feature_builder)
