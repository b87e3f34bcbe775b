"""Carry the reference's scheduler state across to the port.

The scheduler's state is its configuration objects (the application DAG,
the cost model, the provider portfolio with its price traces, the
cold-start model and the pool trace) plus the ``pred``/``act`` latency
matrices, which are plain numpy and cross as they are, as do concurrency
caps (plain numbers). Its only weights are the fitted ridge models of the
perf model (the video detector's weights ship with the app as data,
``apps/detector_w7.npz``). The functions
here rebuild the port's objects from plain Python fields and numpy arrays
— the dicts ``dataclasses.asdict`` makes of the reference's (or the
port's) frozen dataclasses, each ridge model's ``w``, ``b``, ``mu`` and
``sigma`` as arrays, or the same data read back from JSON or ``.npz`` — so
nothing here imports the reference package.

    fields = dataclasses.asdict(reference_dag)
    dag = dag_from_fields(fields)

The model stack's state crosses the same way: a parameter tree as numpy
(:func:`model_params_from_fields`) and an AdamW state's step and moments
(:func:`adamw_state_from_fields`).
"""
from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch

from .coldstart import ColdStartModel, PoolTrace
from .cost import CostModel, PriceTrace, Provider, ProviderPortfolio
from .dag import AppDAG, Stage
from .perfmodel import (DTYPE, AppPerfModel, FeatureBuilder, RidgeModel,
                        StageModels, default_feature_builder)
from .vectorsim import resolve_device


def _floats(v) -> tuple:
    return tuple(float(x) for x in v)


def dag_from_fields(fields: Mapping[str, Any]) -> AppDAG:
    """:class:`AppDAG` from ``{"name", "stages": [stage fields], "edges"}``;
    a stage's fields are ``name``, ``replicas``, ``mem_mb`` and
    ``must_private``."""
    stages = tuple(Stage(name=str(s["name"]), replicas=int(s["replicas"]),
                         mem_mb=float(s["mem_mb"]),
                         must_private=bool(s["must_private"]))
                   for s in fields["stages"])
    edges = tuple((int(u), int(v)) for (u, v) in fields["edges"])
    return AppDAG(str(fields["name"]), stages, edges)


def cost_model_from_fields(fields: Mapping[str, Any]) -> CostModel:
    """:class:`CostModel` from ``{"quantum_ms", "usd_per_gb_ms",
    "min_quantums"}``."""
    return CostModel(quantum_ms=float(fields["quantum_ms"]),
                     usd_per_gb_ms=float(fields["usd_per_gb_ms"]),
                     min_quantums=float(fields["min_quantums"]))


def price_trace_from_fields(
        fields: Optional[Mapping[str, Any]]) -> Optional[PriceTrace]:
    """:class:`PriceTrace` from its per-segment fields (``None`` passes)."""
    if fields is None:
        return None
    return PriceTrace(usd_per_gb_ms=_floats(fields["usd_per_gb_ms"]),
                      egress_usd_per_gb=_floats(fields["egress_usd_per_gb"]),
                      latency_mult=_floats(fields["latency_mult"]),
                      breakpoints=_floats(fields["breakpoints"]))


def provider_from_fields(fields: Mapping[str, Any]) -> Provider:
    """:class:`Provider` from its fields, its price trace included."""
    mem = fields["max_mem_mb"]
    conc = fields["max_concurrency"]
    return Provider(name=str(fields["name"]),
                    quantum_ms=float(fields["quantum_ms"]),
                    usd_per_gb_ms=float(fields["usd_per_gb_ms"]),
                    egress_usd_per_gb=float(fields["egress_usd_per_gb"]),
                    latency_mult=float(fields["latency_mult"]),
                    min_quantums=float(fields["min_quantums"]),
                    max_mem_mb=None if mem is None else float(mem),
                    trace=price_trace_from_fields(fields["trace"]),
                    max_concurrency=None if conc is None else int(conc))


def portfolio_from_fields(fields: Mapping[str, Any]) -> ProviderPortfolio:
    """:class:`ProviderPortfolio` from ``{"providers": [provider fields]}``."""
    return ProviderPortfolio(tuple(provider_from_fields(p)
                                   for p in fields["providers"]))


def coldstart_from_fields(
        fields: Optional[Mapping[str, Any]]) -> Optional[ColdStartModel]:
    """:class:`ColdStartModel` from ``{"warm_up_s", "keep_alive_s",
    "scale_to_zero", "provider_warm_up_s"}`` (``None`` passes)."""
    if fields is None:
        return None
    pw = fields.get("provider_warm_up_s")
    return ColdStartModel(warm_up_s=float(fields["warm_up_s"]),
                          keep_alive_s=float(fields["keep_alive_s"]),
                          scale_to_zero=bool(fields["scale_to_zero"]),
                          provider_warm_up_s=None if pw is None
                          else _floats(pw))


def pool_trace_from_fields(
        fields: Optional[Mapping[str, Any]]) -> Optional[PoolTrace]:
    """:class:`PoolTrace` from ``{"counts", "breakpoints"}`` (``None``
    passes); a segment's counts are one int or one per stage."""
    if fields is None:
        return None
    return PoolTrace(counts=tuple(tuple(int(x) for x in c)
                                  for c in fields["counts"]),
                     breakpoints=_floats(fields["breakpoints"]))


def ridge_from_fields(fields: Optional[Mapping[str, Any]],
                      device=None) -> Optional[RidgeModel]:
    """:class:`.perfmodel.RidgeModel` from ``{"w", "b", "mu", "sigma"}``
    arrays, as float32 tensors on ``device`` (``None`` passes)."""
    if fields is None:
        return None
    dev = resolve_device(device)
    return RidgeModel(**{k: torch.as_tensor(np.array(fields[k]),
                                            dtype=DTYPE, device=dev)
                         for k in ("w", "b", "mu", "sigma")})


def perf_model_from_fields(
        dag: AppDAG, fields: Mapping[str, Any], device=None,
        feature_builder: FeatureBuilder = default_feature_builder,
) -> AppPerfModel:
    """:class:`.perfmodel.AppPerfModel` from ``{"stages": [stage fields]}``;
    a stage's fields are ``private``, ``public``, ``outsize``, ``upload``
    and ``download`` (ridge fields or ``None``) and ``overhead_s``."""
    stages = [StageModels(
        private=ridge_from_fields(s["private"], device),
        public=ridge_from_fields(s["public"], device),
        outsize=ridge_from_fields(s.get("outsize"), device),
        overhead_s=float(s.get("overhead_s", 0.0)),
        upload=ridge_from_fields(s.get("upload"), device),
        download=ridge_from_fields(s.get("download"), device))
        for s in fields["stages"]]
    return AppPerfModel(dag=dag, stages=stages,
                        feature_builder=feature_builder)



def _leaves(tree, prefix: str = ""):
    """(dotted path, array) of every leaf of a nested dict / list tree."""
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def tensor_from_array(a, device=None) -> torch.Tensor:
    """A numpy array as a tensor on ``device``; bfloat16 and float8_e4m3fn
    arrays (``ml_dtypes`` types, which ``torch.from_numpy`` rejects) cross
    as their 16- and 8-bit patterns."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:  # torch.from_numpy needs a writable buffer
        a = a.copy()
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    elif a.dtype.name == "float8_e4m3fn":
        t = torch.from_numpy(a.view(np.uint8)).view(torch.float8_e4m3fn)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def model_params_from_fields(cfg, fields: Mapping[str, Any], device=None):
    """:class:`repro_torch.models.Model` of ``cfg`` on ``device``
    (``cuda`` unless the caller names another) holding the weights of a
    reference parameter tree given as numpy arrays: ``embed``,
    ``lm_head``, ``final_norm``, ``scan_layers.slot{i}`` (layers stacked
    along axis 0), ``rest_layers`` (a list) and an encoder-decoder's
    ``encoder`` (``layers`` stacked, ``pos_embed``, ``final_norm``). The
    tree's paths are the model's parameter names; shapes and dtypes must
    match exactly."""
    from ..models.model import Model

    model = Model(cfg, device=device)
    params = dict(model.named_parameters())
    given = dict(_leaves(fields))
    if set(given) != set(params):
        raise ValueError(
            f"parameter names differ: missing {sorted(set(params) - set(given))}"
            f", unexpected {sorted(set(given) - set(params))}")
    with torch.no_grad():
        for name, p in params.items():
            t = tensor_from_array(np.asarray(given[name]))
            if tuple(t.shape) != tuple(p.shape) or t.dtype != p.dtype:
                raise ValueError(
                    f"{name}: got {tuple(t.shape)} {t.dtype}, the model has "
                    f"{tuple(p.shape)} {p.dtype}")
            p.copy_(t)
    return model


def adamw_state_from_fields(fields: Mapping[str, Any], params,
                            device=None):
    """:class:`repro_torch.training.AdamWState` of the model parameters
    ``params`` (dotted name -> tensor) from a reference optimizer state
    given as numpy: ``{"step": int32 [], "m": tree, "v": tree}`` (the
    reference's ``AdamWState._asdict()``), each moment tree shaped as the
    parameter tree with, at a parameter's path, an array of its shape or
    an int8 moment's ``{"q", "scale"}`` / ``{"q", "lo", "scale"}``. On
    ``device`` (``cuda`` unless the caller names another)."""
    from ..training.optimizer import AdamWState

    dev = resolve_device(device)

    def moments(tree):
        flat = dict(_leaves(tree))
        out = {}
        for name, p in params.items():
            parts = {k[len(name) + 1:]: v for k, v in flat.items()
                     if k.startswith(name + ".")}
            if name in flat:
                t = tensor_from_array(flat[name], dev)
                if tuple(t.shape) != tuple(p.shape):
                    raise ValueError(f"{name}: moment {tuple(t.shape)}, "
                                     f"parameter {tuple(p.shape)}")
                out[name] = t
            elif parts and set(parts) <= {"q", "lo", "scale"}:
                out[name] = {k: tensor_from_array(v, dev)
                             for k, v in parts.items()}
            else:
                raise ValueError(f"{name}: no moment in the given state")
        return out

    return AdamWState(step=torch.tensor(int(fields["step"]),
                                        dtype=torch.int32, device=dev),
                      m=moments(fields["m"]), v=moments(fields["v"]))
