"""Carry the reference's scheduler state across to the port.

The scheduler has no weights: its state is its configuration objects (the
application DAG, the cost model, the provider portfolio with its price
traces) plus the ``pred``/``act`` latency matrices, which are plain numpy
and cross as they are. The functions here rebuild the port's objects from
plain Python fields — the dicts ``dataclasses.asdict`` makes of the
reference's (or the port's) frozen dataclasses, or the same data read back
from JSON — so nothing here imports the reference package.

    fields = dataclasses.asdict(reference_dag)
    dag = dag_from_fields(fields)
"""
from __future__ import annotations

from typing import Any, Mapping, Optional

from .cost import CostModel, PriceTrace, Provider, ProviderPortfolio
from .dag import AppDAG, Stage


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
