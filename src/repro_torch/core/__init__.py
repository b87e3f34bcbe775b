"""Skedulix core in PyTorch: Alg. 1's batch path and the perf models that
feed it.

Layout follows the JAX reference package module for module:

``dag``
    :class:`AppDAG`/:class:`Stage` — the application model; ``APPS`` holds
    the paper's three canonical applications.
``cost``
    Eqn.-1 billing: :class:`CostModel`, the multi-provider
    :class:`ProviderPortfolio` and time-dependent :class:`PriceTrace`.
``arrivals``
    Exogenous release streams generalizing the batch at ``t0``.
``priority``
    SPT / HCF priority orders (Sec. III-C).
``greedy``
    Capacity-prefix initialization offload, ACD sweeps, provider
    selection — numpy functions and their torch counterparts.
``simulator``
    ``engine="des"``: the discrete-event reference (:func:`simulate`),
    the exactness anchor of the batched engine.
``vectorsim``
    ``engine="vector"``: the batched torch engine
    (:func:`simulate_scenarios`, :func:`sweep_scenarios`), running on CUDA
    with the ACD sweep in the hand-written ``acd_evict`` kernel and the
    capped public-dispatch chain in ``fifo_dispatch``.
``perfmodel``
    Sec. IV-B's ridge latency and output-size models (:class:`RidgeModel`,
    :func:`grid_search_ridge`, :class:`AppPerfModel`,
    :func:`fit_app_perf_model`), fitted in float32 on the device.
``prng``
    The reference's cross-validation fold permutation, bit for bit.
``precision``
    :func:`ieee_float32`: TF32 off on the card for the port's float32
    products and convolutions, whatever the process set.
``scheduler``
    :class:`SkedulixScheduler` — the user-facing service.
``convert``
    Rebuild the port's configuration objects and fitted models from the
    reference's fields.
``coldstart``
    Load-dependent latency: :class:`ColdStartModel`, :class:`PoolTrace`
    and the concurrency-cap normaliser, run by both engines.

``faults``
    Fault injection and recovery: :class:`FaultModel` grids and the
    :class:`RetryPolicy`, run by both engines.
``workloads``
    Trace-derived workloads: ``azure:`` specs sample days of serverless
    invocations from the reference's committed trace sample.

The MILP bound is not ported yet.
"""
from .arrivals import (ArrivalProcess, BatchArrivals, MMPPArrivals,
                       PoissonArrivals, TraceArrivals, parse_arrivals,
                       resolve_release)
from .coldstart import ColdStartModel, PoolTrace
from .convert import (coldstart_from_fields, cost_model_from_fields,
                      dag_from_fields, perf_model_from_fields,
                      pool_trace_from_fields,
                      portfolio_from_fields, ridge_from_fields)
from .cost import (CostModel, LAMBDA_COST, PriceTrace, Provider,
                   ProviderPortfolio, as_portfolio, demo_portfolio,
                   diurnal_portfolio, lambda_cost, spot_portfolio,
                   stage_costs)
from .dag import APPS, AppDAG, Stage, image_app, matrix_app, video_app
from .faults import FaultModel, RetryPolicy, as_fault_model
from .greedy import (acd_sweep, acd_sweep_torch, init_offload,
                     init_offload_torch, offload_negative_acd,
                     select_provider, select_provider_torch, t_max)
from .perfmodel import (AppPerfModel, RidgeModel, StageModels,
                        default_feature_builder, fit_app_perf_model,
                        fit_ridge, grid_search_ridge, mape)
from .precision import ieee_float32
from .priority import ORDERS, hcf_key, sort_queue, spt_key
from .scheduler import BatchReport, SkedulixScheduler
from .simulator import (SimResult, simulate, simulate_all_private,
                        simulate_all_public)
from .vectorsim import (ENGINE_IMPLS, VectorSimResult, resolve_device,
                        resolve_engine_impl, simulate_scenarios,
                        sweep_scenarios)
from .workloads import (AzureWorkload, day_counts, load_azure_sample,
                        parse_workload, resolve_workload)

__all__ = [
    "AppDAG", "Stage", "APPS", "matrix_app", "video_app", "image_app",
    "CostModel", "LAMBDA_COST", "lambda_cost", "stage_costs",
    "PriceTrace", "Provider", "ProviderPortfolio", "as_portfolio",
    "demo_portfolio", "spot_portfolio", "diurnal_portfolio",
    "ArrivalProcess", "BatchArrivals", "TraceArrivals", "PoissonArrivals",
    "MMPPArrivals", "parse_arrivals", "resolve_release",
    "init_offload", "init_offload_torch", "acd_sweep", "acd_sweep_torch",
    "offload_negative_acd", "select_provider", "select_provider_torch",
    "t_max",
    "ORDERS", "spt_key", "hcf_key", "sort_queue",
    "SkedulixScheduler", "BatchReport",
    "SimResult", "simulate", "simulate_all_public", "simulate_all_private",
    "VectorSimResult", "simulate_scenarios", "sweep_scenarios",
    "ENGINE_IMPLS", "resolve_engine_impl", "resolve_device", "ieee_float32",
    "dag_from_fields", "portfolio_from_fields", "cost_model_from_fields",
    "coldstart_from_fields", "pool_trace_from_fields",
    "perf_model_from_fields", "ridge_from_fields",
    "ColdStartModel", "PoolTrace",
    "FaultModel", "RetryPolicy", "as_fault_model",
    "AzureWorkload", "parse_workload", "resolve_workload", "day_counts",
    "load_azure_sample",
    "RidgeModel", "fit_ridge", "grid_search_ridge", "mape", "StageModels",
    "AppPerfModel", "fit_app_perf_model", "default_feature_builder",
]
