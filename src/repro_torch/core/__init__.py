"""Skedulix core in PyTorch: the port's first slice of Alg. 1's batch path.

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
    with the ACD sweep in the hand-written ``acd_evict`` kernel.
``scheduler``
    :class:`SkedulixScheduler` — the user-facing service.
``convert``
    Rebuild the port's configuration objects from the reference's fields.

``faults`` and ``coldstart`` are copied too: the DES and the argument
normalisers use them. The perf models, the MILP bound and trace-derived
workloads are not ported yet.
"""
from .arrivals import (ArrivalProcess, BatchArrivals, MMPPArrivals,
                       PoissonArrivals, TraceArrivals, parse_arrivals,
                       resolve_release)
from .convert import (cost_model_from_fields, dag_from_fields,
                      portfolio_from_fields)
from .cost import (CostModel, LAMBDA_COST, PriceTrace, Provider,
                   ProviderPortfolio, as_portfolio, demo_portfolio,
                   diurnal_portfolio, lambda_cost, spot_portfolio,
                   stage_costs)
from .dag import APPS, AppDAG, Stage, image_app, matrix_app, video_app
from .greedy import (acd_sweep, acd_sweep_torch, init_offload,
                     init_offload_torch, offload_negative_acd,
                     select_provider, select_provider_torch, t_max)
from .priority import ORDERS, hcf_key, sort_queue, spt_key
from .scheduler import BatchReport, SkedulixScheduler
from .simulator import (SimResult, simulate, simulate_all_private,
                        simulate_all_public)
from .vectorsim import (ENGINE_IMPLS, VectorSimResult, resolve_device,
                        resolve_engine_impl, simulate_scenarios,
                        sweep_scenarios)

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
    "ENGINE_IMPLS", "resolve_engine_impl", "resolve_device",
    "dag_from_fields", "portfolio_from_fields", "cost_model_from_fields",
]
