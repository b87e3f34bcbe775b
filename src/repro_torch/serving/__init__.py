# Serving: the batched prefill + greedy decode engine over a Model, the
# paper's hybrid scheduler applied to LLM request batches and continuous
# request streams (private pod replicas + costed elastic overflow;
# rolling-horizon online mode), and the pluggable policy harness with
# literature baselines (NOAH, cost-analysis placement) and the
# Fig.-4-style policy comparison sweep (port of repro.serving).
from .engine import Completion, InferenceEngine, Request
from .hybrid import (AutoscaleFrontier, HybridServingScheduler,
                     OnlineReport, ReliabilityFrontier, ServingLatencyModel,
                     SpotFrontier, elastic_portfolio, pareto_mask,
                     plan_batch_torch, serving_dag, spot_elastic_traces)
from .policies import (CostAnalysisPlacement, NoahSharedQueue, Policy,
                       PolicyContext, PolicyPlan, PolicyReport, PrivateOnly,
                       PublicOnly, RandomFeasible, SkedulixGreedy,
                       compare_policies, policy_from_mode, POLICIES)

__all__ = ["InferenceEngine", "Request", "Completion",
           "HybridServingScheduler", "ServingLatencyModel", "serving_dag",
           "plan_batch_torch", "elastic_portfolio", "OnlineReport",
           "AutoscaleFrontier", "pareto_mask", "SpotFrontier",
           "spot_elastic_traces", "ReliabilityFrontier",
           "Policy", "PolicyContext", "PolicyPlan", "PolicyReport",
           "SkedulixGreedy", "PrivateOnly", "PublicOnly", "RandomFeasible",
           "NoahSharedQueue", "CostAnalysisPlacement",
           "compare_policies", "policy_from_mode", "POLICIES"]
