# Serving: the batched prefill + greedy decode engine over a Model (port of
# repro.serving.engine). The hybrid scheduler over request batches
# (repro.serving.hybrid, .policies) is ROADMAP Queue 1 item 5.
from .engine import Completion, InferenceEngine, Request

__all__ = ["InferenceEngine", "Request", "Completion"]
