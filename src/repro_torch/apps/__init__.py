"""The paper's three canonical serverless applications (Sec. V-A) as real
PyTorch stage programs, + trace generation for the performance models.

``SPECS[name](scale=..., device=...)`` builds an :class:`AppSpec` whose
jobs and stages run on ``device`` (``cuda`` unless given); the matrix
app's MM stage runs the hand-written CUDA ``matmul`` kernel there.
"""
from . import image, matrix, video
from .base import AppSpec, fit_models, generate_traces, run_job, split_traces

SPECS = {
    "matrix": matrix.make_spec,
    "video": video.make_spec,
    "image": image.make_spec,
}

__all__ = ["AppSpec", "generate_traces", "fit_models", "run_job",
           "split_traces", "SPECS", "matrix", "video", "image"]
