"""Roofline terms of a traced step on NVIDIA H100 cards.

Port of the reference's ``launch/roofline.py``, on one H100 SXM5 80GB at
its 700 W limit (NVIDIA's data sheet, dense rates without sparsity;
``PEAK_FLOPS``, ``HBM_BW`` and ``LINK_BW`` are ``kernels.cost``'s):

    compute    = FLOPs / (cards * 989 TF/s bf16 on the tensor cores)
    memory     = bytes / (cards * 3.35 TB/s HBM3)
    collective = collective bytes / (cards * 50 GB/s)

``LINK_BW`` is one 400 Gb/s NDR InfiniBand port per card, as a DGX H100
has: a 256-card mesh spans 32 eight-card nodes, so its collectives cross
nodes. NVLink's 450 GB/s a direction inside a node is not the term's
rate.

The FLOPs, bytes and collectives are per device, from the counters of
one traced step (``launch.counting.StepCounter``): each kernel's cost
(``kernels.cost``) and every other aten op, and the collectives the step
issues, which :func:`collective_bytes` lays out as the reference's
dictionary (output bytes per device of each kind and the ``n_`` counts).
They are scaled by the card count to globals, as the reference scales
XLA's per-device ``cost_analysis``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, Tuple

from ..kernels.cost import HBM_BW, LINK_BW, PEAK_FLOPS

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


def collective_bytes(issued: Iterable[Tuple[str, int]]) -> Dict[str, int]:
    """Per-device output bytes per collective kind, and ``n_<kind>`` counts,
    of the ``(kind, bytes)`` collectives a step issued."""
    out: Dict[str, int] = {k: 0 for k in COLLECTIVES}
    counts: Dict[str, int] = {k: 0 for k in COLLECTIVES}
    for kind, nbytes in issued:
        out[kind] += nbytes
        counts[kind] += 1
    return {**out, **{f"n_{k}": v for k, v in counts.items()}}


@dataclasses.dataclass
class RooflineTerms:
    flops_global: float
    bytes_global: float
    collective_global: float
    n_chips: int
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float = 0.0

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        if not self.flops_global:
            return 0.0
        return self.model_flops / self.flops_global

    @property
    def roofline_fraction(self) -> float:
        """useful-compute time / bound time — the perf score."""
        if self.bound_s <= 0:
            return 0.0
        return (self.model_flops / (self.n_chips * PEAK_FLOPS)) / self.bound_s

    def to_dict(self) -> Dict[str, Any]:
        return {**dataclasses.asdict(self),
                "useful_flops_ratio": self.useful_flops_ratio,
                "roofline_fraction": self.roofline_fraction,
                "bound_s": self.bound_s}


def roofline(cost: Dict[str, float], coll: Dict[str, int], n_chips: int,
             model_flops: float = 0.0) -> RooflineTerms:
    """``cost`` (``flops``, ``bytes accessed``) and ``coll`` are per
    device."""
    flops_dev = float(cost.get("flops", 0.0))
    bytes_dev = float(cost.get("bytes accessed", 0.0))
    coll_dev = float(sum(v for k, v in coll.items() if not k.startswith("n_")))
    flops_g = flops_dev * n_chips
    bytes_g = bytes_dev * n_chips
    coll_g = coll_dev * n_chips
    compute_s = flops_g / (n_chips * PEAK_FLOPS)
    memory_s = bytes_g / (n_chips * HBM_BW)
    collective_s = coll_g / (n_chips * LINK_BW)
    dominant = max(
        (("compute", compute_s), ("memory", memory_s),
         ("collective", collective_s)), key=lambda kv: kv[1])[0]
    return RooflineTerms(
        flops_global=flops_g, bytes_global=bytes_g, collective_global=coll_g,
        n_chips=n_chips, compute_s=compute_s, memory_s=memory_s,
        collective_s=collective_s, dominant=dominant, model_flops=model_flops)


def model_flops_estimate(param_count_active: int, tokens: int,
                         kind: str) -> float:
    """MODEL_FLOPS = 6*N_active*D for training, 2*N_active*D for a forward
    (prefill/decode) pass."""
    mult = 6.0 if kind == "train" else 2.0
    return mult * param_count_active * tokens
