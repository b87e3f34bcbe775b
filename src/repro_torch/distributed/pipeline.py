"""GPipe-style pipeline parallelism over a mesh axis.

Port of the reference's ``distributed/pipeline.py``. Stage s holds layer
slice s; microbatches flow forward by ``send``/``recv`` in the
reference's ``n_micro + n_stages - 1``-tick schedule, and the last
stage's outputs are replicated to every stage, as the reference's masked
``psum`` does. Each rank of the axis runs the returned function.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch
import torch.distributed as dist

from ..kernels.cost import note_collective
from .sharding import all_reduce

Params = Any


def gpipe(stage_fn: Callable[[Params, torch.Tensor], torch.Tensor],
          mesh, axis: str, n_stages: int, n_micro: int):
    """Build ``fn(stage_params, x_micro) -> y_micro``, run by every rank.

    ``stage_params``: this stage's slice of leaves whose leading dim is
    ``n_stages`` (leading dim 1: ``NamedSharding(mesh, P(axis)).local``).
    ``x_micro``: [n_micro, mb, ...] microbatches (replicated). Returns
    [n_micro, mb, ...] outputs (replicated; computed by the last stage).
    """
    if mesh.shape[axis] != n_stages:
        raise ValueError(f"axis {axis!r} has {mesh.shape[axis]} ranks, not "
                         f"{n_stages} stages")
    ranks = mesh.group_ranks(axis)
    group = mesh.group(axis)

    def run(params: Dict[str, torch.Tensor], xs: torch.Tensor
            ) -> torch.Tensor:
        params = {k: p[0] for k, p in params.items()}
        stage = mesh.coords[axis]
        last = stage == n_stages - 1
        recv = torch.zeros(xs.shape[1:], dtype=xs.dtype, device=xs.device)
        outs = torch.zeros_like(xs)
        for t in range(n_micro + n_stages - 1):
            mb = t - stage
            active = 0 <= mb < n_micro
            x_in = xs[min(max(t, 0), n_micro - 1)] if stage == 0 else recv
            y = (stage_fn(params, x_in) if active
                 else torch.zeros_like(recv))
            if active and last:
                outs[mb] = y
            ops = []
            if not last:
                ops.append(dist.P2POp(dist.isend, y.contiguous(),
                                      ranks[stage + 1], group))
            if stage > 0:
                recv = torch.empty_like(recv)
                ops.append(dist.P2POp(dist.irecv, recv, ranks[stage - 1],
                                      group))
            if ops:
                for work in dist.batch_isend_irecv(ops):
                    work.wait()
                if stage > 0:
                    note_collective("collective-permute", recv, n_stages)
        # replicate the last stage's outputs to every stage
        outs = outs * float(last)
        all_reduce(outs, group)
        return outs

    return run
