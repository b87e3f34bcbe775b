"""Meshes over a ``torch.distributed`` process group.

Port of the reference's ``launch/mesh.py``. A :class:`Mesh` lays the
group's ranks out row-major over named axes (``('data', 'model')``, or
``('pod', 'data', 'model')`` across pods), as the reference's device array
is reshaped, and holds one process group for every set of axes: the
ranks that differ only along those axes, in row-major order over them.
Each rank runs one process on one device; the collectives of the
distribution layer run over these groups.

Single pod: (data=16, model=16), 256 ranks. Multi-pod: (pod=2, data=16,
model=16), 512 ranks. :func:`init_distributed` starts the group (``nccl``
on CUDA, ``gloo`` on the CPU) from ``torchrun``'s environment, or for one
process through a ``FileStore`` in a temporary directory (no port opened).
"""
from __future__ import annotations

import datetime
import itertools
import math
import os
import tempfile
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

#: how long a collective may wait for the other ranks before it raises
TIMEOUT = datetime.timedelta(seconds=300)
PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def init_distributed(device, rank: int = None, world_size: int = None,
                     init_file: str = None,
                     timeout: datetime.timedelta = TIMEOUT) -> None:
    """Start the default process group for ``device`` (``nccl`` for a
    CUDA device, ``gloo`` otherwise) if none is running. ``rank`` and
    ``world_size`` default to ``torchrun``'s ``RANK`` and ``WORLD_SIZE``
    (0 and 1 without them). The rendezvous is ``init_file`` (a
    ``file://`` store every rank names), else ``torchrun``'s ``env://``,
    else, for one rank, a ``FileStore`` in a new temporary directory."""
    if dist.is_initialized():
        return
    dev = torch.device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    rank = int(os.environ.get("RANK", 0)) if rank is None else rank
    world_size = (int(os.environ.get("WORLD_SIZE", 1)) if world_size is None
                  else world_size)
    kw = dict(rank=rank, world_size=world_size, timeout=timeout)
    if dev.type == "cuda":
        dev = torch.device("cuda", dev.index if dev.index is not None
                           else int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
        kw["device_id"] = dev          # this rank's card, not a guess
    if init_file is not None:
        dist.init_process_group(backend, init_method=f"file://{init_file}",
                                **kw)
    elif "MASTER_ADDR" in os.environ:
        dist.init_process_group(backend, init_method="env://", **kw)
    elif world_size == 1:
        path = os.path.join(tempfile.mkdtemp(prefix="repro_torch_store_"),
                            "store")
        dist.init_process_group(backend, store=dist.FileStore(path, 1),
                                **kw)
    else:
        raise RuntimeError(
            f"{world_size} ranks need a rendezvous: run under torchrun or "
            f"pass init_file")


class Mesh:
    """Named axes over the ranks of the initialised default group.

    ``shape`` maps each axis name to its size and ``axis_names`` orders
    them, as the reference's ``Mesh`` does (the sharding rules read only
    those two); ``coords`` is this rank's index along each axis. The mesh
    must cover the whole group. :meth:`group` gives the process group of
    the ranks that differ from this one only along the named axes."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        if not dist.is_initialized():
            raise RuntimeError("Mesh needs an initialised process group "
                               "(init_distributed)")
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        sizes = tuple(int(s) for s in shape)
        if len(sizes) != len(self.axis_names):
            raise ValueError(f"shape {sizes} does not name axes "
                             f"{self.axis_names}")
        self.shape: Dict[str, int] = dict(zip(self.axis_names, sizes))
        self.size = math.prod(sizes)
        world = dist.get_world_size()
        if self.size != world:
            raise RuntimeError(f"mesh {sizes} needs {self.size} ranks, the "
                               f"group has {world}")
        self.rank = dist.get_rank()
        self.ranks = np.arange(self.size).reshape(sizes)
        self.coords = self.coords_of(self.rank)
        self._groups = {}
        # every rank creates every group, in the same order
        for n in range(len(sizes) + 1):
            for axes in itertools.combinations(self.axis_names, n):
                for ranks in self._members(axes):
                    g = dist.new_group(ranks=ranks, timeout=TIMEOUT)
                    if self.rank in ranks:
                        self._groups[axes] = (g, ranks)

    def coords_of(self, rank: int) -> Dict[str, int]:
        """The index along each axis of ``rank``."""
        return dict(zip(self.axis_names, (int(c) for c in np.unravel_index(
            rank, self.ranks.shape))))

    def _members(self, axes: Tuple[str, ...]):
        """The rank lists of the groups along ``axes`` (row-major over
        them, which is ascending rank order)."""
        keep = [i for i, a in enumerate(self.axis_names) if a in axes]
        rest = [i for i in range(len(self.axis_names)) if i not in keep]
        grid = self.ranks.transpose(rest + keep).reshape(
            -1, math.prod(self.ranks.shape[i] for i in keep))
        return [[int(r) for r in row] for row in grid]

    def _key(self, axes) -> Tuple[str, ...]:
        axes = (axes,) if isinstance(axes, str) else tuple(axes or ())
        unknown = set(axes) - set(self.axis_names)
        if unknown:
            raise ValueError(f"no mesh axes {sorted(unknown)}")
        return tuple(a for a in self.axis_names if a in axes)

    def group(self, axes=()) -> "dist.ProcessGroup":
        """This rank's group along ``axes`` (any order; ``()`` is this rank
        alone), its members in row-major order over the axes."""
        return self._groups[self._key(axes)][0]

    def group_ranks(self, axes=()) -> Tuple[int, ...]:
        """The global ranks of :meth:`group`, in its order."""
        return tuple(self._groups[self._key(axes)][1])

    def __repr__(self):
        return f"Mesh({self.shape}, rank {self.rank} at {self.coords})"


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The production mesh: 256 ranks, or 512 across two pods."""
    shape, axes = PRODUCTION[multi_pod]
    n = math.prod(shape)
    if _world() < n:
        raise RuntimeError(
            f"need {n} ranks for mesh {shape}, have {_world()}: launch "
            f"{n} processes (one per GPU) with torchrun")
    return Mesh(shape, axes)


def make_test_mesh(shape=(2, 2), axes=("data", "model")) -> Mesh:
    """A small mesh over ``prod(shape)`` ranks."""
    n = math.prod(shape)
    if _world() < n:
        raise RuntimeError(f"need {n} ranks, have {_world()}")
    return Mesh(shape, axes)
