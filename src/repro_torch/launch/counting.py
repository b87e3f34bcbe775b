"""Counting one step: kernels, aten ops, collectives and memory.

:class:`StepCounter` is a ``TorchDispatchMode`` over one step of the
model, on ``meta`` tensors (the dry run's trace) or on real ones (the
card's or the CPU's step), counting the same things either way:

* kernel calls, operations and bytes by kernel, as the wrappers of
  ``kernels.ops`` report them (``kernels.cost``: on the card and on
  ``meta`` each launch, on the CPU each plain version's call);
* every other aten op on the step's device: its FLOPs by the formulas of
  ``torch.utils.flop_counter`` (products and attention; 0 for the rest)
  and its bytes, each distinct tensor input read and each output written
  once; views (an output sharing an input's storage, the op not
  mutating) and allocations (``empty``) move none, ``copy_`` reads only
  its source, a gather (``index``, ...) of its source only the elements
  it writes. Ops on other devices (the CPU's random-state copies of a
  card's remat) and the kernels' own aten ops are not counted;
* the collectives the distribution layer's helpers issue: over a group of
  more than one rank by kind (``roofline.collective_bytes``: the output's
  bytes on this rank and the count), over a group of one rank counted
  apart (``n_local``: they move nothing across ranks);
* memory: the peak of the live bytes of the storages the step allocates
  on its device (:meth:`memory` lays it out as the reference's
  ``memory_analysis`` fields).

Aten counts of ops whose tensors lie on another device than ``device``
are skipped, so a counter on ``cuda`` and one on ``meta`` over the same
step see the same ops.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, List, Tuple

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from ..kernels import cost
from .roofline import collective_bytes

#: allocations: their outputs are written by whatever fills them
_NO_TRAFFIC = frozenset(("empty", "empty_strided", "empty_like", "new_empty",
                         "new_empty_strided"))
#: gathers: they read of their source only the elements they write
_GATHERS = frozenset(("index", "index_select", "gather", "embedding"))


def tensors(tree) -> List[torch.Tensor]:
    """The tensors of a nested dict / list / tuple (NamedTuples too)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in tensors(x)]
    return []


def tensor_bytes(tree) -> int:
    """Bytes of the tensors of ``tree`` (their elements, not their
    storages: a view of a larger tensor counts its own)."""
    return sum(t.numel() * t.element_size() for t in tensors(tree))


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


class StepCounter(TorchDispatchMode):
    """Counts the ops of one step on ``device`` (see the module
    docstring); ``arguments`` are the step's inputs (their storages are
    not the step's allocations). Use as a context around the step."""

    def __init__(self, device, arguments=()):
        super().__init__()
        self.device_type = torch.device(device).type
        self.kernels: Dict[str, Dict[str, int]] = {}
        self.aten_flops = 0
        self.aten_bytes = 0
        #: aten op name -> [calls, FLOPs, bytes] of the counted ops
        self.ops: Dict[str, List[int]] = {}
        self.issued: List[Tuple[str, int]] = []
        self.n_local = 0
        self._args = {_key(t) for t in tensors(arguments)}
        self._live: Dict[int, Tuple[StorageWeakRef, int]] = {}
        self._live_bytes = 0
        self.peak_bytes = 0
        from torch.utils.flop_counter import flop_registry
        self._flops = flop_registry

    def __enter__(self):
        out = super().__enter__()
        cost.COUNTERS.append(self)
        return out

    def __exit__(self, *exc):
        cost.COUNTERS.remove(self)
        return super().__exit__(*exc)

    # -- reports of kernels.cost --------------------------------------------
    def kernel(self, name: str, operations: int, nbytes: int) -> None:
        k = self.kernels.setdefault(name, {"calls": 0, "operations": 0,
                                           "bytes": 0})
        k["calls"] += 1
        k["operations"] += operations
        k["bytes"] += nbytes

    def collective(self, kind: str, nbytes: int, group_size: int) -> None:
        if group_size > 1:
            self.issued.append((kind, nbytes))
        else:
            self.n_local += 1

    # -- the aten ops -------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        if not any(t.device.type == self.device_type for t in ins + outs):
            return out
        for t in outs:
            self._allocated(t)
        if cost.QUIET[0] or func.namespace != "aten":
            return out
        in_keys = {_key(t) for t in ins}
        mutating = func._schema.is_mutable
        if func.is_view or (outs and not mutating
                            and all(_key(t) in in_keys for t in outs)):
            return out
        formula = self._flops.get(func._overloadpacket)
        flops = (0 if formula is None
                 else int(formula(*args, **kwargs, out_val=out)))
        name = func._overloadpacket.__name__
        nbytes = 0
        if name not in _NO_TRAFFIC:
            if name == "copy_":
                ins = ins[1:]       # the destination is written, not read
            elif name in _GATHERS:  # the source's rows read: the output's
                ins = ins[1:]
                nbytes += sum(t.numel() * t.element_size() for t in outs)
            seen = set()
            for t in ins + outs:
                if id(t) not in seen:
                    seen.add(id(t))
                    nbytes += t.numel() * t.element_size()
        self.aten_flops += flops
        self.aten_bytes += nbytes
        tally = self.ops.setdefault(name, [0, 0, 0])
        tally[0] += 1
        tally[1] += flops
        tally[2] += nbytes
        return out

    def _allocated(self, t: torch.Tensor) -> None:
        """Track ``t``'s storage if the step allocated it, and the peak."""
        if t.device.type != self.device_type:
            return
        st = t.untyped_storage()
        key = st._cdata
        if key in self._args:
            return
        known = self._live.get(key)
        if known is not None and not known[0].expired():
            return
        for k, (ref, n) in list(self._live.items()):
            if ref.expired():
                del self._live[k]
                self._live_bytes -= n
        self._live[key] = (StorageWeakRef(st), st.nbytes())
        self._live_bytes += st.nbytes()
        self.peak_bytes = max(self.peak_bytes, self._live_bytes)

    # -- results ------------------------------------------------------------
    def kernel_totals(self) -> Tuple[int, int]:
        """(operations, bytes) of every kernel call."""
        return (sum(k["operations"] for k in self.kernels.values()),
                sum(k["bytes"] for k in self.kernels.values()))

    def cost(self) -> Dict[str, float]:
        """The reference's ``cost_analysis`` keys, per device: kernels and
        aten ops together (``flops_raw``/``bytes_raw`` equal the totals:
        the trace counts every layer as it runs, so no loop-trip
        correction is made)."""
        k_ops, k_bytes = self.kernel_totals()
        flops = float(k_ops + self.aten_flops)
        nbytes = float(k_bytes + self.aten_bytes)
        return {"flops": flops, "bytes accessed": nbytes,
                "flops_raw": flops, "bytes_raw": nbytes,
                "kernel_flops": float(k_ops), "kernel_bytes": float(k_bytes),
                "aten_flops": float(self.aten_flops),
                "aten_bytes": float(self.aten_bytes)}

    def collectives(self) -> Dict[str, int]:
        """The reference's dictionary of collectives (over groups of more
        than one rank), and ``n_local``: those over a group of one."""
        return {**collective_bytes(self.issued), "n_local": self.n_local}

    def memory(self, arguments, outputs) -> Dict[str, float]:
        """The reference's ``memory_analysis`` fields, per device:
        arguments (``arguments``' tensors), outputs (``outputs``'), the
        outputs that alias an argument (updated in place), temporaries
        (the step's peak live bytes less its new outputs), and their sums
        as the reference's ``per_device_hbm_bytes`` and
        ``persistent_bytes``."""
        args = {_key(t) for t in tensors(arguments)}
        outs = tensors(outputs)
        out_b = tensor_bytes(outs)
        alias = sum(t.numel() * t.element_size() for t in outs
                    if _key(t) in args)
        temp = max(0, self.peak_bytes - (out_b - alias))
        mem = {"argument_size_in_bytes": float(tensor_bytes(arguments)),
               "output_size_in_bytes": float(out_b),
               "temp_size_in_bytes": float(temp),
               "alias_size_in_bytes": float(alias)}
        mem["per_device_hbm_bytes"] = (mem["argument_size_in_bytes"]
                                       + out_b + temp - alias)
        mem["persistent_bytes"] = (mem["argument_size_in_bytes"]
                                   + out_b - alias)
        return mem

    def summary(self) -> Dict[str, Any]:
        """Everything two runs of one step should agree on: kernels by
        name, aten FLOPs and bytes, collectives."""
        return {"kernels": {k: dict(v) for k, v in
                            sorted(self.kernels.items())},
                "aten_flops": self.aten_flops, "aten_bytes": self.aten_bytes,
                "collectives": self.collectives()}
