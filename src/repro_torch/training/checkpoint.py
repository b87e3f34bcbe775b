"""Checkpoints with atomic commit and async save, in the reference's layout.

Port of the reference's ``training/checkpoint.py``; a checkpoint written by
either package restores in the other. Layout::

    <dir>/step_<N>/
        manifest.json     {step, keys, shapes, dtypes}
        <flatkey>.npy     one global array per leaf

A leaf's key is its tree path joined with ``::`` as the reference's
``jax.tree_util`` paths print: the model's dotted parameter names split at
the dots (``params::scan_layers::slot0::mixer::wq``), an
:class:`.optimizer.AdamWState` field as ``.step`` / ``.m`` / ``.v``, an int8
moment's parts as ``::q``, ``::lo``, ``::scale``. bfloat16 and
float8_e4m3fn leaves are saved as their unsigned-integer bit patterns with
the true dtype in the manifest (``np.load`` cannot read them otherwise).
Saves go to a ``.tmp`` directory that is renamed into place (the commit),
so a preempted save never corrupts the latest checkpoint; ``keep`` old
steps are garbage-collected.

Sharded trees (``shardings=``: a tree of the same structure whose leaves
are ``repro_torch.distributed`` ``NamedSharding`` or ``Region`` objects)
are saved as whole leaves in the same layout: every rank takes part in
gathering each leaf, rank 0 writes, and the ranks meet at a barrier once
the step is committed. A restore with ``shardings=`` reads the whole
leaves and copies each rank's part into its tensors, so a checkpoint
written on one mesh restores on any other (elastic).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

_SEP = "::"
#: torch dtypes numpy cannot hold -> (manifest name, the signed integer
#: dtype of their width; saved as the unsigned one, as the reference saves)
_BITS = {torch.bfloat16: ("bfloat16", torch.int16),
         torch.float8_e4m3fn: ("float8_e4m3fn", torch.int8)}
_FROM_BITS = {name: dt for dt, (name, _) in _BITS.items()}


def _is_sharding(x) -> bool:
    return hasattr(x, "box") or hasattr(x, "region")


def _leaves(tree: Any, path: Tuple[str, ...] = (), is_leaf=None
            ) -> Iterator[Tuple[str, torch.Tensor]]:
    """(key, tensor) of every leaf: a dict key is split at its dots, a
    named tuple's field is ``.field``, a list's index its number.
    ``is_leaf`` picks other leaves (a tree of shardings)."""
    if isinstance(tree, torch.Tensor) or (is_leaf is not None
                                          and is_leaf(tree)):
        yield _SEP.join(path), tree
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from _leaves(getattr(tree, f), path + ("." + f,), is_leaf)
    elif isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _leaves(v, path + tuple(str(k).split(".")), is_leaf)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (str(i),), is_leaf)
    else:
        raise TypeError(f"{_SEP.join(path)}: not a tensor or a tree: "
                        f"{type(tree).__name__}")


def _to_host(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """A leaf as a numpy array on the host and its dtype's name."""
    t = t.detach()
    if t.dtype in _BITS:
        name, signed = _BITS[t.dtype]
        bits = t.view(signed).cpu().numpy()
        return bits.view(f"uint{8 * bits.itemsize}"), name
    arr = t.cpu().numpy()
    return arr, str(arr.dtype)


def _region(sh, local_shape=None, full_shape=None):
    """A leaf's sharding as a ``Region`` (a ``NamedSharding`` needs the
    whole shape: from the checkpoint, or its local part's)."""
    if hasattr(sh, "box"):
        return sh
    if full_shape is None:
        full_shape = [n * k for n, k in
                      zip(local_shape, sh.counts(len(local_shape)))]
    return sh.region(full_shape)


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _host_arrays(tree: Any, shardings: Any = None
                 ) -> Dict[str, Tuple[np.ndarray, str]]:
    """Every leaf on the host, whole; under ``shardings`` gathered from
    every rank (each rank must call it), on rank 0 only (empty
    elsewhere)."""
    if shardings is None:
        return {k: _to_host(t) for k, t in _leaves(tree)}
    sh = dict(_leaves(shardings, is_leaf=_is_sharding))
    out = {}
    with torch.no_grad():
        for k, t in _leaves(tree):
            full = _region(sh[k], local_shape=t.shape).gather(t)
            if _rank() == 0:
                out[k] = _to_host(full)
    return out


def _write(flat: Dict[str, Tuple[np.ndarray, str]], ckpt_dir: str,
           step: int, keep: int) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "keys": sorted(flat),
                "shapes": {k: list(a.shape) for k, (a, _) in flat.items()},
                "dtypes": {k: name for k, (_, name) in flat.items()}}
    for k, (arr, _) in flat.items():
        np.save(os.path.join(tmp, k.replace("/", "_") + ".npy"), arr)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)             # atomic commit
    _gc(ckpt_dir, keep)
    return final


def save(tree: Any, ckpt_dir: str, step: int, keep: int = 3,
         shardings: Any = None) -> str:
    """Blocking atomic save. Returns the committed directory. Under
    ``shardings`` every rank calls it; rank 0 writes the whole leaves and
    the ranks meet at a barrier after the commit."""
    flat = _host_arrays(tree, shardings)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    if _rank() == 0:
        final = _write(flat, ckpt_dir, step, keep)
    if shardings is not None:
        dist.barrier()
    return final


class AsyncCheckpointer:
    """Overlaps checkpoint I/O with the next training steps: each save
    copies the tree to the host first (gathering a sharded tree's whole
    leaves on rank 0), then rank 0 writes it on a thread; :meth:`wait`
    joins it (and, for a sharded tree, meets the other ranks after the
    commit)."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._sharded = False

    def save(self, tree: Any, step: int, shardings: Any = None):
        self.wait()
        # before the next step updates in place
        flat = _host_arrays(tree, shardings)
        self._sharded = shardings is not None
        if _rank() == 0:
            self._thread = threading.Thread(
                target=_write, args=(flat, self.ckpt_dir, step, self.keep),
                daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._sharded:
            self._sharded = False
            dist.barrier()


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def _from_saved(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    dt = _FROM_BITS.get(dtype_name)
    if dt is not None and arr.dtype.kind == "u":
        return torch.from_numpy(arr.view(f"int{8 * arr.itemsize}")).view(dt)
    return torch.from_numpy(arr)


def restore(ckpt_dir: str, like: Any, step: Optional[int] = None,
            shardings: Any = None) -> Tuple[Any, int]:
    """Restore into ``like``'s tensors in place (its devices; a leaf saved
    in another dtype is cast to ``like``'s) and return (``like``, step).
    ``step`` defaults to the latest. Under ``shardings`` (elastic: any
    mesh) each tensor of ``like`` is this rank's part of its leaf and gets
    that part of the whole saved leaf."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    sh = ({} if shardings is None
          else dict(_leaves(shardings, is_leaf=_is_sharding)))
    with torch.no_grad():
        for key, leaf in _leaves(like):
            arr = np.load(os.path.join(d, key.replace("/", "_") + ".npy"))
            t = _from_saved(arr, manifest["dtypes"].get(key, str(arr.dtype)))
            if key in sh:
                t = _region(sh[key], full_shape=t.shape).local(t)
            if list(t.shape) != list(leaf.shape):
                raise ValueError(f"{key}: ckpt shape {tuple(t.shape)} != "
                                 f"{tuple(leaf.shape)}")
            leaf.copy_(t.to(leaf.dtype))
    return like, manifest["step"]


def _gc(ckpt_dir: str, keep: int):
    steps = sorted([d for d in os.listdir(ckpt_dir) if d.startswith("step_")
                    and not d.endswith(".tmp")])
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)
