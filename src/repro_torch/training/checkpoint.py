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
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

_SEP = "::"
#: torch dtypes numpy cannot hold -> (manifest name, the signed integer
#: dtype of their width; saved as the unsigned one, as the reference saves)
_BITS = {torch.bfloat16: ("bfloat16", torch.int16),
         torch.float8_e4m3fn: ("float8_e4m3fn", torch.int8)}
_FROM_BITS = {name: dt for dt, (name, _) in _BITS.items()}


def _leaves(tree: Any, path: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[str, torch.Tensor]]:
    """(key, tensor) of every leaf: a dict key is split at its dots, a
    named tuple's field is ``.field``, a list's index its number."""
    if isinstance(tree, torch.Tensor):
        yield _SEP.join(path), tree
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from _leaves(getattr(tree, f), path + ("." + f,))
    elif isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _leaves(v, path + tuple(str(k).split(".")))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (str(i),))
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


def _host_arrays(tree: Any) -> Dict[str, Tuple[np.ndarray, str]]:
    return {k: _to_host(t) for k, t in _leaves(tree)}


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


def save(tree: Any, ckpt_dir: str, step: int, keep: int = 3) -> str:
    """Blocking atomic save. Returns the committed directory."""
    return _write(_host_arrays(tree), ckpt_dir, step, keep)


class AsyncCheckpointer:
    """Overlaps checkpoint I/O with the next training steps: each save
    copies the tree to the host first, then writes it on a thread."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None

    def save(self, tree: Any, step: int):
        self.wait()
        flat = _host_arrays(tree)  # before the next step updates in place
        self._thread = threading.Thread(
            target=_write, args=(flat, self.ckpt_dir, step, self.keep),
            daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None


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


def restore(ckpt_dir: str, like: Any, step: Optional[int] = None
            ) -> Tuple[Any, int]:
    """Restore into ``like``'s tensors in place (its devices; a leaf saved
    in another dtype is cast to ``like``'s) and return (``like``, step).
    ``step`` defaults to the latest."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    with torch.no_grad():
        for key, leaf in _leaves(like):
            arr = np.load(os.path.join(d, key.replace("/", "_") + ".npy"))
            t = _from_saved(arr, manifest["dtypes"].get(key, str(arr.dtype)))
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
