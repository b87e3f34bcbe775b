"""Training loop: the step, checkpoint/restart, metrics.

Port of the reference's ``training/train_loop.py``. ``make_train_step``
builds the update: ``Model.loss_fn``, autograd (``loss.backward()``), then
:func:`.optimizer.adamw_update` in place. The ``Trainer`` adds
checkpointing (async, atomic), preemption handling and straggler
accounting around it. The parameters are the model's own tensors
(:func:`train_params`): a dict of its dotted parameter names, trainable.

Over a mesh (``Trainer(rules=...)``, the reference's meshed branch of
``launch/train.py``) the model's parameters are this rank's shards and
its moments its ZeRO-1 part (``repro_torch.distributed.MeshParams``): a
step takes the whole batch, computes this rank's rows of it, reduces the
gradients onto the shards, and updates them (see
:func:`.optimizer.adamw_update`); checkpoints hold the whole leaves and
restore on any mesh.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..models.model import Model
from .checkpoint import AsyncCheckpointer, latest_step, restore
from .fault import PreemptionGuard, StepTimer
from .optimizer import AdamWConfig, AdamWState, adamw_init, adamw_update

Params = Dict[str, torch.Tensor]


def train_params(model: Model) -> Params:
    """The model's parameters, made trainable (``requires_grad_(True)``,
    ``train()``), by dotted name."""
    model.requires_grad_(True)
    model.train()
    return dict(model.named_parameters())


def make_train_step(model: Model, ocfg: AdamWConfig
                    ) -> Callable[[Params, AdamWState, Dict[str, Any]],
                                  Tuple[Params, AdamWState,
                                        Dict[str, torch.Tensor]]]:
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``:
    ``params`` are the model's own (:func:`train_params`); their gradients
    live only inside the step. Where a mesh holds the model
    (``model.param_hook`` a ``MeshParams``), ``batch`` is the whole batch
    and the step runs this rank's rows of it on the shards."""
    layout = _layout(model)

    def step(params, opt_state, batch):
        for p in params.values():
            p.grad = None
        if layout is not None:
            batch = layout.local_batch(batch)
        loss, mets = model.loss_fn(batch)
        loss.backward()
        grads = {k: p.grad for k, p in params.items()}
        params, opt_state, omets = adamw_update(grads, opt_state, params,
                                                ocfg, layout)
        for p in params.values():
            p.grad = None
        return params, opt_state, {**mets, **omets}
    return step


def _layout(model: Model):
    """The mesh layout holding ``model``'s parameters, if one does."""
    from ..distributed.sharding import MeshParams
    hook = model.param_hook
    return hook if isinstance(hook, MeshParams) else None


@dataclasses.dataclass
class Trainer:
    """``rules`` (a ``ShardingRules`` over a ``launch.mesh.Mesh``) holds
    the model's parameters as this rank's shards (``MeshParams``, made
    here) and its moments as its ZeRO-1 part."""
    model: Model
    ocfg: AdamWConfig
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 100
    keep: int = 3
    rules: Any = None

    def __post_init__(self):
        if self.rules is not None and _layout(self.model) is None:
            from ..distributed.sharding import MeshParams
            MeshParams(self.model, self.rules)
        self.layout = _layout(self.model)
        self._step_fn = make_train_step(self.model, self.ocfg)
        self._ckpt = (AsyncCheckpointer(self.ckpt_dir, self.keep)
                      if self.ckpt_dir else None)
        #: host wall of every step :meth:`fit` ran, each ending in a sync
        self.step_times: List[float] = []

    def init_state(self, generator: Optional[torch.Generator] = None
                   ) -> Tuple[Params, AdamWState]:
        """Draw the model's weights from ``generator`` (on its device) and
        a zero optimizer state (over a mesh: the whole weights drawn, this
        rank's shards kept)."""
        (self.layout or self.model).init(generator)
        params = train_params(self.model)
        return params, adamw_init(params, self.ocfg, self.layout)

    def shardings(self, opt_state: AdamWState):
        """(the parameters', the optimizer state's) shardings over the
        mesh, ``None`` without one."""
        return None if self.layout is None else self.layout.regions(opt_state)

    def maybe_restore(self, params: Params, opt_state: AdamWState,
                      shardings=None) -> Tuple[Params, AdamWState, int]:
        """Resume from the latest checkpoint if one exists (into the given
        tensors, in place; elastic: ``shardings`` is the (parameters',
        state's) shardings on this run's mesh, by default the trainer's
        own)."""
        if not self.ckpt_dir or latest_step(self.ckpt_dir) is None:
            return params, opt_state, 0
        shardings = shardings or self.shardings(opt_state)
        sh = None
        if shardings is not None:
            sh = {"params": shardings[0], "opt": shardings[1]}
        restored, step = restore(self.ckpt_dir,
                                 {"params": params, "opt": opt_state},
                                 shardings=sh)
        return restored["params"], restored["opt"], step

    def _save(self, params: Params, opt_state: AdamWState, step: int):
        sh = self.shardings(opt_state)
        self._ckpt.save({"params": params, "opt": opt_state}, step,
                        None if sh is None else {"params": sh[0],
                                                 "opt": sh[1]})

    def fit(self, params: Params, opt_state: AdamWState,
            batches: Iterator[Dict[str, np.ndarray]], steps: int,
            start_step: int = 0, log_every: int = 10,
            guard: Optional[PreemptionGuard] = None,
            fail_at: Optional[int] = None
            ) -> Tuple[Params, AdamWState, list]:
        """Run ``steps`` optimizer steps. ``fail_at`` injects a fault (for
        restart tests). Returns (params, opt_state, metric log)."""
        timer = StepTimer()
        log = []
        step = start_step
        dev = self.model.device
        for batch in batches:
            if step >= steps:
                break
            if fail_at is not None and step == fail_at:
                raise RuntimeError(f"injected fault at step {step}")
            t0 = time.perf_counter()
            params, opt_state, mets = self._step_fn(
                params, opt_state,
                {k: torch.as_tensor(v, device=dev) for k, v in batch.items()})
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            dt = time.perf_counter() - t0
            self.step_times.append(dt)
            straggled = timer.observe(dt)
            step += 1
            if step % log_every == 0 or step == steps:
                log.append({"step": step,
                            **{k: float(v) for k, v in mets.items()},
                            "straggled": straggled})
            if self._ckpt and (step % self.ckpt_every == 0
                               or (guard and guard.should_stop)):
                self._save(params, opt_state, step)
            if guard and guard.should_stop:
                break
        if self._ckpt:
            self._save(params, opt_state, step)
            self._ckpt.wait()
        return params, opt_state, log
