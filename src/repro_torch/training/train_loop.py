"""Training loop: the step, checkpoint/restart, metrics.

Port of the reference's ``training/train_loop.py``. ``make_train_step``
builds the update: ``Model.loss_fn``, autograd (``loss.backward()``), then
:func:`.optimizer.adamw_update` in place. The ``Trainer`` adds
checkpointing (async, atomic), preemption handling and straggler
accounting around it. The parameters are the model's own tensors
(:func:`train_params`): a dict of its dotted parameter names, trainable.
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
    live only inside the step."""
    def step(params, opt_state, batch):
        for p in params.values():
            p.grad = None
        loss, mets = model.loss_fn(batch)
        loss.backward()
        grads = {k: p.grad for k, p in params.items()}
        params, opt_state, omets = adamw_update(grads, opt_state, params,
                                                ocfg)
        for p in params.values():
            p.grad = None
        return params, opt_state, {**mets, **omets}
    return step


@dataclasses.dataclass
class Trainer:
    model: Model
    ocfg: AdamWConfig
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 100
    keep: int = 3

    def __post_init__(self):
        self._step_fn = make_train_step(self.model, self.ocfg)
        self._ckpt = (AsyncCheckpointer(self.ckpt_dir, self.keep)
                      if self.ckpt_dir else None)
        #: host wall of every step :meth:`fit` ran, each ending in a sync
        self.step_times: List[float] = []

    def init_state(self, generator: Optional[torch.Generator] = None
                   ) -> Tuple[Params, AdamWState]:
        """Draw the model's weights from ``generator`` (on its device) and
        a zero optimizer state."""
        self.model.init(generator)
        params = train_params(self.model)
        return params, adamw_init(params, self.ocfg)

    def maybe_restore(self, params: Params, opt_state: AdamWState
                      ) -> Tuple[Params, AdamWState, int]:
        """Resume from the latest checkpoint if one exists (into the given
        tensors, in place)."""
        if not self.ckpt_dir or latest_step(self.ckpt_dir) is None:
            return params, opt_state, 0
        restored, step = restore(self.ckpt_dir,
                                 {"params": params, "opt": opt_state})
        return restored["params"], restored["opt"], step

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
                self._ckpt.save({"params": params, "opt": opt_state}, step)
            if guard and guard.should_stop:
                break
        if self._ckpt:
            self._ckpt.save({"params": params, "opt": opt_state}, step)
            self._ckpt.wait()
        return params, opt_state, log
