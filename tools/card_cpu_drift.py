"""Find the operations behind a gap between the card's and the CPU's
training of a smoke config.

Runs on a machine with a CUDA card. For each ``--arch`` (float32 smoke
configs, IEEE float32 products, the same weights on the card and the CPU,
the optimizer settings of ``chip_smoke.py``'s ``train_against_cpu``):

1. ``STEPS`` ``Trainer.fit`` steps on each: losses, gradient norms and
   their largest relative gap.
2. One step by hand: per parameter leaf, the gradient's largest gap of the
   leaf's scale, the elements whose gradient changes sign between the two
   (AdamW's first update is lr * sign(g) wherever |g| is well above its
   eps, so a sign that differs moves a weight by 2 lr), and the weights'
   largest gap after the update.
3. One card step under :class:`Shadow`: every aten op the card runs is run
   again on the CPU on copies of the same inputs; each op whose outputs
   are not the CPU's bit for bit is listed with its calls, the calls that
   differ and the largest gap in float32 ulps. The hand-written kernels
   are ctypes calls, not aten ops, so they are not listed.
4. Step 1 again on the card with the outputs of each listed op, and of all
   of them, replaced by the CPU's (``Shadow(replace=...)``), and the gaps
   that remain.

Usage: python tools/card_cpu_drift.py [--arch A ...]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import sys

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.precision import ieee_float32  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.training import (AdamWConfig, Trainer, adamw_init,  # noqa
                                  train_params)
from repro_torch.training.optimizer import adamw_update  # noqa: E402

#: chip_smoke.py's train_against_cpu: its seed for each config, its data
SEEDS = {"llama3-8b": 71, "rwkv6-1.6b": 73, "recurrentgemma-9b": 74}
DATA = DataConfig(64, 4)
STEPS = 3
OCFG = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=STEPS)
#: ops whose outputs are not a function of their inputs' values
_UNCOMPARED = ("empty", "new_empty", "empty_strided", "empty_like",
               "rand", "randn", "normal", "uniform", "bernoulli",
               "_local_scalar_dense", "record_stream", "set_")


def _ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest gap between two float32 tensors in units in the last place
    (NaNs in the same places equal)."""
    both_nan = torch.isnan(a) & torch.isnan(b)
    ia = a.contiguous().view(torch.int32).long()
    ib = b.contiguous().view(torch.int32).long()
    # map the sign-magnitude bit patterns onto a line
    ia = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    d = (ia - ib).abs().masked_fill(both_nan, 0)
    return int(d.max()) if d.numel() else 0


class Shadow(TorchDispatchMode):
    """Run each aten op that touches the card again on the CPU, on copies
    of its inputs taken before it ran, and keep per op name: calls, calls
    whose floating outputs differ from the CPU's, the largest float32 ulp
    gap. The outputs of the ops named in ``replace`` are overwritten with
    the CPU's."""

    card = "cuda"

    def __init__(self, replace=()):
        super().__init__()
        self.replace = set(replace)
        self.stats = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        flat, _ = tree_flatten((args, kwargs))
        on_card = any(isinstance(t, torch.Tensor)
                      and t.device.type == self.card for t in flat) \
            or str(kwargs.get("device", "")).startswith(self.card)
        if not on_card or name.startswith(_UNCOMPARED) \
                or "generator" in kwargs:
            return func(*args, **kwargs)

        def to_cpu(x):
            if isinstance(x, torch.Tensor):
                return x.detach().to("cpu", copy=True)
            if isinstance(x, torch.device) and x.type == "cuda":
                return torch.device("cpu")
            return x
        cpu_args, cpu_kwargs = tree_map(to_cpu, (args, kwargs))
        if "device" in cpu_kwargs:
            cpu_kwargs["device"] = torch.device("cpu")
        out = func(*args, **kwargs)
        try:
            want = func(*cpu_args, **cpu_kwargs)
        except Exception:  # an op with no CPU kernel: not compared
            return out
        got_flat, _ = tree_flatten(out)
        want_flat, _ = tree_flatten(want)
        st = self.stats.setdefault(name, [0, 0, 0])
        st[0] += 1
        differs, worst = False, 0
        for g, w in zip(got_flat, want_flat):
            if not (isinstance(g, torch.Tensor) and isinstance(w, torch.Tensor)
                    and g.is_floating_point() and g.shape == w.shape):
                continue
            gc = g.detach().cpu()
            same_nan = bool((torch.isnan(gc) == torch.isnan(w)).all())
            if torch.equal(gc, w) or same_nan and torch.equal(
                    gc.nan_to_num(0.0), w.nan_to_num(0.0)):
                continue
            differs = True
            if g.dtype == torch.float32:
                worst = max(worst, _ulps(gc, w))
            if name in self.replace:
                g.detach().copy_(w.to(g.device))
        st[1] += int(differs)
        st[2] = max(st[2], worst)
        return out


def _models(arch):
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32",
                              kv_dtype="float32")
    cpu = Model(cfg, device="cpu").init(
        torch.Generator().manual_seed(SEEDS[arch]))
    card = Model(cfg, device="cuda")
    card.load_state_dict(cpu.state_dict())
    return cfg, card, cpu


def _fit(model, cfg, steps, mode=None):
    tr = Trainer(model, OCFG)
    p = train_params(model)
    with ieee_float32(), mode or contextlib.nullcontext():
        _, _, log = tr.fit(p, adamw_init(p, OCFG),
                           SyntheticLM(cfg, DATA).iterate(), steps=steps,
                           log_every=1)
    return log


def _gap(card_log, cpu_log):
    return max(abs(a[k] - b[k]) / abs(b[k]) for a, b in zip(card_log, cpu_log)
               for k in ("loss", "grad_norm"))


def fit_gaps(arch):
    cfg, card, cpu = _models(arch)
    logs = [_fit(m, cfg, STEPS) for m in (card, cpu)]
    for k in ("loss", "grad_norm"):
        print(f"{arch} fit {k}: card {[e[k] for e in logs[0]]} CPU "
              f"{[e[k] for e in logs[1]]} gaps "
              f"{[abs(a[k] - b[k]) / abs(b[k]) for a, b in zip(*logs)]}")
    print(f"{arch} fit: largest gap {_gap(*logs)!r}")
    return logs[1]


def first_step_leaves(arch):
    cfg, card, cpu = _models(arch)
    batch = SyntheticLM(cfg, DATA).batch(0)
    grads, after = [], []
    for m in (card, cpu):
        p = train_params(m)
        opt = adamw_init(p, OCFG)
        with ieee_float32():
            loss, _ = m.loss_fn({k: torch.as_tensor(v, device=m.device)
                                 for k, v in batch.items()})
            loss.backward()
            grads.append({k: t.grad.detach().cpu().clone()
                          for k, t in p.items()})
            adamw_update({k: t.grad for k, t in p.items()}, opt, p,
                         OCFG)
        after.append({k: t.detach().cpu().clone() for k, t in p.items()})
    rows = []
    for k, gc in grads[1].items():
        gg = grads[0][k]
        scale = float(gc.abs().max()) or 1.0
        flips = (torch.sign(gg) != torch.sign(gc))
        flip_g = float(torch.maximum(gg.abs(), gc.abs())[flips].max()) \
            if flips.any() else 0.0
        dp = (after[0][k] - after[1][k]).abs()
        rows.append((float(dp.max()), k, float((gg - gc).abs().max()) / scale,
                     int(flips.sum()), flip_g / scale, gc.numel()))
    rows.sort(reverse=True)
    print(f"{arch} step 1 by leaf (weights' largest gap after the update; "
          f"gradient gap of scale; sign flips, their largest |g| of scale; "
          f"elements):")
    for dp, k, gap, nf, fg, n in rows:
        print(f"  {k}: weights {dp:.3e}; gradient {gap:.3e}; flips {nf} "
              f"(largest {fg:.3e}); {n}")


def shadow_ops(arch):
    cfg, card, _ = _models(arch)
    mode = Shadow()
    _fit(card, cfg, 1, mode)
    diff = {n: s for n, s in mode.stats.items() if s[1]}
    print(f"{arch} shadow of one card step: {len(mode.stats)} aten ops "
          f"compared ({sum(s[0] for s in mode.stats.values())} calls); not "
          f"the CPU's bit for bit (calls, differing calls, largest ulp gap): "
          f"{diff}")
    return sorted(diff)


def replaced(arch, names, cpu_log):
    for group in [[n] for n in names] + ([names] if len(names) > 1 else []):
        cfg, card, _ = _models(arch)
        log = _fit(card, cfg, STEPS, Shadow(replace=group))
        print(f"{arch} fit with the CPU's {group}: grad norms "
              f"{[e['grad_norm'] for e in log]}, largest gap "
              f"{_gap(log, cpu_log)!r}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", nargs="+", default=list(SEEDS),
                    choices=list(SEEDS))
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("card_cpu_drift: needs a CUDA card")
    np.set_printoptions(precision=4)
    for arch in a.arch:
        cpu_log = fit_gaps(arch)
        first_step_leaves(arch)
        names = shadow_ops(arch)
        replaced(arch, names, cpu_log)


if __name__ == "__main__":
    main()
