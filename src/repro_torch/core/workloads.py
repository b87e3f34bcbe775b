"""Trace-derived workload families: the ``azure:`` spec.

The paper evaluates batches of a few hundred jobs; the production regime
the ROADMAP targets is *days of serverless traffic* — heavy-tailed
durations and diurnal invocation counts, the shape the Azure Functions
2019 trace characterizes (Shahrad et al., ATC'20). This module turns the
small committed trace sample (``src/repro/data/azure_sample.csv.gz``,
~200 functions x 1 day at hourly resolution — a synthetic,
seed-reproducible extract calibrated to the published statistics; see
``src/repro/data/AZURE_SAMPLE.md`` for provenance) into concrete
``(pred, act, release)`` workloads for either engine at any scale, so
``scale=1e5``..``1e6`` invocation days are one spec string away.

Spec strings parse with :func:`parse_workload`::

    azure:day=tue,scale=1e5            # 10^5 invocations of a Tuesday
    azure:day=sat,scale=2000,seed=7    # weekend dip, reseeded sampling
    azure:scale=500,noise=0,horizon=600  # exact models, 10-min day

and thread through ``simulate_scenarios(workload=...)``,
``sweep_scenarios`` task dicts (``{"workload": "azure:...", ...}``),
``schedule_sweep`` and ``serve_online`` — anywhere a ``pred`` dict is
accepted, the spec replaces it (passing both is an error) and its
release stream becomes the default ``arrivals``.

Sampling model (all draws seeded; a given ``(day, scale, seed)`` is one
fixed workload on every machine):

* each *job* is one invocation of one sampled function — functions are
  drawn proportional to their (day-perturbed) daily invocation counts,
  so the trace's extreme skew carries over;
* release times follow the function's hourly profile (diurnal for HTTP,
  flat for timers), uniform within the hour, over ``horizon_s`` seconds
  of simulated day — continuous draws, so tied releases have measure
  zero and the DES==vector exactness caveat holds;
* a job's total duration is the function's mean duration jittered by
  its per-function coefficient of variation (lognormal, mean-
  preserving), split across the app DAG's stages by per-function
  weights that are stable across seeds and days ("the same function
  has the same stage profile");
* public durations, transfer volumes (scaled by the function's memory
  size) and the ``noise``-controlled pred-vs-act model error follow the
  repo's standard synthetic-workload idiom (cf. the Fig.-4 generators).

Day-of-week variants perturb per-function counts with a seeded
lognormal (deterministic per day, independent of ``seed`` — "Tuesday's
traffic" is one fixed day) and apply a weekend dip; the committed
sample stores a single reference day.

This is the reference package's module, numpy only. The port shares the
reference's data file and reads it by path (importing ``repro.data``
would import JAX), so both packages sample the same workloads bit for
bit.
"""
from __future__ import annotations

import csv
import dataclasses
import functools
import gzip
import os
from typing import Dict, Tuple, Union

import numpy as np

from .dag import AppDAG

AZURE_SAMPLE = os.path.abspath(os.path.join(
    os.path.dirname(__file__), os.pardir, os.pardir, "repro", "data",
    "azure_sample.csv.gz"))

DAYS = ("mon", "tue", "wed", "thu", "fri", "sat", "sun")
_WEEKEND_SCALE = 0.72
# entropy tag for the per-day count perturbation and the per-function
# stage-split draws (stable across workload seeds by design)
_SAMPLE_TAG = 20190715


@dataclasses.dataclass(frozen=True)
class AzureWorkload:
    """A parsed ``azure:`` spec: one reproducible invocation day.

    ``scale`` is J, the number of sampled invocations; ``noise`` the
    lognormal sigma of the actual-vs-predicted model error (0 = perfect
    models, ``act is pred``-equivalent); ``horizon_s`` the simulated
    length of the day the hourly profile is stretched over (the default
    86400 s is real time; shrink it to compress the same diurnal shape
    into a shorter horizon).
    """

    day: str = "mon"
    scale: int = 1000
    seed: int = 0
    noise: float = 0.05
    horizon_s: float = 86400.0

    def __post_init__(self):
        if self.day not in DAYS:
            raise ValueError(
                f"azure workload: unknown day {self.day!r} (one of {DAYS})")
        if int(self.scale) < 1:
            raise ValueError("azure workload: scale must be >= 1")
        if self.noise < 0:
            raise ValueError("azure workload: noise must be >= 0")
        if self.horizon_s <= 0:
            raise ValueError("azure workload: horizon must be > 0")


WorkloadLike = Union[None, str, AzureWorkload]


def parse_workload(spec: WorkloadLike) -> AzureWorkload:
    """Parse a workload spec string (or pass through a built workload).

    Grammar: ``azure[:key=value,...]`` with keys ``day`` (mon..sun),
    ``scale`` (job count; accepts ``1e5`` float notation), ``seed``,
    ``noise`` and ``horizon`` (seconds).
    """
    if isinstance(spec, AzureWorkload):
        return spec
    if not isinstance(spec, str):
        raise TypeError(f"workload spec must be a str or AzureWorkload, "
                        f"got {type(spec).__name__}")
    family, _, rest = spec.partition(":")
    if family.strip() != "azure":
        raise ValueError(f"unknown workload family {family.strip()!r} "
                         f"(supported: 'azure')")
    kw: Dict[str, object] = {}
    if rest.strip():
        for item in rest.split(","):
            key, sep, val = item.partition("=")
            key, val = key.strip(), val.strip()
            if not sep or not val:
                raise ValueError(f"azure workload: malformed item {item!r} "
                                 f"(expected key=value)")
            if key == "day":
                kw["day"] = val
            elif key == "scale":
                kw["scale"] = int(float(val))
            elif key == "seed":
                kw["seed"] = int(val)
            elif key == "noise":
                kw["noise"] = float(val)
            elif key == "horizon":
                kw["horizon_s"] = float(val)
            else:
                raise ValueError(
                    f"azure workload: unknown key {key!r} (supported: "
                    f"day, scale, seed, noise, horizon)")
    return AzureWorkload(**kw)


@functools.lru_cache(maxsize=4)
def load_azure_sample(path: str = AZURE_SAMPLE) -> Dict[str, np.ndarray]:
    """Load the committed trace sample into column arrays (cached)."""
    with gzip.open(path, "rt", newline="") as f:
        rows = list(csv.reader(f))
    header, body = rows[0], rows[1:]
    col = {name: i for i, name in enumerate(header)}
    hours = [col[f"h{h:02d}"] for h in range(24)]
    return dict(
        func=np.array([r[col["func"]] for r in body]),
        trigger=np.array([r[col["trigger"]] for r in body]),
        mem_mb=np.array([float(r[col["mem_mb"]]) for r in body]),
        avg_dur_s=np.array([float(r[col["avg_dur_s"]]) for r in body]),
        cv_dur=np.array([float(r[col["cv_dur"]]) for r in body]),
        hourly=np.array([[float(r[h]) for h in hours] for r in body]),
    )


def day_counts(wl: AzureWorkload) -> np.ndarray:
    """[F, 24] hourly invocation counts of the workload's day."""
    s = load_azure_sample()
    day_i = DAYS.index(wl.day)
    counts = s["hourly"].astype(np.float64)
    drng = np.random.default_rng([_SAMPLE_TAG, day_i])
    counts = counts * drng.lognormal(0.0, 0.25, (counts.shape[0], 1))
    if wl.day in ("sat", "sun"):
        counts = counts * _WEEKEND_SCALE
    return counts


def resolve_workload(workload: WorkloadLike, dag: AppDAG, t0: float = 0.0
                     ) -> Tuple[Dict[str, np.ndarray],
                                Dict[str, np.ndarray], np.ndarray]:
    """Materialize a workload spec for ``dag``: ``(pred, act, release)``.

    ``release`` is the [J] absolute release-time stream (starts at
    ``t0``), ready to pass as ``arrivals=`` — the callers that accept
    ``workload=`` default their arrivals to it.
    """
    wl = parse_workload(workload)
    s = load_azure_sample()
    counts = day_counts(wl)
    F = counts.shape[0]
    J = int(wl.scale)
    M = dag.num_stages
    rng = np.random.default_rng([wl.seed, DAYS.index(wl.day), 911])

    # function per job, proportional to the day's traffic
    p_f = counts.sum(axis=1)
    f_j = rng.choice(F, size=J, p=p_f / p_f.sum())
    # release: hour from the function's profile, uniform within the hour
    prof = counts / counts.sum(axis=1, keepdims=True)
    cp = np.cumsum(prof, axis=1)
    h_j = np.minimum((rng.random(J)[:, None] > cp[f_j]).sum(axis=1), 23)
    release = t0 + (h_j + rng.random(J)) * (wl.horizon_s / 24.0)

    # durations: mean-preserving lognormal jitter at the function's CV,
    # split across stages by the function's stable stage profile
    cv = s["cv_dur"][f_j]
    dur = s["avg_dur_s"][f_j] * np.exp(rng.normal(0.0, 1.0, J) * cv
                                       - 0.5 * cv * cv)
    wrng = np.random.default_rng([_SAMPLE_TAG, 7, M])
    wts = wrng.gamma(2.0, 1.0, (F, M))
    wts = wts / wts.sum(axis=1, keepdims=True)
    P_priv = dur[:, None] * wts[f_j]
    gb = s["mem_mb"][f_j][:, None] / 512.0
    pred = dict(P_private=P_priv,
                P_public=P_priv * rng.uniform(0.8, 1.6, (J, M)),
                upload=gb * rng.uniform(0.02, 0.2, (J, M)),
                download=gb * rng.uniform(0.02, 0.2, (J, M)))
    if wl.noise > 0:
        act = {k: v * rng.lognormal(0.0, wl.noise, v.shape)
               for k, v in pred.items()}
    else:
        act = {k: v.copy() for k, v in pred.items()}
    return pred, act, release
