#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. Environment and build: prints the card's name and power limit as
   ``nvidia-smi`` reports them, and builds every CUDA kernel of the main
   path from ``src/repro_torch/kernels/csrc/`` with ``nvcc``.
2. Kernels against their plain PyTorch versions, on the card: random and
   hand-built near-tie inputs at the main path's shapes and ragged ones,
   compared bit for bit; the kernel's time, the plain version's time and
   the least time the card could take for the same work.
3. The main path: Algorithm 1 over the Fig.-4 grid (image, matrix and
   video x {spt, hcf} x 5 deadlines = 30 scenarios) in one
   ``sweep_scenarios`` call on ``cuda`` at J=512 and J=4096 jobs. Launch
   counts are reset just before and read just after, and every kernel of
   the path must have launched. The J=512 sweep reruns on the CPU and
   must agree field for field; three scenarios of the J=4096 grid replay
   through the port's DES and must meet the parity contract (placements,
   replicas, providers, segments, start and end exact; cost and makespan
   to a relative 1e-12). The J=512 sweep then runs once more under
   ``torch.profiler`` to split its wall time into device-busy and idle.
4. Prints the kernels' JSON line, then the device line last.

Needs a CUDA device (exits 1 without one) and the repository's ``src/``
beside it; imports nothing of JAX.
"""
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

#: published H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, and the
#: non-tensor-core float rates the kernel's adds and compares run at
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float64": 34e12, "float32": 67e12}

N_DEADLINES = 5
ORDERS = ("spt", "hcf")
MAIN_J = (512, 4096)
DES_SCENARIOS = ((0, 0), (1, 7), (2, 9))  # (task, scenario) pairs


def fig4_workload(apps, J, jitter=0.05):
    """Fig-4-style batch per app (the throughput benchmark's generator):
    lognormal stage latencies, moderate prediction error, transfer
    latencies, a deadline grid scaled off the ideal all-private makespan."""
    import numpy as np

    fracs = np.linspace(0.45, 0.95, N_DEADLINES)
    tasks = []
    for ai, (name, dag) in enumerate(sorted(apps.items())):
        rng = np.random.default_rng(ai)
        M = dag.num_stages
        P_priv = rng.lognormal(0.0, 0.5, (J, M)) * 2.0
        pred = dict(P_private=P_priv,
                    P_public=P_priv * rng.uniform(0.8, 1.6, (J, M)),
                    upload=rng.uniform(0.05, 0.3, (J, M)),
                    download=rng.uniform(0.05, 0.3, (J, M)))
        act = {k: v * rng.lognormal(0, jitter, v.shape)
               for k, v in pred.items()}
        base = float(P_priv.sum()) / float(dag.replicas.sum())
        tasks.append(dict(name=name, dag=dag, pred=pred, act=act,
                          c_max_grid=tuple(float(base * f) for f in fracs),
                          orders=ORDERS))
    return tasks


RESULT_FIELDS = ("makespan", "cost_usd", "public_mask", "start", "end",
                 "completion", "n_offloaded_stages", "n_init_offloaded_jobs",
                 "per_stage_offloads", "provider", "replica", "segment",
                 "attempts", "failed", "abandoned", "queue_wait", "cold")


def same(a, b) -> bool:
    import numpy as np

    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        return False
    return bool(np.array_equal(a, b, equal_nan=a.dtype.kind == "f"))


def main() -> int:
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from repro_torch.core import APPS, simulate, sweep_scenarios
    from repro_torch.core import vectorsim
    from repro_torch.kernels import build, ops
    from repro_torch.kernels.ref import acd_evict_plain

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)

    # -- 1. environment and build -------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi)  # the card's name and power limit, as nvidia-smi gives them
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    libs = build.build_all()
    for name, path in libs.items():
        print(f"build: {name} {build.BUILD_SECONDS[name]:.2f} s "
              f"-> {os.path.relpath(path, ROOT)}")

    # -- 2. kernel against plain version ------------------------------------
    rng = np.random.default_rng(0)
    f64, f32 = torch.float64, torch.float32

    def random_case(B, J, dtype, p_mask=0.8):
        P = rng.lognormal(0.0, 0.6, (B, J))
        thresh = rng.uniform(0.0, 0.5 * J, (B, J)) * float(P.mean())
        mask = rng.random((B, J)) < p_mask
        return (torch.tensor(P, dtype=dtype, device=dev),
                torch.tensor(thresh, dtype=dtype, device=dev),
                torch.tensor(mask, device=dev))

    def near_tie_case(B, J):
        P = rng.lognormal(0.0, 0.5, (B, J))
        s = np.concatenate([np.zeros((B, 1)),
                            np.cumsum(P, axis=1)[:, :-1]], axis=1)
        thresh = s.copy()
        thresh[1::3] = np.nextafter(s[1::3], -np.inf)
        thresh[2::3] = np.nextafter(s[2::3], np.inf)
        thresh[:, 0] = 0.0  # no subnormal thresholds
        return (torch.tensor(P, dtype=f64, device=dev),
                torch.tensor(thresh, dtype=f64, device=dev),
                torch.ones((B, J), dtype=torch.bool, device=dev))

    cases = [
        ("main-path f64 [30, 4096]", random_case(30, 4096, f64), True),
        ("main-path f64 [30, 512]", random_case(30, 512, f64), True),
        ("f32 [30, 4096]", random_case(30, 4096, f32), True),
        ("ragged f64 [7, 1000]", random_case(7, 1000, f64), True),
        ("ragged f32 [5, 4097]", random_case(5, 4097, f32), True),
        ("ragged f64 [3, 1]", random_case(3, 1, f64, 1.0), False),
        ("empty mask f64 [4, 300]", random_case(4, 300, f64, 0.0), False),
        ("near ties f64 [9, 2049]", near_tie_case(9, 2049), True),
    ]
    max_err = 0
    for label, (P, thresh, mask), evicts in cases:
        got = ops.acd_evict(P, thresh, mask)
        want = acd_evict_plain(P, thresh, mask)
        torch.cuda.synchronize()
        err = int((got.to(torch.int16) - want.to(torch.int16)).abs().max())
        max_err = max(max_err, err)
        print(f"acd_evict {label}: evicted {int(got.sum())}/"
              f"{int(mask.sum())} masked, max_abs_err {err}")
        if err != 0 or not torch.equal(got, want):
            raise AssertionError(f"acd_evict {label}: kernel != plain")
        if evicts != bool(got.any()):
            raise AssertionError(f"acd_evict {label}: evictions expected "
                                 f"{evicts}, got {bool(got.any())}")

    def cuda_ms(fn, n):
        fn()
        torch.cuda.synchronize()
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        for _ in range(n):
            fn()
        t1.record()
        torch.cuda.synchronize()
        return t0.elapsed_time(t1) / n

    P, thresh, mask = cases[0][1]
    B, J = P.shape
    k_ms = cuda_ms(lambda: ops.acd_evict(P, thresh, mask), 50)
    p_ms = cuda_ms(lambda: acd_evict_plain(P, thresh, mask), 2)
    n_bytes = B * J * (2 * P.element_size() + 2)
    n_ops = 2 * B * J  # one compare and one add per element
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / PEAK_OPS_PER_S["float64"] * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    print(f"acd_evict [{B}, {J}] f64: kernel {k_ms:.6f} ms "
          f"({k_ms * 1e6 / J:.3f} ns per element of the serial chain), "
          f"plain {p_ms:.3f} ms, bound {bound_ms:.6f} ms "
          f"(bytes {n_bytes} -> {bytes_ms:.6f} ms, ops {n_ops} -> "
          f"{ops_ms:.6f} ms)")

    # -- 3. the main path ---------------------------------------------------
    outs, walls = {}, {}
    ops.reset_launch_counts()
    launches_by_J = {}
    for J in MAIN_J:
        tasks = fig4_workload(APPS, J)
        before = ops.launch_counts()["acd_evict"]
        t0 = time.perf_counter()
        out = sweep_scenarios(tasks, device="cuda")
        torch.cuda.synchronize()
        wall = walls[J] = time.perf_counter() - t0
        launches_by_J[J] = ops.launch_counts()["acd_evict"] - before
        stats = vectorsim._LAST_RUN_STATS
        print(f"main path J={J}: 30 scenarios on {stats['device']} in "
              f"{wall:.3f} s (prep {stats['prep_s']:.3f} s, engine "
              f"{stats['engine_s']:.3f} s, finalize "
              f"{stats['finalize_s']:.3f} s); body steps per stage "
              f"{stats['trips']}; acd_evict launches {launches_by_J[J]}")
        for task, res in zip(tasks, out):
            M = task["dag"].num_stages
            if res.num_scenarios != 2 * N_DEADLINES or \
                    res.start.shape != (2 * N_DEADLINES, J, M):
                raise AssertionError(f"J={J} {task['name']}: bad shapes")
            if not (np.isfinite(res.makespan).all()
                    and np.isfinite(res.cost_usd).all()
                    and np.isfinite(res.end).all()):
                raise AssertionError(f"J={J} {task['name']}: non-finite")
            print(f"  {task['name']}: makespan {res.makespan.min():.3f}.."
                  f"{res.makespan.max():.3f} s, cost "
                  f"{res.cost_usd.min():.6f}..{res.cost_usd.max():.6f} USD, "
                  f"offload {res.offload_fraction.min():.3f}.."
                  f"{res.offload_fraction.max():.3f}")
        outs[J] = (tasks, out)
    launches = ops.launch_counts()["acd_evict"]
    if launches <= 0 or min(launches_by_J.values()) <= 0:
        raise AssertionError("the main path never launched acd_evict")

    tasks, out = outs[512]
    t0 = time.perf_counter()
    cpu = sweep_scenarios(tasks, device="cpu")
    print(f"J=512 rerun on the CPU in {time.perf_counter() - t0:.3f} s")
    for task, g, c in zip(tasks, out, cpu):
        bad = [f for f in RESULT_FIELDS
               if not same(getattr(g, f), getattr(c, f))]
        if bad:
            raise AssertionError(f"J=512 {task['name']}: cuda != cpu in "
                                 f"{bad}")
    print("J=512: cuda and cpu results equal in every field")

    tasks, out = outs[4096]
    for ti, s in DES_SCENARIOS:
        task, res = tasks[ti], out[ti]
        t0 = time.perf_counter()
        d = simulate(task["dag"], task["pred"], task["act"],
                     c_max=float(res.c_max[s]), order=res.orders[s])
        v = res.scenario(s)
        bad = [f for f in ("public_mask", "provider", "replica", "segment",
                           "start", "end", "completion")
               if not same(getattr(v, f), getattr(d, f))]
        for f in ("cost_usd", "makespan"):
            if not np.isclose(getattr(v, f), getattr(d, f), rtol=1e-12,
                              atol=0):
                bad.append(f)
        print(f"J=4096 DES {task['name']} {res.orders[s]} "
              f"c_max={res.c_max[s]:.3f}: {time.perf_counter() - t0:.3f} s, "
              f"cost {v.cost_usd!r} vs {d.cost_usd!r}, makespan "
              f"{v.makespan!r} vs {d.makespan!r}")
        if bad:
            raise AssertionError(f"J=4096 {task['name']} scenario {s}: "
                                 f"engine != DES in {bad}")

    # -- 3b. where the J=512 sweep's time goes, under torch.profiler ---------
    from torch.profiler import ProfilerActivity, profile

    tasks = outs[512][0]
    # device activity only: host-op events would triple the trace and
    # its post-processing time without entering the busy share
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sweep_scenarios(tasks, device="cuda")
        torch.cuda.synchronize()
        wall_p = time.perf_counter() - t0
    dev_events = sorted((e for e in prof.key_averages()
                         if e.device_type == torch.autograd.DeviceType.CUDA),
                        key=lambda e: -e.self_device_time_total)
    busy_s = sum(e.self_device_time_total for e in dev_events) * 1e-6
    if busy_s > 0:
        acd_s = sum(e.self_device_time_total for e in dev_events
                    if "acd_evict" in e.key) * 1e-6
        print(f"profile J=512: device busy {busy_s:.3f} s of a "
              f"{wall_p:.3f} s profiled wall ({busy_s / wall_p:.3f}); of "
              f"the unprofiled {walls[512]:.3f} s wall "
              f"{busy_s / walls[512]:.3f} busy, "
              f"{1 - busy_s / walls[512]:.3f} idle; acd_evict kernel "
              f"{acd_s:.3f} s ({acd_s / busy_s:.3f} of busy); "
              f"{sum(e.count for e in dev_events)} device events")
        for e in dev_events[:6]:
            print(f"  {e.self_device_time_total * 1e-6:.3f} s "
                  f"x{e.count} {e.key[:90]}")
    else:
        print("profile J=512: torch.profiler saw no device time; device "
              "busy share not measured")

    # -- 4. result ------------------------------------------------------------
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [{
        "name": "acd_evict", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/acd_evict.cu",
        "replaces": "src/repro/kernels/acd_sweep.py:44",
        "launches": launches, "max_abs_err": float(max_err),
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
