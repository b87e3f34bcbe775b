#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. Environment and build: prints the card's name and power limit as
   ``nvidia-smi`` reports them, and builds every CUDA kernel of the main
   paths from ``src/repro_torch/kernels/csrc/`` with ``nvcc`` (one
   process per source, all started together).
2. Kernels against their plain PyTorch versions, on the same inputs:
   random and hand-built edge inputs (near ties, tied slot clocks,
   uncapped and infeasible providers, never-used slots, empty and full
   chains) at the main paths' shapes and ragged ones, compared bit for
   bit; each kernel's time, its plain version's time and the least time
   the card could take for the same work.
3. The uncapped main path: Algorithm 1 over the Fig.-4 grid (image,
   matrix and video x {spt, hcf} x 5 deadlines = 30 scenarios) in one
   ``sweep_scenarios`` call on ``cuda`` at J=512 and J=4096 jobs. The grid
   at J=256 runs on the card and on the CPU and must agree field for
   field; three scenarios of each timed grid (J=512 and J=4096) replay
   through the port's DES and must meet the parity contract (placements,
   replicas, providers, segments, start and end exact; cost and makespan
   to a relative 1e-12). The J=512 sweep then runs once more under
   ``torch.profiler`` to split its wall time into device-busy and idle.
4. The congested main path: the same grid on a 3-provider portfolio with
   2-slot concurrency caps per provider and a 0.5 s warm-up / 1 s
   keep-alive scale-to-zero cold-start model (the throughput benchmark's
   ``--coldstart 0.5`` point), at J=512 and J=4096 on ``cuda``. Queue waits
   and cold starts must occur; the J=256 grid agrees between the card and
   the CPU field for field; three scenarios of each timed grid meet the
   DES contract, queue waits and cold flags exact; the J=512 sweep runs
   once more under the profiler.
5. A pool trace (one private replica per stage, two from a breakpoint
   inside the horizon) with the cold-start model, J=512 on ``cuda``; three
   of its scenarios meet the DES contract, and the J=256 grid agrees
   between the card and the CPU field for field.
6. Prints the kernels' JSON line, then the device line last.

Launch counts are set to 0 just before each main path and read just after
it; every kernel of a path must have launched in it.

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
#: the congested path: the throughput benchmark's ``--coldstart 0.5``
#: point (2-slot caps per provider of demo_portfolio(3), a W-second
#: warm-up with a 2W keep-alive window, scale-to-zero pools)
LOAD_WARM_UP_S = 0.5
LOAD_CAP = 2
LOAD_PROVIDERS = 3
LOAD_DES_SCENARIOS = ((0, 3), (1, 6), (2, 9))
#: job count of the CPU reruns: a J=512 rerun of each path on the CPU (the
#: plain acd_evict loop) took 46-64 s and put the script at 6 minutes
CPU_J = 256


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


def check_sweep(label, tasks, out, J):
    """Shapes and finiteness of one sweep's results; prints a summary."""
    import numpy as np

    for task, res in zip(tasks, out):
        M = task["dag"].num_stages
        if res.num_scenarios != 2 * N_DEADLINES or \
                res.start.shape != (2 * N_DEADLINES, J, M):
            raise AssertionError(f"{label} {task['name']}: bad shapes")
        if not (np.isfinite(res.makespan).all()
                and np.isfinite(res.cost_usd).all()
                and np.isfinite(res.end).all()):
            raise AssertionError(f"{label} {task['name']}: non-finite")
        print(f"  {task['name']}: makespan {res.makespan.min():.3f}.."
              f"{res.makespan.max():.3f} s, cost "
              f"{res.cost_usd.min():.6f}..{res.cost_usd.max():.6f} USD, "
              f"offload {res.offload_fraction.min():.3f}.."
              f"{res.offload_fraction.max():.3f}, queue wait "
              f"{res.queue_wait.sum():.3f} s, cold starts "
              f"{int(res.cold.sum())}")


def check_cpu_rerun(label, tasks, sweep_kw):
    """One sweep on the card and on the CPU: equal in every field."""
    import time

    from repro_torch.core import sweep_scenarios

    out = sweep_scenarios(tasks, device="cuda", **sweep_kw)
    t0 = time.perf_counter()
    cpu = sweep_scenarios(tasks, device="cpu", **sweep_kw)
    print(f"{label}: rerun on the CPU in {time.perf_counter() - t0:.3f} s")
    for task, g, c in zip(tasks, out, cpu):
        bad = [f for f in RESULT_FIELDS
               if not same(getattr(g, f), getattr(c, f))]
        if bad:
            raise AssertionError(f"{label} {task['name']}: cuda != cpu in "
                                 f"{bad}")
    print(f"{label}: cuda and cpu results equal in every field")


def profile_sweep(label, tasks, sweep_kw, wall):
    """The sweep once more under ``torch.profiler`` (device activity
    only): device-busy share of the unprofiled wall ``wall``, kernel time
    by name, device events per body step."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import sweep_scenarios, vectorsim

    # host-op events would triple the trace and its post-processing time
    # without entering the busy share
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sweep_scenarios(tasks, device="cuda", **sweep_kw)
        torch.cuda.synchronize()
        wall_p = time.perf_counter() - t0
    steps = sum(sum(t) for t in vectorsim._LAST_RUN_STATS["trips"])
    dev_events = sorted((e for e in prof.key_averages()
                         if e.device_type == torch.autograd.DeviceType.CUDA),
                        key=lambda e: -e.self_device_time_total)
    busy_s = sum(e.self_device_time_total for e in dev_events) * 1e-6
    if busy_s <= 0:
        print(f"profile {label}: torch.profiler saw no device time; device "
              f"busy share not measured")
        return
    n_events = sum(e.count for e in dev_events)
    kern = {k: sum(e.self_device_time_total for e in dev_events
                   if k in e.key) * 1e-6
            for k in ("acd_evict", "fifo_dispatch")}
    print(f"profile {label}: device busy {busy_s:.3f} s of a {wall_p:.3f} s "
          f"profiled wall ({busy_s / wall_p:.3f}); of the unprofiled "
          f"{wall:.3f} s wall {busy_s / wall:.3f} busy, "
          f"{1 - busy_s / wall:.3f} idle; kernels "
          + ", ".join(f"{k} {v:.3f} s ({v / busy_s:.3f} of busy)"
                      for k, v in kern.items())
          + f"; {n_events} device events, {n_events / steps:.1f} per body "
          f"step ({steps} steps)")
    for e in dev_events[:6]:
        print(f"  {e.self_device_time_total * 1e-6:.3f} s "
              f"x{e.count} {e.key[:90]}")


def check_des(label, tasks, out, pairs, sim_kw, load_fields=False):
    """Scenarios of a sweep against the port's DES under the parity
    contract (queue waits and cold flags exact too, when loaded)."""
    import time

    import numpy as np

    from repro_torch.core import simulate

    exact = ("public_mask", "provider", "replica", "segment", "start",
             "end", "completion")
    if load_fields:
        exact += ("queue_wait", "cold")
    for ti, s in pairs:
        task, res = tasks[ti], out[ti]
        t0 = time.perf_counter()
        d = simulate(task["dag"], task["pred"], task["act"],
                     c_max=float(res.c_max[s]), order=res.orders[s],
                     **sim_kw)
        v = res.scenario(s)
        bad = [f for f in exact if not same(getattr(v, f), getattr(d, f))]
        for f in ("cost_usd", "makespan"):
            if not np.isclose(getattr(v, f), getattr(d, f), rtol=1e-12,
                              atol=0):
                bad.append(f)
        print(f"{label} DES {task['name']} {res.orders[s]} "
              f"c_max={res.c_max[s]:.3f}: {time.perf_counter() - t0:.3f} s, "
              f"cost {float(v.cost_usd)!r} vs {float(d.cost_usd)!r}, "
              f"makespan {float(v.makespan)!r} vs {float(d.makespan)!r}")
        if bad:
            raise AssertionError(f"{label} {task['name']} scenario {s}: "
                                 f"engine != DES in {bad}")


def main() -> int:
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from repro_torch.core import (APPS, ColdStartModel, PoolTrace,
                                  demo_portfolio, sweep_scenarios)
    from repro_torch.core import vectorsim
    from repro_torch.kernels import build, ops
    from repro_torch.kernels.ref import acd_evict_plain, fifo_dispatch_plain

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
    t0 = time.perf_counter()
    libs = build.build_all()
    print(f"build: {len(libs)} kernels in {time.perf_counter() - t0:.2f} s")
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
    kernels = [{
        "name": "acd_evict", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/acd_evict.cu",
        "replaces": "src/repro/kernels/acd_sweep.py:44",
        "max_abs_err": float(max_err), "ms": k_ms, "plain_ms": p_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None}]

    # -- 2b. fifo_dispatch against its plain version --------------------------
    def fifo_case(B, P, J, C, n_pub=None, capped=(True, False, True),
                  edit=None):
        """Random chain inputs on the card (the reference kernel test's
        distributions), rows with random n_pub unless one is given."""
        order = np.stack([rng.permutation(J) for _ in range(B)])
        npub = (rng.integers(0, J + 1, B) if n_pub is None
                else np.full(B, n_pub))
        x = dict(order=order.astype(np.int32), n_pub=npub.astype(np.int32),
                 ready=rng.uniform(0.0, 0.01 * J, (B, P, J)),
                 dur=rng.lognormal(0.0, 0.5, (B, P, J)),
                 selc=rng.uniform(0.0, 2.0, (B, P, J)),
                 occ=rng.uniform(0.0, 0.3, (B, P, J)),
                 seg=rng.integers(0, 4, (B, P, J)).astype(np.int32),
                 capped=np.resize(np.asarray(capped, bool), P),
                 wu=rng.uniform(0.1, 1.0, P),
                 sclk0=rng.uniform(0.0, 3.0, (B, P, C)))
        x["sidle0"] = np.where(rng.random((B, P, C)) < 0.3, -np.inf,
                               x["sclk0"])
        if edit is not None:
            edit(x)
        return [torch.from_numpy(np.ascontiguousarray(x[k])).to(dev)
                for k in ("order", "n_pub", "ready", "dur", "selc", "occ",
                          "seg", "capped", "wu", "sclk0", "sidle0")]

    def tie(x):
        x["sclk0"][:] = 1.0
        x["sidle0"][:] = 1.0
        for k in ("ready", "selc", "occ"):
            x[k][:, 1] = x[k][:, 0]
        x["wu"][1] = x["wu"][0]

    def infeasible(x):
        x["selc"][:, 0] = np.inf
        x["selc"][:, :, ::7] = np.inf  # all-inf columns too

    def never_used(x):
        x["sidle0"][:] = -np.inf

    KA = 2.0 * LOAD_WARM_UP_S
    fifo_cases = [
        ("main-path [30, 3, 4096, 2]", fifo_case(30, 3, 4096, 2)),
        ("main-path [30, 3, 4096, 2] all capped, n_pub=J",
         fifo_case(30, 3, 4096, 2, n_pub=4096, capped=(True,))),
        ("main-path [30, 3, 512, 2]", fifo_case(30, 3, 512, 2)),
        ("P=1 [8, 1, 1000, 2]", fifo_case(8, 1, 1000, 2, capped=(True,))),
        ("n_pub=0 [4, 3, 512, 2]", fifo_case(4, 3, 512, 2, n_pub=0)),
        ("ragged [7, 3, 1000, 3]", fifo_case(7, 3, 1000, 3)),
        ("ragged [5, 3, 4097, 2]", fifo_case(5, 3, 4097, 2)),
        ("tied slot clocks [6, 3, 700, 2]",
         fifo_case(6, 3, 700, 2, edit=tie)),
        ("infeasible provider [6, 3, 700, 2]",
         fifo_case(6, 3, 700, 2, edit=infeasible)),
        ("never-used slots [6, 3, 700, 4]",
         fifo_case(6, 3, 700, 4, edit=never_used)),
    ]
    fifo_err = 0.0
    for label, args in fifo_cases:
        for cold in (False, True):
            got = ops.fifo_dispatch(*args, KA, cold=cold)
            torch.cuda.synchronize()
            # the plain version on the CPU copy of the same inputs: the
            # chain is elementwise float64, so the device cannot matter,
            # and the CPU takes seconds where the card's plain loop of
            # small launches takes many
            want = fifo_dispatch_plain(*(a.cpu() for a in args), KA,
                                       cold=cold)
            errs = [float((g.cpu().double() - w.double()).nan_to_num(
                0.0, 0.0, 0.0).abs().max()) if w.numel() else 0.0
                for g, w in zip(got, want)]
            fifo_err = max(fifo_err, *errs)
            ok = all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
            print(f"fifo_dispatch {label} cold={cold}: "
                  f"{int(args[1].sum())} chain steps, queue wait "
                  f"{float(got[2].sum()):.3f}, cold {int(got[3].sum())}, "
                  f"max_abs_err {max(errs)}")
            if not ok:
                raise AssertionError(f"fifo_dispatch {label} cold={cold}: "
                                     f"kernel != plain")

    args = fifo_cases[1][1]
    B, P, J = args[2].shape
    C = args[9].shape[2]
    fk_ms = cuda_ms(lambda: ops.fifo_dispatch(*args, KA, cold=True), 20)
    t0 = time.perf_counter()
    plain_out = fifo_dispatch_plain(*args, KA, cold=True)
    torch.cuda.synchronize()
    fp_ms = (time.perf_counter() - t0) * 1e3
    if not all(torch.equal(g, w) for g, w in zip(
            ops.fifo_dispatch(*args, KA, cold=True), plain_out)):
        raise AssertionError("fifo_dispatch: kernel != plain on the card")
    n_steps = int(args[1].sum())  # chain steps this input needs (n_pub)
    f_bytes = (n_steps * P * (4 * 8 + 4)      # ready/dur/selc/occ, seg
               + n_steps * 4 + B * 4          # order, n_pub
               + P * (1 + 8) + 2 * B * P * C * 8  # capped, wu, sclk0/sidle0
               + B * J * (2 * 4 + 4 * 8 + 1))  # the seven outputs
    f_ops = n_steps * P * (C + 12)  # slot argmin + wait/cold/pen/key
    f_bytes_ms = f_bytes / HBM_BYTES_PER_S * 1e3
    f_ops_ms = f_ops / PEAK_OPS_PER_S["float64"] * 1e3
    f_bound_ms = max(f_bytes_ms, f_ops_ms)
    print(f"fifo_dispatch [{B}, {P}, {J}, {C}] cold, n_pub=J: kernel "
          f"{fk_ms:.6f} ms ({fk_ms * 1e6 / J:.3f} ns per chain step), "
          f"plain on the card {fp_ms:.3f} ms, bound {f_bound_ms:.6f} ms "
          f"(bytes {f_bytes} -> {f_bytes_ms:.6f} ms, ops {f_ops} -> "
          f"{f_ops_ms:.6f} ms)")
    kernels.append({
        "name": "fifo_dispatch", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fifo_dispatch.cu",
        "replaces": "src/repro/kernels/dispatch.py:90",
        "max_abs_err": fifo_err, "ms": fk_ms, "plain_ms": fp_ms,
        "bound_ms": f_bound_ms,
        "bound_by": "bytes" if f_bytes_ms >= f_ops_ms else "operations",
        "library_ms": None})

    # -- 3. the uncapped main path ----------------------------------------
    def run_path(label, J, tasks, sweep_kw):
        """One sweep on the card, with the launch counts set to 0 just
        before it and read just after it."""
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out = sweep_scenarios(tasks, device="cuda", **sweep_kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        stats = vectorsim._LAST_RUN_STATS
        print(f"{label} J={J}: 30 scenarios on {stats['device']} in "
              f"{wall:.3f} s (prep {stats['prep_s']:.3f} s, engine "
              f"{stats['engine_s']:.3f} s, finalize "
              f"{stats['finalize_s']:.3f} s); body steps per stage "
              f"{stats['trips']}; launches {counts}")
        check_sweep(f"{label} J={J}", tasks, out, J)
        return out, wall, counts

    outs, walls, launches = {}, {}, {}
    for J in MAIN_J:
        tasks = fig4_workload(APPS, J)
        out, walls[J], counts = run_path("main path", J, tasks, {})
        if counts["acd_evict"] <= 0:
            raise AssertionError(f"main path J={J} never launched "
                                 f"acd_evict")
        launches[("main", J)] = counts
        outs[J] = (tasks, out)
    check_cpu_rerun(f"main path J={CPU_J}", fig4_workload(APPS, CPU_J), {})
    for J in MAIN_J:
        check_des(f"main path J={J}", *outs[J], DES_SCENARIOS, {})
    # where the J=512 sweep's time goes
    profile_sweep("main path J=512", outs[512][0], {}, walls[512])

    # -- 4. the congested main path: caps and cold starts --------------------
    cs = ColdStartModel(warm_up_s=LOAD_WARM_UP_S,
                        keep_alive_s=2.0 * LOAD_WARM_UP_S, scale_to_zero=True)
    pf = demo_portfolio(LOAD_PROVIDERS)
    load_kw = dict(portfolio=pf, concurrency=LOAD_CAP, coldstart=cs)
    louts, lwalls = {}, {}
    for J in MAIN_J:
        tasks = fig4_workload(APPS, J)
        out, lwalls[J], counts = run_path("congested path", J, tasks,
                                          load_kw)
        if counts["fifo_dispatch"] <= 0 or counts["acd_evict"] <= 0:
            raise AssertionError(f"congested path J={J}: a kernel never "
                                 f"launched: {counts}")
        launches[("load", J)] = counts
        if not (any(r.queue_wait.max() > 0 for r in out)
                and any(r.cold.any() for r in out)):
            raise AssertionError(f"congested path J={J}: caps or cold "
                                 f"starts never bound")
        louts[J] = (tasks, out)
    check_cpu_rerun(f"congested path J={CPU_J}",
                    fig4_workload(APPS, CPU_J), load_kw)
    for J in MAIN_J:
        check_des(f"congested path J={J}", *louts[J], LOAD_DES_SCENARIOS,
                  load_kw, load_fields=True)
    profile_sweep("congested path J=512", louts[512][0], load_kw,
                  lwalls[512])

    # -- 5. a pool trace with cold starts --------------------------------------
    def pool_kw_for(tasks):
        """The second replica of every stage turns on a quarter of the way
        to the tightest deadline."""
        t_on = 0.25 * min(min(t["c_max_grid"]) for t in tasks)
        return t_on, dict(portfolio=pf, coldstart=cs, pool_trace=PoolTrace(
            counts=(1, 2), breakpoints=(t_on,)))

    tasks = fig4_workload(APPS, 512)
    t_on, pool_kw = pool_kw_for(tasks)
    out, _, counts = run_path("pool path", 512, tasks, pool_kw)
    if counts["acd_evict"] <= 0:
        raise AssertionError("pool path never launched acd_evict")
    launches[("pool", 512)] = counts
    for task, res in zip(tasks, out):
        priv = ~res.public_mask
        if (res.replica[priv & (res.start < t_on)] > 0).any() or \
                not (res.replica[priv] == 1).any():
            raise AssertionError(f"pool path {task['name']}: the pool "
                                 f"trace did not bind")
    check_des("pool path J=512", tasks, out, LOAD_DES_SCENARIOS, pool_kw,
              load_fields=True)
    tasks = fig4_workload(APPS, CPU_J)
    check_cpu_rerun(f"pool path J={CPU_J}", tasks, pool_kw_for(tasks)[1])

    # -- 6. result ------------------------------------------------------------
    print(f"total {time.perf_counter() - t_start:.1f} s")
    # each kernel's launches on the main path of its slice: acd_evict on
    # the uncapped sweeps, fifo_dispatch on the congested ones
    kernels[0]["launches"] = sum(launches[("main", J)]["acd_evict"]
                                 for J in MAIN_J)
    kernels[1]["launches"] = sum(launches[("load", J)]["fifo_dispatch"]
                                 for J in MAIN_J)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
