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
6. The paper's profile -> predict -> schedule path. First ``matmul``
   against its plain version on the card (ragged shapes, transposed views,
   1024^3, bf16; the matrix app's integer ``x @ x.T`` at n = 344 and 496
   bit for bit, also against the CPU) and its time, bound and
   ``torch.matmul``'s time at [496]^3 and [4096]^3. Then the matrix app at
   full width traces 924 jobs on the card (MM through ``matmul``), splits
   them 774/150, fits the ridge models on the card, predicts the test
   jobs, schedules them SPT and HCF at 0.55x the all-private makespan
   (DES) and sweeps 2 orders x 5 deadlines on the card (``acd_evict``);
   video and image run the same loop at full width with 40/16 jobs.
   Per-stage card latency, model MAPE and lambdas are printed, and 100
   matrix jobs are traced once more under the profiler. The first
   jobs' stage outputs agree between card and CPU (MM, EF and RI bit for
   bit, LU with the same pivots), and the card's fits equal the CPU's
   (the same lambdas, predictions to a relative 1e-4).
7. The model stack's serving path. First the bf16 ``matmul`` kernel
   (tensor cores) at the serve shapes: against its plain version at
   M = 8, 656 and 8192 through the FFN's layer views and at M = 8 through
   both heads, each timed beside torch.matmul and its bound; its TMA and
   thread-staged paths bit for bit; and every row of ``linear(x [M, K],
   w)`` and of the norms' ``row_mean`` equal to the row computed alone,
   bit for bit, at M = 8, 656 and 8192 (what keeps the bf16
   prefill/decode split exact), beside torch.matmul's and torch.var's
   counts, and ``row_mean`` over 65,600 rows of 4096 (more row tiles than
   a second grid dimension may number). Then ``flash_attention`` and ``flash_decode`` at every
   attention shape of the phase and ragged ones (S = 1, sq < sk,
   sq > sk, windows, not causal, float32; decode lengths 0, 1, partial
   and full) against their plain versions, with times, bounds and
   ``scaled_dot_product_attention``'s time as the yardstick; ``rglru`` at
   recurrentgemma's [8, 2048, 4096] (from a nonzero h0, a continuation
   split at t = 1000, a ragged shape) and ``rwkv6`` at rwkv6-1.6b's
   [8, 32, 2048, 64] (bf16, and float32 from a nonzero s0, in the model's
   strided layout), and both at the serve phase's own shapes. Then
   ``launch/serve.py --execute-smoke``'s batch (8 requests, 16 new tokens)
   through ``InferenceEngine`` at the full ``rwkv6-1.6b``,
   ``recurrentgemma-9b`` and ``llama3-8b`` configs, plus each long batch
   (2 x 2304 tokens past recurrentgemma's window, 2 x 4096 tokens of
   llama3-8b), with walls, every kernel's launch count against its
   prediction, finite logits and profiler passes; the decode step timed
   with the port's activations and with torch's fused ones;
   prefill(S) + decode_step against prefill(S+1) at the full configs in
   bf16 and in float32, within the reference suite's tolerance;
   ``stablelm-12b`` and ``starcoder2-15b`` at full width and 2 layers (a
   prefill and 4 decode steps, each against prefill(S+1)); and card
   against CPU at full width, 2 and 3 layers, float32: the same greedy
   tokens.
8. Prints the kernels' JSON line, then the device line last.

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

#: published H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, the
#: non-tensor-core float rates the kernels' float64 and float32 work runs
#: at, and the dense bf16 tensor-core rate, the bound of bf16 products and
#: attention (any kernel computing the same function may use the tensor
#: cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float64": 34e12, "float32": 67e12, "bfloat16": 989e12}

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
#: the profiling path: every app at full width (scale 1.0); the matrix app
#: with the paper's trace counts (benchmarks/common.py FULL_COUNTS), video
#: and image with the benchmark's quick counts (QUICK_COUNTS)
PROFILE_COUNTS = {"matrix": (774, 150), "video": (40, 16),
                  "image": (40, 16)}
PROFILE_C_MAX_FRAC = 0.55  # the quickstart's deadline: 0.55x all-private
PRED_KEYS = ("P_private", "P_public", "upload", "download")
#: jobs of each app whose stage outputs are compared between card and CPU
CPU_JOBS = {"matrix": 8, "video": 4, "image": 4}
#: matmul against its plain version: |got - want| <= MM_RTOL * (|x| @ |y|)
#: elementwise, the float32 rounding of any summation order (bf16 outputs
#: may also differ by one bf16 ulp, 2^-7 of the value)
MM_RTOL = 1e-5
#: LU on the card against the CPU (both float32, the same pivots): packed
#: factors within LU_RTOL * max|LU|, the tolerance the CPU tests hold LU to
#: against the reference, and each factorization's backward error
#: max|P L U - A| / max|A| below LU_BACKWARD
LU_RTOL = 1e-4
LU_BACKWARD = 1e-5
#: perf models fitted on the card against the same fit on the CPU
PM_RTOL = 1e-4
#: the serving path: launch/serve.py --execute-smoke's batch (8 requests,
#: prompt lengths drawn from [8, 96) with numpy's seed, 16 new tokens,
#: cache_len 192), at each architecture's full config
SERVE_SEED = 0
SERVE_REQUESTS = 8
SERVE_PROMPT = (8, 96)
SERVE_NEW = 16
SERVE_CACHE = 192
#: each architecture's long batch (2 prompts, cache_len): recurrentgemma
#: past its 2048-token window, so prefill takes the rolled-cache path and
#: rglru runs 2304 steps; llama3-8b a 4096-token document with room for
#: the new tokens in its full-attention cache (long documents, RAG
#: contexts)
LONG_BATCH = 2
LONG = {"recurrentgemma-9b": (2304, 2048), "llama3-8b": (4096, 4112)}
#: the architectures served at full width and depth
SERVED = ("rwkv6-1.6b", "recurrentgemma-9b", "llama3-8b")
#: dense architectures run at full width and SHORT_LAYERS layers: one
#: prefill and SHORT_DECODE decode steps, each held against prefill(S+1)
SHORT = ("stablelm-12b", "starcoder2-15b")
SHORT_LAYERS = 2
SHORT_DECODE = 4
#: prefill(S) + decode_step == prefill(S+1): the reference suite's own
#: tolerance (tests/test_models.py:88-90), held at the full configs in
#: bf16 and in float32. Every weight product goes through the matmul
#: kernel, whose rows do not depend on how many come with them, so the two
#: paths round alike in bf16 too.
INCR_TOL = dict(rtol=2e-2, atol=2e-3)
#: card against CPU at full width and cut depth, float32 in IEEE float32:
#: depth (one super-block of recurrentgemma), decode steps, and the logits'
#: tolerance |card - cpu| <= CPU_RTOL * max|cpu| (float32 rounding of
#: d = 2048-4096 dot products in another order, through a few layers)
CPU_LAYERS = {"rwkv6-1.6b": 2, "recurrentgemma-9b": 3, "llama3-8b": 2}
#: the rows of linear(x [M, K], w) against linear(x[i:i+1], w), bf16, at
#: the dense projections' widths: the FFN's (4096 -> 14336, 14336 -> 4096),
#: at the serve phase's row counts (a decode step, the serve batch's
#: prefill, the long batch's; check_linear_rows)
ROWS_SHAPES = ((4096, 14336), (14336, 4096))
#: the heads at a decode step: (label, d, vocab, tied); a tied head is the
#: embedding's transpose [V, d].T, so y is K-major
HEADS = (("llama3-8b head", 4096, 128256, False),
         ("recurrentgemma-9b tied head", 4096, 256000, True))
#: a norm over a long prefill (rows, d): 65,600 tokens at d = 4096, whose
#: row mean's first level [4,198,400, 64] takes more row tiles than the
#: 65,535 a second grid dimension may number; its means within
#: ROW_MEAN_ATOL of the float64 ones
ROW_MEAN_LONG = (65600, 4096)
ROW_MEAN_ATOL = 1e-6
#: the attention kernels against their plain versions: |err| <=
#: ATTN_RTOL * max|v| (outputs are convex combinations of v's rows; float32
#: summation order), plus one bf16 ulp of the output for bf16 outputs
ATTN_RTOL = 1e-5
CPU_DECODE = 4
CPU_RTOL = 1e-4


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


def device_profile(label, fn):
    """``fn()`` once under ``torch.profiler``, device activity only (host-op
    events would triple the trace and its post-processing time without
    entering the busy share). Returns (device-busy s, profiled wall s,
    device events by descending self time), or None, saying so, when the
    profiler saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_p = time.perf_counter() - t0
    dev_events = sorted((e for e in prof.key_averages()
                         if e.device_type == torch.autograd.DeviceType.CUDA),
                        key=lambda e: -e.self_device_time_total)
    busy_s = sum(e.self_device_time_total for e in dev_events) * 1e-6
    if busy_s <= 0:
        print(f"profile {label}: torch.profiler saw no device time; device "
              f"busy share not measured")
        return None
    return busy_s, wall_p, dev_events


def print_top_events(dev_events, n=6):
    for e in dev_events[:n]:
        print(f"  {e.self_device_time_total * 1e-3:.3f} ms x{e.count} "
              f"{e.key[:90]}")


def profile_sweep(label, tasks, sweep_kw, wall):
    """The sweep once more under the profiler: device-busy share of the
    profiled wall and of the unprofiled wall ``wall``, kernel time by name,
    device events per body step."""
    from repro_torch.core import sweep_scenarios, vectorsim

    got = device_profile(label, lambda: sweep_scenarios(
        tasks, device="cuda", **sweep_kw))
    if got is None:
        return
    busy_s, wall_p, dev_events = got
    steps = sum(sum(t) for t in vectorsim._LAST_RUN_STATS["trips"])
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
    print_top_events(dev_events)


def cuda_ms(fn, n):
    """Milliseconds per call of ``fn`` on the card: one warm-up call, then
    ``n`` calls between two CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(n):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / n


def matmul_bound(M, K, N, dtype):
    """(bound ms, what bounds it, bytes, operations) of one [M, K] @ [K, N]
    in ``dtype`` ("float32" or "bfloat16"): each input read once and the
    output written once at the HBM rate, the 2MNK operations at the peak of
    the type (float32 without tensor cores, bf16 on the tensor cores)."""
    itemsize = 4 if dtype == "float32" else 2
    n_bytes = (M * K + K * N + M * N) * itemsize
    n_ops = 2 * M * N * K
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations", n_bytes, n_ops)


def matmul_check(label, x, y, got, want):
    """|got - want| <= MM_RTOL * (|x| @ |y|), plus 2^-7 |want| (the
    output's rounding) in bf16; prints, raises on a miss; returns the max
    abs error."""
    import torch

    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    bound = MM_RTOL * (x.float().abs() @ y.float().abs())
    if x.dtype == torch.bfloat16:
        bound = bound + 2.0 ** -7 * want.float().abs()
    worst = float((err / bound.clamp(min=1e-30)).max())
    print(f"matmul {label} {str(x.dtype)[6:]}: max_abs_err "
          f"{float(err.max())!r}, worst |err| / tolerance {worst:.4f}")
    if got.dtype != x.dtype or not bool((err <= bound).all()):
        raise AssertionError(f"matmul {label}: kernel != plain")
    return float(err.max())


def check_matmul(dev):
    """``matmul`` against its plain version on the card (ragged, transposed
    views, 1024^3, bf16; the app's integer x @ x.T bit for bit, also
    against the CPU), then its time, bound and ``torch.matmul``'s time at
    [496]^3 and [4096]^3. Returns its entry of the kernels line."""
    from repro_torch.core.precision import ieee_float32

    # the plain version and the library call in IEEE float32, as the
    # kernel computes; the process's own setting comes back after
    with ieee_float32():
        return _check_matmul(dev)


def _check_matmul(dev):
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import matmul_plain

    rng = np.random.default_rng(13)

    def normal(*shape, dtype=torch.float32):
        return torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).to(dev).to(dtype)

    max_err = 0.0  # over the float32 cases
    cases = [("(1, 1, 1)", normal(1, 1), normal(1, 1)),
             ("ragged (130, 257, 65)", normal(130, 257), normal(257, 65)),
             ("ragged (127, 129, 131)", normal(127, 129), normal(129, 131)),
             ("transposed views (200, 300, 150)", normal(300, 200).T,
              normal(150, 300).T),
             ("normal (1024, 1024, 1024)", normal(1024, 1024),
              normal(1024, 1024)),
             ("bf16 ragged (130, 257, 65)",
              normal(130, 257, dtype=torch.bfloat16),
              normal(257, 65, dtype=torch.bfloat16)),
             ("bf16 (512, 512, 512)", normal(512, 512, dtype=torch.bfloat16),
              normal(512, 512, dtype=torch.bfloat16))]
    for label, x, y in cases:
        err = matmul_check(label, x, y, ops.matmul(x, y), matmul_plain(x, y))
        if x.dtype == torch.float32:
            max_err = max(max_err, err)
    for n in (344, 496):
        xi = torch.from_numpy(rng.integers(0, 10, (n, n)).astype(
            np.float32)).to(dev)
        got = ops.matmul(xi, xi.T)
        want = matmul_plain(xi, xi.T)
        cpu = matmul_plain(xi.cpu(), xi.cpu().T)
        same_card, same_cpu = torch.equal(got, want), torch.equal(
            got.cpu(), cpu)
        print(f"matmul integer x @ x.T n={n}: bitwise equal to the plain "
              f"version on the card {same_card}, on the CPU {same_cpu}")
        if not (same_card and same_cpu):
            raise AssertionError(f"matmul x @ x.T n={n}: not bit for bit")

    rows = {}
    for n, reps in ((496, 200), (4096, 10)):
        x, y = normal(n, n), normal(n, n)
        k_ms = cuda_ms(lambda: ops.matmul(x, y), reps)
        p_ms = cuda_ms(lambda: matmul_plain(x, y), reps)
        l_ms = cuda_ms(lambda: torch.matmul(x, y), reps)
        bound, by, n_bytes, n_ops = matmul_bound(n, n, n, "float32")
        print(f"matmul [{n}, {n}, {n}] f32: kernel {k_ms:.6f} ms "
              f"({n_ops / k_ms * 1e-9:.3f} TFLOP/s), plain {p_ms:.6f} ms, "
              f"torch.matmul (TF32 off) {l_ms:.6f} ms, bound "
              f"{bound:.6f} ms by {by} (bytes {n_bytes}, operations "
              f"{n_ops}); kernel at {bound / k_ms:.3f} of the bound")
        rows[n] = (k_ms, p_ms, l_ms, bound, by)
    k_ms, p_ms, l_ms, bound, by = rows[496]
    return {"name": "matmul", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/matmul.cu",
            "replaces": "src/repro/kernels/matmul.py:36",
            "max_abs_err": max_err, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": l_ms}


def profile_app(name, device="cuda"):
    """The paper's loop for one app at full width on ``device``: trace its
    jobs, split them, fit the perf models, predict the test jobs, and
    schedule them SPT and HCF at 0.55x the all-private makespan through
    the DES. Prints per-stage card latency, model MAPE and lambdas."""
    import numpy as np

    from repro_torch.apps import SPECS, fit_models, generate_traces, \
        split_traces
    from repro_torch.core import (SkedulixScheduler, mape,
                                  simulate_all_private)

    spec = SPECS[name](scale=1.0, device=device)
    n_tr, n_te = PROFILE_COUNTS[name]
    t0 = time.perf_counter()
    traces = generate_traces(spec, n_tr + n_te, seed=0)
    t_trace = time.perf_counter() - t0
    tr, te = split_traces(traces, n_tr)
    t0 = time.perf_counter()
    pm = fit_models(spec, tr)
    t_fit = time.perf_counter() - t0
    pred_all = pm.predict(te["base_features"])
    for key in ("private", "public", "outsize"):
        if not np.isfinite(traces[key]).all():
            raise AssertionError(f"profile {name}: non-finite {key} traces")
    for key in PRED_KEYS + ("sizes",):
        if pred_all[key].shape != te["private"].shape or \
                not np.isfinite(pred_all[key]).all():
            raise AssertionError(f"profile {name}: bad {key} predictions")
    print(f"profile {name}: {n_tr + n_te} jobs traced on {spec.device} in "
          f"{t_trace:.3f} s, models fitted in {t_fit:.3f} s")
    card_s = (traces["private"] - traces["overhead"]) / spec.time_scale
    for k, stage in enumerate(spec.dag.stages):
        sm = pm.stages[k]
        print(f"  {stage.name}: median card latency "
              f"{np.median(card_s[:, k]) * 1e3:.6f} ms; test MAPE private "
              f"{mape(te['private'][:, k], pred_all['P_private'][:, k]):.2f}%"
              f", public "
              f"{mape(te['public'][:, k], pred_all['P_public'][:, k]):.2f}%"
              f", size {mape(te['outsize'][:, k], pred_all['sizes'][:, k]):.2f}"
              f"%; lambda private {sm.private.lam}, public {sm.public.lam}, "
              f"size {sm.outsize.lam}")
    pred = {k: pred_all[k] for k in PRED_KEYS}
    act = dict(P_private=te["private"], P_public=te["public"],
               upload=pred["upload"], download=pred["download"])
    sched = SkedulixScheduler(spec.dag, pm)
    priv = simulate_all_private(spec.dag, pred, act)
    c_max = PROFILE_C_MAX_FRAC * priv.makespan
    print(f"  all-private makespan {priv.makespan:.3f} s; C_max "
          f"{c_max:.3f} s")
    for order in ORDERS:
        r = sched.schedule(c_max, base_features=te["base_features"],
                           act=act, order=order).result
        if not (np.isfinite(r.makespan) and np.isfinite(r.cost_usd)):
            raise AssertionError(f"profile {name} {order}: non-finite")
        print(f"  {order.upper()}: makespan {r.makespan:.3f} s, met "
              f"{bool(r.met_deadline)}, cost {r.cost_usd:.6f} USD, "
              f"{int(r.n_offloaded_stages)} stage executions offloaded")
    return dict(spec=spec, traces=traces, tr=tr, te=te, pm=pm, act=act,
                sched=sched, priv=priv)


def profile_traces(spec, n_jobs):
    """``n_jobs`` of the app's jobs traced once more without and once
    under the profiler: device-busy share of the profiled and of the
    unprofiled wall, kernel time by name."""
    import torch

    from repro_torch.apps import generate_traces

    t0 = time.perf_counter()
    generate_traces(spec, n_jobs, seed=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    label = f"{spec.name} traces"
    got = device_profile(label, lambda: generate_traces(spec, n_jobs,
                                                        seed=0))
    if got is None:
        return
    busy_s, wall_p, dev_events = got
    print(f"profile {label}: {n_jobs} jobs, device busy {busy_s:.6f} s of "
          f"a {wall_p:.3f} s profiled wall ({busy_s / wall_p:.4f}); of the "
          f"unprofiled {wall:.3f} s wall {busy_s / wall:.4f} busy, "
          f"{1 - busy_s / wall:.4f} idle; "
          f"{sum(e.count for e in dev_events)} device events")
    print_top_events(dev_events)


def check_apps_against_cpu(name, spec, traces):
    """The first jobs' stage outputs on the card against the CPU (each CPU
    stage gets the card stage's own input), at the CPU tests' tolerances."""
    import numpy as np
    import torch

    from repro_torch.apps import SPECS

    cpu_spec = SPECS[name](scale=1.0, device="cpu")
    rng = np.random.default_rng(0)  # generate_traces' stream, seed 0
    M = spec.dag.num_stages
    worst = {}
    for j in range(CPU_JOBS[name]):
        job, feats = spec.make_job(rng)
        for _ in range(M):  # the trace's per-stage draws, in its order
            rng.uniform(*spec.overhead_range_s)
            rng.lognormal(0.0, spec.public_jitter)
            rng.lognormal(0.0, 0.02)
        if not np.array_equal(feats, traces["base_features"][j]):
            raise AssertionError(f"{name} job {j}: not the trace's job")
        outs = {}
        for k in spec.dag.topo_order():
            preds = spec.dag.predecessors(k)
            ins = [outs[p] for p in preds] if preds else [job]
            raw = spec.stage_fns[k](ins)
            cpu_raw = cpu_spec.stage_fns[k]([x.cpu() for x in ins])
            got = raw[0] if isinstance(raw, tuple) else raw
            want = cpu_raw[0] if isinstance(cpu_raw, tuple) else cpu_raw
            outs[k] = got
            stage = spec.dag.stages[k].name
            g, w = got.cpu(), want
            if g.shape != w.shape or g.dtype != w.dtype:
                raise AssertionError(f"{name} {stage}: shape or dtype")
            if name == "matrix" and stage == "LU":
                x = ins[0].to(torch.float32)
                _, piv_c = torch.linalg.lu_factor(x)
                _, piv_h = torch.linalg.lu_factor(x.cpu())
                if not torch.equal(piv_c.cpu(), piv_h):
                    raise AssertionError(f"matrix job {j}: LU pivots differ"
                                         f" between card and CPU")
                d = float((g - w).abs().max() / w.abs().max())
                back = []
                for lu, piv in ((g, piv_c.cpu()), (w, piv_h)):
                    P_, L_, U_ = torch.lu_unpack(lu.double(), piv)
                    a = x.cpu().double()
                    back.append(float((P_ @ L_ @ U_ - a).abs().max()
                                      / a.abs().max()))
                ok = d <= LU_RTOL and max(back) <= LU_BACKWARD
                worst["LU rel"] = max(worst.get("LU rel", 0.0), d)
                worst["LU backward"] = max(worst.get("LU backward", 0.0),
                                           *back)
            elif (name == "matrix" or stage in ("EF", "RI")):
                ok = torch.equal(g, w)
            elif name == "video":
                err = (g - w).abs()
                ok = bool((err <= 1e-5 * w.abs() + 1e-7).all())
                worst[stage] = max(worst.get(stage, 0.0), float(err.max()))
            else:
                d = (g.long() - w.long()).abs()
                frac = float((d > 0).float().mean())
                ok = int(d.max()) <= 1 and frac <= 1e-3
                worst[stage] = max(worst.get(stage, 0.0), frac)
            if not ok:
                raise AssertionError(f"{name} job {j} stage {stage}: card "
                                     f"!= CPU beyond the tolerance")
    print(f"profile {name}: the first {CPU_JOBS[name]} jobs' stage outputs "
          f"agree between card and CPU (worst: "
          + ", ".join(f"{k} {v!r}" for k, v in worst.items()) + ")")


def check_tf32_took_effect(dev):
    """With TF32 turned on for the process: a float32 product outside the
    port's IEEE scope must differ from the one inside it (so the setting
    took effect), and a second product inside must equal the first."""
    import torch

    from repro_torch.core.precision import ieee_float32

    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(1024, 1024, device=dev, generator=g)
    with ieee_float32():
        ieee = x @ x
    tf32 = x @ x
    with ieee_float32():
        again = x @ x
    rel = float((tf32 - ieee).abs().max() / ieee.abs().max())
    print(f"TF32 on for the process: a product outside the port's scope "
          f"differs from the IEEE one by {rel!r} of its max; inside the "
          f"scope bit for bit {torch.equal(again, ieee)}")
    if rel == 0.0 or not torch.equal(again, ieee):
        raise AssertionError("TF32 setting or its scope did not take effect")


def check_fit_against_cpu(name, spec, tr, te, pm):
    """The perf models fitted on the card, and refitted on the card under
    the process's current setting, against the same fit on the CPU: the
    same lambda for every model, predictions within PM_RTOL."""
    import numpy as np

    from repro_torch.apps import fit_models

    cpu = fit_models(spec, tr, device="cpu")
    want = cpu.predict(te["base_features"])
    for label, fit in (("card fit", pm), ("card refit", fit_models(spec, tr))):
        for k, (a, b) in enumerate(zip(fit.stages, cpu.stages)):
            for part in ("private", "public", "outsize"):
                la, lb = getattr(a, part).lam, getattr(b, part).lam
                if la != lb:
                    raise AssertionError(
                        f"{name} {label} stage {k} {part}: lambda {la} on "
                        f"the card, {lb} on the CPU")
        got = fit.predict(te["base_features"])
        rel = max(float(np.max(np.abs(got[k] - want[k])
                               / np.maximum(np.abs(want[k]), 1e-30)))
                  for k in want)
        print(f"profile {name}: {label} equals the CPU fit in every lambda;"
              f" predictions max relative difference {rel!r}")
        if rel > PM_RTOL:
            raise AssertionError(f"{name}: {label} predictions != CPU's")


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


def rglru_bound(B, T, D, with_h0):
    """(bound ms, what bounds it, bytes, operations) of one ``rglru``: x and
    a read and y written once (float32), h0 read and h_T written; seven
    float operations per element (a*a, 1-, max, sqrt, *x, a*h, +)."""
    n = B * T * D
    n_bytes = 3 * n * 4 + (2 if with_h0 else 1) * B * D * 4
    n_ops = 7 * n
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / PEAK_OPS_PER_S["float32"] * 1e3
    return (max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations", n_bytes, n_ops)


def rwkv6_bound(B, H, T, Dk, Dv, itemsize, with_s0):
    """(bound ms, what bounds it, bytes, operations) of one ``rwkv6``: r, k,
    v read and o written in their type, w (float32) read, u read, s0 read
    and S_T written (float32); the operations the function needs per
    (b, h, t): 2 Dk Dv for r^T S, 3 Dk Dv for w * S + k^T v, and 3 Dk + 2 Dv
    for the bonus (sum_k r u k) * v and its add (the kernel itself does
    7 Dk Dv: see csrc/rwkv6.cu)."""
    n_bytes = (B * H * T * (2 * Dk + 2 * Dv) * itemsize
               + B * H * T * Dk * 4 + H * Dk * 4
               + (2 if with_s0 else 1) * B * H * Dk * Dv * 4)
    n_ops = B * H * T * (5 * Dk * Dv + 3 * Dk + 2 * Dv)
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / PEAK_OPS_PER_S["float32"] * 1e3
    return (max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations", n_bytes, n_ops)


def longest_prompt(arch):
    """The longest prompt of the serve batch at ``arch``'s config: the
    recurrences' T at its prefill."""
    from repro_torch.configs import get_config

    return max(r.prompt_len for r in serve_requests(
        get_config(arch), SERVE_REQUESTS, SERVE_PROMPT, SERVE_NEW,
        SERVE_SEED))


def check_rglru(dev):
    """``rglru`` against its plain version on the card, bit for bit: at
    recurrentgemma's width [8, 2048, 4096] from a nonzero h0, a
    continuation split at t = 1000, a ragged shape, and the shapes the
    serve phase gives it (each batch's prefill from zeros and a decode step
    from a nonzero h); then its time, the plain version's and the bound.
    Returns its entry of the kernels line."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import rglru_plain

    g = torch.Generator(device=dev).manual_seed(21)

    def inputs(B, T, D):
        x = torch.randn(B, T, D, device=dev, generator=g)
        a = torch.rand(B, T, D, device=dev, generator=g) * 0.98 + 0.01
        return x, a, torch.randn(B, D, device=dev, generator=g)

    x, a, h0 = inputs(8, 2048, 4096)
    y, hT = ops.rglru(x, a, h0)
    yp, hp = rglru_plain(x, a, h0)
    c = 1000
    y1, h1 = ops.rglru(x[:, :c].contiguous(), a[:, :c].contiguous(), h0)
    y2, h2 = ops.rglru(x[:, c:].contiguous(), a[:, c:].contiguous(), h1)
    xr, ar, _ = inputs(3, 37, 300)
    yr, hr = ops.rglru(xr, ar)
    yrp, hrp = rglru_plain(xr, ar)
    torch.cuda.synchronize()
    err = max(float((y - yp).abs().max()), float((hT - hp).abs().max()),
              float((yr - yrp).abs().max()))
    ulps = int((y.view(torch.int32).long()
                - yp.view(torch.int32).long()).abs().max())
    same = (torch.equal(y, yp) and torch.equal(hT, hp)
            and torch.equal(yr, yrp) and torch.equal(hr, hrp))
    split = torch.equal(torch.cat([y1, y2], 1), y) and torch.equal(h2, hT)
    print(f"rglru [8, 2048, 4096] f32 from h0 and ragged [3, 37, 300]: "
          f"bitwise equal to the plain version {same} (max_abs_err {err!r},"
          f" largest ulp gap {ulps}); split at t={c} equals the whole scan "
          f"{split}")
    if not (same and split):
        raise AssertionError("rglru: kernel != plain version")
    S = longest_prompt("recurrentgemma-9b")
    for B, T, with_h0 in ((SERVE_REQUESTS, S, False),
                          (SERVE_REQUESTS, 1, True),
                          (LONG_BATCH, LONG["recurrentgemma-9b"][0], False),
                          (LONG_BATCH, 1, True)):
        xs, as_, hs = inputs(B, T, 4096)
        args = (xs, as_, hs if with_h0 else None)
        ys, hTs = ops.rglru(*args)
        ysp, hsp = rglru_plain(*args)
        torch.cuda.synchronize()
        ok = torch.equal(ys, ysp) and torch.equal(hTs, hsp)
        e = max(float((ys - ysp).abs().max()), float((hTs - hsp).abs().max()))
        err = max(err, e)
        print(f"rglru serve shape [{B}, {T}, 4096] f32 from "
              f"{'a nonzero h0' if with_h0 else 'zeros'}: bitwise equal to "
              f"the plain version {ok} (max_abs_err {e!r})")
        if not ok:
            raise AssertionError(f"rglru [{B}, {T}, 4096]: kernel != plain "
                                 f"version")
    B, T, D = x.shape
    k_ms = cuda_ms(lambda: ops.rglru(x, a, h0), 20)
    p_ms = cuda_ms(lambda: rglru_plain(x, a, h0), 1)
    bound, by, n_bytes, n_ops = rglru_bound(B, T, D, True)
    print(f"rglru [{B}, {T}, {D}] f32: kernel {k_ms:.6f} ms "
          f"({n_bytes / k_ms * 1e-9:.3f} TB/s), plain {p_ms:.3f} ms, bound "
          f"{bound:.6f} ms by {by} (bytes {n_bytes}, operations {n_ops}); "
          f"kernel at {bound / k_ms:.3f} of the bound")
    return {"name": "rglru", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/rglru.cu",
            "replaces": "src/repro/kernels/rglru.py:51",
            "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": None}


def check_rwkv6(dev):
    """``rwkv6`` against its plain version on the card, in the model's
    layout (head-split views): at rwkv6-1.6b's [8, 32, 2048, 64] in bf16
    and in float32 from a nonzero s0, and at the shapes the serve phase
    gives it in bf16 (its prefill, T = the longest prompt, from zeros and
    from a nonzero s0, and a decode step, T = 1, from a nonzero s0). S_T
    bit for bit; o within the float32 rounding of two summation orders
    over k, 2 (Dk - 1) 2^-24 sum_k |terms|, plus one bf16 ulp of the value
    in bf16. Then its time, the plain version's and the bound. Returns its
    entry of the kernels line."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import rwkv6_plain

    g = torch.Generator(device=dev).manual_seed(22)
    H, Dk = 32, 64

    def inputs(B, T, dt, with_s0):
        # the model's [B, T, H, D] projections viewed as [B, H, T, D]
        r, k, v = (torch.randn(B, T, H, Dk, device=dev, generator=g)
                   .mul(0.3).to(dt).transpose(1, 2) for _ in range(3))
        w = torch.exp(-torch.exp(torch.randn(B, T, H, Dk, device=dev,
                                             generator=g) - 4.0))
        u = torch.randn(H, Dk, device=dev, generator=g) * 0.1
        s0 = (torch.randn(B, H, Dk, Dk, device=dev, generator=g)
              if with_s0 else None)
        return r, k, v, w.transpose(1, 2), u, s0

    def against_plain(label, args):
        o, sT = ops.rwkv6(*args)
        op, sp, sums = rwkv6_plain(*args, term_sums=True)
        torch.cuda.synchronize()
        err = (o.float() - op.float()).abs()
        bound = 2 * (Dk - 1) * 2.0 ** -24 * sums
        if o.dtype == torch.bfloat16:
            _, e = torch.frexp(torch.maximum(o.float().abs(),
                                             op.float().abs()))
            bound = bound + torch.ldexp(torch.ones_like(bound), e - 8)
        ok_o = bool((err <= bound).all())
        ok_s = torch.equal(sT, sp)
        print(f"rwkv6 {list(args[0].shape)} {label}: o max_abs_err "
              f"{float(err.max())!r} (at most {float((err / bound).max()):.3f}"
              f" of its bound), S_T bitwise equal to the plain version "
              f"{ok_s}; o strides {o.stride()}")
        if not (ok_o and ok_s):
            raise AssertionError(f"rwkv6 {label}: kernel != plain version")
        return float(err.max())

    B, T = 8, 2048
    timed = inputs(B, T, torch.bfloat16, False)
    max_err = max(against_plain("bf16", timed),
                  against_plain("f32 from s0",
                                inputs(B, T, torch.float32, True)))
    S = longest_prompt("rwkv6-1.6b")
    for label, T_serve, with_s0 in (("serve prefill bf16", S, False),
                                    ("serve prefill bf16 from s0", S, True),
                                    ("serve decode bf16 from s0", 1, True)):
        max_err = max(max_err, against_plain(
            label, inputs(SERVE_REQUESTS, T_serve, torch.bfloat16, with_s0)))
    k_ms = cuda_ms(lambda: ops.rwkv6(*timed), 10)
    p_ms = cuda_ms(lambda: rwkv6_plain(*timed), 1)
    bound, by, n_bytes, n_ops = rwkv6_bound(B, H, T, Dk, Dk, 2, False)
    print(f"rwkv6 [{B}, {H}, {T}, {Dk}] bf16: kernel {k_ms:.6f} ms "
          f"({n_ops / k_ms * 1e-9:.3f} TFLOP/s of the function's "
          f"operations), plain {p_ms:.3f} ms, bound {bound:.6f} ms by {by} "
          f"(bytes {n_bytes}, operations {n_ops}; built without fused "
          f"multiply-adds, the kernel can reach at most half the float32 "
          f"peak, {2 * bound:.6f} ms); kernel at {bound / k_ms:.3f} of the "
          f"bound")
    return {"name": "rwkv6", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/rwkv6.cu",
            "replaces": "src/repro/kernels/rwkv6.py:56",
            "max_abs_err": max_err, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": None}


def live_pairs(sq, sk, causal, window):
    """Live (query, key) pairs of one (b, h) of a prefill: query i at
    position sk - sq + i, key j live iff j <= qpos (causal) and j > qpos -
    window."""
    n = 0
    for i in range(sq):
        qpos = sk - sq + i
        hi = min(sk - 1, qpos) if causal else sk - 1
        lo = max(0, qpos - window + 1) if window else 0
        n += max(0, hi - lo + 1)
    return n


def attention_bound(q_elems, kv_elems, itemsize, n_ops, dtype):
    """(bound ms, what bounds it, bytes, operations) of one attention call:
    q read and out written (``q_elems`` each), the live K and V rows read
    (``kv_elems`` each), in their type; ``n_ops`` (4 D per live pair and
    query head) at the bf16 tensor-core peak for bf16 inputs, the float32
    peak for float32 ones."""
    n_bytes = (2 * q_elems + 2 * kv_elems) * itemsize
    peak = PEAK_OPS_PER_S["bfloat16" if dtype == "bfloat16" else "float32"]
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / peak * 1e3
    return (max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations", n_bytes, n_ops)


def attn_check(label, got, want, v):
    """|got - want| <= ATTN_RTOL * max|v| (+ one bf16 ulp of the output in
    bf16); prints and raises on a miss; returns the max abs error."""
    import torch

    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    bound = ATTN_RTOL * float(v.float().abs().max()) + torch.zeros_like(err)
    if got.dtype == torch.bfloat16:
        _, e = torch.frexp(torch.maximum(got.float().abs(),
                                         want.float().abs()))
        bound = bound + torch.ldexp(torch.ones_like(bound), e - 8)
    ok = (got.dtype == want.dtype and got.shape == want.shape
          and bool((err <= bound).all()) and bool(torch.isfinite(got).all()))
    e_max = float(err.max()) if err.numel() else 0.0
    worst = float((err / bound).max()) if err.numel() else 0.0
    print(f"{label}: max_abs_err {e_max!r}, worst |err| / tolerance "
          f"{worst:.4f}")
    if not ok:
        raise AssertionError(f"{label}: kernel != plain version")
    return e_max


def head_split(B, S, H, D, dt, dev, g):
    """A [B, H, S, D] view of a [B, S, H, D] tensor (the model's layout)."""
    import torch

    return torch.randn(B, S, H, D, device=dev, generator=g).to(
        dt).transpose(1, 2)


def attention_shapes():
    """The serve phase's attention shapes: (arch, B, Hq, Hkv, D, window,
    serve prompt, serve cache, long prompt or None, long cache)."""
    from repro_torch.configs import get_config

    out = []
    for arch in ("recurrentgemma-9b", "llama3-8b") + SHORT:
        cfg = get_config(arch)
        long_p, long_c = LONG.get(arch, (None, None))
        out.append((arch, cfg.num_heads, cfg.num_kv_heads, cfg.hd,
                    cfg.window, longest_prompt(arch), long_p, long_c))
    return out


def check_flash_attention(dev):
    """``flash_attention`` against its plain version on the card: at every
    prefill shape of the serve phase (both batches of recurrentgemma-9b and
    llama3-8b, the short runs of stablelm-12b and starcoder2-15b) in bf16,
    and ragged cases (S = 1, sq < sk, sq > sk, windows, not causal,
    float32, head dims 8-256); then its time, the plain version's,
    ``scaled_dot_product_attention``'s (the yardstick, never the port's)
    and the bound at llama3-8b's long prefill. Returns its entry of the
    kernels line."""
    import torch
    import torch.nn.functional as F

    from repro_torch.core.precision import ieee_float32
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import flash_attention_plain

    g = torch.Generator(device=dev).manual_seed(23)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = []
    for arch, hq, hkv, d, window, s_serve, s_long, _ in attention_shapes():
        cases.append((f"{arch} serve prefill", SERVE_REQUESTS, hq, hkv,
                      s_serve, s_serve, d, True, window, bf16))
        if s_long:
            cases.append((f"{arch} long prefill", LONG_BATCH, hq, hkv,
                          s_long, s_long, d, True, window, bf16))
    cases += [("ragged S=1", 3, 4, 2, 1, 1, 64, True, None, f32),
              ("ragged sq < sk", 2, 8, 2, 37, 300, 128, True, None, f32),
              ("ragged sq < sk window", 2, 16, 1, 70, 333, 256, True, 50,
               bf16),
              ("ragged sq > sk (rows without keys)", 2, 4, 4, 90, 40, 32,
               True, None, f32),
              ("not causal, window", 2, 6, 3, 65, 129, 16, False, 17, f32),
              ("not causal", 1, 2, 1, 200, 77, 8, False, None, bf16),
              ("f32 causal D=256", 2, 16, 1, 130, 130, 256, True, 64, f32),
              ("f32 causal D=160", 2, 8, 2, 97, 97, 160, True, None, f32)]
    max_err = 0.0
    with ieee_float32():
        for label, B, hq, hkv, sq, sk, d, causal, window, dt in cases:
            q = head_split(B, sq, hq, d, dt, dev, g)
            k, v = (head_split(B, sk, hkv, d, dt, dev, g) for _ in range(2))
            got = ops.flash_attention(q, k, v, causal=causal, window=window)
            want = flash_attention_plain(q, k, v, causal=causal,
                                         window=window)
            max_err = max(max_err, attn_check(
                f"flash_attention {label} [{B}, {hq}/{hkv}, {sq}x{sk}, {d}] "
                f"{str(dt)[6:]} causal={causal} window={window}", got, want,
                v))
            del q, k, v, got, want

        rows = {}
        for arch, hq, hkv, d, window, s_serve, s_long, _ in \
                attention_shapes()[:2]:
            for B, S in ((SERVE_REQUESTS, s_serve), (LONG_BATCH, s_long)):
                q = head_split(B, S, hq, d, bf16, dev, g)
                k, v = (head_split(B, S, hkv, d, bf16, dev, g)
                        for _ in range(2))
                n = 20 if S < 1000 else 3
                k_ms = cuda_ms(lambda: ops.flash_attention(
                    q, k, v, causal=True, window=window), n)
                p_ms = cuda_ms(lambda: flash_attention_plain(
                    q, k, v, causal=True, window=window), 1)
                if window is None:
                    def lib():
                        return F.scaled_dot_product_attention(
                            q, k, v, is_causal=True, enable_gqa=True)
                else:
                    pos = torch.arange(S, device=dev)
                    mask = ((pos[None, :] <= pos[:, None])
                            & (pos[None, :] > pos[:, None] - window))

                    def lib():
                        return F.scaled_dot_product_attention(
                            q, k, v, attn_mask=mask, enable_gqa=True)
                l_ms = cuda_ms(lib, n)
                pairs = live_pairs(S, S, True, window)
                bound, by, n_bytes, n_ops = attention_bound(
                    B * hq * S * d, B * hkv * S * d, 2,
                    4 * B * hq * d * pairs, "bfloat16")
                print(f"flash_attention {arch} [{B}, {hq}/{hkv}, {S}, {d}] "
                      f"bf16 window={window}: kernel {k_ms:.6f} ms "
                      f"({n_ops / k_ms * 1e-9:.3f} TFLOP/s), plain "
                      f"{p_ms:.3f} ms, scaled_dot_product_attention "
                      f"{l_ms:.6f} ms, bound {bound:.6f} ms by {by} (bytes "
                      f"{n_bytes}, operations {n_ops}, {pairs} live pairs "
                      f"per head); kernel at {bound / k_ms:.4f} of the "
                      f"bound, {k_ms / l_ms:.2f}x the library call")
                rows[arch, S] = (k_ms, p_ms, l_ms, bound, by)
                del q, k, v
    k_ms, p_ms, l_ms, bound, by = rows["llama3-8b", LONG["llama3-8b"][0]]
    torch.cuda.empty_cache()
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:87",
            "max_abs_err": max_err, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": l_ms}


def check_flash_decode(dev):
    """``flash_decode`` against its plain version on the card: at every
    decode shape of the serve phase in bf16 (the query heads' strided view,
    the caches of the serve and the long batches), with lengths 0, 1,
    partial and full, and float32 and other head dims; then its time, the
    plain version's, ``scaled_dot_product_attention``'s with a boolean
    mask of the live slots, and the bound, called as the model calls it
    (with ``end``), at the serve and long batches of recurrentgemma-9b and
    llama3-8b; the kernels line takes llama3-8b's long batch (length 4097
    of 4112 slots). Returns its entry of the kernels line."""
    import torch
    import torch.nn.functional as F

    from repro_torch.core.precision import ieee_float32
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import flash_decode_plain

    g = torch.Generator(device=dev).manual_seed(24)
    bf16, f32 = torch.bfloat16, torch.float32
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count

    def inputs(B, hq, hkv, S, d, dt):
        q = head_split(B, 1, hq, d, dt, dev, g)[:, :, 0]      # [B, Hq, D]
        k, v = (torch.randn(B, hkv, S, d, device=dev, generator=g).to(dt)
                for _ in range(2))
        return q, k, v

    def lengths(B, S, full):
        """0, 1, partial and full lengths over the rows (all ``full`` when
        the model's own mask is wanted)."""
        if full is not None:
            return torch.full((B,), full, dtype=torch.int32, device=dev)
        pick = [0, 1, S // 2 + 3, S, S - 1, 65, 64, 63]
        return torch.tensor([pick[i % len(pick)] for i in range(B)],
                            dtype=torch.int32, device=dev)

    # (label, B, Hq, Hkv, S, D, dtype, length of every row (None: mixed),
    # end of every row (None: the first length slots; else the last length
    # positions before end, position P at slot P % S, as the model reads
    # its caches))
    cases = []
    for arch, hq, hkv, d, window, s_serve, s_long, c_long in \
            attention_shapes():
        eff = min(SERVE_CACHE, window) if window else SERVE_CACHE
        cases.append((f"{arch} serve decode", SERVE_REQUESTS, hq, hkv, eff,
                      d, bf16, s_serve + 1, s_serve + 1))
        cases.append((f"{arch} serve decode, mixed lengths", SERVE_REQUESTS,
                      hq, hkv, eff, d, bf16, None, None))
        if s_long:
            eff = min(c_long, window) if window else c_long
            cases.append((f"{arch} long decode", LONG_BATCH, hq, hkv, eff,
                          d, bf16, min(s_long + 1, eff), s_long + 1))
    cases += [("f32 mixed lengths", 8, 8, 2, 300, 128, f32, None, None),
              ("f32 D=16 G=16", 8, 16, 1, 70, 16, f32, None, None),
              ("bf16 D=160 mixed lengths", 8, 32, 8, 130, 160, bf16, None,
               None),
              ("f32 rolled cache", 8, 8, 2, 100, 64, f32, 100, 1037),
              ("f32 one slot", 3, 4, 4, 1, 64, f32, None, None)]
    max_err = 0.0
    with ieee_float32():
        for label, B, hq, hkv, S, d, dt, full, last in cases:
            q, k, v = inputs(B, hq, hkv, S, d, dt)
            length = lengths(B, S, full)
            end = (None if last is None else torch.full(
                (B,), last, dtype=torch.int32, device=dev))
            got = ops.flash_decode(q, k, v, length, end)
            want = flash_decode_plain(q, k, v, length, end)
            zero = length == 0
            if bool(zero.any()) and bool(got[zero].abs().max() != 0):
                raise AssertionError(f"flash_decode {label}: length 0 did "
                                     f"not give zeros")
            max_err = max(max_err, attn_check(
                f"flash_decode {label} [{B}, {hq}/{hkv}, {S}, {d}] "
                f"{str(dt)[6:]} lengths {length.tolist()} end {last}", got,
                want, v))

        rows = {}
        for arch, hq, hkv, d, window, s_serve, s_long, c_long in \
                attention_shapes()[:2]:
            # the call as the model makes it: length = eff_pos + 1 and end
            # = pos + 1 (recurrentgemma's long batch reads a rolled cache)
            for B, S, last in (
                    (SERVE_REQUESTS, min(SERVE_CACHE, window or SERVE_CACHE),
                     s_serve + 1),
                    (LONG_BATCH, min(c_long, window or c_long), s_long + 1)):
                n_live = min(last, S)
                q, k, v = inputs(B, hq, hkv, S, d, bf16)
                length = lengths(B, S, n_live)
                end = lengths(B, S, last)
                k_ms = cuda_ms(lambda: ops.flash_decode(q, k, v, length, end),
                               50)
                p_ms = cuda_ms(lambda: flash_decode_plain(q, k, v, length,
                                                          end), 5)
                # slot s holds a live position iff it is among the n_live
                # slots before end's, counted around the ring
                mask = ((torch.arange(S, device=dev)[None, :]
                         - (end - length)[:, None]) % S
                        < length[:, None])[:, None, None, :]
                q4 = q[:, :, None]
                l_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                    q4, k, v, attn_mask=mask, enable_gqa=True), 50)
                bound, by, n_bytes, n_ops = attention_bound(
                    B * hq * d, B * hkv * n_live * d, 2,
                    4 * B * hq * d * n_live, "bfloat16")
                print(f"flash_decode {arch} q [{B}, {hq}, {d}], cache [{B}, "
                      f"{hkv}, {S}, {d}] bf16, length {n_live}, end {last}: "
                      f"kernel "
                      f"{k_ms:.6f} ms ({n_bytes / k_ms * 1e-9:.3f} TB/s), "
                      f"{B * hkv} blocks on {n_sm} "
                      f"SMs, plain {p_ms:.6f} ms, "
                      f"scaled_dot_product_attention {l_ms:.6f} ms, bound "
                      f"{bound:.6f} ms by {by} (bytes {n_bytes}, operations "
                      f"{n_ops}); kernel at {bound / k_ms:.4f} of the bound, "
                      f"{k_ms / l_ms:.2f}x the library call")
                rows[arch, B] = (k_ms, p_ms, l_ms, bound, by)
    k_ms, p_ms, l_ms, bound, by = rows["llama3-8b", LONG_BATCH]
    return {"name": "flash_decode", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
            "replaces": "src/repro/kernels/flash_decode.py:70",
            "max_abs_err": max_err, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": l_ms}


def check_linear_rows(dev):
    """The bf16 matmul kernel (tensor cores) on the serving path, and the
    repair of the bf16 prefill/decode gap. Against its plain version
    (check_matmul's bf16 bound) at the weight products the serve phase
    gives it, each timed beside its plain version, torch.matmul and its
    bound: M = 8 (a decode step), the serve batch's prefill rows and the
    long batch's 2 x 4096, through the FFN's [4096, 14336] and
    [14336, 4096] read as layer views of a stacked [2, K, N] parameter,
    and the heads at M = 8: llama3-8b's [4096, 128256] and
    recurrentgemma-9b's tied [256000, 4096].T (y K-major). Then the TMA and
    thread-staged paths bit for bit at the serve batch's prefill through a
    layer view and at a decode step through the tied head; and every row
    of ``linear(x [M, K], w)`` equals ``linear(x[i:i+1], w)`` bit for bit at
    the FFN's widths for M = 8, the prefill rows and 8192 (and the same
    count for torch.matmul), and so does every row of the norms' row mean
    (``layers.row_mean``, float32; the same count for torch.var), also on
    a sample of ``ROW_MEAN_LONG``'s rows. Returns the bf16 timings for
    matmul's entry of the kernels line."""
    import importlib

    import torch

    from repro_torch.core.precision import ieee_float32
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import matmul_plain
    from repro_torch.models.layers import linear, row_mean

    mm = importlib.import_module("repro_torch.kernels.matmul")
    g = torch.Generator(device=dev).manual_seed(25)
    bf16 = torch.bfloat16
    rows = (SERVE_REQUESTS, SERVE_REQUESTS * longest_prompt("llama3-8b"),
            LONG_BATCH * LONG["llama3-8b"][0])

    def normal(*shape, scale=1.0):
        return (torch.randn(*shape, device=dev, generator=g) * scale).to(bf16)

    def timed(label, phase, x, w, reps):
        err = matmul_check(label, x, w, ops.matmul(x, w), matmul_plain(x, w))
        M, K = x.shape
        N = w.shape[1]
        k_ms = cuda_ms(lambda: ops.matmul(x, w), reps)
        p_ms = cuda_ms(lambda: matmul_plain(x, w), reps)
        l_ms = cuda_ms(lambda: torch.matmul(x, w), reps)
        bound, by, n_bytes, n_ops = matmul_bound(M, K, N, "bfloat16")
        plan = mm.tile_plan(M, N, K, w.stride())
        print(f"matmul {label} bf16: kernel {k_ms:.6f} ms, plain {p_ms:.6f} "
              f"ms, torch.matmul {l_ms:.6f} ms, bound {bound:.6f} ms by {by} "
              f"(bytes {n_bytes}, operations {n_ops}); kernel at "
              f"{bound / k_ms:.3f} of the bound, {k_ms / l_ms:.2f}x "
              f"torch.matmul's time; plan {tuple(plan)}")
        return {"phase": phase, "shape": [M, K, N],
                "y_strides": list(w.stride()), "max_abs_err": err,
                "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound,
                "bound_by": by, "library_ms": l_ms}

    timings = []
    with ieee_float32():
        for K, N in ROWS_SHAPES:
            w = normal(2, K, N, scale=K ** -0.5)[1]  # a layer's view
            for m, phase, reps in zip(rows, ("decode", "prefill",
                                             "long prefill"), (50, 20, 5)):
                x = normal(m, K)
                timings.append(timed(f"serve [{m}, {K}] @ layer view [{K}, "
                                     f"{N}]", phase, x, w, reps))
            del w, x
        for label, d, V, tied in HEADS:
            w = normal(V, d).T if tied else normal(d, V, scale=d ** -0.5)
            x = normal(SERVE_REQUESTS, d)
            timings.append(timed(f"{label} [{SERVE_REQUESTS}, {d}] @ "
                                 f"{list(w.shape)} strides {w.stride()}",
                                 "decode head", x, w, 20))
        # the two staging paths: the same bytes in shared memory
        K, N = ROWS_SHAPES[0]
        for label, x, y in (
                ("prefill layer view", normal(rows[1], K),
                 normal(2, K, N, scale=K ** -0.5)[1]),
                ("decode tied head", x, w)):
            tma = ops.matmul(x, y)
            threads = torch.empty_like(tma)
            mm.launch(x, y, threads, _by_threads=True)
            torch.cuda.synchronize()
            same = torch.equal(tma, threads)
            print(f"matmul staging paths, {label} {list(x.shape)} @ "
                  f"{list(y.shape)} strides {y.stride()}: TMA and "
                  f"thread-staged bitwise equal {same}")
            if not same:
                raise AssertionError(f"matmul {label}: TMA != thread-staged")
        del w, x, y, tma, threads
        torch.cuda.empty_cache()

    for K, N in ROWS_SHAPES:
        w = normal(K, N, scale=K ** -0.5)
        for m in rows:
            x = normal(m, K)
            full, lib = linear(x, w), x @ w
            same = sum(torch.equal(linear(x[i:i + 1], w)[0], full[i])
                       for i in range(m))
            same_lib = sum(torch.equal((x[i:i + 1] @ w)[0], lib[i])
                           for i in range(m))
            print(f"linear rows [{m}, {K}] @ [{K}, {N}] bf16: {same} of {m} "
                  f"rows bitwise equal to the row alone (matmul kernel, "
                  f"plan {tuple(mm.tile_plan(m, N, K, w.stride()))}); "
                  f"torch.matmul {same_lib} of {m}")
            if same != m:
                raise AssertionError(f"linear [{m}, {K}] @ [{K}, {N}]: rows "
                                     f"depend on the row count")
        del w, x, full, lib
    # the norms' row means, the other per-row sums of the serving path
    for m in rows:
        x = normal(m, ROWS_SHAPES[0][0]).float() * 3
        full, lib = row_mean(x * x), torch.var(x, -1, correction=0)
        same = sum(torch.equal(row_mean(x[i:i + 1] * x[i:i + 1])[0],
                               full[i]) for i in range(m))
        same_lib = sum(torch.equal(torch.var(x[i:i + 1], -1,
                                             correction=0)[0], lib[i])
                       for i in range(m))
        print(f"row_mean rows [{m}, {x.shape[1]}] float32: {same} of {m} "
              f"rows bitwise equal to the row alone (matmul kernel); "
              f"torch.var {same_lib} of {m}")
        if same != m:
            raise AssertionError(f"row_mean [{m}]: rows depend on the row "
                                 f"count")
    # a long prefill's norm (ROW_MEAN_LONG)
    m, d = ROW_MEAN_LONG
    x = torch.randn(m, d, device=dev, generator=g)
    full = row_mean(x)
    pick = [*range(64), *range(64, m - 64, 997), *range(m - 64, m)]
    same = sum(torch.equal(row_mean(x[i:i + 1])[0], full[i]) for i in pick)
    err = (full.double() - x.double().mean(-1, keepdim=True)).abs().max()
    print(f"row_mean rows [{m}, {d}] float32 (first level [{m * d // 64}, "
          f"64]): {same} of {len(pick)} sampled rows bitwise equal to the "
          f"row alone; max |err| against the float64 mean {float(err)!r}")
    if same != len(pick) or not float(err) <= ROW_MEAN_ATOL:
        raise AssertionError(f"row_mean [{m}, {d}]: wrong past the grid's "
                             f"second dimension")
    del x, full
    torch.cuda.empty_cache()
    return timings


def serve_requests(cfg, n, lengths, new, seed):
    """``n`` requests as ``launch/serve.py --execute-smoke`` draws them: each
    a prompt length from ``lengths`` (a range, or one length), then its
    tokens, from numpy's ``seed``."""
    import numpy as np

    from repro_torch.serving import Request

    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        plen = (int(rng.integers(*lengths)) if isinstance(lengths, tuple)
                else lengths)
        out.append(Request(i, rng.integers(0, cfg.vocab_size, plen)
                           .astype(np.int32), new))
    return out


def padded(reqs):
    """The engine's left-padded token batch of ``reqs``."""
    import numpy as np

    pmax = max(r.prompt_len for r in reqs)
    toks = np.zeros((len(reqs), pmax), np.int32)
    for i, r in enumerate(reqs):
        toks[i, pmax - r.prompt_len:] = r.tokens
    return toks


def serve_batch(label, engine, reqs):
    """One ``generate_batch`` with the launch counts set to 0 just before
    and read just after; prints its walls and decode rate."""
    import torch

    from repro_torch.kernels import ops

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    outs = engine.generate_batch(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    n_new = max(r.max_new_tokens for r in reqs)
    c = outs[0]
    print(f"serve {label}: {len(reqs)} requests, prompts "
          f"{min(r.prompt_len for r in reqs)}..{max(r.prompt_len for r in reqs)}"
          f" tokens, cache_len {engine.cache_len}: prefill "
          f"{c.prefill_s * 1e3:.3f} ms, decode {c.decode_s * 1e3:.3f} ms for "
          f"{n_new} steps ({len(reqs) * n_new / c.decode_s:.1f} tokens/s, "
          f"{c.decode_s / n_new * 1e3:.3f} ms per step), wall {wall:.3f} s; "
          f"launches {counts}")
    return outs, counts, wall


def incremental_gap(model, toks, cache_len):
    """prefill(S) of ``toks`` [B, S], decode_step of its greedy tokens, and
    prefill(S+1) of the same tokens: (prefill logits, decode logits,
    prefill(S+1) logits, greedy tokens, the INCR_TOL line and whether every
    logit is within it)."""
    import torch

    S = toks.shape[1]
    logits, cache = model.prefill(toks, cache_len=cache_len)
    first = torch.argmax(logits, -1)
    dec, _ = model.decode_step(cache, first, S)
    full, _ = model.prefill(torch.cat([toks, first[:, None]], 1),
                            cache_len=cache_len)
    torch.cuda.synchronize()
    d, f = dec.float(), full.float()
    err = (d - f).abs()
    bad = err > INCR_TOL["atol"] + INCR_TOL["rtol"] * f.abs()
    line = (f"prefill({S}) + decode_step vs prefill({S + 1}): max abs diff "
            f"{float(err.max())!r} on logits up to {float(f.abs().max()):.3f}"
            f", {int(bad.sum())} of {bad.numel()} beyond rtol "
            f"{INCR_TOL['rtol']}, atol {INCR_TOL['atol']}")
    return logits, dec, full, first, line, not bool(bad.any())


def check_serve_logits(label, model, reqs, outs, cache_len):
    """The engine's batch once more by hand: finite logits, the engine's
    first tokens the prefill's argmax, and prefill(S) + decode_step within
    INCR_TOL of prefill(S+1), every logit (the reference suite's check, at
    the full config in its working dtype). Returns the line's reading."""
    import torch

    toks = torch.from_numpy(padded(reqs)).to(model.device)
    logits, dec, full, first, line, ok = incremental_gap(model, toks,
                                                         cache_len)
    engine_first = torch.tensor([int(c.tokens[0]) for c in outs],
                                device=model.device)
    same_first = torch.equal(first, engine_first)
    finite = all(bool(torch.isfinite(x).all()) for x in (logits, dec, full))
    gap = float((dec.float() - full.float()).abs().max()
                / full.float().abs().max())
    print(f"serve {label}: logits {tuple(logits.shape)} finite {finite}; "
          f"the engine's first tokens are the prefill's argmax {same_first};"
          f" {model.cfg.dtype} {line}; max gap {gap!r} of the logits' scale;"
          f" bitwise equal {torch.equal(dec, full)}")
    if not (finite and same_first and ok):
        raise AssertionError(f"serve {label}: logits check failed")


def check_incremental_float32(arch, dev, seed):
    """prefill(S) + decode_step against prefill(S+1) at the full config in
    float32 (full width and depth, IEEE float32 products), within INCR_TOL:
    the serve batch, and the long batch where the architecture has one
    (recurrentgemma past its window, the rolled cache; llama3-8b's 4096
    tokens)."""
    import dataclasses
    import gc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.precision import ieee_float32
    from repro_torch.models import Model

    cfg = dataclasses.replace(get_config(arch), dtype="float32",
                              kv_dtype="float32")
    model = Model(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(seed))
    for label, reqs, cache_len in serve_batches(cfg, arch, 1):
        toks = torch.from_numpy(padded(reqs)).to(dev)
        t0 = time.perf_counter()
        with ieee_float32():
            logits, dec, full, _, line, ok = incremental_gap(model, toks,
                                                             cache_len)
        finite = all(bool(torch.isfinite(x).all())
                     for x in (logits, dec, full))
        print(f"serve {arch} {label} float32, full depth "
              f"({time.perf_counter() - t0:.3f} s): finite {finite}; {line}")
        if not (ok and finite):
            raise AssertionError(f"serve {arch} {label}: float32 "
                                 f"prefill/decode check failed")
    del model
    gc.collect()
    torch.cuda.empty_cache()


def serve_batches(cfg, arch, new):
    """(label, requests, cache_len) of the serve batch and, where the
    architecture has one, its long batch."""
    out = [("batch", serve_requests(cfg, SERVE_REQUESTS, SERVE_PROMPT, new,
                                    SERVE_SEED), SERVE_CACHE)]
    if arch in LONG:
        prompt, cache_len = LONG[arch]
        out.append(("long batch", serve_requests(
            cfg, LONG_BATCH, prompt, new, SERVE_SEED + 1), cache_len))
    return out


#: weight products (``linear``) of one layer's mixer, by kind
MIXER_PRODUCTS = {"attn": 4, "rglru": 5, "rwkv6": 6}


def expected_launches(cfg, new):
    """Kernel launches of one ``generate_batch`` (a prefill and ``new``
    decode steps): the recurrence kernels and both attention kernels once
    per layer of their kind and forward (flash_attention in the prefill,
    flash_decode in each decode step), matmul once per weight product (the
    mixer's, the FFN's two or three, the head) and per row mean of a norm
    (``layers.row_mean``: one mean per rmsnorm, two per layernorm and per
    rwkv6 group norm; two norms a layer and the final one)."""
    from repro_torch.models.layers import row_mean_launches

    kinds = [cfg.layer_kind(i) for i in range(cfg.num_layers)]
    n_attn = kinds.count("attn")
    per_norm = ((1 if cfg.norm == "rmsnorm" else 2)
                * row_mean_launches(cfg.d_model))
    per_forward = (sum(MIXER_PRODUCTS[k] for k in kinds)
                   + (3 if cfg.glu else 2) * cfg.num_layers + 1
                   + per_norm * (2 * cfg.num_layers + 1)
                   + 2 * row_mean_launches(cfg.rwkv_head_dim)
                   * kinds.count("rwkv6"))
    return {"acd_evict": 0, "fifo_dispatch": 0,
            "matmul": per_forward * (1 + new),
            "flash_attention": n_attn, "flash_decode": n_attn * new,
            "rglru": kinds.count("rglru") * (1 + new),
            "rwkv6": kinds.count("rwkv6") * (1 + new)}


def serve_full(arch, dev, seed):
    """One architecture's full config on the card (weights drawn from a
    seeded generator there): a warm-up batch, then the timed batch (and the
    long batch where it has one) with every kernel's launch count, the
    logits checks, the decode step with fused activations, and for rwkv6
    and llama3-8b a profiler pass. Returns ({kernel: launches in the timed
    batches}, {batch label: (completions, wall)})."""
    import gc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.serving import InferenceEngine

    cfg = get_config(arch)
    kinds = [cfg.layer_kind(i) for i in range(cfg.num_layers)]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Model(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(seed))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    n_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    print(f"serve {arch}: {cfg.num_layers} layers ("
          + ", ".join(f"{kinds.count(k)} {k}" for k in sorted(set(kinds)))
          + f"), d_model {cfg.d_model}, {cfg.num_heads} heads over "
          f"{cfg.num_kv_heads} KV heads, head_dim {cfg.hd}, vocab "
          f"{cfg.vocab_size}: {n_params} parameters, {n_bytes / 1e9:.3f} GB,"
          f" drawn on the card in {time.perf_counter() - t0:.3f} s")
    launches, runs = {}, {}
    for label, reqs, cache_len in serve_batches(cfg, arch, SERVE_NEW):
        engine = InferenceEngine(model, cache_len=cache_len)
        if label == "batch":  # first-use costs stay out of the timed run
            engine.generate_batch(reqs)
        outs, counts, wall = serve_batch(f"{arch} {label}", engine, reqs)
        want = expected_launches(cfg, max(r.max_new_tokens for r in reqs))
        if counts != want:
            raise AssertionError(f"serve {arch} {label}: launches {counts}, "
                                 f"expected {want}")
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n
        check_serve_logits(f"{arch} {label}", model, reqs, outs, cache_len)
        runs[label] = (outs, wall)
        if arch in ("rwkv6-1.6b", "llama3-8b"):
            profile_serve(arch, engine, reqs, wall)
        if label == "batch":
            time_activations(arch, engine, reqs)
    print(f"serve {arch}: peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    del model, engine
    gc.collect()
    torch.cuda.empty_cache()
    return launches, runs


def serve_short(arch, dev, seed):
    """A dense architecture at full width and SHORT_LAYERS layers, bf16:
    the serve batch's prefill and SHORT_DECODE greedy decode steps, each
    step's logits held against the card's own prefill of the tokens so far
    at INCR_TOL, every kernel's launches counted. Returns the launches."""
    import dataclasses
    import gc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import Model

    cfg = dataclasses.replace(get_config(arch), num_layers=SHORT_LAYERS)
    model = Model(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(seed))
    reqs = serve_requests(cfg, SERVE_REQUESTS, SERVE_PROMPT, SHORT_DECODE,
                          SERVE_SEED)
    toks = torch.from_numpy(padded(reqs)).to(dev)
    S = toks.shape[1]
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    logits, cache = model.prefill(toks, cache_len=SERVE_CACHE)
    steps = []
    for i in range(SHORT_DECODE):
        tok = torch.argmax(logits, -1)
        toks = torch.cat([toks, tok[:, None]], 1)
        logits, cache = model.decode_step(cache, tok, S + i)
        steps.append(logits)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    want = expected_launches(cfg, SHORT_DECODE)
    readings, ok = [], counts == want
    for i, dec in enumerate(steps):
        full, _ = model.prefill(toks[:, :S + i + 1], cache_len=SERVE_CACHE)
        d, f = dec.float(), full.float()
        bad = (d - f).abs() > INCR_TOL["atol"] + INCR_TOL["rtol"] * f.abs()
        ok = ok and not bool(bad.any()) and bool(torch.isfinite(d).all())
        readings.append(f"{int(bad.sum())} beyond (max abs diff "
                        f"{float((d - f).abs().max())!r})")
    print(f"serve {arch} at {SHORT_LAYERS} layers, d_model {cfg.d_model}, "
          f"{cfg.num_heads} heads over {cfg.num_kv_heads} KV heads, "
          f"head_dim {cfg.hd}: prefill {S} tokens + {SHORT_DECODE} decode "
          f"steps in {wall:.3f} s; each step against prefill(S+1) at "
          f"INCR_TOL: {'; '.join(readings)}; launches {counts}")
    del model, cache
    gc.collect()
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError(f"serve {arch}: short run failed (launches "
                             f"expected {want})")
    return counts


def time_activations(arch, engine, reqs, n=3):
    """The decode step with the port's activations (``layers.gelu``,
    ``silu``, ``sigmoid``: one op per op of XLA's expansion, for bf16
    parity with the reference) against torch's fused ``F.gelu(approximate=
    "tanh")``, ``F.silu`` and ``torch.sigmoid`` swapped in: ``n``
    ``generate_batch`` calls each, alternating; prints each one's median
    decode ms per step. A measurement of what the parity costs; the fused
    versions are not the port's."""
    import statistics

    import torch
    import torch.nn.functional as F

    from repro_torch.models import layers, recurrent

    ported = {k: getattr(layers, k) for k in ("gelu", "silu", "sigmoid")}
    fused = {"gelu": lambda x: F.gelu(x, approximate="tanh"),
             "silu": F.silu, "sigmoid": torch.sigmoid}
    steps = max(r.max_new_tokens for r in reqs)
    per_step = {"ported": [], "fused": []}
    try:
        for _ in range(n):
            for name, fns in (("ported", ported), ("fused", fused)):
                for mod in (layers, recurrent):
                    for k, f in fns.items():
                        setattr(mod, k, f)
                outs = engine.generate_batch(reqs)
                per_step[name].append(outs[0].decode_s / steps * 1e3)
    finally:
        for mod in (layers, recurrent):
            for k, f in ported.items():
                setattr(mod, k, f)
    med = {k: statistics.median(v) for k, v in per_step.items()}
    print(f"serve {arch} activations: decode ms per step, the port's "
          f"expanded {med['ported']:.3f} (runs "
          f"{', '.join(f'{x:.3f}' for x in per_step['ported'])}), torch's "
          f"fused {med['fused']:.3f} (runs "
          f"{', '.join(f'{x:.3f}' for x in per_step['fused'])}): the "
          f"expansion costs {med['ported'] - med['fused']:.3f} ms per step")


def profile_serve(arch, engine, reqs, wall):
    """One more ``generate_batch`` under the profiler: device busy and idle
    share of the profiled and of the unprofiled wall, the kernels' share,
    the top device operations."""
    got = device_profile(f"serve {arch}",
                         lambda: engine.generate_batch(reqs))
    if got is None:
        return
    busy_s, wall_p, dev_events = got
    kern = {k: sum(e.self_device_time_total for e in dev_events
                   if k in e.key) * 1e-6
            for k in ("rwkv6", "rglru", "matmul", "flash_attention",
                      "flash_decode")}
    print(f"profile serve {arch}: device busy {busy_s:.6f} s of a "
          f"{wall_p:.3f} s profiled wall ({busy_s / wall_p:.4f}); of the "
          f"unprofiled {wall:.3f} s wall {busy_s / wall:.4f} busy, "
          f"{1 - busy_s / wall:.4f} idle; "
          + ", ".join(f"{k} {v:.6f} s ({v / busy_s:.4f} of busy)"
                      for k, v in kern.items() if v)
          + f"; {sum(e.count for e in dev_events)} device events")
    print_top_events(dev_events, 8)


def check_serve_against_cpu(arch, dev, seed):
    """The architecture at full width and CPU_LAYERS depth in float32, the
    same weights on the card and the CPU (drawn on the card, copied): the
    engine's greedy tokens over CPU_DECODE steps equal, prefill logits
    within CPU_RTOL of their scale; float32 products in IEEE float32. Then,
    as a reading, the CPU's bf16 prefill(S) + decode_step against
    prefill(S+1) with the same weights rounded to bf16."""
    import dataclasses
    import gc

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.precision import ieee_float32
    from repro_torch.models import Model
    from repro_torch.serving import InferenceEngine

    cfg = dataclasses.replace(get_config(arch), num_layers=CPU_LAYERS[arch],
                              dtype="float32", kv_dtype="float32")
    card = Model(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(seed))
    cpu = Model(cfg, device="cpu")
    cpu.load_state_dict(card.state_dict())
    reqs = serve_requests(cfg, SERVE_REQUESTS, SERVE_PROMPT, CPU_DECODE,
                          SERVE_SEED)
    toks = torch.from_numpy(padded(reqs))
    t0 = time.perf_counter()
    with ieee_float32():
        got = InferenceEngine(card, SERVE_CACHE).generate_batch(reqs)
        lc, _ = card.prefill(toks.to(dev), cache_len=SERVE_CACHE)
        t1 = time.perf_counter()
        want = InferenceEngine(cpu, SERVE_CACHE).generate_batch(reqs)
        lh, _ = cpu.prefill(toks, cache_len=SERVE_CACHE)
    t2 = time.perf_counter()
    same = all(np.array_equal(g.tokens, w.tokens) for g, w in zip(got, want))
    rel = float((lc.cpu() - lh).abs().max() / lh.abs().max())
    print(f"serve {arch} at {cfg.num_layers} layers, float32: card "
          f"{t1 - t0:.3f} s, CPU {t2 - t1:.3f} s; greedy tokens over "
          f"{CPU_DECODE} steps equal {same}; prefill logits differ by "
          f"{rel!r} of their max (tolerance {CPU_RTOL})")
    # a reading, not a gate: the plain product's rows no longer depend on
    # the row count, but the plain attention versions still sum prefill
    # and decode in different orders on the CPU
    cpu = Model(dataclasses.replace(cfg, dtype="bfloat16",
                                    kv_dtype="bfloat16"), device="cpu")
    cpu.load_state_dict(card.state_dict())
    print(f"serve {arch} at {cfg.num_layers} layers, bf16 on the CPU: "
          f"{incremental_gap(cpu, toks, SERVE_CACHE)[4]}")
    del card, cpu
    gc.collect()
    torch.cuda.empty_cache()
    if not same or rel > CPU_RTOL:
        raise AssertionError(f"serve {arch}: card != CPU")


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

    # -- 6. the profiling path: profile -> predict -> schedule -------------
    kernels.append(check_matmul(dev))
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    mx = profile_app("matrix")
    # the whole grid of the matrix test jobs in one batched sweep (acd_evict)
    fracs = np.linspace(0.45, 0.95, N_DEADLINES)
    sweep = mx["sched"].schedule_sweep(
        [float(mx["priv"].makespan * f) for f in fracs],
        base_features=mx["te"]["base_features"], act=mx["act"],
        orders=ORDERS)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    print(f"profile matrix: 2 orders x {N_DEADLINES} deadlines swept on the "
          f"card, makespan {sweep.makespan.min():.3f}.."
          f"{sweep.makespan.max():.3f} s, cost {sweep.cost_usd.min():.6f}.."
          f"{sweep.cost_usd.max():.6f} USD; path wall "
          f"{time.perf_counter() - t0:.3f} s; launches {counts}")
    n_jobs = sum(PROFILE_COUNTS["matrix"])
    if counts["matmul"] < n_jobs or counts["acd_evict"] <= 0:
        raise AssertionError(f"profiling path: matmul launched "
                             f"{counts['matmul']} times for {n_jobs} jobs, "
                             f"acd_evict {counts['acd_evict']}")
    if not (np.isfinite(sweep.makespan).all()
            and np.isfinite(sweep.cost_usd).all()):
        raise AssertionError("profiling path: non-finite sweep")
    launches["profile"] = counts
    profile_traces(mx["spec"], 100)
    profiled = {"matrix": mx}
    for name in ("video", "image"):
        profiled[name] = profile_app(name)
    # card against CPU with TF32 turned on for the process, as a user may
    # turn it on: the port keeps its float32 products and convolutions in
    # IEEE float32 in its own scope, so they must agree all the same
    precision = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        check_tf32_took_effect(dev)
        for name, run in profiled.items():
            check_apps_against_cpu(name, run["spec"], run["traces"])
            check_fit_against_cpu(name, run["spec"], run["tr"], run["te"],
                                  run["pm"])
    finally:
        torch.set_float32_matmul_precision(precision)

    # -- 7. the serving path: the model stack's kernels ---------------------
    bf16_matmul = check_linear_rows(dev)
    kernels.append(check_flash_attention(dev))
    kernels.append(check_flash_decode(dev))
    kernels.append(check_rglru(dev))
    kernels.append(check_rwkv6(dev))
    t0 = time.perf_counter()
    serve_launches = {}
    for seed, arch in enumerate(SERVED):
        counts, _ = serve_full(arch, dev, seed)
        for k, n in counts.items():
            serve_launches[k] = serve_launches.get(k, 0) + n
    for seed, arch in enumerate(SHORT):
        serve_short(arch, dev, seed + 30)
    for seed, arch in enumerate(SERVED):
        check_incremental_float32(arch, dev, seed + 20)
    for seed, arch in enumerate(SERVED):
        check_serve_against_cpu(arch, dev, seed + 10)
    print(f"serve: phase wall {time.perf_counter() - t0:.3f} s; launches "
          f"in the timed serve batches {serve_launches}")

    # -- 8. result ------------------------------------------------------------
    print(f"total {time.perf_counter() - t_start:.1f} s")
    # each kernel's launches on the main path of its slice: acd_evict on
    # the uncapped sweeps, fifo_dispatch on the congested ones; matmul on
    # the matrix app's profiling path and on the timed serve batches (every
    # weight product); flash_attention, flash_decode, rglru and rwkv6 on
    # the timed serve batches
    by_name = {k["name"]: k for k in kernels}
    by_name["acd_evict"]["launches"] = sum(
        launches[("main", J)]["acd_evict"] for J in MAIN_J)
    by_name["fifo_dispatch"]["launches"] = sum(
        launches[("load", J)]["fifo_dispatch"] for J in MAIN_J)
    by_name["matmul"]["launches"] = (launches["profile"]["matmul"]
                                     + serve_launches["matmul"])
    by_name["matmul"]["bf16"] = bf16_matmul
    for name in ("flash_attention", "flash_decode", "rglru", "rwkv6"):
        by_name[name]["launches"] = serve_launches[name]
    missing = [k["name"] for k in kernels if k["launches"] <= 0]
    if missing or len(kernels) != 7:
        raise AssertionError(f"kernels never launched on their path: "
                             f"{missing}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
