#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. Environment and build: prints the card's name and power limit as
   ``nvidia-smi`` reports them, and builds every CUDA kernel of the main
   paths from ``src/repro_torch/kernels/csrc/`` with ``nvcc`` (one
   process per source, all started together).
2. Kernels against their plain PyTorch versions, on the same inputs:
   random and hand-built edge inputs (near ties, mask shares 0 to 1, long
   unmasked runs, demands of 0.0 and -0.0, +-inf and NaN thresholds, tied
   slot clocks, uncapped and infeasible providers, never-used slots,
   empty and full chains) at the main paths' shapes and ragged ones,
   compared bit for bit; each kernel's time, its plain version's time and
   the least time the card could take for the same work (and the chain
   floors of ``acd_evict`` and ``fifo_dispatch``: the longest row's
   masked jobs, or chain steps, times one dependent step's latency,
   measured by ``acd_chain_step_probe`` and ``fifo_chain_step_probe``).
3. The uncapped main path: Algorithm 1 over the Fig.-4 grid (image,
   matrix and video x {spt, hcf} x 5 deadlines = 30 scenarios) in one
   ``sweep_scenarios`` call on ``cuda`` at J=512 and J=4096 jobs. The grid
   at J=128 runs on the card and on the CPU and must agree field for
   field; three scenarios of each timed grid (J=512 and J=4096) replay
   through the port's DES and must meet the parity contract (placements,
   replicas, providers, segments, start and end exact; cost and makespan
   to a relative 1e-12). The J=512 sweep then runs once more under
   ``torch.profiler`` to split its wall time into device-busy and idle,
   and the J=4096 sweep once more to count the share of masked jobs the
   engine gives ``acd_evict`` (``acd_mask_share``); the kernel is timed at
   that share and at 0.8, at J=512 and J=4096, and by device time on
   every 1000th of the engine's own calls, kept from that pass, beside
   their chain floor.
4. The congested main path: the same grid on a 3-provider portfolio with
   2-slot concurrency caps per provider and a 0.5 s warm-up / 1 s
   keep-alive scale-to-zero cold-start model (the throughput benchmark's
   ``--coldstart 0.5`` point), at J=512 and J=4096 on ``cuda``. Queue waits
   and cold starts must occur; the J=128 grid agrees between the card and
   the CPU field for field; three scenarios of each timed grid meet the
   DES contract, queue waits and cold flags exact; the J=512 sweep runs
   once more under the profiler. One more, untimed sweep of the J=4096
   grid keeps the inputs of its every ``fifo_dispatch`` call, and each is
   then held against its plain version and timed by CUDA events beside
   its chain floor.
5. A pool trace (one private replica per stage, two from a breakpoint
   inside the horizon) with the cold-start model, J=512 on ``cuda``; three
   of its scenarios meet the DES contract, and the J=128 grid agrees
   between the card and the CPU field for field.
6. The engine's other options, each path timed with its launch counts
   set to 0 just before it. Scenario axes: the Fig.-4 grid as five tasks
   mixing per-task flags (ACD-adaptive, ``adaptive=False``,
   ``init_phase=False``, an ``offload_mask``, an ``init_window`` over a
   release stream) in one ``sweep_scenarios`` call at J=512 and J=1024,
   uncapped and then with ``egress_lookahead`` under the congested load;
   faults: the Fig.-4 grid at J=512 on the 3-provider portfolio with a
   failure-rate axis (0, 0.1, 0.3) under the default ``RetryPolicy``
   (failures, retries, and an abandonment or a fallback must occur); each
   against the DES on some scenarios and the CPU at J=128, ``acd_evict``
   launched in each, ``fifo_dispatch`` in the capped one. A paged trace
   day: ``azure:day=tue,scale=50000`` on the image app, spt, C_max 60 s,
   4096-job pages (the reference throughput benchmark's streaming point),
   against the DES on the host under the parity contract, with wall,
   jobs/s, pages, retries, body steps and ms per body step; then a
   4096-job day in 512-job pages bit for bit against the monolithic card
   run and the CPU, and a 1024-job day under the profiler. The serving
   scheduler (llama3-8b on a 2/4/2 pod with ``elastic_portfolio(3)``
   overflow, the H100 latency model): the ridge fit on the card against
   the CPU's; ``compare_policies`` (six policies x faults {none, 0.3}) at
   the policy bench's ``--jobs 512`` point, at its ``poisson:8.0`` and at
   ``poisson:32.0`` (the bench's load on the H100's faster pod), each
   against the DES in every scenario and the bench's Fig.-4 ordering, and
   at J=256 against the CPU field for field; ``serve_online`` over 4096
   requests at 32/s under 2-slot caps, cold starts and three queue-wait
   samples (queue waits, cold starts and ``fifo_dispatch`` must occur)
   against the DES; the autoscaling (8 pod sizings), spot (3 markets) and
   reliability (rates 0, 0.1, 0.3) frontiers over 4 deadlines at J=512,
   each's Pareto mask and three scenarios against the DES;
   ``plan_batch_torch`` at J=4096 bit for bit numpy's ``init_offload``;
   ``python -m repro_torch.launch.serve --execute-smoke`` in a process of
   its own. Each part prints its wall, scenarios per second, policy time,
   engine calls, body steps, ms per body step and launches.
7. The paper's profile -> predict -> schedule path. First ``matmul``
   against its plain version on the card (ragged shapes, transposed views,
   1024^3, bf16; the matrix app's integer ``x @ x.T`` at n = 344 and 496
   bit for bit, also against the CPU; every float32 configuration forced
   on one product per regime, bit for bit alike) and its time, bound and
   ``torch.matmul``'s time (CUDA events and device time) at
   ``F32_TIMED`` (the MM stage's squares, [4096]^3, a float32 decode
   step, the norms' row means at llama3-8b's decode and long prefill).
   Then the matrix app at
   full width traces 924 jobs on the card (MM through ``matmul``), splits
   them 774/150, fits the ridge models on the card, predicts the test
   jobs, schedules them SPT and HCF at 0.55x the all-private makespan
   (DES) and sweeps 2 orders x 5 deadlines on the card (``acd_evict``);
   video and image run the same loop at full width with 40/16 jobs.
   Per-stage card latency, model MAPE and lambdas are printed, and 100
   matrix jobs are traced once more under the profiler. The first
   jobs' stage outputs agree between card and CPU (MM, EF and RI bit for
   bit, LU with the same pivots), and the card's fits equal the CPU's
   (the same lambdas, predictions to a relative 1e-4). Fig. 3's quick
   pass: the appendix MILP (scipy's HiGHS on the host, 20 s limit) on the
   first 12 video test jobs against the card's SPT and HCF schedules,
   each equal to the DES, with the cost ratios.
8. The model stack's serving path. First the bf16 ``matmul`` kernel
   (tensor cores) at the serve shapes: against its plain version at
   M = 8, 656 and 8192 through the FFN's layer views and at M = 8 through
   both heads, each timed beside torch.matmul and its bound; its TMA and
   thread-staged paths bit for bit; and every row of ``linear(x [M, K],
   w)`` and of the norms' ``row_mean`` equal to the row computed alone,
   bit for bit, at M = 8, 656 and 8192 (what keeps the bf16
   prefill/decode split exact), beside torch.matmul's and torch.var's
   counts, and ``row_mean`` over 65,600 rows of 4096 (more row tiles than
   a second grid dimension may number). Then ``flash_attention`` and
   ``flash_decode`` at every attention shape of the phase and ragged ones
   (S = 1, sq < sk, sq > sk, windows, not causal, float32, rows not
   16-byte aligned; decode lengths 0, 1, partial and full, live keys
   across the bf16 kernel's 256-position chunks) against their plain
   versions, with times, bounds and ``scaled_dot_product_attention``'s
   time as the yardstick (the decode kernel's block count and its device
   time, under the profiler, too); ``rglru`` at
   recurrentgemma's [8, 2048, 4096] (from a nonzero h0, a continuation
   split at t = 1000, a ragged shape) and ``rwkv6`` at rwkv6-1.6b's
   [8, 32, 2048, 64] (bf16, and float32 from a nonzero s0, in the model's
   strided layout), at the long batch's [2, 32, 4096, 64] and a shape
   whose plan splits columns (o also bit for bit against
   ``ref.rwkv6_ordered``, the kernel's stated order), and both at the
   serve phase's own shapes; ``rwkv6`` timed by events and by device time
   at [8, 32, 2048, 64], the long batch's prefill, the serve prefill and
   a decode step, beside its bound and its term floor. Then
   ``launch/serve.py --execute-smoke``'s batch (8 requests, 16 new tokens)
   through ``InferenceEngine`` at the full ``rwkv6-1.6b``,
   ``recurrentgemma-9b`` and ``llama3-8b`` configs, plus each long batch
   (2 x 4096 tokens of rwkv6-1.6b, 2 x 2304 past recurrentgemma's window,
   2 x 4096 of llama3-8b), with walls, every kernel's launch count against
   its prediction, finite logits and profiler passes; the decode step
   timed with the port's activations and with torch's fused ones;
   prefill(S) + decode_step against prefill(S+1) at the full configs,
   bit for bit in bf16 and within the reference suite's tolerance in
   float32;
   ``stablelm-12b`` and ``starcoder2-15b`` at full width and 2 layers (a
   prefill and 4 decode steps, each bit for bit prefill(S+1)); and card
   against CPU at full width, 2 and 3 layers, float32: the same greedy
   tokens (and, as a reading, the CPU's bf16 prefill(S) + decode_step
   against prefill(S+1)).
9. Prints the kernels' JSON line, then the device line last.

Launch counts are set to 0 just before each main path and read just after
it; every kernel of a path must have launched in it. Each phase prints its
wall (``phase wall ...``).

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
#: job counts of the scenario-axes sweeps: at J=4096 they took ~200 s of
#: a 1,319 s run on a slow host, past the 1,200 s a run may take; the
#: J=4096 scale stays timed and DES-checked on the main and congested
#: paths
AXES_J = (512, 1024)
DES_SCENARIOS = ((0, 0), (1, 7), (2, 9))  # (task, scenario) pairs
#: the congested path: the throughput benchmark's ``--coldstart 0.5``
#: point (2-slot caps per provider of demo_portfolio(3), a W-second
#: warm-up with a 2W keep-alive window, scale-to-zero pools)
LOAD_WARM_UP_S = 0.5
LOAD_CAP = 2
LOAD_PROVIDERS = 3
LOAD_DES_SCENARIOS = ((0, 3), (1, 6), (2, 9))
#: the scenario-axes path: the Fig.-4 grid as five tasks mixing per-task
#: flags (ACD-adaptive, adaptive=False, init_phase=False, an offload_mask,
#: an init_window over a release stream), then the same tasks with
#: egress_lookahead under the congested load
AXES_DES_SCENARIOS = ((0, 0), (1, 7), (2, 9), (3, 4), (4, 2))
#: the paged trace day: the reference throughput benchmark's streaming
#: point (benchmarks/bench_scheduler_throughput.py measure_azure_point:
#: one azure day on the image app, spt, C_max 60 s, 4096-job pages) cut
#: from 10^5 to 5 x 10^4 jobs for the 1,200 s a run may take (79 s and a
#: 19 s DES at 10^5 on a slow host), and a 4096-job day in 512-job pages
#: held against the monolithic run
DAY_SCALE = 50000
DAY_CHUNK = 4096
DAY_C_MAX = 60.0
SMALL_DAY = (4096, 512)
#: the day run under the profiler, for the device's idle share (its
#: post-processing grows with the events: ~100 a body step)
PROFILED_DAY = (1024, 512)
#: the fault path: the Fig.-4 grid at J=512 with a failure-rate axis under
#: the default RetryPolicy
FAULT_J = 512
FAULT_RATES = (0.0, 0.1, 0.3)
FAULT_DES_SCENARIOS = ((0, 1), (1, 17), (2, 26), (0, 29))
#: the serving scheduler (llama3-8b on serving_dag's 2/4/2 pod with
#: elastic_portfolio(3) overflow): benchmarks/bench_policies.py's --jobs 512
#: point (its build_stream, SLA, replan interval, six policies and fault
#: axis) at the bench's rate and at 4x it: the H100 latency model serves
#: faster than the reference's, so at 8 req/s the pod is lightly loaded
#: and Alg. 1 offloads nothing; at 32 its decode stage is overloaded (the
#: phase prints the offered load; the CPU rerun runs at the loaded rate)
SCHED_ARCH = "llama3-8b"
SCHED_PROVIDERS = 3
SCHED_J = 512
SCHED_SLA_S = 4.0
SCHED_REPLAN_S = 0.5
SCHED_RATES = (8.0, 32.0)
SCHED_FAULTS = (None, 0.3)
SCHED_POLICIES = ("skedulix", "private", "public", "random", "noah",
                  "costanalysis")
#: congested online serving: 4096 requests at the bench's load under the
#: congested path's caps and cold starts, with three observed per-stage
#: public queue-wait samples (seconds) folded into the predictions
ONLINE_J = 4096
ONLINE_RATE = 32.0
ONLINE_QUEUE_WAITS = ((0.0, 0.05, 0.0), (0.1, 0.2, 0.0), (0.05, 0.1, 0.0))
#: the three frontiers at J=512 (bench_hybrid_serving.py's stream), each
#: over deadlines at these fractions of the pod's mean private work
FRONTIER_J = 512
FRONTIER_DEADLINES = (0.25, 0.5, 1.0, 2.0)
AUTOSCALE_GRID = tuple((p, d, 1) for p in (1, 2) for d in (1, 2, 4, 8))
RELIABILITY_RATES = (0.0, 0.1, 0.3)
#: Alg. 1's initialization plan on the card against numpy's
PLAN_J = 4096
#: Fig. 3's quick pass (benchmarks/fig3_optimal_vs_greedy.py): the MILP on
#: the first 12 video test jobs against the SPT/HCF greedy schedules
FIG3_JOBS = 12
FIG3_TIME_LIMIT_S = 20.0
#: job count of the CPU reruns: a J=512 rerun of each path on the CPU (the
#: plain acd_evict loop) took 46-64 s and put the script at 6 minutes; at
#: J=256 the eight reruns took 82 s of a 979 s run, so the engine's paths
#: rerun at 128 and the serving scheduler's comparison at 256
CPU_J = 128
SCHED_CPU_J = 256
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
#: each architecture's long batch (2 prompts, cache_len): rwkv6-1.6b a
#: 4096-token document, so rwkv6 runs 4096 steps on 64 heads (its plan
#: splits their columns over the SMs); recurrentgemma past its 2048-token
#: window, so prefill takes the rolled-cache path and rglru runs 2304
#: steps; llama3-8b a 4096-token document with room for the new tokens in
#: its full-attention cache (long documents, RAG contexts)
LONG_BATCH = 2
LONG = {"rwkv6-1.6b": (4096, 4112), "recurrentgemma-9b": (2304, 2048),
        "llama3-8b": (4096, 4112)}
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
#: float32 matmul products timed beside torch.matmul (TF32 off) and the
#: bound: (label, (M, K, N), reps): dense squares at the MM stage's
#: smallest and largest n, the stage's own x @ x.T (x.T a view), the
#: float32 yardstick [4096]^3, a float32 decode step's [8, 4096] @
#: [4096, 4096] (the 32 x 64 tile's narrowest grid), and the norms' row
#: means (y >= 0) at llama3-8b's width: a decode step's 8 tokens and the
#: long batch's 2 x 4096 ([tokens * 64, 64] @ [64, 1], then
#: [tokens, 64] @ [64, 1])
F32_TIMED = (("square n=344", (344, 344, 344), 200),
             ("square n=496", (496, 496, 496), 200),
             ("MM stage x @ x.T n=496", (496, 496, 496), 200),
             ("square n=4096", (4096, 4096, 4096), 10),
             ("f32 decode", (8, 4096, 4096), 100),
             ("row_mean decode level 1", (8 * 64, 64, 1), 200),
             ("row_mean decode level 2", (8, 64, 1), 200),
             ("row_mean long prefill level 1", (8192 * 64, 64, 1), 50),
             ("row_mean long prefill level 2", (8192, 64, 1), 200))
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


def device_ms(fn, n):
    """Device milliseconds per call of ``fn``: ``n`` calls under the
    profiler (after a warm-up), every device event summed: what the card
    spends, where ``cuda_ms`` of a short kernel reads the host's launch
    rate. Returns (ms per call, {event name: ms per call}); nan where
    the profiler saw no device time twice (it sometimes misses a whole
    kernel)."""
    fn()
    got = (device_profile("device_ms", lambda: [fn() for _ in range(n)])
           or device_profile("device_ms", lambda: [fn() for _ in range(n)]))
    if got is None:
        return float("nan"), {}
    busy_s, _, events = got
    return busy_s * 1e3 / n, {e.key: e.self_device_time_total * 1e-3 / n
                              for e in events}


def finite(ms):
    """``ms`` for the JSON line, None where it was not measured (nan):
    the line stays valid JSON."""
    return ms if ms == ms else None


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
    against the CPU; every float32 configuration forced on a product of
    each regime, bit for bit alike), then the float32 kernel's time, bound
    and ``torch.matmul``'s time at ``F32_TIMED``. Returns its entry of the
    kernels line (the MM stage's [496]^3 as its times, every timed shape
    under "f32")."""
    from repro_torch.core.precision import ieee_float32

    # the plain version and the library call in IEEE float32, as the
    # kernel computes; the process's own setting comes back after
    with ieee_float32():
        return _check_matmul(dev)


def _check_matmul(dev):
    import importlib

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

    # every configuration forced on one product per regime: the same bits
    # (each output one ascending fmaf chain, whatever the plan)
    mm = importlib.import_module("repro_torch.kernels.matmul")
    xs, xk = normal(496, 496), normal(4096, 64)
    for label, x, y in (("large", normal(2100, 301), normal(301, 2093)),
                        ("small x @ x.T", xs, xs.T),
                        ("skinny row mean", xk, normal(64, 1).abs())):
        outs = []
        for plan in mm.f32_plans(x.shape[0], y.shape[1], x.shape[1],
                                 x.stride() + y.stride()):
            out = torch.empty((x.shape[0], y.shape[1]), device=dev)
            mm.launch(x, y, out, _f32_plan=plan)
            outs.append(out)
        err = matmul_check(f"f32 {label} {list(x.shape)} @ {list(y.shape)}",
                           x, y, outs[0], matmul_plain(x, y))
        max_err = max(max_err, err)
        same = all(torch.equal(o, outs[0]) for o in outs)
        print(f"matmul f32 {label}: {len(outs)} configurations bitwise "
              f"equal {same}")
        if not same:
            raise AssertionError(f"matmul f32 {label}: configurations "
                                 f"differ")

    timings = []
    for label, (M, K, N), reps in F32_TIMED:
        x = normal(M, K)
        y = (x.T if "x.T" in label else normal(K, N).abs() if N == 1
             else normal(K, N))
        err = matmul_check(f"f32 {label}", x, y, ops.matmul(x, y),
                           matmul_plain(x, y))
        max_err = max(max_err, err)
        k_ms = cuda_ms(lambda: ops.matmul(x, y), reps)
        p_ms = cuda_ms(lambda: matmul_plain(x, y), max(1, reps // 10))
        l_ms = cuda_ms(lambda: torch.matmul(x, y), reps)
        # device time too: events around calls this short read the host
        k_dev = device_ms(lambda: ops.matmul(x, y), reps)[0]
        l_dev = device_ms(lambda: torch.matmul(x, y), reps)[0]
        bound, by, n_bytes, n_ops = matmul_bound(M, K, N, "float32")
        plan = mm.tile_plan_f32(M, N, K, x.stride() + y.stride())
        print(f"matmul {label} [{M}, {K}] @ [{K}, {N}] f32: kernel "
              f"{k_ms:.6f} ms ({n_ops / k_ms * 1e-9:.3f} TFLOP/s, "
              f"{n_bytes / k_ms * 1e-9:.3f} TB/s), plain {p_ms:.6f} ms, "
              f"torch.matmul (TF32 off) {l_ms:.6f} ms, bound {bound:.6f} ms "
              f"by {by} (bytes {n_bytes}, operations {n_ops}); kernel at "
              f"{bound / k_ms:.3f} of the bound, {k_ms / l_ms:.3f}x "
              f"torch.matmul's time; device time: kernel {k_dev:.6f} ms, "
              f"torch.matmul {l_dev:.6f} ms, {k_dev / l_dev:.3f}x, kernel "
              f"at {bound / k_dev:.3f} of the bound; plan {tuple(plan)}, "
              f"{mm.f32_blocks(M, N, plan)} blocks")
        timings.append({"phase": label, "shape": [M, K, N],
                        "plan": list(plan), "ms": k_ms, "plain_ms": p_ms,
                        "bound_ms": bound, "bound_by": by,
                        "library_ms": l_ms, "device_ms": finite(k_dev),
                        "library_device_ms": finite(l_dev)})
        del x, y
    main = next(t for t in timings if t["phase"] == "square n=496")
    return {"name": "matmul", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/matmul.cu",
            "replaces": "src/repro/kernels/matmul.py:36",
            "max_abs_err": max_err, "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "f32": timings}


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


def chain_floor_ms(mask, step_ns):
    """The acd_evict chain floor of one call: the longest row's masked
    jobs times one dependent step's latency."""
    return int(mask.sum(1).max()) * step_ns * 1e-6


def fifo_floor_ms(n_pub, step_ns):
    """The fifo_dispatch chain floor of one call: the longest row's chain
    steps (its n_pub) times one dependent step's latency."""
    return int(n_pub.max()) * step_ns * 1e-6


def fifo_engine_calls(calls, step_ns):
    """``fifo_dispatch`` on the congested sweeps' own calls (``calls``:
    (J, (args, kwargs)) kept by ``keep_fifo_calls``): each against its
    plain version bit for bit, then its time by CUDA events (each call
    far longer than its launch) beside its chain floor and its rows'
    n_pub. Returns the entries for the kernels line."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import fifo_dispatch_plain

    out = []
    for J, (cargs, ckw) in calls:
        want = fifo_dispatch_plain(*(a.cpu() if hasattr(a, "cpu") else a
                                     for a in cargs), **ckw)
        if not all(torch.equal(g.cpu(), w) for g, w in zip(
                ops.fifo_dispatch(*cargs, **ckw), want)):
            raise AssertionError("fifo_dispatch on the engine's inputs: "
                                 "kernel != plain")
        c_ms = cuda_ms(lambda: ops.fifo_dispatch(*cargs, **ckw), 20)
        npub = cargs[1]
        c_floor = fifo_floor_ms(npub, step_ns)
        print(f"fifo_dispatch on a congested J={J} sweep's own call "
              f"{list(cargs[2].shape)} C={cargs[9].shape[2]} cold="
              f"{ckw['cold']}: bitwise equal to the plain version; n_pub "
              f"max {int(npub.max())}, mean {float(npub.double().mean()):.1f}"
              f", total {int(npub.sum())}; {c_ms:.6f} ms by events; chain "
              f"floor {c_floor:.6f} ms, kernel at {c_floor / c_ms:.3f} of "
              f"it")
        out.append({"J": J, "n_pub_max": int(npub.max()),
                    "n_pub_total": int(npub.sum()), "ms": c_ms,
                    "chain_floor_ms": c_floor})
    return out


def keep_fifo_calls(tasks, sweep_kw):
    """Copies of the inputs of every ``fifo_dispatch`` call that one
    sweep of ``tasks`` makes: an untimed pass of its own, the wrapper
    wrapped here only (``ops`` itself stays). Returns [(args, kwargs)]."""
    import types

    import torch

    from repro_torch.core import sweep_scenarios, vectorsim
    from repro_torch.kernels import ops

    kept = []

    def keeping(*args, **kw):
        kept.append((tuple(a.clone() if hasattr(a, "clone") else a
                           for a in args), dict(kw)))
        return ops.fifo_dispatch(*args, **kw)

    vectorsim._kernel_ops = types.SimpleNamespace(**vars(ops))
    vectorsim._kernel_ops.fifo_dispatch = keeping
    try:
        sweep_scenarios(tasks, device="cuda", **sweep_kw)
        torch.cuda.synchronize()
    finally:
        vectorsim._kernel_ops = ops
    return kept


def acd_mask_share(tasks, J, keep_every=1000):
    """The share of masked jobs in the masks the engine gives ``acd_evict``
    over one uncapped sweep of ``tasks``: a counting pass of its own, the
    wrapper wrapped here only, the counts summed on the card and read
    once at the end. Prints it beside the calls' mean longest row.
    Returns (share, copies of the (P, thresh, mask) of every
    ``keep_every``-th call, the first included)."""
    import types

    import torch

    from repro_torch.core import sweep_scenarios, vectorsim
    from repro_torch.kernels import ops

    real = ops.acd_evict
    zero = torch.zeros((), dtype=torch.int64, device="cuda")
    tally = {"masked": zero, "longest": zero, "jobs": 0, "calls": 0}
    kept = []

    def counting(P, thresh, mask):
        if tally["calls"] % keep_every == 0:
            kept.append((P.clone(), thresh.clone(), mask.clone()))
        per_row = mask.sum(1)
        tally["masked"] = tally["masked"] + per_row.sum()
        tally["longest"] = tally["longest"] + per_row.max()
        tally["jobs"] += mask.numel()
        tally["calls"] += 1
        return real(P, thresh, mask)

    # the engine's view of ops, with acd_evict counted (ops itself stays)
    vectorsim._kernel_ops = types.SimpleNamespace(**vars(ops))
    vectorsim._kernel_ops.acd_evict = counting
    try:
        t0 = time.perf_counter()
        sweep_scenarios(tasks, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        vectorsim._kernel_ops = ops
    masked, longest = int(tally["masked"]), int(tally["longest"])
    share = masked / max(tally["jobs"], 1)
    print(f"acd_evict engine mask share over the uncapped J={J} sweep "
          f"(counting pass, {wall:.3f} "
          f"s): {masked} masked of {tally['jobs']} jobs in "
          f"{tally['calls']} calls = {share:.6f}; longest row per call "
          f"{longest / max(tally['calls'], 1):.1f} masked jobs on average")
    return share, kept


#: task keys that are per-task options of the DES's ``simulate``
TASK_SIM_KEYS = ("init_phase", "adaptive", "offload_mask", "init_window",
                 "arrivals")


def check_des(label, tasks, out, pairs, sim_kw, load_fields=False):
    """Scenarios of a sweep against the port's DES under the parity
    contract (queue waits and cold flags exact too, when loaded; attempts,
    failures and abandonment exact under a fault axis, each scenario
    replaying its own fault model)."""
    import time

    from repro_torch.core import RetryPolicy, simulate
    from repro_torch.core.faults import normalize_fault_axis

    for ti, s in pairs:
        task, res = tasks[ti], out[ti]
        kw = dict(sim_kw, **{k: task[k] for k in TASK_SIM_KEYS if k in task})
        faulty = task.get("faults") is not None
        if faulty:
            kw["retry"] = kw.get("retry") or RetryPolicy()
            kw["faults"] = normalize_fault_axis(
                task["faults"], *task["pred"]["P_private"].shape,
                kw["retry"])[int(res.fault_idx[s])]
        t0 = time.perf_counter()
        d = simulate(task["dag"], task["pred"], task["act"],
                     c_max=float(res.c_max[s]), order=res.orders[s], **kw)
        v = res.scenario(s)
        print(f"{label} DES {task['name']} {res.orders[s]} "
              f"c_max={res.c_max[s]:.3f}: {time.perf_counter() - t0:.3f} s, "
              f"cost {float(v.cost_usd)!r} vs {float(d.cost_usd)!r}, "
              f"makespan {float(v.makespan)!r} vs {float(d.makespan)!r}")
        check_contract(f"{label} {task['name']} scenario {s}", v, d,
                       faulty=faulty, loaded=load_fields)


def axes_tasks(apps, J):
    """The Fig.-4 grid as five tasks mixing per-task flags: image
    ACD-adaptive (the sweep's defaults), matrix with ``adaptive=False``,
    video with ``init_phase=False``, image with an ``offload_mask`` over a
    quarter of its jobs, and matrix with an ``init_window`` of a quarter
    of its tightest deadline over a release stream spread across half of
    it."""
    import numpy as np

    base = {t["name"]: t for t in fig4_workload(apps, J)}
    img, mat, vid = base["image"], base["matrix"], base["video"]
    rng = np.random.default_rng(5)
    c0 = min(mat["c_max_grid"])
    return [
        dict(img, name="image adaptive"),
        dict(mat, name="matrix adaptive=False", adaptive=False),
        dict(vid, name="video init_phase=False", init_phase=False),
        dict(img, name="image offload_mask",
             offload_mask=rng.random(J) < 0.25),
        dict(mat, name="matrix init_window", init_window=0.25 * c0,
             arrivals=np.sort(rng.uniform(0.0, 0.5 * c0, J)))]


def check_axes_flags(label, tasks, out):
    """Each task's flag took effect: the offload plan is the mask, no
    initialization offload without the phase, and none of a job released
    after the window."""
    for task, res in zip(tasks, out):
        n_init = res.n_init_offloaded_jobs
        if "offload_mask" in task:
            ok = (n_init == int(task["offload_mask"].sum())).all()
        elif task.get("init_phase") is False:
            ok = (n_init == 0).all()
        elif "init_window" in task:
            ok = (n_init <= int((task["arrivals"]
                                 <= task["init_window"]).sum())).all()
        else:
            ok = (n_init > 0).any()
        if not ok:
            raise AssertionError(f"{label} {task['name']}: initialization "
                                 f"offloads {n_init.tolist()} do not follow "
                                 f"the task's flags")


def scenario_axes_phase(run_path, load_kw):
    """The scenario axes on the card: the five-task flag mix uncapped, then
    with ``egress_lookahead`` under the congested load, at each of
    ``AXES_J``; DES and CPU checks as the main path's. Returns the launch
    counts of each timed sweep."""
    from repro_torch.core import APPS

    launches = {}
    for label, kw in (("axes path", {}),
                      ("axes lookahead congested path",
                       dict(load_kw, egress_lookahead=True))):
        capped = "concurrency" in kw
        for J in AXES_J:
            tasks = axes_tasks(APPS, J)
            out, _, counts = run_path(label, J, tasks, kw)
            need = ("acd_evict", "fifo_dispatch") if capped \
                else ("acd_evict",)
            if any(counts[k] <= 0 for k in need):
                raise AssertionError(f"{label} J={J}: a kernel never "
                                     f"launched: {counts}")
            launches[(label, J)] = counts
            check_axes_flags(f"{label} J={J}", tasks, out)
            check_des(f"{label} J={J}", tasks, out, AXES_DES_SCENARIOS, kw,
                      load_fields=capped)
        check_cpu_rerun(f"{label} J={CPU_J}", axes_tasks(APPS, CPU_J), kw)
    return launches


def check_fault_sweep(label, tasks, out, J):
    """Shapes and finiteness of a faulty sweep, and that the chain ran:
    failures, retries, and an abandonment or a private fallback."""
    import numpy as np

    n = 2 * N_DEADLINES * len(FAULT_RATES)
    for task, res in zip(tasks, out):
        M = task["dag"].num_stages
        if res.num_scenarios != n or res.start.shape != (n, J, M):
            raise AssertionError(f"{label} {task['name']}: bad shapes")
        if not (np.isfinite(res.makespan).all()
                and np.isfinite(res.cost_usd).all()):
            raise AssertionError(f"{label} {task['name']}: non-finite")
        fallback = ((res.attempts > 0) & ~res.public_mask
                    & ~res.abandoned[:, :, None])
        print(f"  {task['name']}: failed attempts {int(res.failed.sum())}, "
              f"retried stages {int((res.attempts > 1).sum())}, abandoned "
              f"jobs {int(res.abandoned.sum())}, private fallbacks "
              f"{int(fallback.sum())}, makespan "
              f"{res.makespan.min():.3f}..{res.makespan.max():.3f} s, cost "
              f"{res.cost_usd.min():.6f}..{res.cost_usd.max():.6f} USD")
    failed = sum(int(r.failed.sum()) for r in out)
    retried = sum(int((r.attempts > 1).sum()) for r in out)
    ended = sum(int(r.abandoned.sum()) + int(
        ((r.attempts > 0) & ~r.public_mask
         & ~r.abandoned[:, :, None]).sum()) for r in out)
    if not (failed and retried and ended):
        raise AssertionError(f"{label}: the attempt chain was not exercised "
                             f"(failed {failed}, retried {retried}, "
                             f"abandoned or fallen back {ended})")


def faults_phase(run_path):
    """The fault axis on the card: the Fig.-4 grid at J=512 on the
    congested path's 3-provider portfolio (uncapped: a failed provider
    leaves two to retry on) with failure rates ``FAULT_RATES`` under the
    default RetryPolicy; scenarios against the DES and the grid at J=256
    against the CPU."""
    from repro_torch.core import APPS, demo_portfolio

    def tasks_at(J):
        return [dict(t, faults=list(FAULT_RATES))
                for t in fig4_workload(APPS, J)]

    kw = dict(portfolio=demo_portfolio(LOAD_PROVIDERS))
    tasks = tasks_at(FAULT_J)
    out, _, counts = run_path("fault path", FAULT_J, tasks, kw,
                              check=check_fault_sweep)
    if counts["acd_evict"] <= 0:
        raise AssertionError(f"fault path never launched acd_evict: {counts}")
    check_des(f"fault path J={FAULT_J}", tasks, out, FAULT_DES_SCENARIOS, kw)
    check_cpu_rerun(f"fault path J={CPU_J}", tasks_at(CPU_J), kw)
    return counts


def run_day(scale, chunk, device="cuda", engine="vector"):
    """One ``azure:day=tue`` day on the image app (spt, ``DAY_C_MAX``) in
    pages of ``chunk`` jobs; returns (result, wall seconds)."""
    import torch

    from repro_torch.core import APPS, simulate_scenarios

    t0 = time.perf_counter()
    out = simulate_scenarios(
        APPS["image"], None, workload=f"azure:day=tue,scale={scale}",
        c_max_grid=(DAY_C_MAX,), orders=("spt",), chunk_jobs=chunk,
        engine=engine, device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def cpu_day(scale, chunk, path):
    """``run_day`` on the CPU in a process of its own (one thread), the
    result fields saved to ``path``: the CPU run overlaps the card's."""
    import numpy as np
    import torch

    sys.path.insert(0, os.path.join(ROOT, "src"))
    torch.set_num_threads(1)
    out, wall = run_day(scale, chunk, device="cpu")
    np.savez(path, wall=wall,
             **{f: np.asarray(getattr(out, f)) for f in RESULT_FIELDS})


def report_day(label, scale, wall, counts):
    """Print a paged day's wall, rate, pages, body steps and launches;
    fails when ``acd_evict`` never launched in it."""
    from repro_torch.core import vectorsim

    stats = vectorsim._LAST_RUN_STATS
    pages = vectorsim._LAST_PAGE_STATS
    trips = stats["trips"]
    steps = sum(sum(t) for t in trips)
    print(f"{label} azure:day=tue,scale={scale}: {wall:.3f} s on the "
          f"card, {scale / wall:.1f} jobs/s, {pages['pages']} pages, "
          f"{pages['retries']} retries, {len(trips)} engine calls "
          f"(prep {stats['prep_s']:.3f} s, engine "
          f"{stats['engine_s']:.3f} s, finalize "
          f"{stats['finalize_s']:.3f} s), {steps} body steps, "
          f"{stats['engine_s'] * 1e3 / steps:.4f} ms per body step; "
          f"launches {counts}")
    print(f"{label}: body steps per stage per engine call {trips}")
    if counts["acd_evict"] <= 0:
        raise AssertionError(f"{label} never launched acd_evict")


def paged_day_phase():
    """A paged trace day on the card: ``azure:day=tue,scale=DAY_SCALE`` on
    the image app in pages of ``DAY_CHUNK`` jobs, against the port's DES
    on the host (same pages) under the parity contract; then a 4096-job
    day in 512-job pages bit for bit against the monolithic card run and
    the CPU (run meanwhile in a process of its own); a 1024-job day under
    the profiler. Returns the launch counts of both timed paged runs."""
    import multiprocessing
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        cpu_path = os.path.join(tmp, "cpu_day.npz")
        proc = multiprocessing.get_context("spawn").Process(
            target=cpu_day, args=(*SMALL_DAY, cpu_path))
        proc.start()
        try:
            return _paged_days(proc, cpu_path)
        finally:
            if proc.is_alive():
                proc.terminate()
            proc.join()


def _paged_days(proc, cpu_path):
    """The timed days of ``paged_day_phase``, the CPU's day running in
    ``proc`` meanwhile."""
    import types

    import numpy as np

    from repro_torch.core import vectorsim
    from repro_torch.kernels import ops

    day, report = run_day, report_day
    exact = ("public_mask", "provider", "replica", "segment", "start",
             "end", "completion", "n_offloaded_stages",
             "n_init_offloaded_jobs", "per_stage_offloads")
    ops.reset_launch_counts()
    big, wall = day(DAY_SCALE, DAY_CHUNK)
    counts = ops.launch_counts()
    report(f"paged day chunk_jobs={DAY_CHUNK}", DAY_SCALE, wall, counts)
    if not (np.isfinite(big.makespan).all() and np.isfinite(big.end).all()):
        raise AssertionError("paged day: non-finite result")
    des, d_wall = day(DAY_SCALE, DAY_CHUNK, device="cpu", engine="des")
    bad = [f for f in exact if not same(getattr(big, f), getattr(des, f))]
    bad += [f for f in ("cost_usd", "makespan")
            if not np.isclose(getattr(big, f), getattr(des, f), rtol=1e-12,
                              atol=0).all()]
    print(f"paged day DES on the host: {d_wall:.3f} s; offloaded stages "
          f"{int(big.n_offloaded_stages[0])} of {big.public_mask.size}, "
          f"makespan {float(big.makespan[0])!r} vs "
          f"{float(des.makespan[0])!r}, cost {float(big.cost_usd[0])!r} vs "
          f"{float(des.cost_usd[0])!r}")
    if bad:
        raise AssertionError(f"paged day: engine != DES in {bad}")

    scale, chunk = SMALL_DAY
    ops.reset_launch_counts()
    paged, wall = day(scale, chunk)
    small_counts = ops.launch_counts()
    report(f"paged day chunk_jobs={chunk}", scale, wall, small_counts)
    mono, m_wall = day(scale, None)
    t0 = time.perf_counter()
    proc.join()
    if proc.exitcode != 0:
        raise AssertionError(f"paged day: the CPU run exited "
                             f"{proc.exitcode}")
    with np.load(cpu_path) as z:
        cpu = types.SimpleNamespace(**{f: z[f] for f in RESULT_FIELDS})
        cpu_wall = float(z["wall"])
    print(f"paged day azure:day=tue,scale={scale}: monolithic on the card "
          f"{m_wall:.3f} s, paged on the CPU {cpu_wall:.3f} s (in its own "
          f"process, {time.perf_counter() - t0:.3f} s waited for it)")
    for other, name in ((mono, "the monolithic card run"), (cpu, "the CPU")):
        bad = [f for f in RESULT_FIELDS
               if not same(getattr(paged, f), getattr(other, f))]
        if bad:
            raise AssertionError(f"paged day scale={scale}: paged card run "
                                 f"!= {name} in {bad}")
    print(f"paged day scale={scale}: paged card run equal to the "
          f"monolithic card run and to the CPU in every field")
    scale, chunk = PROFILED_DAY
    _, wall = day(scale, chunk)
    steps = sum(sum(t) for t in vectorsim._LAST_RUN_STATS["trips"])
    got = device_profile("paged day", lambda: day(scale, chunk))
    if got is not None:
        busy_s, wall_p, dev_events = got
        n_events = sum(e.count for e in dev_events)
        print(f"profile paged day scale={scale} chunk_jobs={chunk}: device "
              f"busy {busy_s:.3f} s of a {wall_p:.3f} s profiled wall, "
              f"{1 - busy_s / wall_p:.3f} idle; of the unprofiled "
              f"{wall:.3f} s wall {1 - busy_s / wall:.3f} idle; "
              f"{n_events} device events, {n_events / steps:.1f} per body "
              f"step ({steps} steps)")
        print_top_events(dev_events)
    return counts, small_counts


def sched_stats(label, wall, n_scen, counts, policy_s=None):
    """Print one serving-scheduler part's wall, scenarios per second,
    policy time (``compare_policies``' record), engine calls, body steps,
    ms per body step (the engine's record of its last sweep) and kernel
    launches; fails when ``acd_evict`` never launched."""
    from repro_torch.core import vectorsim

    stats = vectorsim._LAST_RUN_STATS
    steps = sum(sum(t) for t in stats["trips"])
    per_step = stats["engine_s"] * 1e3 / steps if steps else float("nan")
    print(f"{label}: {n_scen} scenarios on {stats['device']} in {wall:.3f} s"
          f" ({n_scen / wall:.3f} scenarios/s; policy_s "
          f"{'n/a' if policy_s is None else f'{policy_s:.6f}'}, prep "
          f"{stats['prep_s']:.3f} s, engine {stats['engine_s']:.3f} s, "
          f"finalize {stats['finalize_s']:.3f} s), {len(stats['trips'])} "
          f"engine calls, {steps} body steps, {per_step:.4f} ms per body "
          f"step; launches {counts}")
    if counts["acd_evict"] <= 0:
        raise AssertionError(f"{label}: acd_evict never launched")


def check_contract(label, got, des, faulty=False, loaded=False):
    """A result (batched or one run) against the DES under the parity
    contract: placements, replicas, providers, segments, start, end and
    completion exact (attempts, failures and abandonment under faults;
    queue waits and cold flags under load); cost and makespan to a
    relative 1e-12."""
    import numpy as np

    exact = ("public_mask", "provider", "replica", "segment", "start",
             "end", "completion")
    if faulty:
        exact += ("attempts", "failed", "abandoned")
    if loaded:
        exact += ("queue_wait", "cold")
    bad = [f for f in exact if not same(getattr(got, f), getattr(des, f))]
    bad += [f for f in ("cost_usd", "makespan")
            if not np.allclose(getattr(got, f), getattr(des, f), rtol=1e-12,
                               atol=0)]
    if bad:
        raise AssertionError(f"{label}: engine != DES in {bad}")


def policy_comparison(sched, rate, J, device):
    """compare_policies at the bench's point on ``device`` (the DES when
    None); the report, the wall, the launch counts and the policy time."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.serving import policies

    rng = np.random.default_rng(0)  # bench_policies.build_stream
    plen, ntok = rng.integers(64, 2048, J), rng.integers(16, 256, J)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rep = sched.compare_policies(
        plen, ntok, SCHED_POLICIES, sla_s=SCHED_SLA_S,
        arrivals=f"poisson:{rate}", replan_every_s=SCHED_REPLAN_S,
        use_ridge=False, faults=list(SCHED_FAULTS),
        engine="vector" if device is not None else "des")
    if device == "cuda":
        torch.cuda.synchronize()
    return (rep, time.perf_counter() - t0, ops.launch_counts(),
            policies._LAST_POLICY_STATS["policy_s"])


def check_fig4_ordering(label, rep):
    """The bench's Fig.-4 ordering: hybrid at <= half the public spend with
    its attainment within 0.05 of public's and at or above private's, and
    the private pool at $0."""
    hyb, pub, priv = rep["skedulix"], rep["public"], rep["private"]
    ok = (hyb["cost_usd"] <= 0.5 * pub["cost_usd"]
          and hyb["sla"] >= pub["sla"] - 0.05
          and hyb["sla"] >= priv["sla"] - 1e-9
          and priv["cost_usd"] == 0.0)
    print(f"{label}: Fig.-4 ordering {'holds' if ok else 'BROKEN'}: hybrid "
          f"${hyb['cost_usd']:.6f} "
          f"({100 * hyb['cost_usd'] / max(pub['cost_usd'], 1e-12):.2f}% of "
          f"public ${pub['cost_usd']:.6f}) at SLA {hyb['sla']:.4f} (public "
          f"{pub['sla']:.4f}, private {priv['sla']:.4f})")
    if not ok:
        raise AssertionError(f"{label}: Fig.-4 ordering broken")


def serving_scheduler_phase():
    """The serving scheduler on the card: the policy comparison, congested
    online serving, the three frontiers and Alg. 1's initialization plan,
    each against the DES (and the comparison against the CPU), then the
    serving launcher in a process of its own. Returns the launch counts of
    each timed part."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import ColdStartModel, init_offload
    from repro_torch.kernels import ops
    from repro_torch.serving import (HybridServingScheduler,
                                     elastic_portfolio, pareto_mask,
                                     plan_batch_torch, spot_elastic_traces)

    t_phase = time.perf_counter()
    cfg = get_config(SCHED_ARCH)
    pf = elastic_portfolio(SCHED_PROVIDERS)
    sched = HybridServingScheduler(cfg, portfolio=pf, device="cuda")
    cpu = HybridServingScheduler(cfg, portfolio=pf, device="cpu")
    launches = {}

    # the set-up: the ridge fit on the card, against the CPU's
    t0 = time.perf_counter()
    pm = sched.fit_perf_models(n_train=256, seed=0)
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    feats = np.stack(build_serve_features(64), 1)
    got, want = pm.predict(feats), cpu.fit_perf_models(256, 0).predict(feats)
    rel = max(float(np.max(np.abs(got[k] - want[k])
                           / np.maximum(np.abs(want[k]), 1e-30)))
              for k in PRED_KEYS)
    lams = [(s.private.lam, s.public.lam) for s in pm.stages]
    print(f"serving scheduler: {SCHED_ARCH} ridge fit on 256 traces on the "
          f"card in {t_fit:.3f} s, lambdas {lams}; predictions against the "
          f"CPU fit max relative difference {rel!r}")
    if rel > PM_RTOL:
        raise AssertionError("serving scheduler: card fit != CPU fit")

    # the policy comparison: six policies x a fault axis, one sweep
    rng = np.random.default_rng(0)
    mean_s = sched.lat.latencies(rng.integers(64, 2048, SCHED_J),
                                 rng.integers(16, 256, SCHED_J),
                                 None)["P_private"].mean(axis=0)
    for rate in SCHED_RATES:
        label = f"serving policies poisson:{rate} J={SCHED_J}"
        load = rate * mean_s / sched.dag.replicas
        print(f"{label}: offered load per private stage (rate x mean "
              f"predicted latency / replicas) {np.round(load, 4).tolist()}")
        rep, wall, counts, policy_s = policy_comparison(sched, rate,
                                                        SCHED_J, "cuda")
        sched_stats(label, wall, int(rep.cost_usd.size), counts, policy_s)
        launches[label] = counts
        print(rep.table())
        check_fig4_ordering(label, rep)
        t0 = time.perf_counter()
        des, _, _, _ = policy_comparison(sched, rate, SCHED_J, None)
        for name, v, d in zip(rep.policies, rep.results, des.results):
            check_contract(f"{label} {name}", v, d, faulty=True)
        print(f"{label}: all {int(rep.cost_usd.size)} scenarios meet the DES "
              f"contract (DES on the host {time.perf_counter() - t0:.3f} s)")
    rate, J = SCHED_RATES[-1], SCHED_CPU_J
    small, _, _, _ = policy_comparison(sched, rate, J, "cuda")
    t0 = time.perf_counter()
    on_cpu, _, _, _ = policy_comparison(cpu, rate, J, "cpu")
    bad = [f"{name} {f}" for name, g, c in zip(
        small.policies, small.results, on_cpu.results)
        for f in RESULT_FIELDS if not same(getattr(g, f), getattr(c, f))]
    bad += [f for f in ("cost_usd", "sla", "makespan", "offload_frac",
                        "abandoned_frac")
            if not same(getattr(small, f), getattr(on_cpu, f))]
    print(f"serving policies poisson:{rate} J={J}: rerun on the CPU in "
          f"{time.perf_counter() - t0:.3f} s")
    if bad:
        raise AssertionError(f"serving policies J={J}: cuda != cpu in {bad}")
    print(f"serving policies poisson:{rate} J={J}: cuda and cpu results "
          f"equal in every field")

    # congested online serving: caps, cold starts, queue-wait telemetry
    rng = np.random.default_rng(1)
    plen, ntok = rng.integers(64, 2048, ONLINE_J), rng.integers(16, 256,
                                                                ONLINE_J)
    cs = ColdStartModel(warm_up_s=LOAD_WARM_UP_S,
                        keep_alive_s=2.0 * LOAD_WARM_UP_S, scale_to_zero=True)
    okw = dict(sla_s=SCHED_SLA_S, replan_every_s=SCHED_REPLAN_S,
               use_ridge=False, concurrency=LOAD_CAP, coldstart=cs,
               stage_queue_waits=[np.array(q) for q in ONLINE_QUEUE_WAITS])
    arr = f"poisson:{ONLINE_RATE}"
    label = f"serving online {arr} J={ONLINE_J} congested"
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    on = sched.serve_online(plen, ntok, arr, **okw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    sched_stats(label, wall, 1, counts)
    launches[label] = counts
    r = on.result
    n_wait = int((np.nan_to_num(r.queue_wait) > 0).sum())
    summ = on.summary()
    print(f"{label}: offload {summ['offload_frac']:.4f}, SLA "
          f"{summ['sla_attainment']:.4f}, cost {summ['cost_usd']!r} USD, "
          f"p95 latency {summ['p95_latency_s']:.3f} s, {n_wait} queue "
          f"waits (total {float(np.nansum(r.queue_wait)):.3f} s), "
          f"{int(r.cold.sum())} cold starts")
    if counts["fifo_dispatch"] <= 0 or not n_wait or not r.cold.any():
        raise AssertionError(f"{label}: fifo_dispatch, queue waits or cold "
                             f"starts missing")
    t0 = time.perf_counter()
    des = sched.serve_online(plen, ntok, arr, engine="des", **okw)
    check_contract(label, r, des.result, loaded=True)
    print(f"{label}: meets the DES contract (DES on the host "
          f"{time.perf_counter() - t0:.3f} s)")

    # the frontiers: pod sizings, spot markets, fault rates x deadlines
    rng = np.random.default_rng(1)  # bench_hybrid_serving.py's stream
    plen, ntok = rng.integers(128, 4096, FRONTIER_J), rng.integers(
        32, 512, FRONTIER_J)
    tot = float(sched.lat.latencies(plen, ntok, None)["P_private"].sum()
                / sched.dag.replicas.sum())
    grid = tuple(tot * f for f in FRONTIER_DEADLINES)
    traces = spot_elastic_traces(SCHED_PROVIDERS, horizon_s=tot)
    frontiers = (
        ("autoscale", "autoscale_frontier",
         [np.array(c) for c in AUTOSCALE_GRID], "replicas"),
        ("spot", "spot_frontier", traces, "trace_idx"),
        ("reliability", "reliability_frontier", list(RELIABILITY_RATES),
         "fault_idx"))
    for name, method, axis, idx in frontiers:
        label = f"serving {name} frontier J={FRONTIER_J}"
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        fr = getattr(sched, method)(plen, ntok, axis, grid, use_ridge=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        sched_stats(label, wall, fr.num_scenarios, counts)
        launches[label] = counts
        cost = fr.total_usd if name == "autoscale" else fr.cost_usd
        front = fr.frontier()
        c, q = cost[front], fr.sla[front]
        dominated = [i for i in range(len(front))
                     if ((c <= c[i]) & (q >= q[i])
                         & ((c < c[i]) | (q > q[i]))).any()]
        if not (len(front) and not dominated and same(
                fr.pareto, pareto_mask(cost, fr.sla))):
            raise AssertionError(f"{label}: bad Pareto mask")
        print(f"{label}: {fr.num_scenarios} scenarios, {len(front)} on the "
              f"frontier (mutually non-dominated)")
        print(fr.table())
        # three scenarios against the DES: the first three axis entries at
        # the second deadline (the whole market and fault axes: a failure
        # rate's draws are seeded by its index in the axis)
        sub = axis[:3]
        t0 = time.perf_counter()
        des = getattr(sched, method)(plen, ntok, sub, grid[1:2],
                                     use_ridge=False, engine="des")
        for s in range(des.num_scenarios):
            key = np.asarray(getattr(des, idx)[s])
            hit = [i for i in range(fr.num_scenarios)
                   if same(np.asarray(getattr(fr, idx)[i]), key)
                   and fr.c_max[i] == des.c_max[s]]
            if len(hit) != 1:
                raise AssertionError(f"{label}: DES scenario {s} not found")
            check_contract(f"{label} scenario {hit[0]}",
                           fr.result.scenario(hit[0]),
                           des.result.scenario(s),
                           faulty=name == "reliability")
        print(f"{label}: {des.num_scenarios} scenarios meet the DES contract "
              f"(DES on the host {time.perf_counter() - t0:.3f} s)")

    # Alg. 1's initialization plan on the card, against numpy's
    pred, _ = sched._pred_act(*build_serve_features(PLAN_J), seed=1,
                              use_ridge=False)
    P = pred["P_private"]
    keys = P.sum(1)
    for frac in (0.1, 0.5, 0.9):
        cap = float(P.sum() * frac)
        t0 = time.perf_counter()
        mask = plan_batch_torch(torch.from_numpy(P).to(sched.device),
                                torch.from_numpy(keys).to(sched.device),
                                cap)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        want = init_offload(P.sum(1), keys, cap)
        print(f"serving plan_batch_torch J={PLAN_J} capacity {frac} of the "
              f"work: {int(mask.sum())} offloaded, {wall * 1e3:.3f} ms")
        if not same(mask.cpu().numpy(), want):
            raise AssertionError("plan_batch_torch != numpy init_offload")

    # the serving launcher, in a process of its own
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         SCHED_ARCH, "--requests", "64", "--execute-smoke"],
        capture_output=True, text=True, timeout=600, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
    print(proc.stdout.rstrip())
    print(f"serving launcher: exit {proc.returncode} in "
          f"{time.perf_counter() - t0:.3f} s")
    if proc.returncode != 0:
        print(proc.stderr[-4000:], file=sys.stderr)
        raise AssertionError("python -m repro_torch.launch.serve failed")
    print(f"serving scheduler: phase wall {time.perf_counter() - t_phase:.3f}"
          f" s")
    return launches


def build_serve_features(J):
    """(prompt lengths, new tokens) of ``J`` requests, seeded: the ranges of
    the launcher and bench_hybrid_serving.py."""
    import numpy as np

    rng = np.random.default_rng(2)
    return rng.integers(128, 4096, J), rng.integers(32, 512, J)


def fig3_part(run):
    """Fig. 3's quick pass on the card's video profile: the appendix MILP
    (HiGHS, host) on the first ``FIG3_JOBS`` test jobs at the bench's
    deadline against SPT and HCF greedy schedules swept on the card
    (``acd_evict``), each equal to the DES. Prints the cost ratios.
    Returns the sweep's launch counts."""
    import torch

    from repro_torch.core import simulate_all_public, solve_milp
    from repro_torch.kernels import ops

    spec, sched = run["spec"], run["sched"]
    J = FIG3_JOBS
    pred_all = run["pm"].predict(run["te"]["base_features"])
    p = {k: pred_all[k][:J] for k in PRED_KEYS}
    a = {k: v[:J] for k, v in run["act"].items()}
    pub = simulate_all_public(spec.dag, p, a)
    priv_time = p["P_private"].sum() / spec.dag.replicas.sum()
    c_max = float(max(priv_time * 0.75, pub.makespan * 1.3))
    t0 = time.perf_counter()
    m = solve_milp(spec.dag, a["P_private"], a["P_public"], c_max,
                   a["upload"], a["download"], time_limit_s=FIG3_TIME_LIMIT_S)
    t_milp = time.perf_counter() - t0
    print(f"fig3 video J={J}: C_max {c_max:.3f} s; MILP status {m.status}, "
          f"feasible {m.feasible}, cost {m.cost_usd!r} USD, bound "
          f"{m.objective_bound!r}, gap {m.mip_gap:.4f}, {t_milp:.3f} s on "
          f"the host (limit {FIG3_TIME_LIMIT_S} s); all-public cost "
          f"{pub.cost_usd!r} USD, makespan {pub.makespan:.3f} s")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    sweep = sched.schedule_sweep([c_max], pred=p, act=a, orders=ORDERS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    for s, order in enumerate(sweep.orders):
        g = sweep.scenario(s)
        d = sched.schedule(c_max, pred=p, act=a, order=order).result
        check_contract(f"fig3 video {order}", g, d)
        ratio = (f"{g.cost_usd / m.cost_usd:.3f}x the MILP's"
                 if m.feasible and m.cost_usd > 0 else "the MILP's is 0")
        print(f"fig3 video {order.upper()}: cost {float(g.cost_usd)!r} USD "
              f"({ratio}), makespan {float(g.makespan):.3f} s, met "
              f"{bool(g.met_deadline)}; equal to the DES")
        if m.feasible and g.met_deadline and \
                g.cost_usd < m.objective_bound - 1e-9:
            raise AssertionError(f"fig3 video {order}: greedy below the "
                                 f"MILP's lower bound")
    print(f"fig3 video: 2 greedy schedules on the card in {wall:.3f} s; "
          f"launches {counts}")
    if counts["acd_evict"] <= 0:
        raise AssertionError("fig3: acd_evict never launched")
    return counts


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
    7 Dk Dv: see csrc/rwkv6.cu and ``rwkv6_term_floor``)."""
    n_bytes = (B * H * T * (2 * Dk + 2 * Dv) * itemsize
               + B * H * T * Dk * 4 + H * Dk * 4
               + (2 if with_s0 else 1) * B * H * Dk * Dv * 4)
    n_ops = B * H * T * (5 * Dk * Dv + 3 * Dk + 2 * Dv)
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / PEAK_OPS_PER_S["float32"] * 1e3
    return (max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations", n_bytes, n_ops)


def rwkv6_term_floor(B, H, T, Dk, Dv):
    """The kernel's own floor in ms: its 7 rounded float32 operations per
    state element and step (none fused, so one per lane and clock: half
    the 67 TFLOP/s peak, which counts a fused multiply-add as two)."""
    return 7 * Dk * Dv * B * H * T / (PEAK_OPS_PER_S["float32"] / 2) * 1e3


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
    and in float32 from a nonzero s0, at the long batch's [2, 32, 4096,
    64] (whose plan splits each head's columns over two blocks), at a
    float32 [1, 32, 300, 64] from s0 (split over four), and at the shapes
    the serve phase gives it in bf16 (its prefill, T = the longest prompt,
    from zeros and from a nonzero s0, and a decode step, T = 1, from a
    nonzero s0). S_T bit for bit; o within the float32 rounding of two
    summation orders over k, 2 (Dk - 1) 2^-24 sum_k |terms|, plus one bf16
    ulp of the value in bf16, and bit for bit equal to
    ``ref.rwkv6_ordered`` (the kernel's stated order) at the
    timed and the split shapes. Then its time by CUDA events and by
    profiler device time at four shapes ([8, 32, 2048, 64], the long
    batch's prefill, the serve prefill and the decode step), each beside
    the bound and the kernel's term floor, and the plain version's time.
    Returns its entry of the kernels line."""
    import importlib

    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import rwkv6_ordered, rwkv6_plain

    # the module, not the package's ``rwkv6`` wrapper of the same name
    rk = importlib.import_module("repro_torch.kernels.rwkv6")

    g = torch.Generator(device=dev).manual_seed(22)
    H, Dk = 32, 64
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count

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

    def against_plain(label, args, ordered=False):
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
        ok_m = True
        if ordered:
            ok_m = torch.equal(o, rwkv6_ordered(*args)[0])
        B, _, T, _ = args[0].shape
        print(f"rwkv6 {list(args[0].shape)} {label}, plan "
              f"{tuple(rk.launch_plan(B, H, Dk, n_sm))}: o max_abs_err "
              f"{float(err.max())!r} (at most {float((err / bound).max()):.3f}"
              f" of its bound), S_T bitwise equal to the plain version "
              f"{ok_s}"
              + (f", o bitwise equal to ref.rwkv6_ordered {ok_m}"
                 if ordered else "") + f"; o strides {o.stride()}")
        if not (ok_o and ok_s and ok_m):
            raise AssertionError(f"rwkv6 {label}: kernel != plain version")
        return float(err.max())

    B, T = 8, 2048
    timed = inputs(B, T, torch.bfloat16, False)
    long_in = inputs(LONG_BATCH, LONG["rwkv6-1.6b"][0], torch.bfloat16,
                     False)
    max_err = max(against_plain("bf16", timed, ordered=True),
                  against_plain("f32 from s0",
                                inputs(B, T, torch.float32, True)),
                  against_plain("long batch bf16", long_in, ordered=True),
                  against_plain("f32 from s0, columns split",
                                inputs(1, 300, torch.float32, True),
                                ordered=True))
    S = longest_prompt("rwkv6-1.6b")
    serve_in = {}
    for label, T_serve, with_s0 in (("serve prefill bf16", S, False),
                                    ("serve prefill bf16 from s0", S, True),
                                    ("serve decode bf16 from s0", 1, True)):
        serve_in[label] = inputs(SERVE_REQUESTS, T_serve, torch.bfloat16,
                                 with_s0)
        max_err = max(max_err, against_plain(label, serve_in[label]))
    shapes = []
    for label, args, reps in (
            ("rwkv6-1.6b", timed, 10),
            ("long batch prefill", long_in, 10),
            ("serve prefill", serve_in["serve prefill bf16"], 50),
            ("decode step from s0", serve_in["serve decode bf16 from s0"],
             200)):
        Bs, _, Ts, _ = args[0].shape
        ev = cuda_ms(lambda: ops.rwkv6(*args), reps)
        dv = device_ms(lambda: ops.rwkv6(*args), reps)[0]
        bound, by, n_bytes, n_ops = rwkv6_bound(Bs, H, Ts, Dk, Dk, 2,
                                                args[5] is not None)
        floor = rwkv6_term_floor(Bs, H, Ts, Dk, Dk)
        plan = rk.launch_plan(Bs, H, Dk, n_sm)
        print(f"rwkv6 {label} [{Bs}, {H}, {Ts}, {Dk}] bf16, plan "
              f"{tuple(plan)}: kernel {ev:.6f} ms by events, {dv:.6f} ms of "
              f"device time; bound {bound:.6f} ms by {by} (bytes {n_bytes}, "
              f"operations {n_ops}), term floor {floor:.6f} ms (7 rounded "
              f"operations per state element at half the float32 peak); "
              f"device time at {bound / dv:.3f} of the bound, "
              f"{floor / dv:.3f} of the term floor")
        shapes.append({"label": label, "shape": [Bs, H, Ts, Dk],
                       "plan": list(plan), "ms": ev,
                       "device_ms": finite(dv), "bound_ms": bound,
                       "bound_by": by, "term_floor_ms": floor})
    k_ms = shapes[0]["ms"]
    p_ms = cuda_ms(lambda: rwkv6_plain(*timed), 1)
    bound, by, n_bytes, n_ops = rwkv6_bound(B, H, T, Dk, Dk, 2, False)
    print(f"rwkv6 [{B}, {H}, {T}, {Dk}] bf16: kernel {k_ms:.6f} ms "
          f"({n_ops / k_ms * 1e-9:.3f} TFLOP/s of the function's "
          f"operations), plain {p_ms:.3f} ms, bound {bound:.6f} ms by {by};"
          f" kernel at {bound / k_ms:.3f} of the bound")
    return {"name": "rwkv6", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/rwkv6.cu",
            "replaces": "src/repro/kernels/rwkv6.py:56",
            "max_abs_err": max_err, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": None,
            "device_ms": shapes[0]["device_ms"],
            "term_floor_ms": shapes[0]["term_floor_ms"], "shapes": shapes}


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
              ("f32 causal D=160", 2, 8, 2, 97, 97, 160, True, None, f32),
              ("D=36 (rows not 16-byte aligned: plain loads)", 2, 4, 2,
               150, 700, 36, True, None, bf16),
              ("sq < sk across chunks, window", 2, 16, 1, 300, 1300, 256,
               True, 700, bf16)]
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
    from repro_torch.kernels.flash_decode import blocks as fd_blocks
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
              ("f32 one slot", 3, 4, 4, 1, 64, f32, None, None),
              # the bf16 kernel's chunks: live keys across 256-position
              # boundaries, plain and rolled, G = 4, 12, 16
              ("bf16 across chunks, mixed lengths", 8, 32, 8, 1100, 128,
               bf16, None, None),
              ("bf16 across chunks, rolled cache", 4, 48, 4, 900, 128,
               bf16, 900, 2345),
              ("bf16 MQA G=16 across chunks, rolled cache", 2, 16, 1, 2048,
               256, bf16, 2048, 4000),
              ("bf16 D=36 (plain loads), mixed lengths", 8, 8, 2, 600, 36,
               bf16, None, None)]
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
                launched, working = fd_blocks(length, end, S, hq, hkv)
                kd_ms, k_events = device_ms(
                    lambda: ops.flash_decode(q, k, v, length, end), 20)
                ld_ms, _ = device_ms(lambda: F.scaled_dot_product_attention(
                    q4, k, v, attn_mask=mask, enable_gqa=True), 20)
                print(f"flash_decode {arch} [{B}, {hq}/{hkv}, {S}, {d}] "
                      f"device time per call: kernel {kd_ms:.6f} ms ("
                      + ", ".join(f"{name[:40]} {t:.6f}"
                                  for name, t in k_events.items())
                      + f"), scaled_dot_product_attention {ld_ms:.6f} ms")
                print(f"flash_decode {arch} q [{B}, {hq}, {d}], cache [{B}, "
                      f"{hkv}, {S}, {d}] bf16, length {n_live}, end {last}: "
                      f"kernel "
                      f"{k_ms:.6f} ms ({n_bytes / k_ms * 1e-9:.3f} TB/s), "
                      f"{working} working blocks of a grid of {launched} on "
                      f"{n_sm} SMs, plain {p_ms:.6f} ms, "
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
    bitwise = torch.equal(dec, full)
    print(f"serve {label}: logits {tuple(logits.shape)} finite {finite}; "
          f"the engine's first tokens are the prefill's argmax {same_first};"
          f" {model.cfg.dtype} {line}; max gap {gap!r} of the logits' scale;"
          f" bitwise equal {bitwise}")
    # in bf16 every kernel and row mean keeps one order per row whatever
    # the length, so the decode step is prefill(S+1)'s bits
    if not (finite and same_first and ok
            and (bitwise or model.cfg.dtype != "bfloat16")):
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
        ok = (ok and not bool(bad.any()) and bool(torch.isfinite(d).all())
              and torch.equal(dec, full))  # bf16: bit for bit
        readings.append(f"{int(bad.sum())} beyond (max abs diff "
                        f"{float((d - f).abs().max())!r}, bitwise equal "
                        f"{torch.equal(dec, full)})")
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
    # "matmul" sums both dtypes; "matmul_f32" is the norms' row means
    kern = {k: sum(e.self_device_time_total for e in dev_events
                   if k in e.key) * 1e-6
            for k in ("rwkv6", "rglru", "matmul", "matmul_f32",
                      "flash_attention", "flash_decode")}
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
    # a reading, not a gate: the plain product, the norms' row means and
    # the plain attention versions (fixed key tiles and chunks, fixed
    # [PLAIN_ROWS, D] products) sum each row as the row alone would
    cpu = Model(dataclasses.replace(cfg, dtype="bfloat16",
                                    kv_dtype="bfloat16"), device="cpu")
    cpu.load_state_dict(card.state_dict())
    t0 = time.perf_counter()
    _, dec, full, _, line, _ = incremental_gap(cpu, toks, SERVE_CACHE)
    print(f"serve {arch} at {cfg.num_layers} layers, bf16 on the CPU "
          f"({time.perf_counter() - t0:.3f} s): {line}; bitwise equal "
          f"{torch.equal(dec, full)}")
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
    from repro_torch.kernels.acd_sweep import chain_step_latency
    from repro_torch.kernels.fifo import \
        chain_step_latency as fifo_chain_step_latency
    from repro_torch.kernels.ref import acd_evict_plain, fifo_dispatch_plain

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    t_lap = [t_start]

    def lap(name):
        """Print the wall since the previous phase ended."""
        now = time.perf_counter()
        print(f"phase wall {name}: {now - t_lap[0]:.1f} s")
        t_lap[0] = now

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

    lap("1 environment and build")
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

    def edit_case(B, J, edit):
        """The compaction's edge inputs, at a mask share of 0.8."""
        P, thresh, mask = (a.cpu().numpy() for a in random_case(B, J, f64))
        if edit == "runs":  # stretches of unmasked jobs, across tiles
            for lo in range(0, J, 1500):
                mask[:, lo:lo + 1000] = False
        elif edit == "zeros":
            P[:, ::3] = 0.0
            P[:, 1::3] = -0.0
        else:
            thresh[:, ::5] = np.inf
            thresh[:, 1::5] = -np.inf
            thresh[:, 2::5] = np.nan
        return tuple(torch.from_numpy(a).to(dev) for a in (P, thresh, mask))

    cases = [
        ("main-path f64 [30, 4096]", random_case(30, 4096, f64), True),
        ("main-path f64 [30, 512]", random_case(30, 512, f64), True),
        ("f32 [30, 4096]", random_case(30, 4096, f32), True),
        ("ragged f64 [7, 1000]", random_case(7, 1000, f64), True),
        ("ragged f32 [5, 4097]", random_case(5, 4097, f32), True),
        ("ragged f64 [3, 1]", random_case(3, 1, f64, 1.0), False),
        ("empty mask f64 [4, 300]", random_case(4, 300, f64, 0.0), False),
        ("near ties f64 [9, 2049]", near_tie_case(9, 2049), True),
        ("mask share 0.05 f64 [30, 4096]",
         random_case(30, 4096, f64, 0.05), None),
        ("mask share 0.5 f64 [30, 4096]", random_case(30, 4096, f64, 0.5),
         True),
        ("mask share 1 f64 [30, 4096]", random_case(30, 4096, f64, 1.0),
         True),
        ("long unmasked runs f64 [8, 8192]", edit_case(8, 8192, "runs"),
         True),
        ("zero and -0.0 demands f64 [8, 2049]",
         edit_case(8, 2049, "zeros"), True),
        ("+-inf and NaN thresholds f64 [8, 2049]",
         edit_case(8, 2049, "nonfinite"), True),
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
        if evicts is not None and evicts != bool(got.any()):
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
    step_clk, step_ns = chain_step_latency()
    floor_ms = chain_floor_ms(mask, step_ns)
    print(f"acd_evict [{B}, {J}] f64: kernel {k_ms:.6f} ms "
          f"({k_ms * 1e6 / J:.3f} ns per job of a row), "
          f"plain {p_ms:.3f} ms, bound {bound_ms:.6f} ms "
          f"(bytes {n_bytes} -> {bytes_ms:.6f} ms, ops {n_ops} -> "
          f"{ops_ms:.6f} ms); chain floor {floor_ms:.6f} ms (the longest "
          f"row's {int(mask.sum(1).max())} masked jobs x {step_ns:.4f} ns, "
          f"{step_clk:.2f} SM clocks, per dependent float64 step: "
          f"acd_chain_step_probe), kernel at {floor_ms / k_ms:.3f} of it")
    kernels = [{
        "name": "acd_evict", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/acd_evict.cu",
        "replaces": "src/repro/kernels/acd_sweep.py:44",
        "max_abs_err": float(max_err), "ms": k_ms, "plain_ms": p_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None, "chain_floor_ms": floor_ms,
        "step_ns": step_ns}]

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
    fstep_clk, fstep_ns = fifo_chain_step_latency()
    f_floor_ms = fifo_floor_ms(args[1], fstep_ns)
    fk_dev = device_ms(lambda: ops.fifo_dispatch(*args, KA, cold=True),
                       20)[0]
    print(f"fifo_dispatch [{B}, {P}, {J}, {C}] cold, n_pub=J: kernel "
          f"{fk_ms:.6f} ms by events, {fk_dev:.6f} ms of device time "
          f"({fk_ms * 1e6 / J:.3f} ns per chain step), plain on the card "
          f"{fp_ms:.3f} ms, bound {f_bound_ms:.6f} ms (bytes {f_bytes} -> "
          f"{f_bytes_ms:.6f} ms, ops {f_ops} -> {f_ops_ms:.6f} ms); chain "
          f"floor {f_floor_ms:.6f} ms (the longest row's "
          f"{int(args[1].max())} chain steps x {fstep_ns:.4f} ns, "
          f"{fstep_clk:.2f} SM clocks, per dependent step of the 3 x 2 "
          f"cold pool: fifo_chain_step_probe), kernel at "
          f"{f_floor_ms / fk_ms:.3f} of it")
    kernels.append({
        "name": "fifo_dispatch", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fifo_dispatch.cu",
        "replaces": "src/repro/kernels/dispatch.py:90",
        "max_abs_err": fifo_err, "ms": fk_ms, "plain_ms": fp_ms,
        "bound_ms": f_bound_ms,
        "bound_by": "bytes" if f_bytes_ms >= f_ops_ms else "operations",
        "library_ms": None, "device_ms": finite(fk_dev),
        "chain_floor_ms": f_floor_ms, "step_ns": fstep_ns})

    lap("2 kernels against their plain versions")
    # -- 3. the uncapped main path ----------------------------------------
    def run_path(label, J, tasks, sweep_kw, check=check_sweep):
        """One sweep on the card, with the launch counts set to 0 just
        before it and read just after it."""
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out = sweep_scenarios(tasks, device="cuda", **sweep_kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        stats = vectorsim._LAST_RUN_STATS
        n_scen = sum(r.num_scenarios for r in out)
        print(f"{label} J={J}: {n_scen} scenarios on {stats['device']} in "
              f"{wall:.3f} s (prep {stats['prep_s']:.3f} s, engine "
              f"{stats['engine_s']:.3f} s, finalize "
              f"{stats['finalize_s']:.3f} s); body steps per stage "
              f"{stats['trips']}; launches {counts}")
        check(f"{label} J={J}", tasks, out, J)
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
    # the engine's own mask share, and the kernel's time at it
    share, kept = acd_mask_share(fig4_workload(APPS, max(MAIN_J)),
                                 max(MAIN_J))
    kernels[0]["engine_mask_share"] = share
    # the kernel on the engine's own inputs, by device time: the calls
    # kept from the counting pass, each launched once per profiled pass
    for P, thresh, mask in kept:
        if not torch.equal(ops.acd_evict(P, thresh, mask),
                           acd_evict_plain(P, thresh, mask)):
            raise AssertionError("acd_evict on the engine's inputs: "
                                 "kernel != plain")
    e_dev = device_ms(lambda: [ops.acd_evict(*c) for c in kept], 20)[0]
    e_dev /= len(kept)
    e_floor = sum(chain_floor_ms(c[2], step_ns) for c in kept) / len(kept)
    e_rows = [int(c[2].sum(1).max()) for c in kept]
    print(f"acd_evict on {len(kept)} of the engine's own calls "
          f"{list(kept[0][0].shape)} (every 1000th of the counting pass): "
          f"bitwise equal to the plain version; device {e_dev:.6f} ms a "
          f"call on average, chain floor {e_floor:.6f} ms on average "
          f"(longest rows {e_rows} masked jobs), kernel at "
          f"{e_floor / e_dev:.3f} of its floor")
    kernels[0]["engine_calls_device_ms"] = finite(e_dev)
    kernels[0]["engine_calls_chain_floor_ms"] = e_floor
    for J in MAIN_J:
        for p_mask in (share, 0.8):
            P, thresh, mask = random_case(30, J, f64, p_mask)
            t_ms = cuda_ms(lambda: ops.acd_evict(P, thresh, mask), 50)
            print(f"acd_evict [30, {J}] f64 at mask share {p_mask:.4f}: "
                  f"kernel {t_ms:.6f} ms, chain floor "
                  f"{chain_floor_ms(mask, step_ns):.6f} ms")

    lap("3 uncapped main path")
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
    # the kernel on the engine's own inputs: every call of one more sweep
    # of the J=4096 grid, kept (the timed sweeps above ran unwrapped)
    kernels[1]["engine_calls"] = fifo_engine_calls(
        [(max(MAIN_J), c) for c in keep_fifo_calls(louts[max(MAIN_J)][0],
                                                   load_kw)], fstep_ns)

    lap("4 congested main path")
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

    lap("5 pool trace")
    # -- 6. the engine's other options: the scenario axes -----------------
    launches.update(scenario_axes_phase(run_path, load_kw))
    lap("6 scenario axes")
    # -- 6b. the fault axis: the attempt chain -----------------------------
    launches["faults"] = faults_phase(run_path)
    lap("6b faults")
    # -- 6c. a paged trace day -----------------------------------------------
    launches["day"], launches["small day"] = paged_day_phase()
    lap("6c paged day")
    # -- 6d. the serving scheduler -------------------------------------------
    launches.update(serving_scheduler_phase())

    lap("6d serving scheduler")
    # -- 7. the profiling path: profile -> predict -> schedule -------------
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
    # Fig. 3 of the serving-scheduler phase, on the video profile's jobs
    launches["fig3"] = fig3_part(profiled["video"])
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

    lap("7 profiling path and Fig. 3")
    # -- 8. the serving path: the model stack's kernels ---------------------
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

    lap("8 serving path")
    # -- 9. result ------------------------------------------------------------
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
    # and on the paths of the engine's other options, each counted in its
    # own timed run
    for name in ("acd_evict", "fifo_dispatch"):
        by_name[name]["path_launches"] = {
            (k if isinstance(k, str) else f"{k[0]} J={k[1]}"): c[name]
            for k, c in launches.items()
            if k != "profile" and c.get(name, 0) > 0}
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
