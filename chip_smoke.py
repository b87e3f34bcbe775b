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
   ``sweep_scenarios`` call on ``cuda`` at J=512 jobs. The grid
   at J=64 runs on the card and on the CPU and must agree field for
   field; three scenarios of the timed grid replay
   through the port's DES and must meet the parity contract (placements,
   replicas, providers, segments, start and end exact; cost and makespan
   to a relative 1e-12). The J=512 sweep then runs once more under
   ``torch.profiler`` to split its wall time into device-busy and idle,
   and the grid once more at J=512 (``SIDE_J``) to count the share of
   masked jobs the engine gives ``acd_evict`` (``acd_mask_share``); the
   kernel is timed at that share and at 0.8, at J=512, and by
   device time on every 125th of the engine's own calls, kept from that
   pass, beside their chain floor.
4. The congested main path: the same grid on a 3-provider portfolio with
   2-slot concurrency caps per provider and a 0.5 s warm-up / 1 s
   keep-alive scale-to-zero cold-start model (the throughput benchmark's
   ``--coldstart 0.5`` point), at J=512 on ``cuda``. Queue waits
   and cold starts must occur; the J=64 grid agrees between the card and
   the CPU field for field; three scenarios of the timed grid meet the
   DES contract, queue waits and cold flags exact; the J=512 sweep runs
   once more under the profiler. One more, untimed sweep of the grid at
   J=512 (``SIDE_J``) keeps the inputs of its every ``fifo_dispatch``
   call, and each is then held against its plain version and timed by
   CUDA events beside its chain floor.
5. A pool trace (one private replica per stage, two from a breakpoint
   inside the horizon) with the cold-start model, J=512 on ``cuda``; three
   of its scenarios meet the DES contract, and the J=64 grid agrees
   between the card and the CPU field for field.
6. The engine's other options, each path timed with its launch counts
   set to 0 just before it. Scenario axes: the Fig.-4 grid as five tasks
   mixing per-task flags (ACD-adaptive, ``adaptive=False``,
   ``init_phase=False``, an ``offload_mask``, an ``init_window`` over a
   release stream) in one ``sweep_scenarios`` call at J=512,
   uncapped and then with ``egress_lookahead`` under the congested load;
   faults: the Fig.-4 grid at J=512 on the 3-provider portfolio with a
   failure-rate axis (0, 0.1, 0.3) under the default ``RetryPolicy``
   (failures, retries, and an abandonment or a fallback must occur); each
   against the DES on some scenarios and the CPU at J=64, ``acd_evict``
   launched in each, ``fifo_dispatch`` in the capped one. A paged trace
   day: ``azure:day=tue,scale=8192`` on the image app, spt, C_max 60 s,
   4096-job pages (the reference throughput benchmark's streaming point),
   against the DES on the host under the parity contract, with wall,
   jobs/s, pages, retries, body steps and ms per body step; then a
   512-job day in 256-job pages bit for bit against the monolithic card
   run and the CPU, and the same day again under the profiler. The serving
   scheduler (llama3-8b on a 2/4/2 pod with ``elastic_portfolio(3)``
   overflow, the H100 latency model): the ridge fit on the card against
   the CPU's; ``compare_policies`` (six policies x faults {none, 0.3}) at
   the policy bench's ``--jobs 512`` point, at its ``poisson:8.0`` and at
   ``poisson:32.0`` (the bench's load on the H100's faster pod), each
   against the DES in every scenario and the bench's Fig.-4 ordering, and
   at J=128 against the CPU field for field; ``serve_online`` over 1024
   requests at 32/s under 2-slot caps, cold starts and three queue-wait
   samples (queue waits, cold starts and ``fifo_dispatch`` must occur)
   against the DES; the autoscaling (8 pod sizings), spot (3 markets) and
   reliability (rates 0, 0.1, 0.3) frontiers over 4 deadlines at J=512,
   each's Pareto mask and three scenarios against the DES;
   ``plan_batch_torch`` at J=4096 bit for bit numpy's ``init_offload``;
   ``python -m repro_torch.launch.serve --execute-smoke`` in a process of
   its own. Each part prints its wall, scenarios per second, policy time,
   engine calls, body steps, ms per body step and launches. The engine
   twins: the Fig.-4 grid at J=256 (``TWINS_J``), uncapped and congested,
   under each
   inner loop (``engine_impl`` ``kernel``, ``scan`` and ``loop``) on the
   card, equal field for field, the twins with no kernel launched, each
   with its wall, body steps and ms per body step; their DES scenarios
   under the contract and their J=64 grids against the CPU; how many of
   the ``scan`` twin's prefix elements ``torch.cumsum`` on the card would
   give otherwise than the host's sequential sum (a reading, over its
   first 1000 ACD rounds); and a repeated ``kernel`` sweep that hits the
   prep cache (``prep_s``, ``plan_s``).
7. The paper's profile -> predict -> schedule path. First ``matmul``
   against its plain version on the card (ragged shapes, transposed views,
   1024^3, bf16, the MoE routers' float32 [tokens, d] @ [d, E] at phase
   8c's token counts; the matrix app's integer ``x @ x.T`` at n = 344 and
   496 bit for bit, also against the CPU; every float32 configuration forced
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
   against prefill(S+1)). Before the serve batches, ``flash_decode`` on
   float8_e4m3fn caches (cast by ``layers.to_kv``, a few elements past 448
   so that NaNs occur) at qwen1.5-32b's decode shapes, bf16 and float32 q,
   each bit for bit the kernel on the widened caches and within tolerance
   of the plain version, timed at [2, 40, 4112, 128] beside the bf16
   kernel and SDPA on the widened caches; and ``to_kv`` on the card equal
   to the CPU's on all 65,536 bf16 patterns and a float32 sample.
   8b. qwen1.5-32b at full width and 64 layers, its bf16 weights drawn on
   the card (no other model resident; the memory reckoning and
   ``mem_get_info`` printed first), its fp8 cache: the serve batch and a
   2 x 1024-token long batch (cache 1040), launches exact, logits finite,
   first tokens the prefill's argmax, peak memory, and prefill(S) +
   decode_step against prefill(S+1) as a reading (prefill attends the
   unrounded K/V); the same weights with a bf16 cache, each of
   SHORT_DECODE steps bit for bit prefill(S+1); card against CPU at 2
   layers in float32 with a float32 cache.
   8c. MoE, once qwen1.5-32b is freed: the bf16 ``matmul`` at both MoE
   configs' expert products, each through the last expert's view of a
   stacked [E, K, N] parameter, at every slot row count of the phase's
   forwards (``moe_rows``: 8, 104, 656 and 1296 for olmoe, 8, 16 and 656
   for arctic, whose dense FFN takes the same shapes), against its plain
   version and timed, every row bit for bit the row computed alone;
   olmoe-1b-7b at full width and 16
   layers (64 experts, top-8), its serve batch and a 2 x 4080-token long
   batch (groups of 340, 54 slots an expert: pairs are dropped), launches
   exact (a router product and three products an
   expert, every layer and forward), a profiler pass, prefill(S) +
   decode_step against prefill(S+1) a reading at the shipped capacity
   factor 1.25 and bit for bit at E/k (nothing dropped); the ``scatter``
   dispatch's serve batch beside the ``einsum`` one (they compute other
   functions: a reading); card against CPU at 2 layers in float32. Then
   arctic-480b at full width and 2 of its 35 layers (128 experts, top-2,
   a dense residual FFN, 56 heads over 8 KV heads): the serve batch, the
   same gates, card against CPU at its smoke config.
   8d. The encoder-decoder, whisper-large-v3 at full width and depth (32
   encoder + 32 decoder layers, 20 heads of 64, a 51,866-token vocabulary;
   frames drawn on the card): the bf16 ``matmul`` at its products (the
   encoder's 12,000 and 48,000 rows, the cross ``wk``/``wv``, the head,
   whose row stride takes no TMA) against its plain version and timed,
   rows bit for bit the row alone; its attention shapes (the encoder's
   causal 1,500 x 1,500, the cross-attention's prefill and decode over
   1,500 keys, the decoder's self-attention) against their plain
   versions, timed beside SDPA and their bounds; then the serve batch and
   a batch-transcription batch (32 x 4 tokens, 32 new, cache_len 448)
   through ``Model.prefill(frames=...)`` and ``decode_step`` in the
   engine's greedy loop (``PrefixEngine``), launches exact (the encoder
   and the cross ``wk``/``wv`` once a prefill), logits finite, first
   tokens the argmax, the encoder's share of each prefill, a profiler
   pass, prefill(S) + decode_step bit for bit prefill(S+1) with the same
   frames, SHORT_DECODE of SHORT_DECODE steps; card against CPU at 2 + 2
   layers in float32 (the encoder output, the greedy tokens).
   8e. The vision-language model, internvl2-76b at full width (d 8192,
   64 heads over 8 KV heads, d_ff 28,672, a 128,256-token vocabulary) and
   40 of its 80 layers (``VLM_LAYERS``: the deepest one card holds with
   the serve batch's caches and activations), each request with 256 patch
   embeddings drawn on the card in front of its tokens: the serve batch
   through ``PrefixEngine`` (decode steps at P + S), launches exact,
   logits finite, first tokens the argmax, a profiler pass, prefill(S) +
   decode_step bit for bit prefill(S+1) with the same patches, and
   SHORT_DECODE steps of it; card against CPU at 2 layers in float32 (the
   greedy tokens, the prefill logits).
9. Training. The bf16 ``matmul`` at llama3-8b's training products (4 x
   1024 tokens: each backward product as the autograd Function launches
   it, dX on the weight's transposed view and dW on a contiguous copy of
   x.T) against its plain version, timed beside torch.matmul and its
   bound, with the copy's time and the thread-staged time on the x.T view
   as readings; ``flash_attention``'s forward and its torch backward at
   the training shape, timed beside SDPA, the gradients against SDPA's
   float32 autograd. Then llama3-8b at full width and depth with int8
   AdamW moments (about 48.6 GB of weights, gradients and moments),
   TRAIN_STEPS steps of 4 x 1024 tokens through ``launch/train.py``'s
   ``run`` with remat: every loss and gradient norm finite, ``matmul`` and
   ``flash_attention`` launches exactly ``models.model.train_launches`` a
   step, the steady step's time, tokens per second, its share of the bf16
   peak at 6 N FLOP a token, peak memory, and one more step under the
   profiler (idle share). The llama3-8b and internvl2-76b smoke configs'
   float32 steps on the card against the CPU's; internvl2-76b at full
   width and 2 layers, one step with its patches, launches exact; and a
   checkpoint of llama3-8b at full width and 2 layers saved, restored bit
   for bit into a fresh model, and resumed two steps beside the
   uninterrupted run. The first DIGEST_STEPS steps run through ``run``,
   and a digest of the state after them (``state_digest``) is kept for
   phase 10. The recurrences' backward kernels at the training shapes:
   ``rglru_bwd`` at recurrentgemma-9b's [4, 1024, 4096] (and from h0 with
   dh_T, and a ragged shape with a = 1 steps) bit for bit its plain
   version, ``rwkv6_bwd`` at rwkv6-1.6b's [4, 32, 1024, 64] bf16 head
   views (and float32 from s0 with dS_T, and a ragged shape) within the
   summation-order bound of its sums, ds0 bit for bit, each timed by
   CUDA events beside its plain version and its ``kernels/cost.py``
   bound. Then ``RECURRENT_TRAIN``, rwkv6-1.6b and recurrentgemma-9b at
   full width and depth with int8 moments, TRAIN_STEPS steps of 4 x 1024
   tokens each through ``run``: losses and norms finite, every kernel's
   launches exactly ``train_launches`` (the recurrence's forward twice a
   layer under remat, its backward kernel once), the steady step, tokens
   per second, peak memory and a profiled step's idle share; their smoke
   configs' float32 steps on the card against the CPU's; one more
   rwkv6-1.6b step counted for phase 11.
10. Distribution at world size 1, once phase 9's state is freed: an NCCL
   group of one rank through a ``FileStore`` and the (data=1, model=1)
   mesh; llama3-8b at full width and depth with int8 moments, DIGEST_STEPS
   sharded steps through ``run(mesh=...)`` (parameters held by the
   sharding rules, ZeRO-1 moments, every collective run on its group of
   one rank) on phase 9's seed and batches: losses, gradient norms and the
   state's digest bit for bit phase 9's, launches exactly
   ``train_launches`` a step, step times and peak memory beside phase 9's;
   a 2-layer sharded checkpoint restored bit for bit; ``_quantize`` on the
   card equal to the CPU's bits; a one-stage ``gpipe`` through
   ``ops.matmul``; the engine's scenario split over [cuda:0, cuda:0] at
   J=512, uncapped and congested, bit for bit phase 3's and 4's unsplit
   sweeps. Before its state is freed, one more sharded step, untimed,
   under ``launch.counting.StepCounter``, whose counts phase 11 reads.
   Tensor-parallel serving over the same mesh (``tp_serve``): llama3-8b
   and qwen1.5-32b (fp8 cache) at full width and TP_SERVE's depth, the
   serve batch's rows prefilled and decoded greedily, unsharded and then
   with the weights on their 'model' cuts: logits, tokens and caches bit
   for bit, launches equal; qwen1.5-32b's decode step at its cache's last
   slot counted for phase 11. Then ``flash_decode`` against a cache cut
   along its slots at qwen1.5-32b's ``decode_32k`` per-rank shape
   ([8, 40, 32768, 128] fp8 in 16 runs: each run's partials, merged) bit
   for bit the whole-cache kernel and, plain, the whole-cache plain
   version, timed beside its bounds (``check_flash_decode_split``), and
   the same at recurrentgemma-9b's rolled 2,048-slot window in 16 runs of
   128 slots (each chunk split between two runs: within attn_check's
   tolerance of the whole-cache kernel and of the plain split version);
   and
   the 16-way cut's per-rank products at full width, float32 partials
   included, against their plain versions, ``torch.mm`` and their bounds
   (``check_tp_products``).
11. The dry run against the card, once phase 10's NCCL group is
   destroyed: ``launch.dryrun.trace_step`` traces the same sharded step
   (llama3-8b at full width and depth, 4 x 1024 tokens, int8 moments,
   remat) on meta tensors over a fake (1, 1) mesh; its kernel calls,
   operations and bytes by kernel, aten FLOPs and bytes, collectives and
   argument bytes must equal the card's counted step exactly, the calls
   ``train_launches``; its traced memory beside phase 9's measured peak
   and its roofline bound beside phase 9's step are readings. The card's
   bf16 -> float8_e4m3fn cast (``models.layers._bf16_cast_is_xla``,
   probed afresh) must be the one meta traces take. rwkv6-1.6b's
   training step (phase 9's counted step, one card, no mesh) against its
   meta trace, count for count, its ``rwkv6`` and ``rwkv6_bwd`` calls
   ``train_launches``. Then
   llama3-8b's decode step at the serve batch (8 rows, cache 192, at its
   last slot) on the card under the counter against its meta trace: the
   ``matmul`` and ``flash_decode`` calls must be equal; phase 10's
   tensor-parallel decode step against its meta trace over a fake (1, 1)
   mesh, equal in every count and in its argument bytes. Then the
   production cells ``DRYRUN_CELLS`` on fake groups of 256 and 512 ranks:
   per-device GiB, the dominant term and the bound, reckoned from the
   H100's data-sheet peaks.
12. Prints the kernels' JSON line, then the device line last.

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
sys.path.insert(0, os.path.join(ROOT, "src"))
from repro_torch.kernels import cost  # noqa: E402
from repro_torch.kernels.cost import HBM_BW, PEAK_FLOPS  # noqa: E402

#: published H100 SXM peaks (NVIDIA data sheet): the non-tensor-core float
#: rates the kernels' float64 and float32 work runs at, and the dense bf16
#: tensor-core rate, the bound of bf16 products and attention (any kernel
#: computing the same function may use the tensor cores); the HBM and bf16
#: rates are ``kernels.cost``'s
PEAK_OPS_PER_S = {"float64": 34e12, "float32": 67e12, "bfloat16": PEAK_FLOPS}

N_DEADLINES = 5
ORDERS = ("spt", "hcf")
#: the main paths' two job counts, cut from (512, 4096) for the run's time
#: when the training phase came (the J=4096 sweeps took 38.7 and 47.6 s of
#: a 1,217 s run on a host at 2.55 ms a body step), and from (512, 2048)
#: when the recurrent training runs came (a 1,012 s run on a host at 1.91
#: ms a body step, the J=2048 sweep 13.4 s of phase 3), and to J=512 alone
#: when a 1,277 s run on a host at 2.2-2.7 ms a body step passed the
#: 1,200 s a run may take (the J=1024 sweeps 10.3 and 12.6 s); the paged
#: day's 4096-job pages keep the engine at J=4096 under the DES contract
MAIN_J = (512,)
#: the grid of the main paths' side passes (the uncapped path's counting
#: pass, the congested path's kept ``fifo_dispatch`` calls), cut from
#: J=4096 for the run's time (on an H100 the counting pass took 31.2 s and
#: a congested J=4096 sweep 32.8 s of a 973 s run), and from J=1024 (11.8 s
#: of the 1,277 s run)
SIDE_J = 512
#: every this-many-th of the counting pass's ``acd_evict`` calls is kept
#: and timed by device time (16 of the J=512 pass's ~2,000)
KEEP_EVERY = 125
#: job counts of the scenario-axes sweeps: at J=4096 they took ~200 s of
#: a 1,319 s run on a slow host, past the 1,200 s a run may take, and at
#: J=1024 58.9 s of a 1,217 s run (the training phase's room); the larger
#: scales stay timed and DES-checked on the main and congested paths
AXES_J = (512,)
DES_SCENARIOS = ((0, 0), (1, 7), (2, 9))  # (task, scenario) pairs
#: the engine twins' grid: 256 jobs, not MAIN_J[0], for the run's time
#: (on an H100 the phase took 53-57 s of 856-916 s at J=512, and the
#: qwen1.5-32b phase needs the room); the kernel body is timed at J=512
#: and 4096 on the main paths, the twins against it by
#: tools/time_engine_twins.py
TWINS_J = 256
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
#: for the 1,200 s a run may take, from 10^5 to 5 x 10^4 jobs (79 s and a
#: 19 s DES at 10^5 on a slow host), to 2.5 x 10^4 (48.4 s at 5 x 10^4)
#: to 1.25 x 10^4 (35.8 s at 2.5 x 10^4; room for the training phase) and
#: to 8192, two full pages (31.7 s at 1.25 x 10^4 on a host at 2.55 ms a
#: body step), and a 512-job day in 256-job pages held against the
#: monolithic run and the CPU (4096 jobs before: 34.9 s waited for the
#: CPU's day; 2048: 30.4 s; 1024: 16.8 s); 512 jobs in 256-job pages still
#: take two pages
DAY_SCALE = 8192
DAY_CHUNK = 4096
DAY_C_MAX = 60.0
SMALL_DAY = (512, 256)
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
#: congested online serving: 1024 requests at the bench's load under the
#: congested path's caps and cold starts, with three observed per-stage
#: public queue-wait samples (seconds) folded into the predictions (4096
#: requests took 39.5 s of a 1,217 s run, cut to 2048 for the training
#: phase; 2048 took 15.4 s of a 1,012 s run, cut for the recurrent
#: training runs)
ONLINE_J = 1024
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
#: reran at 128 and the serving scheduler's comparison at 256; at those
#: the reruns took 62 s of a 1,277 s run on a slow host, so they run at 64
#: and 128
CPU_J = 64
SCHED_CPU_J = 128
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
        "llama3-8b": (4096, 4112), "qwen1.5-32b": (1024, 1040),
        "olmoe-1b-7b": (4080, 4096)}
#: qwen1.5-32b's long batch is 2 x 1024 tokens: its bf16 weights take
#: 65.56 GiB of the card's 80, and check_serve_logits holds a second fp8
#: cache (2 x 2064 slots: 2.52 GiB each over 64 layers; 2 x 4112 would
#: take 5.02 GiB each); 2 x 2048 until the training phase needed the time
#: (a 2 x 1040-slot cache is 1.27 GiB)
#: the architectures served at full width and depth (QWEN in a phase of
#: its own, after the others are freed)
SERVED = ("rwkv6-1.6b", "recurrentgemma-9b", "llama3-8b")
#: dense architectures run at full width and SHORT_LAYERS layers: one
#: prefill and SHORT_DECODE decode steps, each held against prefill(S+1)
SHORT = ("stablelm-12b", "starcoder2-15b")
SHORT_LAYERS = 2
SHORT_DECODE = 4
#: the MoE phase (8c): olmoe-1b-7b at full width and depth (13.84 GB of
#: bf16 weights), its long batch inside OLMoE's 4,096-token context;
#: arctic-480b at full width and ARCTIC_LAYERS of its 35 layers (55.36 GB;
#: three would take 82.6 GB, the whole model about 13 cards), its
#: card-against-CPU check at its smoke config (2 full layers in float32
#: would take 110 GB of host memory)
OLMOE = "olmoe-1b-7b"
ARCTIC = "arctic-480b"
MOE = (OLMOE, ARCTIC)
ARCTIC_LAYERS = 2
#: the encoder-decoder phase (8d): whisper-large-v3 at full width and depth
#: (32 encoder + 32 decoder layers, 1,603,486,720 parameters: 3.207 GB in
#: bf16), each request's 1,500 frame embeddings drawn N(0, FRAMES_STD) on
#: the card (the reference data pipeline's distribution,
#: src/repro/data/pipeline.py:56-58): the serve batch, and TRANSCRIBE, a
#: batch-transcription batch (requests, prompt tokens, new tokens,
#: cache_len): 32 segments of 30 s of audio, Whisper's 4-token
#: start-of-transcript prompt, 32 new tokens, cache_len 448 (Whisper's text
#: context); it puts the encoder at 48,000 rows and 7.9 GB of ck/cv caches
#: on the card
WHISPER = "whisper-large-v3"
TRANSCRIBE = (32, 4, 32, 448)
FRAMES_STD = 0.02
#: whisper's card-against-CPU check: encoder and decoder layers, and the
#: first WHISPER_CPU_REQUESTS requests of the serve batch (the CPU runs the
#: encoder over 1,500 frames a request); its encoder output within ENC_RTOL
#: of its largest value (float32 rounding of d = 1280 dot products in
#: another order, through two layers)
WHISPER_CPU_LAYERS = 2
#: phase 8e: internvl2-76b at full width and VLM_LAYERS of its 80 layers,
#: the deepest one card holds with the serve batch's caches and the
#: prefill's activations (param_count: 2.10 B + 0.856 B a layer, so 36.3 B
#: parameters, 72.6 GB of bf16 at 40 layers); each request's 256 patch
#: embeddings drawn N(0, PATCHES_STD) on the card; card against CPU at
#: VLM_CPU_LAYERS layers on the serve batch's first VLM_CPU_REQUESTS
VLM = "internvl2-76b"
VLM_LAYERS = 40
PATCHES_STD = 0.02
VLM_CPU_LAYERS = 2
VLM_CPU_REQUESTS = 1
#: phase 9, training: llama3-8b at full width and depth with int8 moments,
#: TRAIN_STEPS steps of SyntheticLM batches of TRAIN_BATCH x TRAIN_SEQ
#: tokens through ``launch/train.py``'s ``run`` (remat on); the card's
#: float32 smoke-config steps against the CPU's within TRAIN_CPU_RTOL (the
#: CPU tests' tolerance against the reference); internvl2-76b at full
#: width and VLM_TRAIN_LAYERS layers, one step of VLM_TRAIN (batch, text
#: positions) with its patches; a checkpoint of llama3-8b at full width
#: and CKPT_LAYERS layers saved at step CKPT_STEPS[0], restored bit for
#: bit, and resumed to CKPT_STEPS[1]
TRAIN_ARCH = "llama3-8b"
#: the recurrent configs phase 9 trains at full width and depth, as
#: TRAIN_ARCH (recurrentgemma-9b: 67.6 GB a step traced on meta), and the
#: one whose counted step phase 11 holds its meta trace to
RECURRENT_TRAIN = ("rwkv6-1.6b", "recurrentgemma-9b")
RWKV_TRAIN = "rwkv6-1.6b"
TRAIN_BATCH, TRAIN_SEQ = 4, 1024
TRAIN_STEPS = 4
TRAIN_SEED = 70
#: phase 10's one-stage gpipe: GPIPE_MICRO microbatches of [rows, K]
#: through a [K, K] bf16 ``matmul`` (GPIPE_SHAPE = (rows, K)); the
#: ``_quantize`` check takes K * K + 100 float32 elements
GPIPE_MICRO = 4
GPIPE_SHAPE = (512, 4096)
#: phase 9's steps through ``run`` before the digest phase 10 is held to
DIGEST_STEPS = 2
#: phase 10's tensor-parallel serving at world size 1: (arch, layers) at
#: full width, depth cut for the run's time (the serve batch's rows,
#: TP_PROMPT tokens each, TP_NEW greedy steps, TP_CACHE slots; qwen1.5-32b
#: with its fp8 cache), bit for bit the unsharded model; the last one's
#: decode step at its cache's last slot is counted for phase 11
TP_SERVE = (("llama3-8b", 4), ("qwen1.5-32b", 4))
TP_PROMPT, TP_NEW, TP_CACHE, TP_SEED = 64, 4, 192, 91
#: qwen1.5-32b's decode_32k on one rank of 16 x 16: its 8 rows, 40 heads
#: (the rules cut neither the 40 heads nor the 40 KV heads 16 ways) and a
#: [8, 40, 32768, 128] fp8 cache cut into SPLIT_RANKS runs of slots
SPLIT_DECODE = (8, 40, 32768, 128)
SPLIT_RANKS = 16
#: recurrentgemma-9b's decode_32k on one rank of 16 x 16: 8 rows, its 16
#: query heads over 1 KV head, its 2,048-slot window rolled, cut into
#: SPLIT_RANKS runs of 128 slots (so every chunk is split between two
#: runs): q heads, the cache [B, Hkv, S, D], and each row's live keys
#: (length) ending at end (a short first window in the last row)
SPLIT_ROLLED = (16, (8, 1, 2048, 256),
                [2048] * 7 + [300],
                [32845, 32845, 32896, 33023, 33024, 32769, 35816, 300])
#: the 16-way cut's per-rank weight products at decode_32k's 8 rows: (arch,
#: name) -> (K, N, float32 partials): column-parallel outputs and
#: row-parallel partials at full width
TP_PRODUCTS = {("qwen1.5-32b", "wq"): (5120, 320, False),
               ("qwen1.5-32b", "w_up"): (5120, 1712, False),
               ("qwen1.5-32b", "w_down"): (1712, 5120, True),
               ("qwen1.5-32b", "wo"): (320, 5120, True),
               ("internvl2-76b", "wq"): (8192, 512, False),
               ("internvl2-76b", "wk"): (8192, 64, False),
               ("internvl2-76b", "w_up"): (8192, 1792, False),
               ("internvl2-76b", "w_down"): (1792, 8192, True),
               ("internvl2-76b", "wo"): (512, 8192, True)}
TP_ROWS = 8
#: the production cells phase 11 traces on fake groups: (arch, shape, mesh)
DRYRUN_CELLS = (("llama3-8b", "train_4k", "single"),
                ("olmoe-1b-7b", "decode_32k", "multi"))
TRAIN_CPU_STEPS = 3
TRAIN_CPU_RTOL = 1e-5
#: recurrentgemma-9b's smoke config's tolerance over the same steps, set
#: above its reading (2.6e-5, its second step's norm, on an H100 80GB HBM3
#: at 700 W; rwkv6-1.6b's 4.3e-6 is within TRAIN_CPU_RTOL). What moves it
#: is AdamW's first update, lr * m / (sqrt(v) + eps), whose size does not
#: follow |g|: at two gradient elements of about 1e-7 of their leaves'
#: scale (``embed`` and the first layer's RG-LRU ``w_out``) the card's
#: and the CPU's gradients differ in sign, so those weights move by 6-7e-4
#: apart where every other weight is within 1e-5. The card's libm (rsqrt
#: and tanh within 2 ulps, exp, sin, cos) and its sums' order set those
#: signs: with its tanh or rsqrt taken from the CPU the gap is 8e-6, with
#: every aten op's 1.1e-5 (``tools/card_cpu_drift.py``)
RECURRENT_CPU_RTOL = {"rwkv6-1.6b": TRAIN_CPU_RTOL, "recurrentgemma-9b": 5e-5}
VLM_TRAIN_LAYERS = 2
VLM_TRAIN = (2, 512)
CKPT_LAYERS = 2
CKPT_STEPS = (2, 4)
#: llama3-8b's weight products at TRAIN_BATCH x TRAIN_SEQ tokens, (label,
#: [M, K, N] of the forward x [M, K] @ w [K, N]); a loss chunk is 2 x 512
#: rows against the head. The backward takes dX = g [M, N] @ w.T (a view)
#: and dW = x.T (a contiguous copy) @ g [M, N]
TRAIN_PRODUCTS = (("wq/wo", (4096, 4096, 4096)),
                  ("wk/wv", (4096, 4096, 1024)),
                  ("w_gate/w_up", (4096, 4096, 14336)),
                  ("w_down", (4096, 14336, 4096)),
                  ("head chunk", (2048, 4096, 128256)))
#: llama3-8b's training attention: q [B, 32, S, 128] over k/v [B, 8, S, 128]
TRAIN_ATTN = (TRAIN_BATCH, 32, 8, TRAIN_SEQ, 128)
#: (two requests took 20.2 s of the CPU in a 1,277 s run on a slow host)
WHISPER_CPU_REQUESTS = 1
ENC_RTOL = 1e-4
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
CPU_LAYERS = {"rwkv6-1.6b": 2, "recurrentgemma-9b": 3, "llama3-8b": 2,
              "qwen1.5-32b": 2, "olmoe-1b-7b": 2}
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
#: check_serve_against_cpu's requests, the first of the serve batch's draw:
#: all 8 took 4.2-28.1 s an architecture on the CPU of a slow host, in a
#: 1,277 s run; its bf16 prefill(S) + decode_step reading runs the shorter
#: of them alone (the first, 82 tokens, took 1.8-10.8 s; 8 requests took
#: 3-14 s an architecture, 2 took 2.0-10.3 s)
CPU_SERVE_REQUESTS = 2


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


def bound_of(work, peak):
    """(bound ms, what bounds it, bytes, operations) of one kernel call
    whose ``work`` is ``(operations, bytes)`` from its ``kernels.cost``
    function: the bytes at the HBM rate against the operations at
    ``PEAK_OPS_PER_S[peak]`` (float32 work without tensor cores, bf16
    products and attention on them)."""
    n_ops, n_bytes = work
    bytes_ms = n_bytes / HBM_BW * 1e3
    ops_ms = n_ops / PEAK_OPS_PER_S[peak] * 1e3
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

    from repro_torch.configs import get_config
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
    # the MoE routers' float32 products, at phase 8c's token counts
    for arch in MOE:
        cfg = get_config(arch)
        d, E = cfg.d_model, cfg.num_experts
        for tokens in sorted({t for t, _ in moe_rows(arch).values()}):
            cases.append((f"{arch} router ({tokens}, {d}, {E})",
                          normal(tokens, d), normal(d, E) * d ** -0.5))
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
        bound, by, n_bytes, n_ops = bound_of(
            cost.matmul(M, K, N, torch.float32), "float32")
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


#: the scan twin's ACD rounds whose prefixes are also taken on the card
CUMSUM_PROBE_CALLS = 1000


def twin_stats(label, wall, counts):
    """Print one twin's wall, body steps and ms per body step (the engine's
    record of the sweep just run); returns the three."""
    from repro_torch.core import vectorsim

    stats = vectorsim._LAST_RUN_STATS
    steps = sum(sum(t) for t in stats["trips"])
    print(f"{label}: impl {stats['impl']}, wall {wall:.3f} s, {steps} body "
          f"steps, {stats['engine_s'] * 1e3 / steps:.4f} ms per body step "
          f"of engine time ({wall * 1e3 / steps:.4f} of wall); launches "
          f"{counts}")
    return wall, steps, stats["engine_s"] * 1e3 / steps


def check_cpu_cumsum_sequential():
    """``torch.cumsum`` of CPU float64 rows on this host equals a sequential
    left-to-right loop: the property the twins' host prefixes rest on."""
    import numpy as np
    import torch

    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.lognormal(0.0, 2.0, (30, 4096))
                         * rng.choice([1e-6, 1.0, 1e6], (30, 4096)))
    acc = torch.zeros(30, dtype=torch.float64)
    want = torch.empty_like(x)
    for j in range(x.shape[1]):
        acc = acc + x[:, j]
        want[:, j] = acc
    if not torch.equal(torch.cumsum(x, 1), want):
        raise AssertionError("torch.cumsum on the host is not sequential")
    print("torch.cumsum of CPU float64 rows [30, 4096] on this host equals "
          "the sequential loop bit for bit")


def cumsum_probe(tasks, budget):
    """One more, untimed ``scan`` sweep of ``tasks`` on the card. For its
    first ``budget`` ACD rounds, the two demand prefixes the twin takes on
    the host are also taken by ``torch.cumsum`` on the card: prints how
    many prefix elements differ, the largest difference, and how many
    evict/leftover decisions the card's prefixes would have changed. A
    reading only: the engine always uses the host's."""
    import torch

    from repro_torch.core import sweep_scenarios, vectorsim

    real = vectorsim._acd_twin
    rec = dict(calls=0, elems=0, diff=0, max_diff=0.0, flips=0)

    def probe(P_q, q1, m, thresh, certain):
        out = real(P_q, q1, m, thresh, certain)
        if certain and P_q.is_cuda and rec["calls"] < budget:
            rec["calls"] += 1
            contrib = torch.where(q1, P_q, torch.zeros((), dtype=P_q.dtype,
                                                       device=P_q.device))
            host = contrib.cpu()
            pe_h = torch.cumsum(host, 1) - host
            pe_d = torch.cumsum(contrib, 1) - contrib
            # the second prefix over the host's violators on both sides
            viol = m.cpu() & (pe_h > thresh.cpu())
            vc_h = torch.where(viol, host, torch.zeros((), dtype=host.dtype))
            vc_d = vc_h.to(P_q.device)
            for h, d in ((pe_h, pe_d), (torch.cumsum(vc_h, 1) - vc_h,
                                        torch.cumsum(vc_d, 1) - vc_d)):
                d = d.cpu()
                rec["elems"] += h.numel()
                rec["diff"] += int((d != h).sum())
                rec["max_diff"] = max(rec["max_diff"],
                                      float((d - h).abs().max()))
            alt = vectorsim._acd_round(contrib, thresh, m, certain)
            rec["flips"] += int((alt.cpu() != out.cpu()).sum())
        return out

    vectorsim._acd_twin = probe
    try:
        sweep_scenarios(tasks, device="cuda", engine_impl="scan")
    finally:
        vectorsim._acd_twin = real
    print(f"cumsum probe (scan twin's rows, first {rec['calls']} ACD rounds "
          f"of an uncapped J={tasks[0]['pred']['P_private'].shape[0]} "
          f"sweep): torch.cumsum on the card differs from the host's "
          f"sequential prefix in {rec['diff']} of {rec['elems']} prefix "
          f"elements, largest difference {rec['max_diff']!r}; the card's "
          f"prefixes would have changed {rec['flips']} evict/leftover "
          f"decisions")
    return rec


def engine_twins_phase(run_path, load_kw):
    """The vector engine's three inner loops on one grid: the Fig.-4 grid
    at ``TWINS_J`` uncapped and congested under ``kernel``, ``scan`` and
    ``loop`` on the card, equal field for field; the twins launch no
    kernel. Then the DES contract on the twins' scenarios, the twins at
    ``CPU_J`` on the CPU against the card, the ``cumsum`` reading, and a
    repeated ``kernel`` sweep that hits the prep cache. Returns the
    ``kernel`` sweeps' launch counts."""
    from repro_torch.core import APPS, vectorsim

    t_phase = time.perf_counter()
    check_cpu_cumsum_sequential()
    J = TWINS_J
    tasks = fig4_workload(APPS, J)
    launches, table = {}, {}
    for load, kw in (("uncapped", {}), ("congested", load_kw)):
        outs = {}
        for impl in ("kernel", "scan", "loop"):
            label = f"engine twins {load} {impl}"
            # every timed sweep misses the prep cache, whatever ran before
            vectorsim._PREP_CACHE.clear()
            outs[impl], wall, counts = run_path(
                label, J, tasks, dict(kw, engine_impl=impl))
            stats = vectorsim._LAST_RUN_STATS
            if impl == "kernel" and load == "uncapped":
                first = (stats["prep_s"], stats["plan_s"])
            table[(load, impl)] = twin_stats(label, wall, counts)
            need = ("acd_evict", "fifo_dispatch") if kw else ("acd_evict",)
            if impl == "kernel":
                if any(counts[k] <= 0 for k in need):
                    raise AssertionError(f"{label}: a kernel never "
                                         f"launched: {counts}")
                launches[f"twins {load} kernel J={J}"] = counts
            elif counts["acd_evict"] or counts["fifo_dispatch"]:
                raise AssertionError(f"{label}: a twin launched a kernel: "
                                     f"{counts}")
        for impl in ("scan", "loop"):
            for task, a, b in zip(tasks, outs[impl], outs["kernel"]):
                bad = [f for f in RESULT_FIELDS
                       if not same(getattr(a, f), getattr(b, f))]
                if bad:
                    raise AssertionError(f"engine twins {load} "
                                         f"{task['name']}: {impl} != "
                                         f"kernel in {bad}")
            check_des(f"engine twins {load} {impl} J={J}", tasks,
                      outs[impl],
                      LOAD_DES_SCENARIOS if kw else DES_SCENARIOS, kw,
                      load_fields=bool(kw))
        print(f"engine twins {load} J={J}: loop, scan and kernel equal in "
              f"every field")
        for impl in ("scan", "loop"):
            check_cpu_rerun(f"engine twins {load} {impl} J={CPU_J}",
                            fig4_workload(APPS, CPU_J),
                            dict(kw, engine_impl=impl))
    for load in ("uncapped", "congested"):
        k_wall, k_steps, k_ms = table[(load, "kernel")]
        print(f"engine twins {load} J={J}: "
              + "; ".join(f"{impl} {w:.3f} s, {n} steps, {ms:.4f} ms a "
                          f"step ({w / k_wall:.3f}x the kernel's wall, "
                          f"{n / k_steps:.3f}x its steps)"
                          for impl in ("kernel", "scan", "loop")
                          for w, n, ms in (table[(load, impl)],)))
    cumsum_probe(tasks, CUMSUM_PROBE_CALLS)
    _, _, counts = run_path("engine twins uncapped kernel repeated", J,
                            tasks, dict(engine_impl="kernel"))
    stats = vectorsim._LAST_RUN_STATS
    print(f"engine twins prep cache: first kernel sweep prep_s "
          f"{first[0]:.6f} plan_s {first[1]:.6f}; repeated identical sweep "
          f"prep_s {stats['prep_s']:.6f} plan_s {stats['plan_s']:.6f}")
    if stats["plan_s"] != 0.0:
        raise AssertionError("the repeated sweep missed the prep cache")
    print(f"engine twins: phase wall {time.perf_counter() - t_phase:.3f} s")
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
    default RetryPolicy; scenarios against the DES and the grid at
    ``CPU_J`` against the CPU."""
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
    on the host (same pages) under the parity contract; then a
    ``SMALL_DAY`` day in 512-job pages bit for bit against the monolithic
    card run and the CPU (run meanwhile in a process of its own), then
    under the profiler. Returns the launch counts of both timed paged
    runs."""
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
    paged, small_wall = day(scale, chunk)
    small_counts = ops.launch_counts()
    report(f"paged day chunk_jobs={chunk}", scale, small_wall, small_counts)
    steps = sum(sum(t) for t in vectorsim._LAST_RUN_STATS["trips"])
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
    # the same day under the profiler, for the device's idle share (its
    # post-processing grows with the events: ~100 a body step)
    got = device_profile("paged day", lambda: day(scale, chunk))
    if got is not None:
        busy_s, wall_p, dev_events = got
        n_events = sum(e.count for e in dev_events)
        print(f"profile paged day scale={scale} chunk_jobs={chunk}: device "
              f"busy {busy_s:.3f} s of a {wall_p:.3f} s profiled wall, "
              f"{1 - busy_s / wall_p:.3f} idle; of the unprofiled "
              f"{small_wall:.3f} s wall {1 - busy_s / small_wall:.3f} idle; "
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
    bound, by, n_bytes, n_ops = bound_of(cost.rglru(B, T, D, True),
                                         "float32")
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
        # the function's operations (the kernel itself does 7 Dk Dv per
        # (b, h, t): see csrc/rwkv6.cu and ``rwkv6_term_floor``)
        bound, by, n_bytes, n_ops = bound_of(cost.rwkv6(
            Bs, H, Ts, Dk, Dk, torch.bfloat16, args[5] is not None),
            "float32")
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
    bound, by, n_bytes, n_ops = bound_of(
        cost.rwkv6(B, H, T, Dk, Dk, torch.bfloat16, False), "float32")
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
    """The serve phases' attention shapes: (arch, Hq, Hkv, D, window,
    serve prompt, long prompt or None, long cache or None); the MoE phase's
    too (olmoe-1b-7b's 16/16 heads, arctic-480b's 56/8) and whisper's
    decoder self-attention (20/20 heads of 64; its encoder and
    cross-attention shapes are :func:`check_whisper_attention`'s)."""
    from repro_torch.configs import get_config

    out = []
    for arch in ("recurrentgemma-9b", "llama3-8b") + SHORT + MOE + (
            WHISPER,):
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
                pairs = cost.live_pairs(S, S, True, window)
                bound, by, n_bytes, n_ops = bound_of(cost.flash_attention(
                    (B, hq, S, d), (B, hkv, S, d), bf16, True, window),
                    "bfloat16")
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
                bound, by, n_bytes, n_ops = bound_of(cost.flash_decode(
                    (B, hq, d), hkv, bf16, bf16, B * n_live), "bfloat16")
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


#: qwen1.5-32b's decode shapes for the fp8 cache checks: the serve batch's
#: cache (cache_len SERVE_CACHE), the long batch's (QWEN_LONG), and the
#: kernel timed alone at a 4097-key cache of 4112 slots (the other dense
#: configs' long-batch cache, past what the full model's long batch fits)
QWEN = "qwen1.5-32b"
QWEN_TIMED = (2, 4112, 4097)
#: elements of each fp8 test cache set past 448 before the cast, so the
#: cast gives NaN there (XLA's astype; torch's own .to saturates)
KV8_NAN_ELEMS = 3


def fp8_caches(B, hkv, S, d, dev, g, n_big=KV8_NAN_ELEMS, width=None):
    """k, v [B, Hkv, S, d] float8_e4m3fn caches cast by ``layers.to_kv``
    from random bf16 values (|x| up to ~4 * 2), ``n_big`` elements of each
    set past 448 (to +-500 and -1000: NaN after the cast); ``width`` > d
    makes each a [..., :d] view of a wider cache (rows not 16-byte
    aligned)."""
    import torch

    from repro_torch.models.layers import to_kv

    out = []
    for _ in range(2):
        x = (torch.randn(B, hkv, S, width or d, device=dev, generator=g)
             * 2.0).to(torch.bfloat16)
        idx = torch.randint(0, x.numel(), (n_big,), device=dev,
                            generator=g)
        big = torch.tensor([500.0, -500.0, -1000.0], device=dev)
        x.view(-1)[idx] = big.repeat(n_big // 3 + 1)[:n_big].to(x.dtype)
        out.append(to_kv(x, torch.float8_e4m3fn)[..., :d])
    return out


def kv8_check(label, got, wid, want, v8):
    """The fp8 kernel's ``got`` against the same kernel on the widened
    caches (``wid``): NaN where it has NaN and, elsewhere, the same bits;
    and against the plain version (``want``): NaN where it has NaN, the
    rest within attn_check's tolerance (ATTN_RTOL * max|v| over v's finite
    values, plus one bf16 ulp of a bf16 output). Raises on a miss; returns
    (max abs error against the plain version, NaN elements)."""
    import torch

    torch.cuda.synchronize()
    nan = torch.isnan(got)
    ints = torch.int16 if got.dtype == torch.bfloat16 else torch.int32
    same_bits = bool(torch.equal(nan, torch.isnan(wid))) and bool(
        (got.view(ints) == wid.view(ints))[~nan].all())
    same_nan = bool(torch.equal(nan, torch.isnan(want)))
    vf = v8.float()
    v_max = float(vf[torch.isfinite(vf)].abs().max())
    ok = nan.numel() == 0 or not bool(nan.all())
    err = (got.float() - want.float()).abs()[~nan]
    bound = ATTN_RTOL * v_max + torch.zeros_like(err)
    if got.dtype == torch.bfloat16:
        _, e = torch.frexp(torch.maximum(got.float().abs(),
                                         want.float().abs())[~nan])
        bound = bound + torch.ldexp(torch.ones_like(bound), e - 8)
    within = bool((err <= bound).all())
    e_max = float(err.max()) if err.numel() else 0.0
    worst = float((err / bound).max()) if err.numel() else 0.0
    print(f"{label}: bit for bit the kernel on the widened caches "
          f"{same_bits}; NaN pattern of the plain version {same_nan} "
          f"({int(nan.sum())} of {nan.numel()} NaN); max_abs_err "
          f"{e_max!r}, worst |err| / tolerance {worst:.4f}")
    if not (same_bits and same_nan and within and ok
            and got.dtype == want.dtype and got.shape == want.shape):
        raise AssertionError(f"{label}: fp8 kernel check failed")
    return e_max, int(nan.sum())


def check_flash_decode_kv8(dev):
    """``flash_decode`` on float8_e4m3fn caches (``layers.to_kv``, a few
    elements past 448 so that NaNs occur) at qwen1.5-32b's decode shapes
    (the serve and long batches' caches and [2, 40, 4112, 128]; lengths 0,
    1, partial and full, and as the model calls it, with ``end``), under
    bf16 and float32 q, plus GQA, a rolled cache and rows that are not
    16-byte aligned: each bit for bit the kernel on the widened caches and
    within tolerance of the plain version. Then at [2, 40, 4112, 128],
    length 4097: the fp8 kernel's time, the bf16 kernel's on the widened
    caches, the plain version's, ``scaled_dot_product_attention``'s on the
    widened caches with a mask of the live slots, and the bound (fp8 K/V
    bytes). Returns the fp8 reading for flash_decode's kernels entry."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.core.precision import ieee_float32
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import flash_decode_plain

    cfg = get_config(QWEN)
    hq, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    g = torch.Generator(device=dev).manual_seed(25)
    bf16, f32 = torch.bfloat16, torch.float32
    s_serve = longest_prompt(QWEN)
    long_p, long_c = LONG[QWEN]
    B_t, S_t, n_t = QWEN_TIMED

    def lengths(B, S, full):
        if full is not None:
            return torch.full((B,), full, dtype=torch.int32, device=dev)
        pick = [0, 1, S // 2 + 3, S, S - 1, 65, 64, 257]
        return torch.tensor([min(pick[i % len(pick)], S) for i in range(B)],
                            dtype=torch.int32, device=dev)

    # (label, B, Hq, Hkv, S, D, q dtype, length of every row (None:
    # mixed), end of every row (None: the first length slots), width of
    # the cache rows (None: D))
    cases = []
    for dt in (bf16, f32):
        name = str(dt)[6:]
        cases += [
            (f"{QWEN} serve decode, {name} q", SERVE_REQUESTS, hq, hkv,
             SERVE_CACHE, d, dt, s_serve + 1, s_serve + 1, None),
            (f"{QWEN} serve cache, mixed lengths, {name} q", SERVE_REQUESTS,
             hq, hkv, SERVE_CACHE, d, dt, None, None, None),
            (f"{QWEN} long decode, {name} q", LONG_BATCH, hq, hkv, long_c,
             d, dt, long_p + 1, long_p + 1, None),
            (f"timed cache, mixed lengths, {name} q", B_t, hq, hkv, S_t,
             d, dt, None, None, None),
            (f"timed cache, length {n_t}, {name} q", B_t, hq, hkv, S_t, d,
             dt, n_t, n_t, None)]
    cases += [("GQA G=4 across chunks, rolled cache, bf16 q", 4, 32, 8,
               900, 128, bf16, 900, 2345, None),
              ("rows not 16-byte aligned (plain loads), bf16 q", 8, 8, 2,
               600, 128, bf16, None, None, 136),
              ("D=40 (plain loads), mixed lengths, bf16 q", 8, 8, 2, 300,
               40, bf16, None, None, None),
              ("G=16 D=256, mixed lengths, float32 q", 4, 16, 1, 300, 256,
               f32, None, None, None)]
    max_err, n_nan = 0.0, 0
    with ieee_float32():
        for label, B, hq_, hkv_, S, d_, dt, full, last, width in cases:
            q = head_split(B, 1, hq_, d_, dt, dev, g)[:, :, 0]
            k8, v8 = fp8_caches(B, hkv_, S, d_, dev, g, width=width)
            length = lengths(B, S, full)
            end = (None if last is None else torch.full(
                (B,), last, dtype=torch.int32, device=dev))
            got = ops.flash_decode(q, k8, v8, length, end)
            wid = ops.flash_decode(q, k8.to(dt), v8.to(dt), length, end)
            want = flash_decode_plain(q, k8, v8, length, end)
            zero = length == 0
            if bool(zero.any()) and bool(got[zero].abs().max() != 0):
                raise AssertionError(f"flash_decode fp8 {label}: length 0 "
                                     f"did not give zeros")
            e, n = kv8_check(f"flash_decode fp8 K/V {label} [{B}, {hq_}/"
                             f"{hkv_}, {S}, {d_}] lengths "
                             f"{length.tolist()} end {last}", got, wid,
                             want, v8)
            max_err, n_nan = max(max_err, e), n_nan + n
            del q, k8, v8, got, wid, want
    if n_nan == 0:
        raise AssertionError("flash_decode fp8: no NaN reached an output")

    # timed at [2, 40, 4112, 128], length 4097, as the model calls it
    q = head_split(B_t, 1, hq, d, bf16, dev, g)[:, :, 0]
    k8, v8 = fp8_caches(B_t, hkv, S_t, d, dev, g, n_big=0)
    kb, vb = k8.to(bf16), v8.to(bf16)
    length = lengths(B_t, S_t, n_t)
    end = length.clone()
    k_ms = cuda_ms(lambda: ops.flash_decode(q, k8, v8, length, end), 50)
    w_ms = cuda_ms(lambda: ops.flash_decode(q, kb, vb, length, end), 50)
    p_ms = cuda_ms(lambda: flash_decode_plain(q, k8, v8, length, end), 5)
    mask = (torch.arange(S_t, device=dev)[None, :]
            < length[:, None])[:, None, None, :]
    q4 = q[:, :, None]
    l_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q4, kb, vb, attn_mask=mask, enable_gqa=True), 50)
    kd_ms, k_events = device_ms(
        lambda: ops.flash_decode(q, k8, v8, length, end), 20)
    wd_ms, _ = device_ms(lambda: ops.flash_decode(q, kb, vb, length, end),
                         20)
    bound, by, n_bytes, n_ops = bound_of(cost.flash_decode(
        (B_t, hq, d), hkv, bf16, torch.float8_e4m3fn, B_t * n_t),
        "bfloat16")
    w_bound = bound_of(cost.flash_decode(
        (B_t, hq, d), hkv, bf16, bf16, B_t * n_t), "bfloat16")[0]
    print(f"flash_decode fp8 K/V q [{B_t}, {hq}, {d}] bf16, cache [{B_t}, "
          f"{hkv}, {S_t}, {d}] float8_e4m3fn, length {n_t}: kernel "
          f"{k_ms:.6f} ms ({n_bytes / k_ms * 1e-9:.3f} TB/s; device "
          f"{kd_ms:.6f} ms: "
          + ", ".join(f"{name[:40]} {t:.6f}" for name, t in k_events.items())
          + f"), the bf16 kernel on the widened caches {w_ms:.6f} ms "
          f"(device {wd_ms:.6f}; its bound {w_bound:.6f} ms), plain "
          f"{p_ms:.6f} ms, scaled_dot_product_attention on the widened "
          f"caches {l_ms:.6f} ms, bound {bound:.6f} ms by {by} (bytes "
          f"{n_bytes}, operations {n_ops}); kernel at {bound / k_ms:.4f} of "
          f"the bound, {k_ms / w_ms:.3f}x the bf16 kernel, "
          f"{k_ms / l_ms:.3f}x the library call")
    del q, k8, v8, kb, vb
    torch.cuda.empty_cache()
    return {"kv_dtype": "float8_e4m3fn", "shape": [B_t, hkv, S_t, d],
            "length": n_t, "max_abs_err": max_err, "ms": k_ms,
            "device_ms": finite(kd_ms), "plain_ms": p_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": l_ms,
            "bf16_widened_ms": w_ms, "bf16_widened_device_ms": finite(wd_ms),
            "bf16_widened_bound_ms": w_bound}


def check_kv_cast(dev):
    """``layers.to_kv`` on the card against the CPU, uint8 views equal: all
    65,536 bf16 bit patterns and a float32 sample (10^6 values across
    magnitudes 2^-20 .. 2^10, and 448, 464, 466, 480, +-inf, NaN, the fp8
    subnormals and their ties). Prints whether bf16 casts take torch's own
    cast on each device, and what torch's CUDA ``.to`` gives above 448
    (torch's CPU cast saturates there where XLA's gives NaN)."""
    import torch

    from repro_torch.models import layers
    from repro_torch.models.layers import to_kv

    fp8, u8 = torch.float8_e4m3fn, torch.uint8
    bits = torch.arange(65536, dtype=torch.int32).to(torch.int16)
    xb = bits.view(torch.bfloat16)
    g = torch.Generator().manual_seed(26)
    sample = (torch.randn(1_000_000, generator=g)
              * torch.exp2(torch.randint(-20, 10, (1_000_000,),
                                         generator=g).float()))
    edge = torch.tensor([448.0, 456.0, 464.0, 464.00003, 466.0, 480.0,
                         float("inf"), float("nan"), 2.0 ** -9, 2.0 ** -10,
                         3 * 2.0 ** -10, 2.0 ** -6, 0.0, 1e-45])
    xf = torch.cat([sample, edge, -edge])
    ok = True
    for label, x in (("bf16 bit patterns", xb), ("float32 sample", xf)):
        host = to_kv(x, fp8).view(u8)
        card = to_kv(x.to(dev), fp8).view(u8).cpu()
        torch_cast = x.to(dev).to(fp8).view(u8).cpu()
        same = bool(torch.equal(host, card))
        ok = ok and same
        diff = torch_cast != card
        xs = x[diff].float()
        print(f"to_kv {label}: card == CPU in all {x.numel()} {same}; "
              f"torch's CUDA .to(float8_e4m3fn) differs in {int(diff.sum())}"
              f" (|x| from {float(xs.abs().min()) if diff.any() else 0!r})")
    print(f"to_kv: bf16 casts take torch's own cast on the card "
          f"{layers._bf16_cast_is_xla(dev)}, on the CPU "
          f"{layers._bf16_cast_is_xla(torch.device('cpu'))} (where it "
          f"equals XLA's on every bf16 input)")
    probe = torch.tensor([448.0, 464.0, 466.0, 480.0, 1e4, float("inf"),
                          -float("inf"), float("nan")], device=dev)
    print("torch's CUDA .to(float8_e4m3fn) of "
          f"{probe.tolist()}: {[hex(int(b)) for b in probe.to(fp8).view(u8)]}"
          f"; to_kv: {[hex(int(b)) for b in to_kv(probe, fp8).view(u8)]}")
    if not ok:
        raise AssertionError("to_kv: the card's cast differs from the CPU's")


def bf16_timed(label, phase, x, w, reps):
    """One bf16 ``matmul`` x @ w against its plain version (check_matmul's
    bf16 bound), timed ``reps`` times beside its plain version,
    torch.matmul and its bound; call under ``ieee_float32`` (the plain
    version's float32 products). Returns its entry of matmul's "bf16"
    timings."""
    import importlib

    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import matmul_plain

    mm = importlib.import_module("repro_torch.kernels.matmul")
    err = matmul_check(label, x, w, ops.matmul(x, w), matmul_plain(x, w))
    M, K = x.shape
    N = w.shape[1]
    k_ms = cuda_ms(lambda: ops.matmul(x, w), reps)
    p_ms = cuda_ms(lambda: matmul_plain(x, w), reps)
    l_ms = cuda_ms(lambda: torch.matmul(x, w), reps)
    bound, by, n_bytes, n_ops = bound_of(
        cost.matmul(M, K, N, torch.bfloat16), "bfloat16")
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
    from repro_torch.models.layers import linear, row_mean

    mm = importlib.import_module("repro_torch.kernels.matmul")
    g = torch.Generator(device=dev).manual_seed(25)
    bf16 = torch.bfloat16
    rows = (SERVE_REQUESTS, SERVE_REQUESTS * longest_prompt("llama3-8b"),
            LONG_BATCH * LONG["llama3-8b"][0])

    def normal(*shape, scale=1.0):
        return (torch.randn(*shape, device=dev, generator=g) * scale).to(bf16)

    timings = []
    with ieee_float32():
        for K, N in ROWS_SHAPES:
            w = normal(2, K, N, scale=K ** -0.5)[1]  # a layer's view
            for m, phase, reps in zip(rows, ("decode", "prefill",
                                             "long prefill"), (50, 20, 5)):
                x = normal(m, K)
                timings.append(bf16_timed(f"serve [{m}, {K}] @ layer view "
                                          f"[{K}, {N}]", phase, x, w, reps))
            del w, x
        for label, d, V, tied in HEADS:
            w = normal(V, d).T if tied else normal(d, V, scale=d ** -0.5)
            x = normal(SERVE_REQUESTS, d)
            timings.append(bf16_timed(f"{label} [{SERVE_REQUESTS}, {d}] @ "
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


def prefix_kw(frames=None, patches=None):
    """(prefill keywords, positions the prefix takes): an encoder-decoder's
    ``frames``, a vision config's ``patches`` [B, P, d], which go in front
    of the tokens (decode continues at P + S)."""
    kw = {k: v for k, v in (("frames", frames), ("patches", patches))
          if v is not None}
    return kw, 0 if patches is None else int(patches.shape[1])


def incremental_gap(model, toks, cache_len, frames=None, patches=None):
    """prefill(S) of ``toks`` [B, S] (with an encoder-decoder's ``frames``
    or a vision config's ``patches``), decode_step of its greedy tokens,
    and prefill(S+1) of the same tokens: (prefill logits, decode logits,
    prefill(S+1) logits, greedy tokens, the INCR_TOL line and whether
    every logit is within it)."""
    import torch

    S = toks.shape[1]
    kw, n_prefix = prefix_kw(frames, patches)
    logits, cache = model.prefill(toks, cache_len=cache_len, **kw)
    first = torch.argmax(logits, -1)
    dec, _ = model.decode_step(cache, first, n_prefix + S)
    del cache
    full, _ = model.prefill(torch.cat([toks, first[:, None]], 1),
                            cache_len=cache_len, **kw)
    torch.cuda.synchronize()
    d, f = dec.float(), full.float()
    err = (d - f).abs()
    bad = err > INCR_TOL["atol"] + INCR_TOL["rtol"] * f.abs()
    line = (f"prefill({S}) + decode_step vs prefill({S + 1}): max abs diff "
            f"{float(err.max())!r} on logits up to {float(f.abs().max()):.3f}"
            f", {int(bad.sum())} of {bad.numel()} beyond rtol "
            f"{INCR_TOL['rtol']}, atol {INCR_TOL['atol']}")
    return logits, dec, full, first, line, not bool(bad.any())


def check_serve_logits(label, model, reqs, outs, cache_len, frames=None,
                       patches=None):
    """The engine's batch once more by hand: finite logits, the engine's
    first tokens the prefill's argmax, and prefill(S) + decode_step within
    INCR_TOL of prefill(S+1), every logit (the reference suite's check, at
    the full config in its working dtype), bit for bit in bf16. Where the
    cache has another dtype than the activations (qwen1.5-32b's fp8), the
    decode step reads K/V that prefill(S+1) attends unrounded, and where
    an MoE layer may drop pairs (capacity factor below E/k) a prefill
    drops pairs that a decode step does not: there the gap is a reading,
    not a gate. Returns the line's reading."""
    import torch

    toks = torch.from_numpy(padded(reqs)).to(model.device)
    logits, dec, full, first, line, ok = incremental_gap(
        model, toks, cache_len, frames, patches)
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
    exact = model.cfg.kv_dtype == model.cfg.dtype and not may_drop(model.cfg)
    if not (finite and same_first and (ok or not exact)
            and (bitwise or model.cfg.dtype != "bfloat16" or not exact)):
        raise AssertionError(f"serve {label}: logits check failed")
    return line, gap


def moe_rows(arch):
    """The rows an MoE layer of ``arch`` gives ``matmul`` in phase 8c:
    {forward: (tokens, slot rows)} for a decode step, the serve batch's
    prefill, that prefill at capacity factor E/k (nothing dropped) and the
    long batch's prefill where the architecture has one. The router (and
    arctic's dense FFN) takes the tokens, each expert product its
    B * (S / group_len) * capacity slot rows."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.moe import capacity, group_len

    cfg = get_config(arch)
    no_drops = dataclasses.replace(
        cfg, capacity_factor=cfg.num_experts / cfg.top_k)
    S = longest_prompt(arch)
    forwards = [("decode", cfg, SERVE_REQUESTS, 1),
                ("prefill", cfg, SERVE_REQUESTS, S),
                ("prefill E/k", no_drops, SERVE_REQUESTS, S)]
    if arch in LONG:
        forwards.append(("long prefill", cfg, LONG_BATCH, LONG[arch][0]))
    out = {}
    for label, c, B, s in forwards:
        gl = group_len(c, s)
        out[label] = (B * s, B * (s // gl) * capacity(c, gl))
    return out


#: reps of the MoE products' timings, by forward
MOE_REPS = {"decode": 50, "prefill": 20, "prefill E/k": 10,
            "long prefill": 5}


def check_moe_products(dev):
    """The bf16 ``matmul`` at both MoE configs' expert products:
    [rows, d] @ w_up[e] (w_gate's shape too) and [rows, ff] @ w_down[e],
    each ``w[e]`` the last expert's view of a stacked [E, K, N] parameter,
    at every slot row count of :func:`moe_rows` (arctic's dense FFN takes
    the same shapes at the E/k prefill's rows, its token count): against
    the plain version and timed (:func:`bf16_timed`), and every row of
    ``linear(x, w[e])`` bit for bit the row computed alone. Returns the
    timings for matmul's "bf16" entry."""
    import gc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.precision import ieee_float32
    from repro_torch.models.layers import linear

    g = torch.Generator(device=dev).manual_seed(26)
    bf16 = torch.bfloat16
    timings = []
    for arch in MOE:
        cfg = get_config(arch)
        E = cfg.num_experts
        for K, N in ((cfg.d_model, cfg.d_ff), (cfg.d_ff, cfg.d_model)):
            stacked = torch.empty((E, K, N), dtype=bf16, device=dev)
            w = stacked[E - 1]  # only this expert's weights are read
            w.copy_(torch.randn(K, N, device=dev, generator=g) * K ** -0.5)
            for label, (_, m) in moe_rows(arch).items():
                x = torch.randn(m, K, device=dev, generator=g).to(bf16)
                with ieee_float32():
                    timings.append(bf16_timed(
                        f"{arch} expert {label} [{m}, {K}] @ expert view "
                        f"[{K}, {N}] of [{E}, {K}, {N}]", f"moe {label}", x,
                        w, MOE_REPS[label]))
                full = linear(x, w)
                same = sum(torch.equal(linear(x[i:i + 1], w)[0], full[i])
                           for i in range(m))
                print(f"linear rows {arch} expert [{m}, {K}] @ [{K}, {N}] "
                      f"bf16: {same} of {m} rows bitwise equal to the row "
                      f"alone")
                if same != m:
                    raise AssertionError(f"linear {arch} expert [{m}, {K}] "
                                         f"@ [{K}, {N}]: rows depend on the "
                                         f"row count")
            del stacked, w, x, full
            gc.collect()
            torch.cuda.empty_cache()
    return timings


def may_drop(cfg):
    """Whether an MoE layer of ``cfg`` may drop (token, choice) pairs: its
    capacity factor is below E/k."""
    return bool(cfg.num_experts) and (cfg.capacity_factor
                                      < cfg.num_experts / cfg.top_k)


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
    architecture has one, its long batch (whisper-large-v3: the
    transcription batch, TRANSCRIBE)."""
    out = [("batch", serve_requests(cfg, SERVE_REQUESTS, SERVE_PROMPT, new,
                                    SERVE_SEED),
            SERVE_CACHE + cfg.vision_patches)]
    if arch == WHISPER:
        n, prompt, n_new, cache_len = TRANSCRIBE
        out.append(("transcription batch", serve_requests(
            cfg, n, prompt, n_new, SERVE_SEED + 1), cache_len))
    if arch in LONG:
        prompt, cache_len = LONG[arch]
        out.append(("long batch", serve_requests(
            cfg, LONG_BATCH, prompt, new, SERVE_SEED + 1), cache_len))
    return out


def expected_launches(cfg, new):
    """Kernel launches of one ``generate_batch`` (a prefill and ``new``
    decode steps): the recurrence kernels and both attention kernels once
    per layer of their kind and forward (flash_attention in the prefill,
    flash_decode in each decode step), matmul once per weight product (the
    mixer's, the FFN's two or three, the head), per row mean of a norm
    (``layers.row_mean``: one mean per rmsnorm, two per layernorm and per
    rwkv6 group norm; two norms a layer and the final one) and, in an MoE
    layer, ``moe.moe_launches``: the router product and two or three
    products per expert (every slot computed), beside the dense FFN where
    ``dense_residual`` is set; the backward kernels never (serving runs
    under inference mode). An encoder-decoder's prefill also runs the
    encoder (per layer: its attention's four products and one
    flash_attention, its FFN, two norms; then its final norm), and each
    decoder layer's cross-attention (a third norm; wq and wo every forward,
    wk and wv only at prefill; one more flash_attention at prefill, not
    causal, and one more flash_decode every decode step)."""
    from repro_torch.models.layers import row_mean_launches
    from repro_torch.models.model import MIXER_PRODUCTS
    from repro_torch.models.moe import moe_launches

    kinds = [cfg.layer_kind(i) for i in range(cfg.num_layers)]
    n_attn = kinds.count("attn")
    per_norm = ((1 if cfg.norm == "rmsnorm" else 2)
                * row_mean_launches(cfg.d_model))
    dense_ffn = not cfg.num_experts or cfg.dense_residual
    ffn = 3 if cfg.glu else 2
    cross = int(cfg.is_encdec)
    decode = (sum(MIXER_PRODUCTS[k] for k in kinds)
              + ffn * cfg.num_layers * dense_ffn
              + (moe_launches(cfg) * cfg.num_layers
                 if cfg.num_experts else 0) + 1
              + per_norm * ((2 + cross) * cfg.num_layers + 1)
              + 2 * row_mean_launches(cfg.rwkv_head_dim)
              * kinds.count("rwkv6")
              + 2 * cross * cfg.num_layers)
    prefill = (decode + 2 * cross * cfg.num_layers
               + cfg.encoder_layers * (MIXER_PRODUCTS["attn"] + ffn
                                       + 2 * per_norm)
               + per_norm * cross)
    return {"acd_evict": 0, "fifo_dispatch": 0,
            "matmul": prefill + decode * new,
            "flash_attention": n_attn * (1 + cross) + cfg.encoder_layers,
            "flash_decode": n_attn * (1 + cross) * new,
            "rglru": kinds.count("rglru") * (1 + new), "rglru_bwd": 0,
            "rwkv6": kinds.count("rwkv6") * (1 + new), "rwkv6_bwd": 0}


def serve_full(arch, dev, seed, layers=None):
    """One architecture's full config on the card (``layers`` of its layers
    where given; weights drawn from a seeded generator there): a warm-up
    batch, then the timed batch (and the long batch where it has one) with
    every kernel's launch count, the logits checks, the decode step with
    fused activations (dense and recurrent configs), and for rwkv6 and
    llama3-8b a profiler pass (olmoe-1b-7b: its serve batch only).
    Returns ({kernel: launches in the timed batches}, {batch label:
    (completions, wall)}). An
    architecture whose cache has another dtype than its activations
    (qwen1.5-32b's fp8) also runs the same weights with a cache in the
    activations' dtype, and an MoE one at capacity factor E/k
    (:func:`decode_against_prefill`, bit for bit), and its serve batch
    through the ``scatter`` dispatch (:func:`scatter_batch`). An
    encoder-decoder (whisper-large-v3) serves through
    :class:`PrefixEngine`, each batch with frames of its own; it prints
    each prefill's encoder share (:func:`encoder_share`), and its serve
    batch's prefill and SHORT_DECODE greedy steps are held bit for bit
    against prefill(S+1) with the same frames."""
    import dataclasses
    import gc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.serving import InferenceEngine

    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    kinds = [cfg.layer_kind(i) for i in range(cfg.num_layers)]
    if arch in (QWEN, ARCTIC, VLM):
        memory_reckoning(arch, cfg)
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
    for i, (label, reqs, cache_len) in enumerate(serve_batches(
            cfg, arch, SERVE_NEW)):
        frames = patches = None
        if cfg.is_encdec:
            frames = draw_frames(cfg, len(reqs), dev, seed * 10 + i)
            engine = PrefixEngine(model, cache_len, frames=frames)
        elif cfg.vision_patches:
            patches = draw_patches(cfg, len(reqs), dev, seed * 10 + i)
            engine = PrefixEngine(model, cache_len, patches=patches)
        else:
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
        check_serve_logits(f"{arch} {label}", model, reqs, outs, cache_len,
                           frames, patches)
        runs[label] = (outs, wall)
        if arch in ("rwkv6-1.6b", "llama3-8b") or (
                arch in (OLMOE, WHISPER, VLM) and label == "batch"):
            profile_serve(arch, engine, reqs, wall)
        if cfg.is_encdec:
            encoder_share(f"{arch} {label}", model, frames, outs)
        elif label == "batch" and arch == QWEN:
            time_kv_cast(arch, engine, reqs)
        elif label == "batch" and cfg.num_experts:
            scatter_batch(arch, engine, reqs, outs)
        elif label == "batch" and not cfg.vision_patches:
            time_activations(arch, engine, reqs)
        print(f"serve {arch} {label}: peak device memory so far "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB")
    if cfg.kv_dtype != cfg.dtype:
        # the same weights with a cache in the activations' dtype: each
        # decode step prefill(S+1)'s bits again
        model.cfg = dataclasses.replace(cfg, kv_dtype=cfg.dtype)
        decode_against_prefill(f"{arch}, {cfg.dtype} cache", model)
        model.cfg = cfg
    if may_drop(cfg):
        # at capacity E/k nothing drops: each decode step prefill(S+1)'s
        # bits again
        model.cfg = dataclasses.replace(
            cfg, capacity_factor=cfg.num_experts / cfg.top_k)
        decode_against_prefill(f"{arch}, capacity factor E/k = "
                               f"{model.cfg.capacity_factor:g}", model)
        model.cfg = cfg
    if cfg.is_encdec:
        engine = frames = None  # free the last batch's frames
        decode_against_prefill(arch, model, draw_frames(
            cfg, SERVE_REQUESTS, dev, seed * 10 + 9))
    if cfg.vision_patches:
        engine = patches = None
        decode_against_prefill(arch, model, patches=draw_patches(
            cfg, SERVE_REQUESTS, dev, seed * 10 + 9))
    print(f"serve {arch}: peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    del model, engine
    gc.collect()
    torch.cuda.empty_cache()
    return launches, runs


def scatter_batch(arch, engine, reqs, einsum_outs):
    """The serve batch through the ``scatter`` dispatch, its launches
    counted against ``expected_launches`` (the same as ``einsum``'s). The
    two paths compute other functions (``einsum`` weights each kept
    expert by the token's summed kept gates, ``scatter`` by its own gate:
    ROADMAP Queue 3 item 17), so their greedy tokens are compared as a
    reading only; the scatter prefill's logits must be finite."""
    import numpy as np
    import torch

    model = engine.model
    model.moe_dispatch = "scatter"
    try:
        outs, counts, _ = serve_batch(f"{arch} batch, scatter dispatch",
                                      engine, reqs)
        toks = torch.from_numpy(padded(reqs)).to(model.device)
        ls, _ = model.prefill(toks, cache_len=engine.cache_len)
    finally:
        model.moe_dispatch = "einsum"
    want = expected_launches(model.cfg, max(r.max_new_tokens for r in reqs))
    same = sum(int(np.sum(a.tokens == b.tokens))
               for a, b in zip(outs, einsum_outs))
    total = sum(a.tokens.size for a in outs)
    finite = bool(torch.isfinite(ls).all())
    print(f"serve {arch} scatter against einsum (a reading: other "
          f"functions): {same} of {total} greedy tokens equal; scatter "
          f"prefill logits finite {finite}")
    if counts != want or not finite:
        raise AssertionError(f"serve {arch} scatter: launches {counts}, "
                             f"expected {want}; finite {finite}")


def decode_against_prefill(label, model, frames=None, patches=None):
    """The serve batch's prefill and SHORT_DECODE greedy decode steps on
    ``model`` (bf16; an encoder-decoder's with ``frames``, a vision
    config's with ``patches`` in front, each prefill with the same ones),
    each step's logits bit for bit (and within INCR_TOL of) the card's own
    prefill of the tokens so far, every kernel's launches counted against
    ``expected_launches``. Raises on a miss; returns the launches."""
    import torch

    from repro_torch.kernels import ops

    cfg = model.cfg
    dev = model.device
    kw, n_prefix = prefix_kw(frames, patches)
    cache_len = SERVE_CACHE + n_prefix
    reqs = serve_requests(cfg, SERVE_REQUESTS, SERVE_PROMPT, SHORT_DECODE,
                          SERVE_SEED)
    toks = torch.from_numpy(padded(reqs)).to(dev)
    S = toks.shape[1]
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    logits, cache = model.prefill(toks, cache_len=cache_len, **kw)
    steps = []
    for i in range(SHORT_DECODE):
        tok = torch.argmax(logits, -1)
        toks = torch.cat([toks, tok[:, None]], 1)
        logits, cache = model.decode_step(cache, tok, n_prefix + S + i)
        steps.append(logits)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    want = expected_launches(cfg, SHORT_DECODE)
    readings, ok = [], counts == want
    del cache
    for i, dec in enumerate(steps):
        full, _ = model.prefill(toks[:, :S + i + 1], cache_len=cache_len,
                                **kw)
        d, f = dec.float(), full.float()
        bad = (d - f).abs() > INCR_TOL["atol"] + INCR_TOL["rtol"] * f.abs()
        ok = (ok and not bool(bad.any()) and bool(torch.isfinite(d).all())
              and torch.equal(dec, full))  # bf16: bit for bit
        readings.append(f"{int(bad.sum())} beyond (max abs diff "
                        f"{float((d - f).abs().max())!r}, bitwise equal "
                        f"{torch.equal(dec, full)})")
    print(f"serve {label} at {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.num_heads} heads over {cfg.num_kv_heads} KV "
          f"heads, head_dim {cfg.hd}: prefill {S} tokens + {SHORT_DECODE} "
          f"decode steps in {wall:.3f} s; each step against prefill(S+1) at "
          f"INCR_TOL: {'; '.join(readings)}; launches {counts}")
    if not ok:
        raise AssertionError(f"serve {label}: decode steps != prefill(S+1)"
                             f" (launches expected {want})")
    return counts


def serve_short(arch, dev, seed):
    """A dense architecture at full width and SHORT_LAYERS layers, bf16:
    :func:`decode_against_prefill`. Returns the launches."""
    import dataclasses
    import gc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import Model

    cfg = dataclasses.replace(get_config(arch), num_layers=SHORT_LAYERS)
    model = Model(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(seed))
    try:
        return decode_against_prefill(arch, model)
    finally:
        del model
        gc.collect()
        torch.cuda.empty_cache()


def memory_reckoning(arch, cfg):
    """Prints what the full config takes on the card, from its parameter
    shapes (a model on the meta device) and its caches, beside
    ``torch.cuda.mem_get_info``, before its weights are drawn; raises if
    another model is still resident (over 1 GiB allocated)."""
    import gc

    import torch

    from repro_torch.models import Model
    from repro_torch.models.layers import dtype_of

    meta = Model(cfg, device="meta")
    n_params = sum(p.numel() for p in meta.parameters())
    n_bytes = sum(p.numel() * p.element_size() for p in meta.parameters())
    kv = torch.empty((), dtype=dtype_of(cfg.kv_dtype)).element_size()
    per_slot = 2 * cfg.num_kv_heads * cfg.hd * len(cfg.attn_layers) * kv
    gib = 2 ** 30
    batches = [("serve batch", SERVE_REQUESTS, SERVE_CACHE)]
    if arch in LONG:
        batches.append(("long batch", LONG_BATCH, LONG[arch][1]))
    caches = "; ".join(
        f"{label} {B} x {c} slots {B * c * per_slot / gib:.3f} GiB"
        for label, B, c in batches + [("a 2 x 4112 batch", 2, 4112)])
    print(f"serve {arch} memory reckoning: {n_params} parameters, "
          f"{n_bytes} bytes ({n_bytes / 1e9:.3f} GB, {n_bytes / gib:.3f} "
          f"GiB); a {cfg.kv_dtype} cache of {per_slot} bytes a request and "
          f"slot over {len(cfg.attn_layers)} layers: {caches} "
          f"(check_serve_logits holds two at once)")
    del meta
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    held = torch.cuda.memory_allocated()
    print(f"serve {arch}: before the draw torch.cuda.mem_get_info "
          f"{free} of {total} bytes free ({free / gib:.3f} of "
          f"{total / gib:.3f} GiB); {held} bytes allocated by this process")
    if held > gib:
        raise AssertionError(f"serve {arch}: {held} bytes still "
                             f"allocated before the draw")


def time_activations(arch, engine, reqs, n=1):
    """The decode step with the port's activations (``layers.gelu``,
    ``silu``, ``sigmoid``: one op per op of XLA's expansion, for bf16
    parity with the reference) against torch's fused ``F.gelu(approximate=
    "tanh")``, ``F.silu`` and ``torch.sigmoid`` swapped in: ``n``
    ``generate_batch`` calls each, alternating; prints each one's median
    decode ms per step (one call each: three took ~27 s of a 1,277 s run
    on a slow host). A measurement of what the parity costs; the fused
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


def time_kv_cast(arch, engine, reqs, n=1):
    """The fp8-cache decode step with its bf16 K/V rows cast by torch's own
    kernel (``layers.to_kv``'s path on a device where that cast equals
    XLA's on every bf16 input) against the cast on the float32 bits
    (``layers._to_e4m3fn``, ~15 elementwise ops a call, two calls a
    layer): ``n`` ``generate_batch`` calls each, alternating, the same
    tokens required; prints each one's median decode ms per step."""
    import statistics

    import numpy as np

    from repro_torch.models import layers

    dev = engine.model.device
    if not layers._bf16_cast_is_xla(dev):
        print(f"serve {arch} K/V cast: torch's cast differs from XLA's on "
              f"this card; every cast takes the float32-bit path")
        return
    steps = max(r.max_new_tokens for r in reqs)
    per_step, tokens = {"torch": [], "bits": []}, {}
    try:
        for _ in range(n):
            for name, fast in (("torch", True), ("bits", False)):
                layers._BF16_CAST_IS_XLA[dev] = fast
                outs = engine.generate_batch(reqs)
                per_step[name].append(outs[0].decode_s / steps * 1e3)
                tokens[name] = [c.tokens for c in outs]
    finally:
        layers._BF16_CAST_IS_XLA[dev] = True
    same = all(np.array_equal(a, b)
               for a, b in zip(tokens["torch"], tokens["bits"]))
    med = {k: statistics.median(v) for k, v in per_step.items()}
    print(f"serve {arch} K/V cast: decode ms per step, torch's cast "
          f"{med['torch']:.3f} (runs "
          f"{', '.join(f'{x:.3f}' for x in per_step['torch'])}), the "
          f"float32-bit cast {med['bits']:.3f} (runs "
          f"{', '.join(f'{x:.3f}' for x in per_step['bits'])}): "
          f"{med['bits'] - med['torch']:.3f} ms per step; the same tokens "
          f"{same}")
    if not same:
        raise AssertionError(f"serve {arch}: the two casts' tokens differ")


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


def check_serve_against_cpu(arch, dev, seed, smoke=False):
    """The architecture at full width and CPU_LAYERS depth (or at its smoke
    config) in float32, the same weights on the card and the CPU (drawn on
    the card, copied), CPU_SERVE_REQUESTS requests: the
    engine's greedy tokens over CPU_DECODE steps equal, prefill logits
    within CPU_RTOL of their scale; float32 products in IEEE float32. Then,
    as a reading, the CPU's bf16 prefill(S) + decode_step against
    prefill(S+1) with the same weights rounded to bf16, on the shorter
    request."""
    import dataclasses
    import gc

    import numpy as np
    import torch

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core.precision import ieee_float32
    from repro_torch.models import Model
    from repro_torch.serving import InferenceEngine

    cfg = (get_smoke_config(arch) if smoke else dataclasses.replace(
        get_config(arch), num_layers=CPU_LAYERS[arch]))
    cfg = dataclasses.replace(cfg, dtype="float32", kv_dtype="float32")
    card = Model(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(seed))
    cpu = Model(cfg, device="cpu")
    cpu.load_state_dict(card.state_dict())
    reqs = serve_requests(cfg, CPU_SERVE_REQUESTS, SERVE_PROMPT, CPU_DECODE,
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
    print(f"serve {cfg.name} at {cfg.num_layers} layers, float32: card "
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
    short = min(reqs, key=lambda r: r.prompt_len)
    _, dec, full, _, line, _ = incremental_gap(
        cpu, torch.from_numpy(padded([short])), SERVE_CACHE)
    print(f"serve {cfg.name} at {cfg.num_layers} layers, bf16 on the CPU, "
          f"1 request ({time.perf_counter() - t0:.3f} s): {line}; bitwise "
          f"equal {torch.equal(dec, full)}")
    del card, cpu
    gc.collect()
    torch.cuda.empty_cache()
    if not same or rel > CPU_RTOL:
        raise AssertionError(f"serve {arch}: card != CPU")


def draw_frames(cfg, n, dev, seed):
    """``n`` requests' frame embeddings [n, encoder_seq, d_model], float32,
    N(0, FRAMES_STD) from a seeded generator on ``dev``."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn((n, cfg.encoder_seq, cfg.d_model), generator=g,
                       device=dev) * FRAMES_STD


class PrefixEngine:
    """``InferenceEngine.generate_batch`` for an encoder-decoder model or a
    vision-language one: the same left padding, greedy loop and host-clock
    timing (each phase ending in a sync on the card), with the batch's
    ``frames`` or ``patches`` handed to prefill (decode steps after P
    patches start at P + S). The port's engine, like the reference's,
    calls prefill without them (ROADMAP Queue 3 item 19)."""

    def __init__(self, model, cache_len, frames=None, patches=None):
        self.model, self.cache_len = model, cache_len
        self.kw, self.n_prefix = prefix_kw(frames, patches)

    def generate_batch(self, reqs):
        import torch

        from repro_torch.serving import Completion

        model, dev = self.model, self.model.device

        def sync():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        toks = torch.from_numpy(padded(reqs)).to(dev)
        b, pmax = toks.shape
        n_new = max(r.max_new_tokens for r in reqs)
        with torch.inference_mode():
            t0 = time.perf_counter()
            logits, cache = model.prefill(toks, cache_len=self.cache_len,
                                          **self.kw)
            sync()
            prefill_s = time.perf_counter() - t0
            out = torch.zeros((b, n_new), dtype=torch.int32, device=dev)
            t0 = time.perf_counter()
            tok = torch.argmax(logits, -1).to(torch.int32)
            for i in range(n_new):
                out[:, i] = tok
                logits, cache = model.decode_step(cache, tok,
                                                  self.n_prefix + pmax + i)
                tok = torch.argmax(logits, -1).to(torch.int32)
            sync()
            decode_s = time.perf_counter() - t0
        out_np = out.cpu().numpy()
        return [Completion(r.rid, out_np[i, :r.max_new_tokens], prefill_s,
                           decode_s) for i, r in enumerate(reqs)]


def encoder_share(label, model, frames, outs, n=3):
    """The encoder alone (``Model._encode`` of the batch's frames, host
    clock ending in a sync, the median of ``n`` calls) beside the batch's
    prefill wall: the encoder's share of the prefill."""
    import statistics

    import torch

    with torch.inference_mode():
        x = frames.to(model.embed.dtype)
        walls = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model._encode(x)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
    enc_s, pre_s = statistics.median(walls), outs[0].prefill_s
    print(f"serve {label}: the encoder over {list(frames.shape)} frames "
          f"{enc_s * 1e3:.3f} ms (median of {n}: "
          f"{', '.join(f'{w * 1e3:.3f}' for w in walls)}) of a "
          f"{pre_s * 1e3:.3f} ms prefill: {enc_s / pre_s:.4f} of it")


def whisper_rows():
    """The row counts whisper-large-v3's weight products take in phase 8d:
    {label: M} for the decode steps (8, 32), the prefills' decoder rows
    (the serve batch's 8 x longest prompt, the transcription batch's
    32 x 4) and the encoder's (8 and 32 x 1,500; the cross wk / wv too)."""
    from repro_torch.configs import get_config

    se = get_config(WHISPER).encoder_seq
    n, prompt, _, _ = TRANSCRIBE
    return {"decode": SERVE_REQUESTS, "transcription decode": n,
            "prefill": SERVE_REQUESTS * longest_prompt(WHISPER),
            "transcription prefill": n * prompt,
            "encoder": SERVE_REQUESTS * se,
            "transcription encoder": n * se}


def sampled_rows(m):
    """Every row of ``m`` up to 1,024; else the first and last 64 and every
    997th between."""
    return (range(m) if m <= 1024 else
            [*range(64), *range(64, m - 64, 997), *range(m - 64, m)])


def check_whisper_products(dev):
    """The bf16 ``matmul`` at whisper-large-v3's weight products, against its
    plain version and timed (:func:`bf16_timed`) at every row count of
    :func:`whisper_rows`: the attention projections (d -> d: wq, wk, wv,
    wo, the cross wk / wv at the encoder's rows) and the FFN's (d -> ff,
    ff -> d), each a layer view of a stacked [2, K, N] parameter, and the
    head [1280, 51866] at the decode rows (a 103,732-byte row stride, so no
    TMA: thread-staged; N & 3 = 2, so scalar stores); every row of
    ``linear`` (sampled past 1,024 rows) bit for bit the row computed
    alone, and so every row of the norms' row mean at d = 1280. Returns the
    timings for matmul's "bf16" entry."""
    import gc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.precision import ieee_float32
    from repro_torch.models.layers import linear, row_mean

    cfg = get_config(WHISPER)
    d, ff, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    g = torch.Generator(device=dev).manual_seed(27)
    bf16 = torch.bfloat16
    rows = whisper_rows()
    reps = {m: 50 if m <= 1024 else 5 for m in rows.values()}
    timings = []

    def check_rows(label, x, w):
        full = linear(x, w)
        pick = sampled_rows(x.shape[0])
        same = sum(torch.equal(linear(x[i:i + 1], w)[0], full[i])
                   for i in pick)
        print(f"linear rows {label}: {same} of {len(pick)} rows bitwise "
              f"equal to the row alone")
        if same != len(pick):
            raise AssertionError(f"linear {label}: rows depend on the row "
                                 f"count")

    for K, N in ((d, d), (d, ff), (ff, d)):
        w = (torch.randn(2, K, N, device=dev, generator=g)
             * K ** -0.5).to(bf16)[1]  # a layer's view
        for label, m in rows.items():
            x = torch.randn(m, K, device=dev, generator=g).to(bf16)
            with ieee_float32():
                timings.append(bf16_timed(
                    f"{WHISPER} {label} [{m}, {K}] @ layer view [{K}, {N}]",
                    f"whisper {label}", x, w, reps[m]))
            check_rows(f"{WHISPER} {label} [{m}, {K}] @ [{K}, {N}] bf16", x,
                       w)
            del x
        del w
        gc.collect()
        torch.cuda.empty_cache()
    w = (torch.randn(d, V, device=dev, generator=g) * d ** -0.5).to(bf16)
    for label in ("decode", "transcription decode"):
        m = rows[label]
        x = torch.randn(m, d, device=dev, generator=g).to(bf16)
        with ieee_float32():
            timings.append(bf16_timed(
                f"{WHISPER} head {label} [{m}, {d}] @ [{d}, {V}] strides "
                f"{w.stride()}", f"whisper head {label}", x, w, 20))
        check_rows(f"{WHISPER} head [{m}, {d}] @ [{d}, {V}] bf16", x, w)
    del w, x
    # the norms' row means at d = 1280 (first level [rows * 20, 64])
    for label, m in rows.items():
        x = torch.randn(m, d, device=dev, generator=g) * 3
        full = row_mean(x * x)
        pick = sampled_rows(m)
        same = sum(torch.equal(row_mean(x[i:i + 1] * x[i:i + 1])[0],
                               full[i]) for i in pick)
        print(f"row_mean rows {WHISPER} {label} [{m}, {d}] float32: {same} "
              f"of {len(pick)} rows bitwise equal to the row alone")
        if same != len(pick):
            raise AssertionError(f"row_mean [{m}, {d}]: rows depend on the "
                                 f"row count")
    del x, full
    gc.collect()
    torch.cuda.empty_cache()
    return timings


def check_whisper_attention(dev):
    """whisper-large-v3's attention shapes (20 heads of 64 over 20 KV heads,
    bf16) at the serve batch (8 x its longest prompt, cache_len 192) and
    the transcription batch (32 x 4 tokens, cache_len 448): the encoder's
    causal self-attention over 1,500 frames, the decoder's causal
    self-attention, the cross-attention's prefill (not causal, Sq tokens
    over 1,500 keys), and at a decode step the self-attention over the
    cache (length S + 1, called with ``end`` as the model calls it) and the
    cross-attention over all 1,500 slots. Each kernel against its plain
    version, then timed beside its plain version,
    ``scaled_dot_product_attention`` and its bound. Returns {kernel: [its
    shapes' timings]} for the kernels line."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import (flash_attention_plain,
                                         flash_decode_plain)

    cfg = get_config(WHISPER)
    H, D, se = cfg.num_heads, cfg.hd, cfg.encoder_seq
    g = torch.Generator(device=dev).manual_seed(28)
    bf16 = torch.bfloat16
    n, prompt, _, cache = TRANSCRIBE
    out = {"flash_attention": [], "flash_decode": []}
    for batch, B, S, C in (("serve", SERVE_REQUESTS, longest_prompt(WHISPER),
                            SERVE_CACHE), ("transcription", n, prompt,
                                           cache)):
        for what, sq, sk, causal in (("encoder", se, se, True),
                                     ("decoder self", S, S, True),
                                     ("cross prefill", S, se, False)):
            q = head_split(B, sq, H, D, bf16, dev, g)
            k, v = (head_split(B, sk, H, D, bf16, dev, g) for _ in range(2))
            label = (f"flash_attention {WHISPER} {batch} {what} [{B}, "
                     f"{H}/{H}, {sq}x{sk}, {D}] bf16 causal={causal}")
            err = attn_check(label, ops.flash_attention(q, k, v,
                                                        causal=causal),
                             flash_attention_plain(q, k, v, causal=causal),
                             v)
            reps = 5 if sq * sk * B > 10 ** 7 else 50
            k_ms = cuda_ms(lambda: ops.flash_attention(q, k, v,
                                                       causal=causal), reps)
            p_ms = cuda_ms(lambda: flash_attention_plain(q, k, v,
                                                         causal=causal), 1)
            l_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal), reps)
            bound, by, n_bytes, n_ops = bound_of(cost.flash_attention(
                (B, H, sq, D), (B, H, sk, D), bf16, causal, None),
                "bfloat16")
            print(f"{label}: kernel {k_ms:.6f} ms ({n_ops / k_ms * 1e-9:.3f} "
                  f"TFLOP/s), plain {p_ms:.3f} ms, "
                  f"scaled_dot_product_attention {l_ms:.6f} ms, bound "
                  f"{bound:.6f} ms by {by} (bytes {n_bytes}, operations "
                  f"{n_ops}); kernel at {bound / k_ms:.4f} of the bound, "
                  f"{k_ms / l_ms:.2f}x the library call")
            out["flash_attention"].append({
                "shape": f"{batch} {what} [{B}, {H}, {sq}, {sk}, {D}]",
                "causal": causal, "max_abs_err": err, "ms": k_ms,
                "plain_ms": p_ms, "bound_ms": bound, "bound_by": by,
                "library_ms": l_ms})
            del q, k, v
        for what, slots, n_live in (("decode self", C, S + 1),
                                    ("decode cross", se, se)):
            q = head_split(B, 1, H, D, bf16, dev, g)[:, :, 0]
            k, v = (torch.randn(B, H, slots, D, device=dev,
                                generator=g).to(bf16) for _ in range(2))
            length = torch.full((B,), n_live, dtype=torch.int32, device=dev)
            end = length if what == "decode self" else None
            label = (f"flash_decode {WHISPER} {batch} {what} q [{B}, {H}, "
                     f"{D}], cache [{B}, {H}, {slots}, {D}] bf16, length "
                     f"{n_live}")
            err = attn_check(label, ops.flash_decode(q, k, v, length, end),
                             flash_decode_plain(q, k, v, length, end), v)
            k_ms = cuda_ms(lambda: ops.flash_decode(q, k, v, length, end),
                           50)
            p_ms = cuda_ms(lambda: flash_decode_plain(q, k, v, length, end),
                           5)
            mask = (torch.arange(slots, device=dev)
                    < n_live)[None, None, None, :]
            q4 = q[:, :, None]
            l_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                q4, k, v, attn_mask=mask), 50)
            bound, by, n_bytes, n_ops = bound_of(cost.flash_decode(
                (B, H, D), H, bf16, bf16, B * n_live), "bfloat16")
            print(f"{label}: kernel {k_ms:.6f} ms "
                  f"({n_bytes / k_ms * 1e-9:.3f} TB/s), plain {p_ms:.6f} ms,"
                  f" scaled_dot_product_attention {l_ms:.6f} ms, bound "
                  f"{bound:.6f} ms by {by} (bytes {n_bytes}, operations "
                  f"{n_ops}); kernel at {bound / k_ms:.4f} of the bound, "
                  f"{k_ms / l_ms:.2f}x the library call")
            out["flash_decode"].append({
                "shape": f"{batch} {what} [{B}, {H}, {slots}, {D}] length "
                         f"{n_live}", "max_abs_err": err, "ms": k_ms,
                "plain_ms": p_ms, "bound_ms": bound, "bound_by": by,
                "library_ms": l_ms})
            del q, k, v
    torch.cuda.empty_cache()
    return out


def check_whisper_against_cpu(dev, seed):
    """whisper-large-v3 at full width and WHISPER_CPU_LAYERS encoder and
    decoder layers in float32 (IEEE float32 products), the same weights
    and frames on the card and the CPU (drawn on the card, copied), the
    serve batch's first WHISPER_CPU_REQUESTS requests: the encoder's output
    within ENC_RTOL of its largest value, the greedy tokens over
    CPU_DECODE steps equal, the prefill logits within CPU_RTOL of their
    scale."""
    import dataclasses
    import gc

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.precision import ieee_float32
    from repro_torch.models import Model

    cfg = dataclasses.replace(
        get_config(WHISPER), num_layers=WHISPER_CPU_LAYERS,
        encoder_layers=WHISPER_CPU_LAYERS, dtype="float32",
        kv_dtype="float32")
    card = Model(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(seed))
    cpu = Model(cfg, device="cpu")
    cpu.load_state_dict(card.state_dict())
    reqs = serve_requests(cfg, SERVE_REQUESTS, SERVE_PROMPT, CPU_DECODE,
                          SERVE_SEED)[:WHISPER_CPU_REQUESTS]
    frames = draw_frames(cfg, len(reqs), dev, seed)
    toks = torch.from_numpy(padded(reqs))
    res = {}
    for name, model, x in (("card", card, frames),
                           ("CPU", cpu, frames.cpu())):
        t0 = time.perf_counter()
        with ieee_float32(), torch.inference_mode():
            enc = model._encode(x)
            outs = PrefixEngine(model, SERVE_CACHE, frames=x
                                ).generate_batch(reqs)
            logits, _ = model.prefill(toks.to(model.device),
                                      cache_len=SERVE_CACHE, frames=x)
        res[name] = (enc.cpu(), outs, logits.cpu(),
                     time.perf_counter() - t0)
    (ec, oc, lc, tc), (eh, oh, lh, th) = res["card"], res["CPU"]
    same = all(np.array_equal(g.tokens, w.tokens) for g, w in zip(oc, oh))
    enc_rel = float((ec - eh).abs().max() / eh.abs().max())
    rel = float((lc - lh).abs().max() / lh.abs().max())
    finite = bool(torch.isfinite(ec).all() and torch.isfinite(lc).all())
    print(f"serve {cfg.name} at {cfg.encoder_layers} + {cfg.num_layers} "
          f"layers, float32, {len(reqs)} requests: card {tc:.3f} s, CPU "
          f"{th:.3f} s; encoder output {list(ec.shape)} differs by "
          f"{enc_rel!r} of its max (tolerance {ENC_RTOL}), finite {finite}; "
          f"greedy tokens over {CPU_DECODE} steps equal {same}; prefill "
          f"logits differ by {rel!r} of their max (tolerance {CPU_RTOL})")
    del card, cpu
    gc.collect()
    torch.cuda.empty_cache()
    if not (same and finite and enc_rel <= ENC_RTOL and rel <= CPU_RTOL):
        raise AssertionError(f"serve {WHISPER}: card != CPU")


def draw_patches(cfg, n, dev, seed):
    """``n`` requests' patch embeddings [n, vision_patches, d_model],
    float32, N(0, PATCHES_STD) from a seeded generator on ``dev``."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn((n, cfg.vision_patches, cfg.d_model), generator=g,
                       device=dev) * PATCHES_STD


def check_vlm_against_cpu(dev, seed):
    """internvl2-76b at full width and VLM_CPU_LAYERS layers in float32
    (IEEE float32 products), the same weights and patches on the card and
    the CPU (drawn on the card, copied), the serve batch's first
    VLM_CPU_REQUESTS requests: the greedy tokens over CPU_DECODE steps
    equal, the prefill logits within CPU_RTOL of their scale."""
    import dataclasses
    import gc

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.precision import ieee_float32
    from repro_torch.models import Model

    cfg = dataclasses.replace(get_config(VLM), num_layers=VLM_CPU_LAYERS,
                              dtype="float32", kv_dtype="float32")
    card = Model(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(seed))
    cpu = Model(cfg, device="cpu")
    cpu.load_state_dict(card.state_dict())
    reqs = serve_requests(cfg, SERVE_REQUESTS, SERVE_PROMPT, CPU_DECODE,
                          SERVE_SEED)[:VLM_CPU_REQUESTS]
    patches = draw_patches(cfg, len(reqs), dev, seed)
    toks = torch.from_numpy(padded(reqs))
    cache_len = SERVE_CACHE + cfg.vision_patches
    res = {}
    for name, model, pt in (("card", card, patches),
                            ("CPU", cpu, patches.cpu())):
        t0 = time.perf_counter()
        with ieee_float32():
            outs = PrefixEngine(model, cache_len, patches=pt
                                ).generate_batch(reqs)
            logits, _ = model.prefill(toks.to(model.device),
                                      cache_len=cache_len, patches=pt)
        res[name] = (outs, logits.cpu(), time.perf_counter() - t0)
    (oc, lc, tc), (oh, lh, th) = res["card"], res["CPU"]
    same = all(np.array_equal(g.tokens, w.tokens) for g, w in zip(oc, oh))
    rel = float((lc - lh).abs().max() / lh.abs().max())
    finite = bool(torch.isfinite(lc).all())
    print(f"serve {cfg.name} at {cfg.num_layers} layers, float32, "
          f"{len(reqs)} requests with {cfg.vision_patches} patches each: "
          f"card {tc:.3f} s, CPU {th:.3f} s; greedy tokens over "
          f"{CPU_DECODE} steps equal {same}; prefill logits finite "
          f"{finite}, differ by {rel!r} of their max (tolerance "
          f"{CPU_RTOL})")
    del card, cpu
    gc.collect()
    torch.cuda.empty_cache()
    if not (same and finite and rel <= CPU_RTOL):
        raise AssertionError(f"serve {VLM}: card != CPU")


def free_card():
    """Return every cached block to the card (after a model is deleted)."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def check_backward_products(dev):
    """The bf16 ``matmul`` at llama3-8b's training products
    (TRAIN_PRODUCTS): each backward product as the autograd Function
    launches it (dX = g @ w.T, w.T a view; dW = x.T copied to be
    contiguous, then @ g) against its plain version, timed beside
    torch.matmul and its bound; beside dW, the copy's time and the same
    product on the x.T view, which TMA does not take (the thread-staged
    path), as a reading. Returns the entries for matmul's "train"
    timings."""
    import torch

    from repro_torch.core.precision import ieee_float32
    from repro_torch.kernels import ops

    g = torch.Generator(device=dev).manual_seed(90)
    out = []
    with ieee_float32():
        for label, (M, K, N) in TRAIN_PRODUCTS:
            bf = torch.bfloat16
            x = torch.randn((M, K), generator=g, device=dev).to(bf)
            w = (torch.randn((K, N), generator=g, device=dev)
                 * K ** -0.5).to(bf)
            dy = (torch.randn((M, N), generator=g, device=dev) * 1e-2).to(bf)
            out.append(bf16_timed(f"train dX {label}", "train dX", dy, w.T,
                                  5))
            xt = ops._left_operand(x.T)
            if xt.stride(1) != 1:
                raise AssertionError(f"train dW {label}: x.T not copied")
            entry = bf16_timed(f"train dW {label}", "train dW", xt, dy, 5)
            entry["copy_ms"] = cuda_ms(lambda: x.T.contiguous(), 5)
            entry["view_ms"] = cuda_ms(lambda: ops.matmul(x.T, dy), 3)
            print(f"matmul train dW {label}: x.T copy {entry['copy_ms']:.6f}"
                  f" ms; the product on the x.T view (thread-staged) "
                  f"{entry['view_ms']:.6f} ms against {entry['ms']:.6f} ms "
                  f"on the copy")
            out.append(entry)
            del x, w, dy, xt
            free_card()
    return out


def check_attention_backward(dev):
    """``flash_attention`` at llama3-8b's training shape (TRAIN_ATTN,
    causal, bf16) as training runs it: the kernel's forward, the torch
    backward (``ops.flash_attention_backward``), each timed, beside SDPA's
    forward and forward + backward on the same inputs; the backward's
    gradients against autograd through SDPA in float32 (the backward is
    float32 math: within 1e-2 of each gradient's scale, the bf16 inputs'
    rounding). Returns the reading for flash_attention's "train" entry."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops

    B, Hq, Hkv, S, D = TRAIN_ATTN
    g = torch.Generator(device=dev).manual_seed(91)
    q = torch.randn((B, Hq, S, D), generator=g, device=dev).bfloat16()
    k, v = (torch.randn((B, Hkv, S, D), generator=g, device=dev).bfloat16()
            for _ in range(2))
    dout = torch.randn((B, Hq, S, D), generator=g, device=dev).bfloat16()
    out = ops.flash_attention(q, k, v)
    dq, dk, dv = ops.flash_attention_backward(q, k, v, out, dout)
    qs, ks, vs = (t.float().requires_grad_(True) for t in (q, k, v))
    rep = Hq // Hkv
    ref = F.scaled_dot_product_attention(
        qs, ks.repeat_interleave(rep, 1), vs.repeat_interleave(rep, 1),
        is_causal=True)
    ref.backward(dout.float())
    errs = [float((a.float() - b.grad).abs().max() / b.grad.abs().max())
            for a, b in zip((dq, dk, dv), (qs, ks, vs))]
    del qs, ks, vs, ref
    fwd_ms = cuda_ms(lambda: ops.flash_attention(q, k, v), 10)
    bwd_ms = cuda_ms(lambda: ops.flash_attention_backward(q, k, v, out,
                                                          dout), 5)
    kr, vr = (t.repeat_interleave(rep, 1) for t in (k, v))
    lib_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, kr, vr, is_causal=True), 10)
    qg, kg, vg = (t.detach().clone().requires_grad_(True)
                  for t in (q, kr, vr))

    def sdpa_step():
        o = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
        o.backward(dout)
    lib_step = cuda_ms(sdpa_step, 5)
    print(f"flash_attention train [{B}, {Hq}/{Hkv}, {S}, {D}] bf16 causal: "
          f"kernel forward {fwd_ms:.6f} ms, torch backward {bwd_ms:.6f} ms "
          f"(SDPA forward {lib_fwd:.6f} ms, forward + backward "
          f"{lib_step:.6f} ms); backward against SDPA's float32 autograd: "
          f"dq, dk, dv within {errs} of their scale")
    if max(errs) > 1e-2 or not all(e == e for e in errs):
        raise AssertionError("flash_attention backward != SDPA's")
    return {"shape": [B, Hq, Hkv, S, D], "forward_ms": fwd_ms,
            "backward_ms": bwd_ms, "sdpa_forward_ms": lib_fwd,
            "sdpa_forward_backward_ms": lib_step, "grad_err_of_scale": errs}


def check_rglru_backward(dev):
    """``rglru_bwd`` against its plain version on the card, bit for bit
    (every operation elementwise; NaN where the reference's autodiff gives
    NaN): at recurrentgemma-9b's training shape [TRAIN_BATCH, TRAIN_SEQ,
    4096] from zeros with no dh_T (as ``loss_fn`` calls it), from a
    nonzero h0 and dh_T, and at a ragged [3, 37, 300] with four steps at a
    = 1 exactly; then its time by CUDA events, the plain version's and the
    bound. Returns its entry of the kernels line."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import rglru_backward_plain

    g = torch.Generator(device=dev).manual_seed(23)

    def inputs(B, T, D, with_state, a_one=False):
        x = torch.randn(B, T, D, device=dev, generator=g)
        a = torch.rand(B, T, D, device=dev, generator=g) * 0.98 + 0.01
        if a_one:
            a[:, 5:9] = 1.0
            x[0, 5:9, :3] = 0.0
        h0, dhT = (torch.randn(B, D, device=dev, generator=g)
                   if with_state else None for _ in range(2))
        dy = torch.randn(B, T, D, device=dev, generator=g)
        return x, a, ops.rglru(x, a, h0)[0], dy, h0, dhT

    B, T, D = TRAIN_BATCH, TRAIN_SEQ, 4096
    train = inputs(B, T, D, False)
    err = 0.0
    for label, args in (("from zeros, no dh_T (the training call)", train),
                        ("from h0 with dh_T", inputs(B, T, D, True)),
                        ("from h0 with dh_T, a = 1 at 4 steps",
                         inputs(3, 37, 300, True, True))):
        got = ops.rglru_bwd(*args)
        want = rglru_backward_plain(*args)
        torch.cuda.synchronize()
        same = all(torch.equal(x.isnan(), y.isnan())
                   and torch.equal(torch.nan_to_num(x), torch.nan_to_num(y))
                   for x, y in zip(got, want))
        e = max(float((torch.nan_to_num(x) - torch.nan_to_num(y)).abs()
                      .max()) for x, y in zip(got, want))
        err = max(err, e)
        print(f"rglru_bwd {list(args[0].shape)} f32 {label}: dx, da, dh0 "
              f"bitwise equal to the plain version {same} (max_abs_err "
              f"{e!r}, non-finite da {int((~torch.isfinite(got[1])).sum())}"
              f")")
        if not same:
            raise AssertionError(f"rglru_bwd {label}: kernel != plain")
    k_ms = cuda_ms(lambda: ops.rglru_bwd(*train), 20)
    p_ms = cuda_ms(lambda: rglru_backward_plain(*train), 1)
    bound, by, n_bytes, n_ops = bound_of(cost.rglru_backward(
        B, T, D, False, False), "float32")
    print(f"rglru_bwd [{B}, {T}, {D}] f32: kernel {k_ms:.6f} ms "
          f"({n_bytes / k_ms * 1e-9:.3f} TB/s), plain {p_ms:.3f} ms, bound "
          f"{bound:.6f} ms by {by} (bytes {n_bytes}, operations {n_ops}); "
          f"kernel at {bound / k_ms:.3f} of the bound")
    return {"name": "rglru_bwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/rglru_bwd.cu",
            "replaces": "src/repro/kernels/rglru.py:51",
            "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": None}


def check_rwkv6_backward(dev):
    """``rwkv6_bwd`` against its plain version on the card: at rwkv6-1.6b's
    training shape [TRAIN_BATCH, 32, TRAIN_SEQ, 64] in bf16 on head views
    of [B, T, H, D] tensors with no s0 and no dS_T (as ``loss_fn`` calls
    it), in float32 from s0 with dS_T, and at a ragged [2, 3, 37, 32 / 60]
    in float32. All six outputs must be ``ref.rwkv6_backward_ordered``'s
    bit for bit (the kernel's fixed orders in torch). Every term of every
    sum is the plain version's bit for bit, so dr, dk, dv, dw and du must
    also lie within the bound two summation orders of their n terms allow
    (``ref.sum_order_bound``: 2 (n - 1) 2^-24 times the terms' magnitudes,
    plus a bf16 ulp in bf16); ds0, elementwise, bit for bit. Then its time
    by CUDA events and profiler device time at the training shape, the
    plain version's, the bound and the design's own count under its plan.
    Returns its entry of the kernels line."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import (rwkv6_backward_ordered,
                                         rwkv6_backward_plain,
                                         sum_order_bound)
    from repro_torch.kernels.rwkv6 import backward_plan

    g = torch.Generator(device=dev).manual_seed(24)

    def inputs(B, H, T, Dk, Dv, dt, with_state):
        def heads(D, scale=0.3, to=dt):
            return (torch.randn(B, T, H, D, device=dev, generator=g)
                    * scale).to(to).transpose(1, 2)
        r, k, v = heads(Dk), heads(Dk), heads(Dv)
        w = torch.exp(-torch.exp(heads(Dk, 1.0, torch.float32) - 4.0))
        u = torch.randn(H, Dk, device=dev, generator=g) * 0.1
        s0, dsT = (torch.randn(B, H, Dk, Dv, device=dev, generator=g)
                   if with_state else None for _ in range(2))
        return r, k, v, w, u, heads(Dv), s0, dsT

    def against_plain(label, args):
        got = ops.rwkv6_bwd(*args)
        ordered = rwkv6_backward_ordered(*args)
        torch.cuda.synchronize()
        bits = [torch.equal(x, y) for x, y in zip(got, ordered)]
        del ordered
        *want, sums = rwkv6_backward_plain(*args, term_sums=True)
        torch.cuda.synchronize()
        B, _, T, Dk = args[0].shape
        Dv = args[2].shape[-1]
        ok, worst, err = torch.equal(got[5], want[5]) and all(bits), 0.0, 0.0
        for gg, ww, sm, n in zip(got, want, sums,
                                 (Dv, Dv, Dk, Dv, Dv + B * T)):
            d = (gg.float() - ww.float()).abs()
            bound = sum_order_bound(sm, n, gg, ww)
            ok = ok and bool((d <= bound).all()) and gg.dtype == ww.dtype
            worst = max(worst, float((d / bound.clamp(min=1e-30)).max()))
            err = max(err, float(d.max()))
        print(f"rwkv6_bwd {list(args[0].shape)} Dv={Dv} "
              f"{str(args[0].dtype)[6:]} {label}: dr, dk, dv, dw, du, ds0 "
              f"bitwise equal to ref.rwkv6_backward_ordered {bits}; "
              f"against the plain version dr, dk, dv, dw, du "
              f"max_abs_err {err!r} (at most {worst:.3f} of the order "
              f"bound), ds0 bitwise equal {torch.equal(got[5], want[5])}; "
              f"gradient strides {[t.stride() for t in got[:4]]}")
        if not ok:
            raise AssertionError(f"rwkv6_bwd {label}: kernel != plain")
        return err

    B, H, T, Dk = TRAIN_BATCH, 32, TRAIN_SEQ, 64
    timed = inputs(B, H, T, Dk, Dk, torch.bfloat16, False)
    err = max(against_plain("no s0, no dS_T (the training call)", timed),
              against_plain("from s0 with dS_T",
                            inputs(B, H, T, Dk, Dk, torch.float32, True)),
              against_plain("ragged, from s0 with dS_T",
                            inputs(2, 3, 37, 32, 60, torch.float32, True)))
    k_ms = cuda_ms(lambda: ops.rwkv6_bwd(*timed), 5)
    d_ms = device_ms(lambda: ops.rwkv6_bwd(*timed), 5)[0]
    p_ms = cuda_ms(lambda: rwkv6_backward_plain(*timed), 1)
    bound, by, n_bytes, n_ops = bound_of(cost.rwkv6_backward(
        B, H, T, Dk, Dk, torch.bfloat16, False, False), "float32")
    plan = backward_plan(Dk, Dk)
    d_bound, d_by, d_bytes, d_ops = bound_of(cost.rwkv6_backward_kernel(
        B, H, T, Dk, Dk, torch.bfloat16, False, False, *plan), "float32")
    print(f"rwkv6_bwd [{B}, {H}, {T}, {Dk}] bf16: kernel {k_ms:.6f} ms by "
          f"events, {d_ms:.6f} ms of device time ({n_ops / k_ms * 1e-9:.3f}"
          f" TFLOP/s of the function's operations), plain {p_ms:.3f} ms, "
          f"bound {bound:.6f} ms by {by} (bytes {n_bytes}, operations "
          f"{n_ops}); kernel at {bound / k_ms:.3f} of the bound. The "
          f"design's own work under plan {tuple(plan)} (a second "
          f"recompute, unfactored terms, the checkpoints' round trip): "
          f"bytes {d_bytes}, operations {d_ops}, {d_bound:.6f} ms by "
          f"{d_by}; kernel at {d_bound / k_ms:.3f} of it")
    return {"name": "rwkv6_bwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/rwkv6_bwd.cu",
            "replaces": "src/repro/kernels/rwkv6.py:56",
            "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": None,
            "device_ms": finite(d_ms)}


def state_digest(params, opt):
    """Per leaf of the parameters and optimizer state, two int64 sums of
    its bit patterns (the bits, and each bit pattern times its top byte),
    slice by slice on the device: equal digests mean the same bits but
    for a permutation within a leaf."""
    import torch

    from repro_torch.training.checkpoint import _leaves
    from repro_torch.training.optimizer import _slices

    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    out = {}
    with torch.no_grad():
        for k, t in _leaves({"params": params, "opt": opt}):
            bits = t.detach().view(ints[t.element_size()])
            s1 = s2 = 0
            for idx in _slices(bits.shape):
                b = bits[idx].to(torch.int64)
                s1 = s1 + b.sum()
                s2 = s2 + (b * ((b >> 8) & 0xFF)).sum()
            out[k] = (int(s1), int(s2))
    return out


def train_full(dev):
    """llama3-8b at full width and depth, int8 moments: TRAIN_STEPS steps
    on the card, the first DIGEST_STEPS through ``launch/train.py``'s
    ``run`` (then a digest of the state, ``state_digest``, that phase 10
    holds its sharded steps to), the rest through the same trainer's
    ``fit``, with the launch counts set to 0 just before and read just
    after (each step exactly ``models.model.train_launches``), every loss
    and gradient norm finite; the steady step's time, tokens per second,
    its share of the card's bf16 peak at 6 N FLOP a token, peak memory;
    one more step under the profiler (device busy and idle share, top
    device operations: :func:`train_report`). Returns (launches a step,
    readings)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train

    cfg = get_config(TRAIN_ARCH)
    n_params = cfg.param_count()
    print(f"train {TRAIN_ARCH} memory reckoning: {n_params} parameters: "
          f"{2 * n_params / 1e9:.2f} GB of bf16 weights, as much of bf16 "
          f"gradients, {2 * n_params * (1 + 3 / 256) / 1e9:.2f} GB of int8 "
          f"moments with their float32 scales (float32 moments would take "
          f"{8 * n_params / 1e9:.2f} GB: with the weights and gradients "
          f"over the card's 80 GB); torch.cuda.mem_get_info "
          f"{torch.cuda.mem_get_info()[0] / 2 ** 30:.3f} GiB free")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    trainer, params, opt, log = launch_train.run(
        cfg, steps=DIGEST_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
        state_dtype="int8", device=dev, seed=TRAIN_SEED, log_every=1)
    torch.cuda.synchronize()
    first_peak = torch.cuda.max_memory_allocated()
    digest = state_digest(params, opt)
    data = SyntheticLM(cfg, DataConfig(TRAIN_SEQ, TRAIN_BATCH))
    params, opt, more = trainer.fit(
        params, opt, data.iterate(DIGEST_STEPS), steps=TRAIN_STEPS,
        start_step=DIGEST_STEPS, log_every=1)
    torch.cuda.synchronize()
    first = log
    log = log + more
    wall = time.perf_counter() - t0
    per_step, readings = train_report(TRAIN_ARCH, cfg, trainer, params, opt,
                                      log, wall, data)
    del trainer, params, opt
    free_card()
    readings["first"] = {"losses": [e["loss"] for e in first],
                         "grad_norms": [e["grad_norm"] for e in first],
                         "step_ms": readings["step_ms_all"][:DIGEST_STEPS],
                         "peak_memory_bytes": first_peak,
                         "digest": digest}
    return per_step, readings


def train_report(arch, cfg, trainer, params, opt, log, wall, data):
    """The end of a full-width training run of TRAIN_STEPS steps whose
    launch counts were set to 0 just before it: its launches read now
    (each step exactly ``models.model.train_launches``), every loss and
    gradient norm finite; the steady step's time, tokens per second, its
    share of the card's bf16 peak at 6 N FLOP a token, peak memory; one
    more step of ``data`` under the profiler (device busy and idle share,
    the port's kernels' shares of busy, top device operations). Returns
    (launches a step, readings)."""
    import statistics

    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models.model import RECURRENT, train_launches

    n_params = cfg.param_count()
    tokens = TRAIN_BATCH * TRAIN_SEQ
    counts = ops.launch_counts()
    per_step = train_launches(cfg, TRAIN_SEQ)
    want = {k: TRAIN_STEPS * per_step.get(k, 0) for k in counts}
    peak = torch.cuda.max_memory_allocated()
    steps_s = list(trainer.step_times)
    steady = statistics.median(steps_s[1:])
    share = 6 * n_params * tokens / steady / PEAK_OPS_PER_S["bfloat16"]
    ok = all(np.isfinite(e["loss"]) and np.isfinite(e["grad_norm"])
             for e in log)
    print(f"train {arch}: {TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ}"
          f" tokens in {wall:.3f} s (the draw and the optimizer state's "
          f"init included); losses {[round(e['loss'], 6) for e in log]}, "
          f"grad norms {[round(e['grad_norm'], 6) for e in log]}, finite "
          f"{ok}; step ms {[round(t * 1e3, 3) for t in steps_s]}, steady "
          f"{steady * 1e3:.3f} ms: {tokens / steady:.1f} tokens/s, "
          f"{share:.4f} of the card's {PEAK_OPS_PER_S['bfloat16']:.3g} bf16 "
          f"FLOP/s at 6 N FLOP a token; peak device memory "
          f"{peak / 1e9:.3f} GB ({peak / 2 ** 30:.3f} GiB); launches "
          f"{counts}, a step {per_step}")
    if counts != want or not ok:
        raise AssertionError(f"train {arch}: launches {counts}, expected "
                             f"{want}; finite {ok}")
    got = device_profile(f"train {arch}", lambda: trainer.fit(
        params, opt, data.iterate(TRAIN_STEPS), steps=TRAIN_STEPS + 1,
        start_step=TRAIN_STEPS))
    idle, kern = None, {}
    if got is not None:
        busy_s, wall_p, dev_events = got
        idle = 1 - busy_s / wall_p
        # kernel symbols: the recurrences' by their names (rwkv6_kernel<...>,
        # rwkv6_bwd_kernel<...>: neither name inside the other)
        names = {k: k for k in ("matmul_bf16", "matmul_f32",
                                "flash_attention")}
        for mixer in RECURRENT:
            if mixer in cfg.block_pattern:
                names.update({mixer: f"{mixer}_kernel",
                              f"{mixer}_bwd": f"{mixer}_bwd_kernel"})
        kern = {k: sum(e.self_device_time_total for e in dev_events
                       if sym in e.key) * 1e-6 for k, sym in names.items()}
        print(f"profile train {arch}: device busy {busy_s:.6f} s of a "
              f"{wall_p:.3f} s profiled step ({busy_s / wall_p:.4f}; idle "
              f"{idle:.4f}); "
              + ", ".join(f"{k} {v:.6f} s ({v / busy_s:.4f} of busy)"
                          for k, v in kern.items())
              + f"; {sum(e.count for e in dev_events)} device events")
        print_top_events(dev_events, 10)
    return per_step, {"step_ms": steady * 1e3,
                      "step_ms_all": [t * 1e3 for t in steps_s],
                      "tokens_per_s": tokens / steady,
                      "peak_share_6N": share, "peak_memory_bytes": peak,
                      "idle_share": idle, "busy_s_by_kernel": kern,
                      "losses": [e["loss"] for e in log]}


def train_recurrent(dev, arch, count=False):
    """``arch`` (a recurrent config) at full width and depth with int8
    moments: TRAIN_STEPS steps of TRAIN_BATCH x TRAIN_SEQ tokens through
    ``launch/train.py``'s ``run`` (remat on), the launch counts set to 0
    just before and read just after (:func:`train_report`: the
    recurrence's kernel twice a layer, forward and recompute, and its
    backward kernel once), and its readings. With ``count``, one more
    step, untimed, under ``launch.counting.StepCounter``, whose counts
    phase 11 holds the dry run's trace to. Returns (launches a step,
    readings, the counted step or None)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.counting import tensor_bytes
    from repro_torch.training.train_loop import make_train_step

    cfg = get_config(arch)
    free_card()
    print(f"train {arch}: {cfg.param_count()} parameters, {cfg.num_layers} "
          f"layers, d_model {cfg.d_model}; torch.cuda.mem_get_info "
          f"{torch.cuda.mem_get_info()[0] / 2 ** 30:.3f} GiB free")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    trainer, params, opt, log = launch_train.run(
        cfg, steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
        state_dtype="int8", device=dev, seed=TRAIN_SEED, log_every=1)
    torch.cuda.synchronize()
    data = SyntheticLM(cfg, DataConfig(TRAIN_SEQ, TRAIN_BATCH))
    per_step, readings = train_report(arch, cfg, trainer, params, opt, log,
                                      time.perf_counter() - t0, data)
    counted = None
    if count:
        batch = {k: torch.as_tensor(v, device=dev) for k, v in
                 data.batch(TRAIN_STEPS + 1).items()}
        counted = counted_step(
            dev, make_train_step(trainer.model, trainer.ocfg),
            (params, opt, batch), lambda out: (out[0], out[1], batch))
        counted.update(ocfg=trainer.ocfg,
                       loss_chunk=trainer.model.loss_chunk,
                       state_bytes=tensor_bytes((params, opt)))
    del trainer, params, opt
    free_card()
    return per_step, readings, counted


def train_against_cpu(dev):
    """The llama3-8b, internvl2-76b, rwkv6-1.6b and recurrentgemma-9b
    smoke configs in float32 (IEEE float32 products), the same weights on
    the card and the CPU: TRAIN_CPU_STEPS ``Trainer.fit`` steps each,
    losses and gradient norms within TRAIN_CPU_RTOL (the recurrent
    configs' within RECURRENT_CPU_RTOL[arch])."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.core.precision import ieee_float32
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.models import Model
    from repro_torch.training import (AdamWConfig, Trainer, adamw_init,
                                      train_params)

    for seed, arch in enumerate((TRAIN_ARCH, VLM) + RECURRENT_TRAIN):
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32",
                                  kv_dtype="float32")
        cpu = Model(cfg, device="cpu").init(
            torch.Generator().manual_seed(71 + seed))
        card = Model(cfg, device=dev)
        card.load_state_dict(cpu.state_dict())
        ocfg = AdamWConfig(lr=1e-3, warmup_steps=1,
                           total_steps=TRAIN_CPU_STEPS)
        logs = []
        for m in (card, cpu):
            tr = Trainer(m, ocfg)
            p = train_params(m)
            with ieee_float32():
                _, _, log = tr.fit(p, adamw_init(p, ocfg), SyntheticLM(
                    cfg, DataConfig(64, 4)).iterate(),
                    steps=TRAIN_CPU_STEPS, log_every=1)
            logs.append(log)
        rel = max(abs(a[k] - b[k]) / abs(b[k]) for a, b in zip(*logs)
                  for k in ("loss", "grad_norm"))
        tol = RECURRENT_CPU_RTOL.get(arch, TRAIN_CPU_RTOL)
        print(f"train {cfg.name} float32, card against CPU over "
              f"{TRAIN_CPU_STEPS} steps: losses {[e['loss'] for e in logs[0]]}"
              f" and {[e['loss'] for e in logs[1]]}, grad norms "
              f"{[e['grad_norm'] for e in logs[0]]} and "
              f"{[e['grad_norm'] for e in logs[1]]}: losses and grad norms "
              f"within {rel!r} (tolerance {tol})")
        if not (rel <= tol and np.isfinite(rel)):
            raise AssertionError(f"train {cfg.name}: card != CPU")
    free_card()


def train_vlm_step(dev):
    """internvl2-76b at full width and VLM_TRAIN_LAYERS layers, int8
    moments: one ``Trainer.fit`` step of a SyntheticLM batch with its 256
    patches a row, launches exactly ``train_launches``, loss finite.
    Returns the launches."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.models import Model
    from repro_torch.models.model import train_launches
    from repro_torch.training import AdamWConfig, Trainer

    cfg = dataclasses.replace(get_config(VLM), num_layers=VLM_TRAIN_LAYERS)
    batch, seq = VLM_TRAIN
    trainer = Trainer(Model(cfg, device=dev),
                      AdamWConfig(state_dtype="int8", warmup_steps=1,
                                  total_steps=1))
    params, opt = trainer.init_state(
        torch.Generator(device=dev).manual_seed(72))
    data = SyntheticLM(cfg, DataConfig(seq, batch))
    ops.reset_launch_counts()
    _, _, log = trainer.fit(params, opt, data.iterate(), steps=1,
                            log_every=1)
    counts = ops.launch_counts()
    want = dict({k: 0 for k in counts}, **train_launches(cfg, seq))
    finite = bool(np.isfinite(log[0]["loss"]))
    print(f"train {VLM} at {cfg.num_layers} layers, full width: one step of "
          f"{batch} x ({cfg.vision_patches} patches + {seq} tokens) in "
          f"{trainer.step_times[0] * 1e3:.3f} ms, loss {log[0]['loss']!r} "
          f"finite {finite}, grad norm {log[0]['grad_norm']!r}; launches "
          f"{counts}")
    del trainer, params, opt
    free_card()
    if counts != want or not finite:
        raise AssertionError(f"train {VLM}: launches {counts}, expected "
                             f"{want}; finite {finite}")
    return counts


def train_checkpoint(dev):
    """llama3-8b at full width and CKPT_LAYERS layers, int8 moments: a run
    saves its checkpoint at step CKPT_STEPS[0] (``Trainer``'s async save,
    waited on), a fresh model restores it (``maybe_restore``) bit for bit
    (parameters, moments, their scales, the step), and both go on to step
    CKPT_STEPS[1]: the restored run's losses within TRAIN_CPU_RTOL of the
    uninterrupted run's (bit for bit where the card's gradient is
    deterministic)."""
    import dataclasses
    import tempfile

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.models import Model
    from repro_torch.training import AdamWConfig, Trainer
    from repro_torch.training.checkpoint import _leaves

    cfg = dataclasses.replace(get_config(TRAIN_ARCH), num_layers=CKPT_LAYERS)
    first, last = CKPT_STEPS
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=last,
                       state_dtype="int8")
    data = SyntheticLM(cfg, DataConfig(TRAIN_SEQ, TRAIN_BATCH))
    with tempfile.TemporaryDirectory() as d:
        a = Trainer(Model(cfg, device=dev), ocfg, ckpt_dir=d,
                    ckpt_every=10 ** 9)
        pa, oa = a.init_state(torch.Generator(device=dev).manual_seed(73))
        t0 = time.perf_counter()
        pa, oa, _ = a.fit(pa, oa, data.iterate(0), steps=first)
        fit_s = time.perf_counter() - t0
        n_bytes = sum(os.path.getsize(os.path.join(root, f))
                      for root, _, files in os.walk(d) for f in files)
        snap = {k: t.clone() for k, t in _leaves({"params": pa, "opt": oa})}
        _, _, la = Trainer(a.model, ocfg).fit(
            pa, oa, data.iterate(first), steps=last, start_step=first,
            log_every=1)
        del a, pa, oa
        b = Trainer(Model(cfg, device=dev), ocfg, ckpt_dir=d)
        pb, ob = b.init_state(torch.Generator(device=dev).manual_seed(74))
        t0 = time.perf_counter()
        pb, ob, start = b.maybe_restore(pb, ob)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        restored = dict(_leaves({"params": pb, "opt": ob}))
        same = sorted(restored) == sorted(snap) and all(
            torch.equal(restored[k], snap[k]) for k in snap)
        del snap, restored
        _, _, lb = Trainer(b.model, ocfg).fit(
            pb, ob, data.iterate(first), steps=last, start_step=first,
            log_every=1)
        del b, pb, ob
    rel = max(abs(x["loss"] - y["loss"]) / abs(x["loss"])
              for x, y in zip(la, lb))
    bitwise = [x["loss"] == y["loss"] for x, y in zip(la, lb)]
    print(f"train {TRAIN_ARCH} at {CKPT_LAYERS} layers, full width: "
          f"{first} steps and the checkpoint's save in {fit_s:.3f} s "
          f"({n_bytes / 1e9:.3f} GB on disk), restored at step {start} in "
          f"{restore_s:.3f} s, bit for bit {same}; steps {first + 1}.."
          f"{last} uninterrupted {[x['loss'] for x in la]}, resumed "
          f"{[y['loss'] for y in lb]}: within {rel!r} (tolerance "
          f"{TRAIN_CPU_RTOL}), bitwise {bitwise}")
    free_card()
    if not (same and start == first and rel <= TRAIN_CPU_RTOL):
        raise AssertionError(f"train {TRAIN_ARCH}: checkpoint round trip "
                             f"failed")


def training_phase(dev):
    """Phase 9 (see the module docstring). Returns (matmul's train
    timings, flash_attention's train reading, launches a step of the full
    run, the full run's readings, internvl2-76b's step's launches, the
    backward kernels' entries of the kernels line, {arch: (launches a
    step, readings)} of the recurrent runs, rwkv6-1.6b's counted step)."""
    backward = check_backward_products(dev)
    attn = check_attention_backward(dev)
    rec_kernels = [check_rglru_backward(dev), check_rwkv6_backward(dev)]
    free_card()
    per_step, readings = train_full(dev)
    train_against_cpu(dev)
    vlm = train_vlm_step(dev)
    train_checkpoint(dev)
    recurrent, counted = {}, None
    for arch in RECURRENT_TRAIN:
        step, got, c = train_recurrent(dev, arch, count=arch == RWKV_TRAIN)
        recurrent[arch] = (step, got)
        counted = c or counted
    return (backward, attn, per_step, readings, vlm, rec_kernels, recurrent,
            counted)


def dist_train(dev, mesh, phase9):
    """llama3-8b at full width and depth with int8 moments: DIGEST_STEPS
    steps through ``launch/train.py``'s ``run`` over ``mesh`` (the
    parameters held by the sharding rules, ZeRO-1 moments, the collectives
    on groups of one rank), phase 9's seed and batches, after phase 9's
    state is freed; the launch counts set to 0 just before and read just
    after (each step exactly ``train_launches``); the losses, gradient
    norms and ``state_digest`` equal to phase 9's first DIGEST_STEPS
    steps bit for bit. Then one more sharded step, untimed, under
    ``launch.counting.StepCounter`` (:func:`counted_step`), whose counts
    phase 11 holds the dry run's trace to. Returns (launches, readings,
    the counted step)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.counting import tensor_bytes
    from repro_torch.models.model import train_launches
    from repro_torch.training.train_loop import make_train_step

    cfg = get_config(TRAIN_ARCH)
    first = phase9["first"]
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    trainer, params, opt, log = launch_train.run(
        cfg, steps=DIGEST_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
        state_dtype="int8", device=dev, seed=TRAIN_SEED, log_every=1,
        mesh=mesh)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    per_step = train_launches(cfg, TRAIN_SEQ)
    want = {k: DIGEST_STEPS * per_step.get(k, 0) for k in counts}
    peak = torch.cuda.max_memory_allocated()
    digest = state_digest(params, opt)
    losses = [e["loss"] for e in log]
    norms = [e["grad_norm"] for e in log]
    same_digest = digest == first["digest"]
    step_ms = [t * 1e3 for t in trainer.step_times]
    batch = {k: torch.as_tensor(v, device=dev) for k, v in SyntheticLM(
        cfg, DataConfig(TRAIN_SEQ, TRAIN_BATCH)).batch(DIGEST_STEPS).items()}
    counted = counted_step(dev, make_train_step(trainer.model, trainer.ocfg),
                           (params, opt, batch),
                           lambda out: (out[0], out[1], batch))
    counted["ocfg"] = trainer.ocfg
    counted["loss_chunk"] = trainer.model.loss_chunk
    counted["state_bytes"] = tensor_bytes((params, opt))
    print(f"dist train {TRAIN_ARCH} on mesh {mesh.shape} "
          f"({type(trainer.layout).__name__}, {mesh.size} rank): "
          f"{DIGEST_STEPS} steps in {wall:.3f} s (the draw included); "
          f"losses {losses} against phase 9's {first['losses']}, grad "
          f"norms {norms} against {first['grad_norms']}; digest of "
          f"{len(digest)} leaves equal {same_digest}; step ms "
          f"{[round(t, 3) for t in step_ms]} against phase 9's "
          f"{[round(t, 3) for t in first['step_ms']]}; peak device memory "
          f"{peak / 1e9:.3f} GB against phase 9's "
          f"{first['peak_memory_bytes'] / 1e9:.3f} GB over its first "
          f"{DIGEST_STEPS} steps; launches {counts}, a step {per_step}")
    del trainer, params, opt
    free_card()
    if not (losses == first["losses"] and norms == first["grad_norms"]
            and same_digest and counts == want):
        raise AssertionError(f"dist train {TRAIN_ARCH}: the sharded steps "
                             f"are not phase 9's (launches {counts}, "
                             f"expected {want})")
    return counts, {"step_ms": step_ms, "phase9_step_ms": first["step_ms"],
                    "peak_memory_bytes": peak,
                    "phase9_peak_memory_bytes": first["peak_memory_bytes"],
                    "wall_s": wall}, counted


def counted_step(dev, step, args, arguments):
    """``step(*args)`` once on ``dev`` under ``launch.counting.
    StepCounter`` (untimed): the counter's summary (kernel calls,
    operations and bytes, aten FLOPs and bytes, collectives), its memory
    fields over ``arguments(out)`` (the step's arguments as they stand
    after it) and the outputs, and its per-op tally."""
    import torch

    from repro_torch.launch.counting import StepCounter

    with StepCounter(dev, args) as counter:
        out = step(*args)
    torch.cuda.synchronize()
    return {"summary": counter.summary(), "ops": counter.ops,
            "memory": counter.memory(arguments(out), out),
            "cost": counter.cost(), "collectives": counter.collectives()}


def dist_checkpoint(dev, mesh):
    """llama3-8b at full width and CKPT_LAYERS layers over ``mesh``, int8
    moments: one sharded step, the trainer's checkpoint (whole leaves,
    rank 0 writing, a barrier), then a fresh sharded trainer restores it
    bit for bit (``maybe_restore`` on the mesh's shardings)."""
    import dataclasses
    import tempfile

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.distributed import MeshSharder, ShardingRules
    from repro_torch.models import Model
    from repro_torch.training import AdamWConfig, Trainer
    from repro_torch.training.checkpoint import _leaves

    cfg = dataclasses.replace(get_config(TRAIN_ARCH), num_layers=CKPT_LAYERS)
    rules = ShardingRules(cfg, mesh)
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=1,
                       state_dtype="int8")

    def trainer(d):
        return Trainer(Model(cfg, device=dev, shard=MeshSharder(rules)),
                       ocfg, ckpt_dir=d, ckpt_every=10 ** 9, rules=rules)

    with tempfile.TemporaryDirectory() as d:
        a = trainer(d)
        pa, oa = a.init_state(torch.Generator(device=dev).manual_seed(75))
        t0 = time.perf_counter()
        pa, oa, _ = a.fit(pa, oa, SyntheticLM(cfg, DataConfig(
            TRAIN_SEQ, TRAIN_BATCH)).iterate(), steps=1)
        save_s = time.perf_counter() - t0
        snap = {k: t.clone() for k, t in _leaves({"params": pa, "opt": oa})}
        del a, pa, oa
        b = trainer(d)
        pb, ob = b.init_state(torch.Generator(device=dev).manual_seed(76))
        t0 = time.perf_counter()
        pb, ob, start = b.maybe_restore(pb, ob)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        got = dict(_leaves({"params": pb, "opt": ob}))
        same_bits = sorted(got) == sorted(snap) and all(
            torch.equal(got[k], snap[k]) for k in snap)
        del b, pb, ob, got, snap
    free_card()
    print(f"dist checkpoint {TRAIN_ARCH} at {CKPT_LAYERS} layers, full "
          f"width, mesh {mesh.shape}: one step and the save in "
          f"{save_s:.3f} s, restored at step {start} in {restore_s:.3f} s, "
          f"bit for bit {same_bits}")
    if not (same_bits and start == 1):
        raise AssertionError("dist checkpoint: the restore is not the save")


def dist_small_parts(dev):
    """``_quantize`` on the card equal to the CPU's bits (a K x K float32
    gradient and a ragged tail); a one-stage ``gpipe`` over a
    ('stage',) mesh of the one rank through ``ops.matmul``, equal to the
    stage run microbatch by microbatch bit for bit. Returns the gpipe's
    ``matmul`` launches."""
    import torch

    from repro_torch.distributed.compression import _quantize
    from repro_torch.distributed.pipeline import gpipe
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import Mesh

    rows, k = GPIPE_SHAPE
    g = torch.Generator(device=dev).manual_seed(77)
    x = torch.randn((k * k + 100,), generator=g, device=dev) * 1e-2
    q, scale, n = _quantize(x)
    qc, sc, nc = _quantize(x.cpu())
    same_q = (n == nc and torch.equal(q.cpu(), qc)
              and torch.equal(scale.cpu(), sc))
    mesh = Mesh((1,), ("stage",))
    w = (torch.randn((1, k, k), generator=g, device=dev)
         * k ** -0.5).bfloat16()
    xs = torch.randn((GPIPE_MICRO, rows, k), generator=g,
                     device=dev).bfloat16()
    ops.reset_launch_counts()
    out = gpipe(lambda p, xb: ops.matmul(xb, p["w"]), mesh, "stage", 1,
                GPIPE_MICRO)({"w": w}, xs)
    torch.cuda.synchronize()
    launches = ops.launch_counts()["matmul"]
    want = torch.stack([ops.matmul(xs[i], w[0])
                        for i in range(GPIPE_MICRO)])
    same_pipe = torch.equal(out, want)
    print(f"dist _quantize [{x.numel()}] float32: the card's q and scales "
          f"equal the CPU's {same_q}; gpipe of 1 stage x {GPIPE_MICRO} "
          f"microbatches [{rows}, {k}] @ [{k}, {k}] bf16 through "
          f"ops.matmul: {launches} matmul launches, equal to the stage "
          f"run alone {same_pipe}")
    if not (same_q and same_pipe and launches == GPIPE_MICRO):
        raise AssertionError("dist: _quantize or gpipe on the card")
    return launches


def tp_serve(dev, mesh):
    """Tensor-parallel serving at world size 1 (see TP_SERVE): each arch's
    prefill and greedy decode steps run unsharded, then with the model's
    weights held by ``MeshParams`` over ``mesh`` under a ``MeshSharder``
    (weights on their 'model' cuts, row-parallel products through float32
    partials, caches cut as ``cache_shardings`` says); logits, tokens and
    caches must be bit for bit the unsharded run's, the launches equal and
    every model kernel of the path launched. Then the last arch's decode
    step at its cache's last slot is counted (``counted_step``) for phase
    11. Returns (launches of the tensor-parallel runs, readings, the
    counted step with its config)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.distributed import (MeshParams, MeshSharder,
                                         ShardingRules)
    from repro_torch.kernels import ops
    from repro_torch.models import Model

    total, readings, counted = {}, {}, None
    for arch, layers in TP_SERVE:
        cfg = dataclasses.replace(get_config(arch), num_layers=layers)
        g = torch.Generator(device=dev).manual_seed(TP_SEED)
        model = Model(cfg, device=dev).init(g)
        toks = torch.randint(0, cfg.vocab_size, (TP_ROWS, TP_PROMPT),
                             generator=g, device=dev, dtype=torch.int32)

        def serve():
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            logits, cache = model.prefill(toks, cache_len=TP_CACHE)
            out = [logits]
            for i in range(TP_NEW):
                logits, cache = model.decode_step(
                    cache, out[-1].argmax(-1).int(), TP_PROMPT + i)
                out.append(logits)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            return torch.stack(out), cache, ops.launch_counts(), wall

        want, want_cache, want_counts, want_s = serve()
        rules = ShardingRules(cfg, mesh)
        model.shard = MeshSharder(rules)
        MeshParams(model, rules)
        model.shard.global_batch = TP_ROWS
        got, got_cache, counts, got_s = serve()
        same_cache = all(
            torch.equal(a.view(torch.uint8), b.view(torch.uint8))
            for a, b in zip(_cache_leaves(got_cache),
                            _cache_leaves(want_cache)))
        same = (torch.equal(got, want) and same_cache
                and torch.equal(got.argmax(-1), want.argmax(-1)))
        print(f"dist tensor-parallel serving {arch} (full width, {layers} "
              f"of {get_config(arch).num_layers} layers, {cfg.kv_dtype} "
              f"cache) on the (1, 1) mesh: {TP_ROWS} x {TP_PROMPT} tokens "
              f"+ {TP_NEW} steps, cache {TP_CACHE}: logits, tokens and "
              f"caches bit for bit the unsharded run {same}; launches "
              f"{counts}, the unsharded run's {want_counts}; wall "
              f"{got_s * 1e3:.3f} ms (unsharded {want_s * 1e3:.3f} ms)")
        missing = [k for k in ("matmul", "flash_attention", "flash_decode")
                   if counts[k] <= 0]
        if not same or counts != want_counts or missing:
            raise AssertionError(f"dist tensor-parallel serving {arch}: "
                                 f"not the unsharded run (launches "
                                 f"{counts}, never launched {missing})")
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n
        readings[arch] = {"layers": layers, "launches": counts,
                          "wall_ms": got_s * 1e3,
                          "unsharded_wall_ms": want_s * 1e3}
        del want, want_cache, got, got_cache
        if arch == TP_SERVE[-1][0]:
            cache = model.init_cache(TP_ROWS, TP_CACHE)
            token = torch.randint(0, cfg.vocab_size, (TP_ROWS,), generator=g,
                                  device=dev, dtype=torch.int32)
            params = dict(model.named_parameters())
            counted = counted_step(
                dev, lambda c, t: model.decode_step(c, t, TP_CACHE - 1),
                (cache, token), lambda out: (params, out[1], token))
            counted["cfg"] = cfg
            del cache, params
        del model
        free_card()
    return total, readings, counted


def _cache_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _cache_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _cache_leaves(v)]
    return [tree]


def check_flash_decode_split(dev, smi):
    """``flash_decode`` against a cache cut along its slots: each of
    SPLIT_RANKS runs of slots gives its chunks' float32 partials
    (``ops.flash_decode_partial`` on a view of the run) and
    ``ops.flash_decode_merge`` merges them. At SPLIT_DECODE (qwen1.5-32b,
    fp8, runs of whole chunks) the result must be bit for bit the
    whole-cache kernel's, the plain versions' (partials and merge) bit for
    bit the whole-cache plain version's, and the kernel within tolerance
    of it (``kv8_check``, NaNs where the plain version has them). At
    SPLIT_ROLLED (recurrentgemma-9b, bf16, a rolled window whose chunks
    two runs split, summed piece by piece in rank order) the result must
    be within attn_check's tolerance of the whole-cache kernel and of the
    plain split version. For each, one run's partial, the merge and the
    whole-cache kernel timed by CUDA events beside their bounds (the
    run's live keys and the pieces that hold them), with the launches of
    the checked path. Returns the readings by architecture."""
    import torch

    from repro_torch.kernels.ref import (flash_decode_merge_plain,
                                         flash_decode_partial_plain,
                                         flash_decode_plain)

    B, H, S, D = SPLIT_DECODE
    g = torch.Generator(device=dev).manual_seed(93)
    q = torch.randn((B, H, D), generator=g, device=dev).bfloat16()
    k, v = fp8_caches(B, H, S, D, dev, g)
    length = torch.full((B,), S, dtype=torch.int32, device=dev)
    merged, whole, runs, reading = _split_decode_on_card(
        "qwen1.5-32b", smi, q, k, v, length, None, SPLIT_RANKS)
    L = S // SPLIT_RANKS
    same = torch.equal(merged.view(torch.int16), whole.view(torch.int16))
    plain = flash_decode_plain(q, k, v, length)
    plain_merged = flash_decode_merge_plain(torch.stack([
        flash_decode_partial_plain(q, kr, vr, length, None, r * L, S)
        for r, (kr, vr) in enumerate(runs)]), q, length, None, S, L, H)
    same_plain = torch.equal(plain_merged.view(torch.int16),
                             plain.view(torch.int16))
    err, nans = kv8_check(f"flash_decode split {SPLIT_RANKS} ways fp8 "
                          f"{list(k.shape)}", merged, whole, plain, v)
    print(f"{smi}: flash_decode cut {SPLIT_RANKS} ways along {[B, H, S, D]}"
          f" fp8: merged bit for bit the whole-cache kernel {same}, the "
          f"plain versions bit for bit the whole-cache plain version "
          f"{same_plain}")
    if not (same and same_plain):
        raise AssertionError("flash_decode split: not the whole-cache "
                             "kernel bit for bit")
    out = {"qwen1.5-32b": dict(reading, max_abs_err=err, nan=nans)}

    hq, (B, hkv, S, D), lens, ends = SPLIT_ROLLED
    q = torch.randn((B, hq, D), generator=g, device=dev).bfloat16()
    k, v = (torch.randn((B, hkv, S, D), generator=g, device=dev).bfloat16()
            for _ in range(2))
    length = torch.tensor(lens, dtype=torch.int32, device=dev)
    end = torch.tensor(ends, dtype=torch.int32, device=dev)
    merged, whole, runs, reading = _split_decode_on_card(
        "recurrentgemma-9b", smi, q, k, v, length, end, SPLIT_RANKS)
    L = S // SPLIT_RANKS
    plain_merged = flash_decode_merge_plain(torch.stack([
        flash_decode_partial_plain(q, kr, vr, length, end, r * L, S)
        for r, (kr, vr) in enumerate(runs)]), q, length, end, S, L, hkv)
    label = f"flash_decode split {SPLIT_RANKS} ways rolled {[B, hkv, S, D]}"
    err_whole = attn_check(f"{label} vs the whole-cache kernel", merged,
                           whole, v)
    err = attn_check(f"{label} vs the plain split version", merged,
                     plain_merged, v)
    out["recurrentgemma-9b"] = dict(reading, max_abs_err=err,
                                    max_abs_err_whole=err_whole)
    return out


def _split_decode_on_card(arch, smi, q, k, v, length, end, m):
    """The partials of m runs of k/v's slots merged (launches counted
    from 0, m + 1 of them), the whole-cache kernel, and one run's partial,
    the merge and the whole-cache kernel timed beside their bounds:
    (merged, whole, runs, reading)."""
    import torch

    from repro_torch.kernels import cost, ops
    from repro_torch.kernels.ref import decode_local_chunks, decode_pieces

    B, hkv, S, D = k.shape
    L = S // m
    runs = [(k[:, :, r * L:(r + 1) * L], v[:, :, r * L:(r + 1) * L])
            for r in range(m)]
    whole = ops.flash_decode(q, k, v, length, end)
    ops.reset_launch_counts()
    parts = torch.stack([ops.flash_decode_partial(q, kr, vr, length, end,
                                                  r * L, S)
                         for r, (kr, vr) in enumerate(runs)])
    merged = ops.flash_decode_merge(parts, q, length, end, S, L, hkv)
    torch.cuda.synchronize()
    launches = ops.launch_counts()["flash_decode"]
    if launches != m + 1:
        raise AssertionError(f"flash_decode split {arch}: {launches} "
                             f"launches, not {m + 1}")
    n_out = decode_local_chunks(S, L)
    kr, vr = runs[0]
    part_ms = cuda_ms(lambda: ops.flash_decode_partial(
        q, kr, vr, length, end, 0, S), 20)
    merge_ms = cuda_ms(lambda: ops.flash_decode_merge(
        parts, q, length, end, S, L, hkv), 20)
    whole_ms = cuda_ms(lambda: ops.flash_decode(q, k, v, length, end), 20)
    lc = length.cpu()
    ec = None if end is None else end.cpu()
    live = ops._local_live(lc, ec, 0, L, S)      # run 0's live keys
    live_all = ops._local_live(lc, ec, 0, S, S)
    part_pieces = decode_pieces(lc, ec, S, L, [0])
    pieces = decode_pieces(lc, ec, S, L, range(0, S, L))
    part_bound = bound_of(cost.flash_decode_partial(
        q.shape, hkv, q.dtype, k.dtype, live, part_pieces), "bfloat16")
    merge_bound = bound_of(cost.flash_decode_merge(q.shape, q.dtype,
                                                   pieces), "float32")
    whole_bound = bound_of(cost.flash_decode(q.shape, hkv, q.dtype, k.dtype,
                                             live_all), "bfloat16")
    print(f"{smi}: {arch} flash_decode cut {m} ways along {[B, hkv, S, D]}"
          f" {str(k.dtype).split('.')[-1]}, q {list(q.shape)} ({L} slots a "
          f"run, {n_out} partials a row and run, {pieces} pieces with live "
          f"keys): {launches} launches ({m} partials, 1 merge); one run's "
          f"partial {part_ms:.6f} ms (bound {part_bound[0]:.6f} ms by "
          f"{part_bound[1]}, {part_bound[2]} B), the merge of {m} runs "
          f"{merge_ms:.6f} ms (bound {merge_bound[0]:.6f} ms by "
          f"{merge_bound[1]}, {merge_bound[2]} B), the whole-cache kernel "
          f"{whole_ms:.6f} ms (bound {whole_bound[0]:.6f} ms by "
          f"{whole_bound[1]})")
    reading = {"shape": [B, hkv, S, D], "q": list(q.shape), "ranks": m,
               "partials_per_row": n_out, "pieces": pieces,
               "launches": launches, "partial_ms": part_ms,
               "partial_bound_ms": part_bound[0], "merge_ms": merge_ms,
               "merge_bound_ms": merge_bound[0], "whole_ms": whole_ms,
               "whole_bound_ms": whole_bound[0]}
    return merged, whole, runs, reading


def check_tp_products(dev, smi):
    """The 16-way cut's per-rank products (TP_PRODUCTS) at TP_ROWS rows and
    full width: each column-parallel product against its plain version
    (``matmul_check``); each row-parallel one's float32 partials against
    the plain version's float32 sums, and rounded once to bf16 equal to
    the kernel's bf16 output bit for bit (one rank's sum is its partial);
    each timed by CUDA events beside ``torch.mm`` of the same function
    (``out_dtype`` for the partials) and its bound. Returns the
    readings."""
    import torch

    from repro_torch.kernels import cost, ops
    from repro_torch.kernels.ref import matmul_plain

    g = torch.Generator(device=dev).manual_seed(95)
    out = {}
    for (arch, name), (K, N, partial) in TP_PRODUCTS.items():
        x = torch.randn((TP_ROWS, K), generator=g, device=dev).bfloat16()
        w = (torch.randn((K, N), generator=g, device=dev)
             * K ** -0.5).bfloat16()
        label = f"{arch} {name} [{TP_ROWS}, {K}] @ [{K}, {N}]"
        if partial:
            got = ops.matmul(x, w, out_dtype=torch.float32)
            want = matmul_plain(x, w, torch.float32)
            torch.cuda.synchronize()
            err = (got - want).abs()
            tol = MM_RTOL * (x.float().abs() @ w.float().abs())
            once = torch.equal(got.to(torch.bfloat16), ops.matmul(x, w))
            ok = got.dtype == torch.float32 and bool((err <= tol).all())
            e_max = float(err.max())
            print(f"matmul {label} float32 partials: max_abs_err "
                  f"{e_max!r} within MM_RTOL {ok}; rounded once, the bf16 "
                  f"kernel's bits {once}")
            if not (ok and once):
                raise AssertionError(f"matmul {label}: partials")
            fn = lambda: ops.matmul(x, w, out_dtype=torch.float32)  # noqa
            lib = lambda: torch.mm(x, w, out_dtype=torch.float32)  # noqa
            work = cost.matmul(TP_ROWS, K, N, x.dtype, torch.float32)
        else:
            e_max = matmul_check(label, x, w, ops.matmul(x, w),
                                 matmul_plain(x, w))
            fn = lambda: ops.matmul(x, w)  # noqa: E731
            lib = lambda: torch.mm(x, w)  # noqa: E731
            work = cost.matmul(TP_ROWS, K, N, x.dtype)
        ms, lib_ms = cuda_ms(fn, 50), cuda_ms(lib, 50)
        bound = bound_of(work, "bfloat16")
        print(f"{smi}: matmul {label}{' float32 partials' if partial else ''}"
              f": {ms:.6f} ms, torch.mm {lib_ms:.6f} ms, bound "
              f"{bound[0]:.6f} ms by {bound[1]}")
        out[f"{arch} {name}"] = {"shape": [TP_ROWS, K, N],
                                 "float32_partials": partial, "ms": ms,
                                 "library_ms": lib_ms,
                                 "bound_ms": bound[0], "max_abs_err": e_max}
    return out


def dist_split_sweeps(load_kw, main512, load512):
    """The engine's scenario split (``vectorsim._dispatch``) over two
    shards on the one card ([cuda:0, cuda:0]: each shard on a stream and
    a host thread of its own) at J=512, uncapped and congested, against
    phase 3's and 4's unsplit sweeps of the same grids bit for bit; the
    launch counts set to 0 just before each and read just after. Returns
    {path: launches}."""
    import torch

    from repro_torch.core import sweep_scenarios, vectorsim
    from repro_torch.kernels import ops

    out = {}
    real = vectorsim._split_devices
    vectorsim._split_devices = lambda d, n: [d, d]
    try:
        for label, kw, (tasks, want) in (("uncapped", {}, main512),
                                         ("congested", load_kw, load512)):
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            got = sweep_scenarios(tasks, device="cuda", **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = ops.launch_counts()
            ok = all(same(getattr(a, f), getattr(b, f))
                     for a, b in zip(got, want) for f in RESULT_FIELDS)
            print(f"dist split {label} J=512: "
                  f"{sum(r.num_scenarios for r in got)} scenarios over 2 "
                  f"shards on cuda:0 in {wall:.3f} s, equal to the unsplit "
                  f"sweep {ok}; body steps per stage (the longer shard's) "
                  f"{vectorsim._LAST_RUN_STATS['trips']}; launches {counts}")
            need = ("acd_evict",) + (("fifo_dispatch",) if kw else ())
            if not ok or any(counts[k] <= 0 for k in need):
                raise AssertionError(f"dist split {label}: != unsplit, or "
                                     f"a kernel never launched: {counts}")
            out[f"split {label} J=512"] = counts
    finally:
        vectorsim._split_devices = real
    return out


def distribution_phase(dev, smi, phase9, load_kw, main512, load512):
    """Phase 10 (see the module docstring): returns (the sharded steps'
    launches, their readings, gpipe's matmul launches, the split sweeps'
    launches, the counted sharded step, the tensor-parallel readings: its
    serving runs' launches and readings, its counted decode step, the
    split decode's and the per-rank products' readings)."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import Mesh, init_distributed

    free_card()
    init_distributed(dev)
    try:
        backend = "nccl" if torch.device(dev).type == "cuda" else "gloo"
        if dist.get_backend() != backend or dist.get_world_size() != 1:
            raise AssertionError(f"dist: group {dist.get_backend()} of "
                                 f"{dist.get_world_size()} ranks")
        mesh = Mesh((1, 1), ("data", "model"))
        counts, readings, counted = dist_train(dev, mesh, phase9)
        dist_checkpoint(dev, mesh)
        gpipe_launches = dist_small_parts(dev)
        split = dist_split_sweeps(load_kw, main512, load512)
        tp_launches, tp_readings, tp_counted = tp_serve(dev, mesh)
    finally:
        dist.destroy_process_group()
    tp = {"launches": tp_launches, "serve": tp_readings,
          "counted": tp_counted,
          "split_decode": check_flash_decode_split(dev, smi),
          "products": check_tp_products(dev, smi)}
    return counts, readings, gpipe_launches, split, counted, tp


def dryrun_recurrent(smi, rec_counted, shape):
    """rwkv6-1.6b's training step as phase 9 counted it on the card (one
    card, no mesh) against its meta trace (``launch.dryrun.trace_step``),
    count for count: kernel calls, operations and bytes by kernel (the
    recurrence's forward and backward kernels among them, their calls
    ``train_launches``), aten FLOPs and bytes, argument bytes. Returns its
    readings."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.models.model import train_launches

    rcfg = get_config(RWKV_TRAIN)
    t0 = time.perf_counter()
    traced, mem = dryrun.trace_step(rcfg, shape, None,
                                    ocfg=rec_counted["ocfg"],
                                    loss_chunk=rec_counted["loss_chunk"])
    trace_s = time.perf_counter() - t0
    got, real = traced.summary(), rec_counted["summary"]
    calls = {k: v["calls"] for k, v in got["kernels"].items()}
    want_calls = {k: n for k, n in train_launches(rcfg, TRAIN_SEQ).items()
                  if n}
    args = mem["argument_size_in_bytes"]
    real_args = rec_counted["memory"]["argument_size_in_bytes"]
    print(f"{smi}: dry run {RWKV_TRAIN} train step ({TRAIN_BATCH} x "
          f"{TRAIN_SEQ} tokens, int8 moments, remat, no mesh) traced on "
          f"meta in {trace_s:.3f} s: kernels {got['kernels']}; aten "
          f"{got['aten_flops']} FLOP, {got['aten_bytes']} B; the card's "
          f"counted step (phase 9): kernels {real['kernels']}; aten "
          f"{real['aten_flops']} FLOP, {real['aten_bytes']} B; equal to the "
          f"trace {got == real}; arguments {args:.0f} B against the card's "
          f"{real_args:.0f} B; traced per-device HBM "
          f"{mem['per_device_hbm_bytes'] / 1e9:.3f} GB, the card's counted "
          f"step {rec_counted['memory']['per_device_hbm_bytes'] / 1e9:.3f} "
          f"GB")
    if got != real:
        ops_t, ops_r = traced.ops, rec_counted["ops"]
        for name in sorted(set(ops_t) | set(ops_r)):
            if ops_t.get(name) != ops_r.get(name):
                print(f"dry run {RWKV_TRAIN}: aten {name}: trace "
                      f"{ops_t.get(name)}, card {ops_r.get(name)}")
    if got != real or calls != want_calls or args != real_args:
        raise AssertionError(f"dry run {RWKV_TRAIN}: the trace is not the "
                             f"card's step (calls {calls}, expected "
                             f"{want_calls}; arguments {args} against "
                             f"{real_args})")
    del traced
    free_card()
    return {"trace_s": trace_s, "kernels": got["kernels"], "memory": mem,
            "card_memory": rec_counted["memory"]}


def dryrun_tp_decode(smi, card):
    """Phase 10's tensor-parallel decode step (its config, TP_ROWS rows, a
    cache of TP_CACHE slots, at the last) traced on meta over a fake (1,
    1) mesh: kernel calls, operations and bytes, aten FLOPs and bytes,
    collectives and argument bytes must equal the card's counted step."""
    import torch.distributed as dist

    from repro_torch.configs.registry import ShapeSpec
    from repro_torch.launch import dryrun

    cfg = card["cfg"]
    t0 = time.perf_counter()
    mesh = dryrun.fake_mesh((1, 1), ("data", "model"))
    try:
        traced, mem = dryrun.trace_step(
            cfg, ShapeSpec("decode", TP_CACHE, TP_ROWS, "decode"), mesh)
    finally:
        dist.destroy_process_group()
    trace_s = time.perf_counter() - t0
    got, real = traced.summary(), card["summary"]
    args = mem["argument_size_in_bytes"]
    real_args = card["memory"]["argument_size_in_bytes"]
    layers = cfg.num_layers
    print(f"{smi}: dry run {cfg.name} tensor-parallel decode step "
          f"({layers} layers, batch {TP_ROWS}, cache {TP_CACHE}, "
          f"{cfg.kv_dtype}) traced on meta over a fake (1, 1) mesh in "
          f"{trace_s:.3f} s: kernels {got['kernels']}, aten "
          f"{got['aten_flops']} FLOP, {got['aten_bytes']} B, collectives "
          f"{got['collectives']}; the card's (phase 10, counted) "
          f"{real['kernels']}, aten {real['aten_flops']} FLOP, "
          f"{real['aten_bytes']} B; equal {got == real}; arguments "
          f"{args:.0f} B against the card's {real_args:.0f} B")
    if got != real or args != real_args:
        ops_t, ops_r = traced.ops, card["ops"]
        for name in sorted(set(ops_t) | set(ops_r)):
            if ops_t.get(name) != ops_r.get(name):
                print(f"dry run tp decode: aten {name}: trace "
                      f"{ops_t.get(name)}, card {ops_r.get(name)}")
        raise AssertionError("dry run: the tensor-parallel decode trace is "
                             "not the card's step")
    return {"trace_s": trace_s, "kernels": got["kernels"],
            "arguments": args}


def dryrun_phase(dev, smi, counted, phase9, rec_counted, tp_counted):
    """Phase 11 (see the module docstring): the dry run's meta traces held
    to the card's steps count for count (``rec_counted``: phase 9's
    counted rwkv6-1.6b step; ``tp_counted``: phase 10's tensor-parallel
    decode step), then DRYRUN_CELLS. Returns its readings."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.configs.registry import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.launch.counting import tensor_bytes
    from repro_torch.launch.roofline import model_flops_estimate, roofline
    from repro_torch.models import Model, layers
    from repro_torch.models.model import train_launches

    cfg = get_config(TRAIN_ARCH)
    shape = ShapeSpec("train", TRAIN_SEQ, TRAIN_BATCH, "train")
    t0 = time.perf_counter()
    mesh = dryrun.fake_mesh((1, 1), ("data", "model"))
    try:
        traced, mem = dryrun.trace_step(cfg, shape, mesh,
                                        ocfg=counted["ocfg"],
                                        loss_chunk=counted["loss_chunk"])
    finally:
        dist.destroy_process_group()
    trace_s = time.perf_counter() - t0
    got, real = traced.summary(), counted["summary"]
    calls = {k: v["calls"] for k, v in got["kernels"].items()}
    want_calls = {k: n for k, n in train_launches(cfg, TRAIN_SEQ).items()
                  if n}
    args, real_args = (mem["argument_size_in_bytes"],
                       counted["memory"]["argument_size_in_bytes"])
    state = counted["state_bytes"]
    terms = roofline(traced.cost(), traced.collectives(), 1,
                     model_flops_estimate(cfg.active_param_count(),
                                          TRAIN_BATCH * TRAIN_SEQ, "train"))
    print(f"{smi}: dry run {TRAIN_ARCH} sharded train step ({TRAIN_BATCH} x "
          f"{TRAIN_SEQ} tokens, int8 moments, remat) traced on meta over a "
          f"fake (1, 1) mesh in {trace_s:.3f} s: kernels {got['kernels']}; "
          f"aten {got['aten_flops']} FLOP, {got['aten_bytes']} B; "
          f"collectives {got['collectives']}")
    print(f"{smi}: the card's sharded step (phase 10, counted): kernels "
          f"{real['kernels']}; aten {real['aten_flops']} FLOP, "
          f"{real['aten_bytes']} B; collectives {real['collectives']}; "
          f"equal to the trace {got == real}")
    print(f"{smi}: dry run arguments {args:.0f} B, the card's "
          f"{real_args:.0f} B (parameters and moments {state} B, batch "
          f"{real_args - state:.0f} B); traced per-device HBM "
          f"{mem['per_device_hbm_bytes'] / 1e9:.3f} GB (temporaries "
          f"{mem['temp_size_in_bytes'] / 1e9:.3f} GB), the card's counted "
          f"step {counted['memory']['per_device_hbm_bytes'] / 1e9:.3f} GB, "
          f"phase 9's measured peak "
          f"{phase9['peak_memory_bytes'] / 1e9:.3f} GB (a reading); bound "
          f"{terms.bound_s * 1e3:.3f} ms by {terms.dominant} (reckoned from "
          f"the H100 datasheet peaks) against phase 9's measured steady step "
          f"{phase9['step_ms']:.3f} ms (a reading)")
    if got != real:
        ops_t, ops_r = traced.ops, counted["ops"]
        for name in sorted(set(ops_t) | set(ops_r)):
            if ops_t.get(name) != ops_r.get(name):
                print(f"dry run: aten {name}: trace {ops_t.get(name)}, card "
                      f"{ops_r.get(name)}")
    if got != real or calls != want_calls or args != real_args:
        raise AssertionError(f"dry run {TRAIN_ARCH}: the trace is not the "
                             f"card's step (calls {calls}, expected "
                             f"{want_calls}; arguments {args} against "
                             f"{real_args})")
    readings = {"train": {"trace_s": trace_s, "kernels": got["kernels"],
                          "memory": mem, "card_memory": counted["memory"],
                          "bound_ms": terms.bound_s * 1e3,
                          "dominant": terms.dominant}}
    del traced
    free_card()

    readings["train " + RWKV_TRAIN] = dryrun_recurrent(smi, rec_counted,
                                                       shape)

    # the K/V cast a meta trace takes (fp8 caches) is the card's: probe
    # the card afresh
    layers._BF16_CAST_IS_XLA.pop(dev, None)
    card_cast = layers._bf16_cast_is_xla(dev)
    meta_cast = layers._bf16_cast_is_xla(torch.device("meta"))
    print(f"{smi}: dry run K/V cast: bf16 takes torch's own cast to "
          f"float8_e4m3fn on the card {card_cast}, in the meta trace "
          f"{meta_cast}")
    if card_cast != meta_cast:
        raise AssertionError("dry run: the meta trace's K/V cast is not the "
                             "card's")

    # llama3-8b's decode step at serve_full's batch, at the cache's last
    # slot (every slot live, as the trace counts them)
    B, S = SERVE_REQUESTS, SERVE_CACHE
    g = torch.Generator(device=dev).manual_seed(SERVE_SEED)
    model = Model(cfg, device=dev).init(g)
    toks = torch.randint(0, cfg.vocab_size, (B, S - 1), generator=g,
                         device=dev, dtype=torch.int32)
    _, cache = model.prefill(toks, cache_len=S)
    token = torch.randint(0, cfg.vocab_size, (B,), generator=g, device=dev,
                          dtype=torch.int32)
    params = dict(model.named_parameters())
    card = counted_step(dev, lambda c, t: model.decode_step(c, t, S - 1),
                        (cache, token), lambda out: (params, out[1], token))
    del model, cache, params
    free_card()
    t0 = time.perf_counter()
    traced, mem = dryrun.trace_step(cfg, ShapeSpec("decode", S, B, "decode"))
    trace_s = time.perf_counter() - t0
    got, real = traced.summary(), card["summary"]
    calls = {k: v["calls"] for k, v in got["kernels"].items()}
    real_calls = {k: v["calls"] for k, v in real["kernels"].items()}
    print(f"{smi}: dry run {TRAIN_ARCH} decode step (batch {B}, cache {S}, "
          f"position {S - 1}) traced on meta in {trace_s:.3f} s: kernels "
          f"{got['kernels']}, aten {got['aten_flops']} FLOP, "
          f"{got['aten_bytes']} B; the card's step {real['kernels']}, aten "
          f"{real['aten_flops']} FLOP, {real['aten_bytes']} B; calls equal "
          f"{calls == real_calls}, everything equal {got == real}; arguments "
          f"{mem['argument_size_in_bytes']:.0f} B against the card's "
          f"{card['memory']['argument_size_in_bytes']:.0f} B")
    if calls != real_calls or not calls.get("flash_decode"):
        raise AssertionError(f"dry run {TRAIN_ARCH} decode: calls {calls}, "
                             f"the card's {real_calls}")
    readings["decode"] = {"trace_s": trace_s, "kernels": got["kernels"],
                          "card_kernels": real["kernels"],
                          "all_equal": got == real}
    readings["tp_decode"] = dryrun_tp_decode(smi, tp_counted)

    readings["cells"] = {}
    for arch, shape_name, mesh_kind in DRYRUN_CELLS:
        res = dryrun.run_cell(arch, shape_name, mesh_kind)
        if not res.ok:
            raise AssertionError(f"dry run {arch} {shape_name} {mesh_kind}: "
                                 f"{res.reason}")
        m = res.memory
        print(f"{smi}: dry run {arch} {shape_name} {mesh_kind} "
              f"({res.n_chips} fake ranks) traced in {res.compile_s:.3f} s: "
              f"per device {m['per_device_hbm_bytes'] / 2 ** 30:.3f} GiB "
              f"(arguments {m['argument_size_in_bytes'] / 2 ** 30:.3f}, "
              f"temporaries {m['temp_size_in_bytes'] / 2 ** 30:.3f}), "
              f"dominant {res.terms['dominant']}, bound "
              f"{res.terms['bound_s'] * 1e3:.3f} ms (reckoned from the H100 "
              f"datasheet peaks, not measured); kernels {res.kernels}")
        readings["cells"][f"{arch} {shape_name} {mesh_kind}"] = {
            k: dataclasses.asdict(res)[k] for k in (
                "compile_s", "n_chips", "memory", "kernels")} | {
            "dominant": res.terms["dominant"],
            "bound_s": res.terms["bound_s"]}
    return readings


def main() -> int:
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
    bytes_ms = n_bytes / HBM_BW * 1e3
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
    f_bytes_ms = f_bytes / HBM_BW * 1e3
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
    share, kept = acd_mask_share(fig4_workload(APPS, SIDE_J), SIDE_J,
                                 KEEP_EVERY)
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
          f"{list(kept[0][0].shape)} (every {KEEP_EVERY}th of the counting "
          f"pass): "
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
    # of the grid at SIDE_J, kept (the timed sweeps above ran unwrapped)
    kernels[1]["engine_calls"] = fifo_engine_calls(
        [(SIDE_J, c) for c in keep_fifo_calls(fig4_workload(APPS, SIDE_J),
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
    # -- 6e. the engine twins: loop, scan and kernel on one grid -----------
    launches.update(engine_twins_phase(run_path, load_kw))
    lap("engine twins")
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
    kv8 = check_flash_decode_kv8(dev)
    check_kv_cast(dev)
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
    # -- 8b. qwen1.5-32b at full width and depth, its fp8 cache ------------
    t0 = time.perf_counter()
    qwen_launches, _ = serve_full(QWEN, dev, 40)
    for k, n in qwen_launches.items():
        serve_launches[k] = serve_launches.get(k, 0) + n
    check_serve_against_cpu(QWEN, dev, 41)
    print(f"serve {QWEN}: phase wall {time.perf_counter() - t0:.3f} s; "
          f"launches in its timed batches {qwen_launches}")
    lap("8b qwen1.5-32b")
    # -- 8c. MoE: olmoe-1b-7b at full width and depth, arctic-480b's layers --
    t0 = time.perf_counter()
    bf16_matmul.extend(check_moe_products(dev))
    moe_counts = {}
    for seed, (arch, layers) in enumerate(((OLMOE, None),
                                           (ARCTIC, ARCTIC_LAYERS))):
        t1 = time.perf_counter()
        counts, _ = serve_full(arch, dev, 50 + seed, layers=layers)
        print(f"serve {arch}: {time.perf_counter() - t1:.3f} s")
        for k, n in counts.items():
            moe_counts[k] = moe_counts.get(k, 0) + n
            serve_launches[k] = serve_launches.get(k, 0) + n
    check_serve_against_cpu(OLMOE, dev, 52)
    check_serve_against_cpu(ARCTIC, dev, 53, smoke=True)
    print(f"serve MoE: phase wall {time.perf_counter() - t0:.3f} s; "
          f"launches in its timed batches {moe_counts}")
    lap("8c MoE")
    # -- 8d. the encoder-decoder: whisper-large-v3 at full width and depth --
    t0 = time.perf_counter()
    bf16_matmul.extend(check_whisper_products(dev))
    whisper_attn = check_whisper_attention(dev)
    whisper_counts, _ = serve_full(WHISPER, dev, 60)
    for k, n in whisper_counts.items():
        serve_launches[k] = serve_launches.get(k, 0) + n
    check_whisper_against_cpu(dev, 61)
    print(f"serve {WHISPER}: phase wall {time.perf_counter() - t0:.3f} s; "
          f"launches in its timed batches {whisper_counts}")
    lap("8d whisper-large-v3")
    # -- 8e. internvl2-76b at full width, its patch prefix -------------------
    t0 = time.perf_counter()
    vlm_counts, _ = serve_full(VLM, dev, 80, layers=VLM_LAYERS)
    for k, n in vlm_counts.items():
        serve_launches[k] = serve_launches.get(k, 0) + n
    check_vlm_against_cpu(dev, 81)
    print(f"serve {VLM}: phase wall {time.perf_counter() - t0:.3f} s; "
          f"launches in its timed batches {vlm_counts}")
    lap("8e internvl2-76b")
    # -- 9. training ------------------------------------------------------------
    t0 = time.perf_counter()
    (backward, attn_train, train_step, train_readings, vlm_train,
     rec_kernels, rec_train, rec_counted) = training_phase(dev)
    kernels.extend(rec_kernels)
    print(f"train: phase wall {time.perf_counter() - t0:.3f} s")
    lap("9 training")
    # -- 10. distribution at world size 1 ----------------------------------------
    t0 = time.perf_counter()
    (dist_counts, dist_readings, gpipe_launches, split_launches, counted,
     tp) = distribution_phase(dev, smi, train_readings, load_kw, outs[512],
                              louts[512])
    launches.update(split_launches)
    print(f"dist: phase wall {time.perf_counter() - t0:.3f} s")
    lap("10 distribution")
    # -- 11. the dry run against the card --------------------------------------
    t0 = time.perf_counter()
    dryrun_readings = dryrun_phase(dev, smi, counted, train_readings,
                                   rec_counted, tp["counted"])
    print(f"dry run: phase wall {time.perf_counter() - t0:.3f} s")
    lap("11 dry run")
    # -- 12. result -------------------------------------------------------------
    print(f"total {time.perf_counter() - t_start:.1f} s")
    # each kernel's launches on the main path of its slice: acd_evict on
    # the uncapped sweeps, fifo_dispatch on the congested ones; matmul on
    # the matrix app's profiling path and on the timed serve batches (every
    # weight product); flash_attention, flash_decode, rglru and rwkv6 on
    # the timed serve batches; every model kernel but flash_decode on the
    # training steps (phase 9), the recurrences' backward kernels there
    # alone
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
                                     + serve_launches["matmul"]
                                     + TRAIN_STEPS * train_step["matmul"]
                                     + dist_counts["matmul"])
    by_name["matmul"]["bf16"] = bf16_matmul
    for name in ("flash_attention", "flash_decode", "rglru", "rwkv6"):
        by_name[name]["launches"] = serve_launches[name]
    # the recurrences on the training path (phase 9's full-width runs):
    # the forwards (and their recomputes) beside the serve batches', the
    # backward kernels' launches there alone
    rec_steps = {}
    for arch, (step, readings) in rec_train.items():
        for name, n in step.items():
            rec_steps[name] = rec_steps.get(name, 0) + TRAIN_STEPS * n
        mixer = "rglru" if step.get("rglru") else "rwkv6"
        for name in (mixer, f"{mixer}_bwd"):
            by_name[name]["train_launches_per_step"] = step[name]
        by_name[f"{mixer}_bwd"]["train_step"] = dict(readings, arch=arch)
    for name in ("rglru", "rwkv6", "matmul", "flash_attention"):
        by_name[name]["launches"] += rec_steps[name]
    for name in ("rglru_bwd", "rwkv6_bwd"):
        by_name[name]["launches"] = rec_steps[name]
    by_name["flash_attention"]["launches"] += (
        TRAIN_STEPS * train_step["flash_attention"]
        + dist_counts["flash_attention"])
    # training (phase 9): launches a step of llama3-8b's full run and of
    # internvl2-76b's 2-layer step, the backward products' timings, the
    # attention backward's reading
    for name in ("matmul", "flash_attention"):
        by_name[name]["train_launches_per_step"] = train_step[name]
        by_name[name]["vlm_train_launches"] = vlm_train[name]
        by_name[name]["vlm_serve_launches"] = vlm_counts[name]
    by_name["matmul"]["train"] = backward
    # phase 10: the sharded steps at world size 1, the one-stage gpipe
    for name in ("matmul", "flash_attention"):
        by_name[name]["dist_train_launches"] = dist_counts[name]
    by_name["matmul"]["dist_train_step"] = dist_readings
    # phase 10's tensor-parallel serving at world size 1 (a main path of
    # its own: launches counted from 0 around each run), the split decode
    # at qwen1.5-32b's per-rank shape and the per-rank products
    for name in ("matmul", "flash_attention", "flash_decode"):
        by_name[name]["tp_serve_launches"] = tp["launches"][name]
        by_name[name]["launches"] += tp["launches"][name]
    by_name["flash_decode"]["tp_split"] = tp["split_decode"]
    by_name["matmul"]["tp_products"] = tp["products"]
    by_name["matmul"]["tp_serve"] = tp["serve"]
    # phase 11: the dry run's traces against the card's steps
    by_name["matmul"]["dry_run"] = dryrun_readings
    by_name["matmul"]["gpipe_launches"] = gpipe_launches
    by_name["flash_attention"]["train"] = attn_train
    by_name["matmul"]["train_step"] = train_readings
    # the fp8 reading: flash_decode's launches on qwen1.5-32b's fp8 caches
    by_name["flash_decode"]["kv8"] = dict(
        kv8, launches=qwen_launches["flash_decode"])
    by_name["matmul"]["moe_launches"] = moe_counts["matmul"]
    # whisper-large-v3's shapes and launches (phase 8d)
    for name in ("matmul", "flash_attention", "flash_decode"):
        by_name[name]["whisper_launches"] = whisper_counts[name]
    for name, rows in whisper_attn.items():
        by_name[name]["whisper"] = rows
    missing = [k["name"] for k in kernels if k["launches"] <= 0]
    if qwen_launches["flash_decode"] <= 0:
        missing.append("flash_decode (float8_e4m3fn caches)")
    missing += [f"{k} (MoE)" for k in ("matmul", "flash_attention",
                                       "flash_decode") if moe_counts[k] <= 0]
    missing += [f"{k} (whisper-large-v3)" for k in (
        "matmul", "flash_attention", "flash_decode") if whisper_counts[k] <= 0]
    missing += [f"{k} ({VLM})" for k in ("matmul", "flash_attention",
                                         "flash_decode")
                if vlm_counts[k] <= 0]
    missing += [f"{k} (training)" for k in ("matmul", "flash_attention")
                if train_step[k] <= 0 or vlm_train[k] <= 0]
    missing += [f"{k} (sharded training)" for k in ("matmul",
                                                     "flash_attention")
                if dist_counts[k] <= 0]
    missing += [f"{k} (tensor-parallel serving)" for k in (
        "matmul", "flash_attention", "flash_decode")
                if tp["launches"][k] <= 0]
    missing += [f"{k} (recurrent training)" for k in (
        "rglru", "rglru_bwd", "rwkv6", "rwkv6_bwd", "matmul")
                if rec_steps.get(k, 0) <= 0]
    if missing or len(kernels) != 9:
        raise AssertionError(f"kernels never launched on their path: "
                             f"{missing}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
