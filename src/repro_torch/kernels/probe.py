"""Development probe of the port's kernels against other versions of
them, on one NVIDIA GPU.

    python -m repro_torch.kernels.probe [--ptxas]
        [--baseline OLD_MATMUL_CU] [--baseline rwkv6=OLD_RWKV6_CU]
        [--baseline fifo_dispatch=OLD_FIFO_CU]
        [--baseline rwkv6_bwd=OLD_RWKV6_BWD_CU]
        [--baseline flash_decode=OLD_FLASH_DECODE_CU]

(with ``src`` on ``PYTHONPATH``; a baseline file is another version of the
kernel's source, e.g. ``git show <commit>:src/repro_torch/kernels/csrc/
rwkv6.cu`` written under the ``.gitignore``d ``build/``). It prints the
card's name and power limit, then:

- with ``--ptxas``, each kernel's registers, shared memory and spills as
  ``nvcc -Xptxas -v`` reports them for ``csrc/matmul.cu``,
  ``csrc/acd_evict.cu``, ``csrc/rwkv6.cu``, ``csrc/fifo_dispatch.cu`` and
  ``csrc/rwkv6_bwd.cu``;
- with a ``matmul`` baseline (a bare path), the float32 kernel of that
  version (its ``matmul_f32`` taking no plan) against this one on a set of
  products (the MM stage's squares and their integer ``x @ x.T``,
  [4096]^3, ragged and transposed views, a lone product that rounds to
  -0.0, the norms' row means at llama3-8b's decode and long prefill,
  float32 weight products), bit for bit;
- with an ``rwkv6`` baseline (a kernel taking no plan), that kernel
  against this one at ``rwkv_shapes`` (rwkv6-1.6b's [8, 32, 2048, 64], the
  long batch's [2, 32, 4096, 64], the serve batch's prefill and a decode
  step from s0): S_T bit for bit, o bit for bit against
  ``ref.rwkv6_ordered`` (and, as a reading, against the baseline's o,
  whose order may differ); then both timed in turns (old, new, new, old)
  by CUDA events and by profiler device time, each call as the engine
  makes it (o and S_T allocated, the kernel's own ctypes launch: the
  baseline's as ``kernels/rwkv6.py:launch`` had it with no plan);
- with a ``fifo_dispatch`` baseline, that kernel against this one at the
  engine's [30, 3, 4096, 2] (every provider capped, n_pub = J; and random
  n_pub), cold starts off and on, all seven outputs bit for bit, and both
  timed in turns by CUDA events and by device time, each call allocating
  its outputs and launching through the same ctypes signature;
- with an ``rwkv6_bwd`` baseline (a kernel taking no plan and a
  workspace of ceil(T / 16) + 16 states a head), that kernel against this
  one at ``bwd_shapes`` (rwkv6-1.6b's training call [4, 32, 1024, 64] bf16
  on head views with no s0 or dS_T, the same in float32 from s0 with dS_T,
  a ragged [2, 3, 37, 32] with Dv = 60 in float32 and in bf16): all six
  outputs (dr, dk, dv, dw, the per-(b, h) du sums, ds0) bit for bit, each
  of this kernel's plans (``rwkv6.backward_plans``) bit for bit the
  first, and this kernel against ``ref.rwkv6_backward_ordered``; then
  both timed in turns (old, new, new, old) at the training call by CUDA
  events and by device time, each call allocating its outputs and
  workspace as ``ops.rwkv6_bwd`` does;
- with a ``flash_decode`` baseline, that version's merge of a sliced
  cache's partials (``flash_decode_merge_bf16``) against this one at
  ``merge_shapes`` (qwen1.5-32b's decode_32k per-rank fp8 cache in 16
  runs of whole chunks; recurrentgemma-9b's rolled window in 16 runs of
  128 slots), on the partials of this version's ``ops.
  flash_decode_partial``: bit for bit, then both timed in turns (old,
  new, new, old) by CUDA events and by device time.

It exits 1 on any mismatch. ``chip_smoke.py`` times the shipped kernels;
this probe does what needs a second build. Nothing here runs when the
module is imported, and the engine never calls it.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import importlib
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from . import build
from . import fifo as _fifo
from .ref import rwkv6_backward_ordered, rwkv6_ordered

# the modules, not the package's wrappers of the same names
mm = importlib.import_module(".matmul", __package__)
_rk = importlib.import_module(".rwkv6", __package__)

#: (label, M, K, N, layout): layout "nn" dense x and y, "nt" y the
#: transpose of a dense [N, K], "tt" both transposed views, "gram" the
#: integer x @ x.T of the matrix app (values 0..9), "negzero" products
#: that round to -0.0
SHAPES = [
    ("square n=344", 344, 344, 344, "nn"),
    ("square n=496", 496, 496, 496, "nn"),
    ("MM stage integer x @ x.T n=344", 344, 344, 344, "gram"),
    ("MM stage integer x @ x.T n=496", 496, 496, 496, "gram"),
    ("square 4096", 4096, 4096, 4096, "nn"),
    ("ragged (130, 257, 65)", 130, 257, 65, "nn"),
    ("ragged (127, 129, 131)", 127, 129, 131, "nn"),
    ("transposed views (200, 300, 150)", 200, 300, 150, "tt"),
    ("ragged K=1, -0.0", 3, 1, 5, "negzero"),
    ("row_mean decode level 1", 8 * 64, 64, 1, "nn"),
    ("row_mean decode level 2", 8, 64, 1, "nn"),
    ("row_mean long prefill level 1", 8192 * 64, 64, 1, "nn"),
    ("row_mean long prefill level 2", 8192, 64, 1, "nn"),
    ("skinny N=3, K=40", 1000, 40, 3, "nn"),
    ("N=9, K=80", 300, 80, 9, "nt"),
    ("f32 decode [8, 4096] @ [4096, 14336]", 8, 4096, 14336, "nn"),
    ("f32 decode [8, 4096] @ [4096, 4096]", 8, 4096, 4096, "nn"),
    ("f32 prefill [656, 4096] @ [4096, 14336]", 656, 4096, 14336, "nn"),
]


def _inputs(M, K, N, layout, gen, dev):
    if layout == "gram":
        x = torch.randint(0, 10, (M, K), generator=gen, device=dev).float()
        return x, x.T
    if layout == "negzero":
        # every product rounds to -0.0 in the first fmaf; the K16 padding
        # step turns it to +0.0
        return (torch.full((M, K), -1e-30, device=dev),
                torch.full((K, N), 1e-30, device=dev))
    x = torch.randn(M, K, generator=gen, device=dev)
    if layout == "tt":
        x = torch.randn(K, M, generator=gen, device=dev).T
    if layout in ("nt", "tt"):
        return x, torch.randn(N, K, generator=gen, device=dev).T
    return x, torch.randn(K, N, generator=gen, device=dev)


def _baseline_lib(name: str, path: Path) -> ctypes.CDLL:
    """Another version of kernel ``name``'s source, built here with the
    same flags."""
    tag = hashlib.sha1(path.read_bytes()).hexdigest()[:12]
    out = build.BUILD_DIR / f"probe_baseline_{name}_{tag}.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-I",
                    str(build.CSRC), "-o", str(out), str(path)], check=True)
    return ctypes.CDLL(str(out))


def _baseline_fn(path: Path):
    """``matmul_f32`` of another version of matmul.cu, built here."""
    fn = _baseline_lib("matmul", path).matmul_f32
    P, I, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [P, P, P, I, I, I, I64, I64, I64, I64, P]
    fn.restype = ctypes.c_int
    return fn


def against_baseline(fn) -> bool:
    """This kernel (its own plan) against the baseline's at ``SHAPES``,
    bit for bit; prints a line a shape."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    ok = True
    for label, M, K, N, layout in SHAPES:
        x, y = _inputs(M, K, N, layout, gen, dev)
        got = torch.empty((M, N), device=dev)
        mm.launch(x, y, got)
        base = torch.empty((M, N), device=dev)
        err = fn(x.data_ptr(), y.data_ptr(), base.data_ptr(), M, N, K,
                 *x.stride(), *y.stride(),
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"baseline matmul_f32: cudaError_t {err}")
        torch.cuda.synchronize()
        same = torch.equal(got, base)
        ok &= same
        plan = mm.tile_plan_f32(M, N, K, x.stride() + y.stride())
        print(f"probe matmul {label} [{M}, {K}] @ [{K}, {N}] strides "
              f"{x.stride()} {y.stride()}, plan {tuple(plan)}: bitwise "
              f"equal to the baseline kernel {same}")
    return ok


def _events_ms(fn, n):
    fn()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(n):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / n


def _device_ms(fn, n):
    """Device milliseconds per call: every device event of ``n`` calls
    under the profiler, summed (nan when the profiler saw none)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages())
    return total * 1e-3 / n if total > 0 else float("nan")


def _serve_prompt() -> int:
    """The longest prompt of chip_smoke's serve batch at rwkv6-1.6b (eight
    lengths drawn from [8, 96) with numpy's seed 0, each followed by its
    tokens)."""
    from repro_torch.configs import get_config

    vocab = get_config("rwkv6-1.6b").vocab_size
    rng = np.random.default_rng(0)
    longest = 0
    for _ in range(8):
        plen = int(rng.integers(8, 96))
        rng.integers(0, vocab, plen)
        longest = max(longest, plen)
    return longest


def rwkv_shapes():
    """(label, B, T, from s0, reps) of the timed rwkv6 shapes, H = 32 heads
    of Dk = Dv = 64, bf16."""
    return [("[8, 32, 2048, 64]", 8, 2048, False, 10),
            ("long batch [2, 32, 4096, 64]", 2, 4096, False, 10),
            (f"serve prefill [8, 32, {_serve_prompt()}, 64]", 8,
             _serve_prompt(), False, 50),
            ("decode step [8, 32, 1, 64] from s0", 8, 1, True, 200)]


def _rwkv_inputs(B, T, with_s0, gen, dev, H=32, D=64):
    # the model's [B, T, H, D] projections viewed as [B, H, T, D]
    r, k, v = (torch.randn(B, T, H, D, device=dev, generator=gen)
               .mul(0.3).to(torch.bfloat16).transpose(1, 2)
               for _ in range(3))
    w = torch.exp(-torch.exp(torch.randn(B, T, H, D, device=dev,
                                         generator=gen) - 4.0))
    u = torch.randn(H, D, device=dev, generator=gen) * 0.1
    s0 = (torch.randn(B, H, D, D, device=dev, generator=gen)
          if with_s0 else None)
    return r, k, v, w.transpose(1, 2), u, s0


def _rwkv_baseline_fn(path: Path):
    fn = _baseline_lib("rwkv6", path).rwkv6_bf16
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P] * 8 + [I] * 5 + [P, P]
    fn.restype = ctypes.c_int
    return fn


def rwkv_against_baseline(fn) -> bool:
    """This ``rwkv6`` (its own plan) against another version's bf16 kernel
    at ``rwkv_shapes``: S_T bit for bit, o and S_T against
    ``ref.rwkv6_ordered``, then both timed in turns."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    ok = True
    for label, B, T, with_s0, reps in rwkv_shapes():
        args = _rwkv_inputs(B, T, with_s0, gen, dev)
        r, k, v, w, u, s0 = args

        def old():  # the baseline's own launch: strides, no plan
            o = torch.empty_like(v)
            sT = torch.empty((B, 32, 64, 64), device=dev)
            strides = (ctypes.c_longlong * 15)(*(
                s for x in (r, k, v, w, o) for s in x.stride()[:3]))
            err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                     u.data_ptr(), None if s0 is None else s0.data_ptr(),
                     o.data_ptr(), sT.data_ptr(), B, 32, T, 64, 64,
                     ctypes.cast(strides, ctypes.c_void_p),
                     torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"baseline rwkv6: cudaError_t {err}")
            return o, sT

        def new():
            o = torch.empty_like(v)
            sT = torch.empty((B, 32, 64, 64), device=dev)
            _rk.launch(r, k, v, w, u, s0, o, sT)
            return o, sT

        (o0, s0_), (o1, s1) = old(), new()
        om, sm = rwkv6_ordered(*args)
        torch.cuda.synchronize()
        same = torch.equal(s0_, s1)  # S_T is elementwise: any order
        model = torch.equal(o1, om) and torch.equal(s1, sm)
        ok &= same and model
        ev = [_events_ms(f, reps) for f in (old, new, new, old)]
        dv = [_device_ms(f, reps) for f in (old, new, new, old)]
        plan = _rk.launch_plan(B, 32, 64, _rk._sm_count(0))
        print(f"probe rwkv6 {label} bf16, plan {tuple(plan)}: S_T "
              f"bitwise equal to the baseline kernel {same}, o and S_T to "
              f"ref.rwkv6_ordered {model}, o to the baseline kernel "
              f"{torch.equal(o0, o1)} (its order may differ); events ms "
              f"old {ev[0]:.6f} / "
              f"{ev[3]:.6f}, new {ev[1]:.6f} / {ev[2]:.6f}; device ms old "
              f"{dv[0]:.6f} / {dv[3]:.6f}, new {dv[1]:.6f} / {dv[2]:.6f}")
    return ok


def _fifo_baseline_fn(path: Path):
    fn = _baseline_lib("fifo_dispatch", path).fifo_dispatch_f64
    fn.argtypes = _fifo._ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _fifo_inputs(rng, n_pub=4096, capped=(True, True, True), B=30, P=3,
                 J=4096, C=2):
    """The engine's [B, P, J, C] chain inputs on the card, chip_smoke's
    distributions; n_pub None: random per row."""
    order = np.stack([rng.permutation(J) for _ in range(B)])
    npub = rng.integers(0, J + 1, B) if n_pub is None else np.full(B, n_pub)
    x = [order.astype(np.int32), npub.astype(np.int32),
         rng.uniform(0.0, 0.01 * J, (B, P, J)),
         rng.lognormal(0.0, 0.5, (B, P, J)),
         rng.uniform(0.0, 2.0, (B, P, J)),
         rng.uniform(0.0, 0.3, (B, P, J)),
         rng.integers(0, 4, (B, P, J)).astype(np.int32),
         np.asarray(capped, bool), rng.uniform(0.1, 1.0, P),
         rng.uniform(0.0, 3.0, (B, P, C))]
    x.append(np.where(rng.random((B, P, C)) < 0.3, -np.inf, x[-1]))
    return [torch.from_numpy(np.ascontiguousarray(a)).to("cuda")
            for a in x]


def _fifo_outs(B, J, dev):
    """The seven [B, J] outputs of one call, as ``ops.fifo_dispatch``
    allocates them."""
    return tuple(torch.empty((B, J), dtype=dt, device=dev) for dt in (
        torch.int32, torch.int32, torch.float64, torch.bool, torch.float64,
        torch.float64, torch.float64))


def fifo_against_baseline(fn) -> bool:
    """This ``fifo_dispatch`` against another version's at the engine's
    [30, 3, 4096, 2], bit for bit in all seven outputs, both timed in
    turns by CUDA events and by device time."""
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    B, P, J, C = 30, 3, 4096, 2
    clk, ns = _fifo.chain_step_latency()
    print(f"probe fifo_dispatch chain step (3 x 2 pool, cold, every "
          f"provider capped): {clk:.2f} SM clocks, {ns:.4f} ns; floor at "
          f"n_pub = {J}: {J * ns * 1e-6:.6f} ms")
    ok = True
    for label, n_pub, capped in (("n_pub = J, every provider capped", J,
                                  (True, True, True)),
                                 ("random n_pub, provider 1 uncapped",
                                  None, (True, False, True))):
        args = _fifo_inputs(rng, n_pub, capped)
        for cold in (False, True):
            def old():
                outs = _fifo_outs(B, J, dev)
                ptrs = [a.data_ptr() for a in (*args, *outs)]
                err = fn(*ptrs, B, P, J, C, 1.0, int(cold),
                         torch.cuda.current_stream().cuda_stream)
                if err != 0:
                    raise RuntimeError(f"baseline fifo: cudaError_t {err}")
                return outs

            def new():
                outs = _fifo_outs(B, J, dev)
                _fifo.launch(*args, 1.0, cold, outs)
                return outs

            a_, b_ = old(), new()
            torch.cuda.synchronize()
            same = all(torch.equal(p, q) for p, q in zip(a_, b_))
            ok &= same
            ev = [_events_ms(f, 10) for f in (old, new, new, old)]
            dv = [_device_ms(f, 10) for f in (old, new, new, old)]
            print(f"probe fifo_dispatch [{B}, {P}, {J}, {C}] {label}, "
                  f"cold={cold}: bitwise equal to the baseline kernel "
                  f"{same}; events ms old "
                  f"{ev[0]:.6f} / {ev[3]:.6f}, new {ev[1]:.6f} / "
                  f"{ev[2]:.6f}; device ms old {dv[0]:.6f} / {dv[3]:.6f}, "
                  f"new {dv[1]:.6f} / {dv[2]:.6f}")
    return ok


def bwd_shapes():
    """(label, B, H, T, Dk, Dv, dtype, with s0 and dS_T) of the compared
    ``rwkv6_bwd`` calls, the timed training call first."""
    return [("[4, 32, 1024, 64] bf16, no s0 or dS_T (the training call)",
             4, 32, 1024, 64, 64, torch.bfloat16, False),
            ("[4, 32, 1024, 64] float32 from s0 with dS_T", 4, 32, 1024, 64,
             64, torch.float32, True),
            ("ragged [2, 3, 37, 32] Dv=60 float32 from s0 with dS_T", 2, 3,
             37, 32, 60, torch.float32, True),
            ("ragged [2, 3, 37, 32] Dv=60 bf16 from s0 with dS_T", 2, 3, 37,
             32, 60, torch.bfloat16, True)]


def _bwd_inputs(B, H, T, Dk, Dv, dt, with_state, gen, dev):
    """r, k, v, w, u, do, s0, dsT as ``loss_fn`` passes them: head views
    of [B, T, H, D] tensors."""
    def heads(D, scale=0.3, to=dt):
        return (torch.randn(B, T, H, D, device=dev, generator=gen)
                * scale).to(to).transpose(1, 2)
    r, k, v = heads(Dk), heads(Dk), heads(Dv)
    w = torch.exp(-torch.exp(heads(Dk, 1.0, torch.float32) - 4.0))
    u = torch.randn(H, Dk, device=dev, generator=gen) * 0.1
    s0, dsT = (torch.randn(B, H, Dk, Dv, device=dev, generator=gen)
               if with_state else None for _ in range(2))
    return r, k, v, w, u, heads(Dv), s0, dsT


def _bwd_outs(r, v, w):
    """dr, dk, dv, dw, du_part, ds0 as ``ops.rwkv6_bwd`` allocates them."""
    B, H, _, Dk = r.shape
    return (torch.empty_like(r), torch.empty_like(r), torch.empty_like(v),
            torch.empty_like(w),
            torch.empty((B, H, Dk), device=r.device),
            torch.empty((B, H, Dk, v.shape[-1]), device=r.device))


def _rwkv_bwd_baseline_fns(path: Path):
    lib = _baseline_lib("rwkv6_bwd", path)
    P, I = ctypes.c_void_p, ctypes.c_int
    fns = {}
    for dt, name in ((torch.float32, "rwkv6_bwd_f32"),
                     (torch.bfloat16, "rwkv6_bwd_bf16")):
        fn = getattr(lib, name)
        fn.argtypes = [P] * 15 + [ctypes.c_longlong] + [I] * 5 + [P, P]
        fn.restype = ctypes.c_int
        fns[dt] = fn
    return fns


def rwkv_bwd_against_baseline(fns) -> bool:
    """This ``rwkv6_bwd`` against another version's at ``bwd_shapes``: the
    six outputs bit for bit, every plan alike, and against
    ``ref.rwkv6_backward_ordered``; then both timed in turns."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    ok = True
    for n_shape, (label, B, H, T, Dk, Dv, dt, state) in enumerate(
            bwd_shapes()):
        args = _bwd_inputs(B, H, T, Dk, Dv, dt, state, gen, dev)
        r, k, v, w, u, do, s0, dsT = args
        opt = [None if x is None else x.data_ptr() for x in (s0, dsT)]

        def old():  # its own workspace: ceil(T / 16) + 16 states a head
            outs = _bwd_outs(r, v, w)
            work = torch.empty(
                (B * H * (-(-T // 16) + 16) * Dk * (-(-Dv // 4) * 4),),
                device=dev)
            strides = (ctypes.c_longlong * 27)(*(
                s for x in (r, k, v, w, do, *outs[:4]) for s in x.stride()[:3]))
            err = fns[dt](*(x.data_ptr() for x in (r, k, v, w, u, do)), *opt,
                          *(x.data_ptr() for x in outs), work.data_ptr(),
                          work.numel(), B, H, T, Dk, Dv, strides,
                          torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"baseline rwkv6_bwd: cudaError_t {err}")
            return outs

        def new(plan=None):
            outs = _bwd_outs(r, v, w)
            work = torch.empty((_rk.workspace_floats(B, H, T, Dk, Dv, plan),),
                               device=dev)
            _rk.launch_backward(r, k, v, w, u, do, s0, dsT, *outs, work,
                                _plan=plan)
            return outs

        base, got = old(), new()
        plans = {tuple(p): new(p) for p in _rk.backward_plans(Dk, Dv)}
        want = rwkv6_backward_ordered(*args)
        torch.cuda.synchronize()
        same = [torch.equal(x, y) for x, y in zip(base, got)]
        alike = all(torch.equal(x, y) for outs in plans.values()
                    for x, y in zip(outs, got))
        du = got[4][0]
        for b in range(1, B):
            du = du + got[4][b]
        model = all(torch.equal(x, y) for x, y in zip(
            (*got[:4], du, got[5]), want))
        ok &= all(same) and alike and model
        line = (f"probe rwkv6_bwd {label}, plans {list(plans)}: bitwise "
                f"equal to the baseline kernel (dr, dk, dv, dw, du_part, "
                f"ds0) {same}, every plan alike {alike}, all six to "
                f"ref.rwkv6_backward_ordered {model}")
        if n_shape == 0:
            ev = [_events_ms(f, 5) for f in (old, new, new, old)]
            dv = [_device_ms(f, 5) for f in (old, new, new, old)]
            line += (f"; events ms old {ev[0]:.6f} / {ev[3]:.6f}, new "
                     f"{ev[1]:.6f} / {ev[2]:.6f}; device ms old {dv[0]:.6f}"
                     f" / {dv[3]:.6f}, new {dv[1]:.6f} / {dv[2]:.6f}")
        print(line, flush=True)
    return ok


def merge_shapes():
    """(label, q heads, cache [B, Hkv, S, D], cache dtype, ranks, length,
    end) of the merges chip_smoke.py checks (SPLIT_DECODE, SPLIT_ROLLED)."""
    return [("qwen1.5-32b decode_32k fp8", 40, (8, 40, 32768, 128),
             torch.float8_e4m3fn, 16, [32768] * 8, None),
            ("recurrentgemma-9b rolled window", 16, (8, 1, 2048, 256),
             torch.bfloat16, 16, [2048] * 7 + [300],
             [32845, 32845, 32896, 33023, 33024, 32769, 35816, 300])]


def _merge_baseline_fn(path: Path):
    fn = _baseline_lib("flash_decode", path).flash_decode_merge_bf16
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, ctypes.c_longlong, I, I, P, P, P, I, I, I, I, I, P]
    fn.restype = ctypes.c_int
    return fn


def merge_against_baseline(fn) -> bool:
    """This merge against the baseline's at ``merge_shapes``, bit for bit,
    and both timed in turns; prints a line a shape."""
    from . import ops
    from .ref import decode_local_chunks
    from ..models.layers import to_kv

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    ok = True
    for label, hq, (B, hkv, S, D), kv_dtype, m, lens, ends in merge_shapes():
        q = torch.randn((B, hq, D), generator=gen, device=dev).bfloat16()
        k, v = (to_kv(torch.randn((B, hkv, S, D), generator=gen,
                                  device=dev).bfloat16(), kv_dtype)
                for _ in range(2))
        length = torch.tensor(lens, dtype=torch.int32, device=dev)
        end = (length.clamp(0, S) if ends is None
               else torch.tensor(ends, dtype=torch.int32, device=dev))
        L = S // m
        parts = torch.stack([ops.flash_decode_partial(
            q, k[:, :, r * L:(r + 1) * L], v[:, :, r * L:(r + 1) * L],
            length, end, r * L, S) for r in range(m)]).contiguous()

        def new():
            return ops.flash_decode_merge(parts, q, length, end, S, L, hkv)

        def old():  # the baseline's merge through the same C signature
            out = torch.empty(q.shape, dtype=q.dtype, device=dev)
            err = fn(parts.data_ptr(), parts.stride(0), m,
                     decode_local_chunks(S, L), length.data_ptr(),
                     end.data_ptr(), out.data_ptr(), B, hq, S, L, D,
                     torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"baseline merge: cudaError_t {err}")
            return out

        same = torch.equal(new().view(torch.int16), old().view(torch.int16))
        ok &= same
        ev = [_events_ms(f, 20) for f in (old, new, new, old)]
        dv = [_device_ms(f, 20) for f in (old, new, new, old)]
        print(f"probe flash_decode merge {label} q [{B}, {hq}, {D}] over "
              f"[{B}, {hkv}, {S}, {D}] in {m} runs: bitwise equal to the "
              f"baseline merge {same}; ms by events old/new/new/old "
              f"{ev[0]:.6f} {ev[1]:.6f} {ev[2]:.6f} {ev[3]:.6f}, by device "
              f"time {dv[0]:.6f} {dv[1]:.6f} {dv[2]:.6f} {dv[3]:.6f}")
    return ok


def ptxas(names=("matmul", "acd_evict", "rwkv6", "fifo_dispatch",
                 "rwkv6_bwd")):
    for name in names:
        out = build.BUILD_DIR / f"probe_ptxas_{name}.so"
        got = subprocess.run(
            [build.find_nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             str(out), str(build.CSRC / build.SOURCES[name])],
            capture_output=True, text=True)
        for line in (got.stdout + got.stderr).splitlines():
            if ("registers" in line or "spill" in line
                    or "Compiling" in line):
                print(f"ptxas {name}: {line.strip()}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", action="append", default=[],
                    help="another version of a kernel's source, as "
                         "NAME=PATH (NAME matmul, rwkv6, fifo_dispatch, "
                         "rwkv6_bwd or flash_decode; a bare PATH is "
                         "matmul's)")
    ap.add_argument("--ptxas", action="store_true",
                    help="print registers and spills per kernel")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    build.build_all(["matmul", "rwkv6", "fifo_dispatch", "rwkv6_bwd",
                     "flash_decode"])
    if args.ptxas:
        ptxas()
    ok = True
    for spec in args.baseline:
        name, _, path = spec.rpartition("=")
        name = name or "matmul"
        if name == "matmul":
            ok &= against_baseline(_baseline_fn(Path(path)))
        elif name == "rwkv6":
            ok &= rwkv_against_baseline(_rwkv_baseline_fn(Path(path)))
        elif name == "fifo_dispatch":
            ok &= fifo_against_baseline(_fifo_baseline_fn(Path(path)))
        elif name == "rwkv6_bwd":
            ok &= rwkv_bwd_against_baseline(
                _rwkv_bwd_baseline_fns(Path(path)))
        elif name == "flash_decode":
            ok &= merge_against_baseline(_merge_baseline_fn(Path(path)))
        else:
            raise SystemExit(f"probe: no baseline for kernel {name!r}")
    print(f"probe: {'all bitwise checks passed' if ok else 'MISMATCH'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
