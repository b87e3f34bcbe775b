"""Where ``rwkv6_bwd``'s time goes, phase by phase, on one NVIDIA GPU.

Builds ``src/repro_torch/kernels/csrc/rwkv6_bwd.cu`` as it is and once more
for each phase with that phase's work taken out (the same source with one
statement removed: its gradients are then wrong, and only its time is
read), then times every build at rwkv6-1.6b's training call ([4, 32, 1024,
64] bf16 head views, no s0, no dS_T) by CUDA events, all builds in turns
over ``--reps`` rounds. A phase's share is what the kernel saves without
it, a reading: the compiler schedules what is left anew. The phases:

- ``pass 1``: the forward walk that writes the checkpoints;
- ``chunk sums``: the chains that add a chunk's tile sums into dr, dk, dw
  and dv, and their stores;
- ``du``: du's step terms;
- ``dots``: the chains of do . v;
- ``steps``: the steps in reverse (dS and the tile sums of each step).

Usage: python tools/rwkv6_bwd_phases.py [--reps 3]
"""
from __future__ import annotations

import argparse
import ctypes
import importlib
import os
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.kernels import build  # noqa: E402

probe = importlib.import_module("repro_torch.kernels.probe")
_rk = importlib.import_module("repro_torch.kernels.rwkv6")

#: phase -> (statement of the source, what replaces it)
CUTS = {
    "pass 1": ("  for (int c = 0; c < nC - 1; ++c) {",
               "  for (int c = 0; c < 0; ++c) {"),
    "chunk sums": ("    if (q > 0) finish(t0 + C, min(C, Tn - t0 - C));\n",
                   ""),
    "du": ("    if (q > 0) {\n      du_of(", "    if (q < 0) {\n      du_of("),
    "dots": ("    dots_of(n, dots + (q & 1) * C);\n", ""),
    "steps": ("    for (int s = C - 1; s >= 0; --s) {\n      const float* st",
              "    for (int s = C - 1; s >= 0 && q < 0; --s) {\n"
              "      const float* st"),
}


def builds(out: Path):
    """The full source and one build a phase, compiled side by side."""
    src = (build.CSRC / build.SOURCES["rwkv6_bwd"]).read_text()
    sources = {"full": src}
    for name, (old, new) in CUTS.items():
        if src.count(old) != 1:
            raise SystemExit(f"rwkv6_bwd_phases: the source no longer has "
                             f"the statement of {name!r}")
        sources[f"without {name}"] = src.replace(old, new)
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, text) in enumerate(sources.items()):
        cu = out / f"rwkv6_bwd_phase{i}.cu"
        cu.write_text(text)
        procs[name] = (subprocess.Popen(
            [build.find_nvcc(), *build.NVCC_FLAGS, "-o",
             str(cu.with_suffix(".so")), str(cu)]), cu.with_suffix(".so"))
    fns = {}
    for name, (proc, so) in procs.items():
        if proc.wait() != 0:
            raise SystemExit(f"rwkv6_bwd_phases: {name} did not build")
        fn = ctypes.CDLL(str(so)).rwkv6_bwd_bf16
        fn.argtypes = _rk._BWD_ARGTYPES
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("rwkv6_bwd_phases: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    fns = builds(build.BUILD_DIR / "phases")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    B, H, T, D = 4, 32, 1024, 64
    r, k, v, w, u, do, _, _ = probe._bwd_inputs(B, H, T, D, D,
                                                torch.bfloat16, False, gen,
                                                dev)
    plan = _rk.backward_plan(D, D)

    def call(fn):
        outs = probe._bwd_outs(r, v, w)
        work = torch.empty((_rk.workspace_floats(B, H, T, D, D),),
                           device=dev)
        strides = (ctypes.c_longlong * 27)(*(
            s for x in (r, k, v, w, do, *outs[:4]) for s in x.stride()[:3]))
        err = fn(*(x.data_ptr() for x in (r, k, v, w, u, do)), None, None,
                 *(x.data_ptr() for x in outs), work.data_ptr(), work.numel(),
                 B, H, T, D, D, strides, (ctypes.c_int * 2)(*plan),
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"rwkv6_bwd: cudaError_t {err}")

    times = {name: [] for name in fns}
    for _ in range(args.reps):
        for name, fn in fns.items():
            times[name].append(probe._events_ms(lambda: call(fn), 5))
    full = min(times["full"])
    for name, ms in times.items():
        best = min(ms)
        print(f"rwkv6_bwd phases [{B}, {H}, {T}, {D}] bf16 {name}: "
              f"{' / '.join(f'{t:.6f}' for t in ms)} ms by events (best "
              f"{best:.6f}; {best / full:.3f} of the full kernel's)",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
