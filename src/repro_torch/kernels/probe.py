"""Development probe of the float32 ``matmul`` kernel against another
version of it, on one NVIDIA GPU.

    python -m repro_torch.kernels.probe [--baseline OLD_MATMUL_CU] [--ptxas]

(with ``src`` on ``PYTHONPATH``). It prints the card's name and power
limit, then:

- with ``--ptxas``, each kernel's registers, shared memory and spills as
  ``nvcc -Xptxas -v`` reports them for ``csrc/matmul.cu`` and
  ``csrc/acd_evict.cu``;
- with ``--baseline``, the float32 kernel of another version of
  ``matmul.cu`` (built from that file with the same flags, its
  ``matmul_f32`` taking no plan) against this one on a set of products
  (the MM stage's squares and their integer ``x @ x.T``, [4096]^3, ragged
  and transposed views, a lone product that rounds to -0.0, the norms'
  row means at llama3-8b's decode and long prefill, float32 weight
  products), bit for bit.

It exits 1 on any mismatch. ``chip_smoke.py`` holds the configurations
against each other and times them; this probe only does what needs a
second build. Nothing here runs when the module is imported, and the
engine never calls it.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib
import subprocess
import sys
from pathlib import Path

import torch

from . import build

# the module, not the package's ``matmul`` wrapper of the same name
mm = importlib.import_module(".matmul", __package__)

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


def _baseline_fn(path: Path):
    """``matmul_f32`` of another version of matmul.cu, built here."""
    out = build.BUILD_DIR / "probe_baseline_matmul.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-o", str(out),
                    str(path)], check=True)
    fn = ctypes.CDLL(str(out)).matmul_f32
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


def ptxas(names=("matmul", "acd_evict")):
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
    ap.add_argument("--baseline", type=Path, default=None,
                    help="another version of csrc/matmul.cu to hold the "
                         "float32 kernel against, bit for bit")
    ap.add_argument("--ptxas", action="store_true",
                    help="print registers and spills per kernel")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    build.build_all(["matmul"])
    if args.ptxas:
        ptxas()
    ok = True
    if args.baseline is not None:
        ok = against_baseline(_baseline_fn(args.baseline))
    print(f"probe: {'all bitwise checks passed' if ok else 'MISMATCH'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
