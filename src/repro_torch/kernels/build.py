"""Build the port's CUDA kernels with ``nvcc`` at first use.

Each source under ``csrc/`` compiles on its own (with the shared headers
``csrc/*.cuh`` it includes) into a shared library with a plain C
interface, loaded with :mod:`ctypes` (no PyTorch headers, so a build takes
seconds, not minutes). Libraries land in ``build/kernels/`` at the
repository root, named by a hash of the source, the headers and the flags,
so an edited source rebuilds and an unchanged one loads the cached file.

Nothing here runs when the package is imported: the CPU tests import every
module on machines without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
#: flags of every source, part of the hash key: sm_90a for wgmma;
#: --fmad=false keeps the CUDA-core float code's multiplies and adds apart
#: (its fused multiply-adds are explicit fmaf); wgmma is unaffected
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "--fmad=false")

#: kernel name -> source file under csrc/
SOURCES = {"acd_evict": "acd_evict.cu",
           "fifo_dispatch": "fifo_dispatch.cu",
           "matmul": "matmul.cu",
           "flash_attention": "flash_attention.cu",
           "flash_decode": "flash_decode.cu",
           "rglru": "rglru.cu",
           "rglru_bwd": "rglru_bwd.cu",
           "rwkv6": "rwkv6.cu",
           "rwkv6_bwd": "rwkv6_bwd.cu"}

_LOADED: Dict[str, ctypes.CDLL] = {}
#: seconds each kernel's last build (or cache hit) took, for reporting
BUILD_SECONDS: Dict[str, float] = {}


def find_nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under ``$CUDA_HOME`` or
    ``/usr/local/cuda``; raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def library_path(name: str) -> Path:
    """Where kernel ``name``'s library lives, keyed by its source, the
    shared headers (``csrc/*.cuh``) and the flags."""
    parts = [(CSRC / SOURCES[name]).read_bytes()]
    parts += [h.read_bytes() for h in sorted(CSRC.glob("*.cuh"))]
    digest = hashlib.sha256(b"".join(parts)
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def _compile_cmd(name: str, out: Path) -> List[str]:
    return [find_nvcc(), *NVCC_FLAGS, "-o", str(out),
            str(CSRC / SOURCES[name])]


def build_all(names=None) -> Dict[str, Path]:
    """Compile every requested kernel that has no cached library, one
    ``nvcc`` process per source, all started together. Returns the
    library paths; raises with the compiler's output on a failure."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t_start = time.perf_counter()
    for name in names:
        lib = library_path(name)
        if lib.is_file():
            BUILD_SECONDS[name] = 0.0
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        procs[name] = (subprocess.Popen(
            _compile_cmd(name, Path(tmp)), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), Path(tmp), lib)
    failed = []
    for name, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        BUILD_SECONDS[name] = time.perf_counter() - t_start
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, lib)  # atomic: a concurrent process never sees half
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return {name: library_path(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building it on first use."""
    lib = _LOADED.get(name)
    if lib is None:
        path = build_all([name])[name]
        lib = ctypes.CDLL(str(path))
        _LOADED[name] = lib
    return lib
