"""Build the CUDA sources in ``csrc/`` with nvcc and bind them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own, at first use, into a shared
library with a plain C interface under ``build/repro_torch_kernels/`` at the
root of the checkout.  The library's file name carries a digest of every
source in ``csrc/`` and of the flags, so an edited source never loads a
stale build.  ``build`` starts one nvcc per missing library, all at once,
and waits for them.

A ``CudaKernel`` is one C entry point: it loads its library on first
launch, raises when the launch returns a CUDA error, and counts the
launches that succeeded in ``launches``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = ("coded_matvec.cu", "count_sketch.cu", "draw.cu", "fwht.cu",
           "normal.cu", "oversketch_gram.cu", "sketch_gram.cu",
           "sketch_gram_sjlt.cu", "sketch_gram_srht.cu")

# The ptxas report (registers, shared memory, spills) of each build made
# by this process, by source name.
BUILD_LOGS: Dict[str, str] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and Path("/usr/local/cuda/bin/nvcc").exists():
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                           "the CUDA toolkit is installed")
    return path


def library_path(source: str) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        digest.update(f.name.encode())
        digest.update(f.read_bytes())
    return BUILD_DIR / f"lib{Path(source).stem}-{digest.hexdigest()[:12]}.so"


def build(sources: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Compile every source whose library is missing, in parallel."""
    paths = {s: library_path(s) for s in sources}
    todo = {s: p for s, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for s, p in todo.items():
        tmp = p.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / s)]
        procs[s] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, p)
    failed = []
    for s, (proc, tmp, p) in procs.items():
        out, _ = proc.communicate()
        BUILD_LOGS[s] = out
        if proc.returncode != 0:
            failed.append(f"{s}:\n{out}")
            continue
        os.replace(tmp, p)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


class CudaKernel:
    """One C entry point of a csrc library (see module docstring)."""

    def __init__(self, name: str, source: str, symbol: str,
                 argtypes: Sequence, replaces: str):
        self.name = name
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.replaces = replaces
        self.launches = 0
        self._lib = None

    def library(self) -> ctypes.CDLL:
        if self._lib is None:
            self._lib = ctypes.CDLL(str(build([self.source])[self.source]))
        return self._lib

    def host_function(self, symbol: str, argtypes: Sequence):
        fn = getattr(self.library(), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        return fn

    def launch(self, *args, symbol: str = "") -> None:
        """Launch through the entry point, or through ``symbol``, another
        mode of the same kernel with the same argument types."""
        err = self.host_function(symbol or self.symbol, self.argtypes)(*args)
        if err != 0:
            raise RuntimeError(f"{self.name}: launch failed with CUDA error "
                               f"{err}")
        self.launches += 1
