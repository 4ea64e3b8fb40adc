#!/usr/bin/env python3
"""Time what the normal kernel's table read costs, on one GPU.

    python3 scripts/time_normal_gather.py [--reps 20]

The normal kernel (src/repro_torch/kernels/csrc/normal.cu) is one
threefry hash, a read of a 32 MiB table at the word's top 23 bits and a
streaming store per draw.  This script builds a probe of that loop (the
same hash, csrc/threefry.cuh) with nvcc into build/, and times it with
CUDA events at one gaussian block's draw (300,000 x 256) in these forms:

  hash_store        the hash and the store alone, no table read
  table_MiB=N       the read from a table of N MiB (32: the kernel's;
                    smaller ones shift more bits off, the same reads)

Prints one JSON line of milliseconds, then the nvidia-smi line.  The probe
reads a random table: it measures the memory system, not the draws.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
BUILD = ROOT / "build" / "probes"

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
#include "threefry.cuh"
constexpr int THREADS = 256;
template <bool READ>
__global__ void __launch_bounds__(THREADS)
    probe(uint32_t k0, uint32_t k1, const float* __restrict__ t,
          float* __restrict__ out, int64_t size, int shift) {
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  for (int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x; i < size;
       i += stride) {
    const uint32_t b = threefry::bits(k0, k1, (uint64_t)i);
    __stcs(out + i, READ ? __ldg(t + (b >> shift)) : __uint_as_float(b >> shift));
  }
}
extern "C" int run(int read, const float* t, float* out, long long size,
                   int shift, void* stream) {
  int sms = 0, dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long want = (size + THREADS - 1) / THREADS, cap = sms * 8LL;
  const int blocks = (int)(want < cap ? want : cap);
  cudaStream_t s = (cudaStream_t)stream;
  if (read) probe<true><<<blocks, THREADS, 0, s>>>(1, 2, t, out, size, shift);
  else probe<false><<<blocks, THREADS, 0, s>>>(1, 2, t, out, size, shift);
  return (int)cudaGetLastError();
}
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("time_normal_gather: no CUDA device is available",
              file=sys.stderr)
        return 2
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    BUILD.mkdir(parents=True, exist_ok=True)
    (BUILD / "normal_gather.cu").write_text(SOURCE)
    lib_path = BUILD / "libnormal_gather.so"
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                    "-I", str(CSRC), "-o", str(lib_path),
                    str(BUILD / "normal_gather.cu")], check=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.run.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]

    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    table = torch.randn(1 << 23, device=dev)
    out = torch.empty(300_000 * 256, device=dev)

    def ms(read: int, shift: int = 9) -> float:
        def call():
            err = lib.run(read, table.data_ptr(), out.data_ptr(), out.numel(),
                          shift, stream)
            if err:
                raise RuntimeError(f"probe launch failed: CUDA error {err}")
        call()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.reps):
            call()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / args.reps

    row = {"hash_store": ms(0)}
    for mib, shift in ((32, 9), (16, 10), (8, 11), (1, 14)):
        row[f"table_MiB={mib}"] = ms(1, shift)
    row["draws"] = out.numel()
    print(json.dumps(row), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
