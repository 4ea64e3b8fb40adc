"""Count-sketch apply ``A_tilde_k = S_k^T A`` for K blocks, and its layered
form, the SJLT apply.

CUDA kernel: ``csrc/count_sketch.cu`` (device code in
``csrc/sketch_common.cuh``); replaces the Pallas kernel
``repro/kernels/count_sketch.py::count_sketch_apply``.  CPU tensors take
the plain version in ``ref.py``; CUDA tensors launch the kernel or raise.

What bounds a segment sum on the H100 is where its partial sums live.  A
shared-memory tile per block holds them only for small b, with one shared
load and store per update; past b ~1,700 no tile fits.  The kernel keeps
them in registers at every b: a stable counting sort of each block's
(row, layer) entries by bucket on the device, into a list of (row, sigma)
pairs, then one warp per output row (block, bucket) and column strip sums
sigma times its bucket's rows of A, strip by strip so that A's K s
re-reads come from L2.  Where a group of blocks' partial sums fit in one
CTA's registers, the grouped gather reads each row of a strip into shared
memory once for the whole group instead.  ``apply_plan`` sizes the sort,
the gather and the scratch.
"""
from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import CudaKernel
from repro_torch.kernels._check import check_cuda, on_cpu, stream

KERNEL = CudaKernel(
    "count_sketch_apply", "count_sketch.cu", "count_sketch_apply_launch",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_float,
                                                  ctypes.c_void_p],
    replaces="src/repro/kernels/count_sketch.py:49")


@dataclass
class InnerLaunches:
    """The launch count of a kernel with no entry point of its own, which
    runs inside other entry points' launches."""
    name: str
    launches: int = 0


# The grouped gather runs inside this kernel's launches and those of the
# fused count-sketch and SJLT Grams; it is counted apart, one launch a
# chunk of blocks it gathers, so that a run shows which gather it took.
GROUPED = InnerLaunches("cs_gather_grouped")

# Columns of A per strip of the gather (8, 16 or 32).  On an H100 at
# n = 300,000, d = 3,000 (``scripts/sweep_apply.py``) 32 runs fastest at
# every shape the paths give it (b = 256 and 4,096, s = 1 and 4, the apply
# alone and the fused Grams): a strip is 38 MB, still inside the 50 MB L2,
# and each row read is a whole 128-byte line.  The sort's chunks:
# one warp each, at least ~8,192 entries, at most 64 per block.
GATHER_WIDTH = 32
SORT_CHUNK_ENTRIES = 8192
SORT_MAX_CHUNKS = 64
# The grouped gather (``csrc/sketch_common.cuh``): one thread of a CTA
# keeps one output row (block, bucket) of a 32-column strip, its 32 partial
# sums in registers.  A CTA has GROUP_THREADS threads, which then hold half
# the SM's registers, and at most GROUP_MAX blocks (the kernel's GG_THREADS
# and GG_MAX_GROUP), so a group holds GROUP_THREADS / b blocks: 4 at
# b = 256, 1 (the per-bucket gather) from b = 1,024 on.  The layers s of a
# block share its partial sums, so s does not enter but for the kernel's
# 32-bit entry indices (K s n below 2^32).
GROUP_THREADS = 1024
GROUP_MAX = 32


@dataclass(frozen=True)
class ApplyPlan:
    """How the CUDA apply runs: ``sort_chunks`` chunks of rows per block
    in the sort; ``group`` blocks a CTA in the grouped gather, or, at 1,
    the per-bucket gather with ``width`` columns per strip; and the int32
    scratch the launch needs."""
    sort_chunks: int
    width: int
    group: int
    scratch_ints: int


def gather_group(k: int, s: int, n: int, block_size: int,
                 aligned: bool = True) -> int:
    """Blocks a group of the grouped gather: one thread a bucket, at most
    K and GROUP_MAX; 1 where no group of two fits, where K s n entries pass
    32-bit indices, or where A's rows are not 16-byte aligned (its tensor
    copies need them)."""
    group = min(k, GROUP_MAX, GROUP_THREADS // int(block_size))
    return group if group > 1 and k * s * n < 1 << 32 and aligned else 1


def rows_aligned(a: torch.Tensor) -> bool:
    """Whether every row of the (n, d) float32 A starts 16 bytes aligned."""
    return a.shape[1] % 4 == 0 and a.data_ptr() % 16 == 0


def apply_plan(k: int, s: int, n: int, block_size: int,
               aligned: bool = True) -> ApplyPlan:
    """The apply's plan for K blocks of s layers over n rows, ``aligned``
    as ``rows_aligned`` of A.  The scratch holds the sort of all K blocks:
    the sorted (row, sigma) pairs (K, s n, 2), bucket starts (K, b + 1)
    and per-chunk counts (K, chunks, b)."""
    b = int(block_size)
    if s * n >= 1 << 31:
        raise ValueError(f"count_sketch_apply: s n = {s * n} must be below "
                         "2^31")
    chunks = max(1, min(SORT_MAX_CHUNKS, -(-s * n // SORT_CHUNK_ENTRIES)))
    return ApplyPlan(chunks, GATHER_WIDTH, gather_group(k, s, n, b, aligned),
                     2 * k * s * n + k * (b + 1) + k * chunks * b)


def count_sketch_apply(h: torch.Tensor, sigma: torch.Tensor, a: torch.Tensor,
                       block_size: int) -> torch.Tensor:
    """(K, n) int32, (K, n) float32, (n, d) float32 -> (K, b, d) float32.

    Given (K, s, n) buckets and signs, the SJLT apply: each block sums its
    s layers and is scaled by 1/sqrt(s), as ``ref.sjlt_apply``; the kernel
    adds the layers into one sum instead of forming K s blocks."""
    layered = h.dim() == 3
    if on_cpu(h, sigma, a):
        if layered:
            return ref.sjlt_apply(h, sigma, a, block_size)
        return ref.count_sketch_apply(h, sigma, a, block_size)
    k, s, n = h.shape if layered else (h.shape[0], 1, h.shape[1])
    d = a.shape[1]
    codes = (k, s, n) if layered else (k, n)
    check_cuda("count_sketch_apply", h=(h, torch.int32, codes),
               sigma=(sigma, torch.float32, codes),
               a=(a, torch.float32, (n, d)))
    b = int(block_size)
    plan = apply_plan(k, s, n, b, rows_aligned(a))
    scratch = torch.empty(plan.scratch_ints, dtype=torch.int32,
                          device=a.device)
    out = torch.empty((k, b, d), dtype=torch.float32, device=a.device)
    KERNEL.launch(h.data_ptr(), sigma.data_ptr(), a.data_ptr(),
                  out.data_ptr(), scratch.data_ptr(), k, s, n, d, b,
                  plan.sort_chunks, plan.width, plan.group,
                  1.0 / math.sqrt(s), stream(a))
    if plan.group > 1:
        GROUPED.launches += 1
    return out
