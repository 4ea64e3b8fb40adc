"""Fused sketch -> survivor-masked Gram, one kernel per sketch family.

CUDA kernels, replacing the Pallas kernels of
``repro/kernels/sketch_gram.py``:

  sketch_gram_count  ``csrc/sketch_gram.cu``       (sketch_gram_count)
  sketch_gram_sjlt   ``csrc/sketch_gram_sjlt.cu``  (sketch_gram_sjlt)
  sketch_gram_srht   ``csrc/sketch_gram_srht.cu``  (sketch_gram_srht)

Each kernel walks the sketch blocks in chunks whose ``A_tilde`` stays
under ``CHUNK_BYTES``: the full ``(K, b, d)`` ``A_tilde`` is never formed,
and a masked block is neither sketched nor read.  CPU tensors take the
plain versions in ``ref.py``; CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import CudaKernel
from repro_torch.kernels._check import check_cuda, on_cpu, stream

KERNEL = CudaKernel(
    "sketch_gram_count", "sketch_gram.cu", "sketch_gram_count_launch",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    replaces="src/repro/kernels/sketch_gram.py:275")
SJLT_KERNEL = CudaKernel(
    "sketch_gram_sjlt", "sketch_gram_sjlt.cu", "sketch_gram_sjlt_launch",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_float,
                                                   ctypes.c_void_p],
    replaces="src/repro/kernels/sketch_gram.py:296")
SRHT_KERNEL = CudaKernel(
    "sketch_gram_srht", "sketch_gram_srht.cu", "sketch_gram_srht_launch",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    replaces="src/repro/kernels/sketch_gram.py:318")

# Budget for one chunk's A_tilde: 24 blocks at b = 256, d = 3,000.  On an
# H100 (scripts/sweep_sketch_gram_chunk.py) chunks of 24 to 144 blocks run
# the fused count-sketch call within 5% of each other and ~20% faster than
# chunks of 6 or 12, whose A_tilde fits in L2: more apply CTAs per chunk
# fill the last wave better, and the Gram half reads A_tilde from HBM at
# little cost.  The SJLT and SRHT kernels take the same budget, untuned.
CHUNK_BYTES = 80 << 20


def chunk_blocks(k: int, block_size: int, d: int, per_cta: int = 1) -> int:
    """Sketch blocks per chunk: as many whole groups of ``per_cta`` blocks
    (the blocks one CTA of the apply holds) as keep the chunk's A_tilde
    under CHUNK_BYTES, at least one group, at most k."""
    fit = CHUNK_BYTES // max(4 * block_size * d, 1)
    return min(max(fit // per_cta, 1) * per_cta, k)


def count_blocks_per_cta(block_size: int) -> int:
    """Blocks one CTA of the count-sketch apply holds at ``block_size``."""
    return KERNEL.host_function("sketch_gram_blocks_per_cta",
                                [ctypes.c_int])(int(block_size))


def sketch_gram_count(h: torch.Tensor, sigma: torch.Tensor, a: torch.Tensor,
                      block_size: int, survivors: torch.Tensor) -> torch.Tensor:
    """(K, n) int32, (K, n) float32, (n, d) float32, (K,) bool -> (d, d)."""
    if on_cpu(h, sigma, a, survivors):
        return ref.sketch_gram_count(h, sigma, a, block_size, survivors)
    k, n = h.shape
    d = a.shape[1]
    b = int(block_size)
    check_cuda("sketch_gram_count", h=(h, torch.int32, (k, n)),
               sigma=(sigma, torch.float32, (k, n)),
               a=(a, torch.float32, (n, d)),
               survivors=(survivors, torch.bool, (k,)))
    chunk = chunk_blocks(k, b, d, count_blocks_per_cta(b))
    mask = survivors.to(torch.float32)
    g = torch.empty((d, d), dtype=torch.float32, device=a.device)
    scratch = torch.empty((chunk, b, d), dtype=torch.float32, device=a.device)
    KERNEL.launch(h.data_ptr(), sigma.data_ptr(), a.data_ptr(), mask.data_ptr(),
                  g.data_ptr(), scratch.data_ptr(), k, n, d, b, chunk,
                  stream(a))
    return g


def sketch_gram_sjlt(h: torch.Tensor, sigma: torch.Tensor, a: torch.Tensor,
                     block_size: int, survivors: torch.Tensor) -> torch.Tensor:
    """(K, s, n) int32, (K, s, n) float32, (n, d) float32, (K,) bool ->
    (d, d): s signed segment-sum layers per block, scaled by 1/sqrt(s)."""
    if on_cpu(h, sigma, a, survivors):
        return ref.sketch_gram_sjlt(h, sigma, a, block_size, survivors)
    k, s, n = h.shape
    d = a.shape[1]
    b = int(block_size)
    check_cuda("sketch_gram_sjlt", h=(h, torch.int32, (k, s, n)),
               sigma=(sigma, torch.float32, (k, s, n)),
               a=(a, torch.float32, (n, d)),
               survivors=(survivors, torch.bool, (k,)))
    per_cta = SJLT_KERNEL.host_function(
        "sketch_gram_sjlt_blocks_per_cta", [ctypes.c_int] * 2)(b, s)
    chunk = chunk_blocks(k, b, d, per_cta)
    mask = survivors.to(torch.float32)
    g = torch.empty((d, d), dtype=torch.float32, device=a.device)
    scratch = torch.empty((chunk, b, d), dtype=torch.float32, device=a.device)
    SJLT_KERNEL.launch(h.data_ptr(), sigma.data_ptr(), a.data_ptr(),
                       mask.data_ptr(), g.data_ptr(), scratch.data_ptr(), k,
                       s, n, d, b, chunk, 1.0 / math.sqrt(s), stream(a))
    return g


def sketch_gram_srht(rows: torch.Tensor, sigma: torch.Tensor, a: torch.Tensor,
                     survivors: torch.Tensor) -> torch.Tensor:
    """(K, b) int32 sampled Hadamard rows in [0, n_pad), (K, n) float32
    signs, (n, d) float32, (K,) bool -> (d, d)."""
    if on_cpu(rows, sigma, a, survivors):
        return ref.sketch_gram_srht(rows, sigma, a, survivors)
    k, b = rows.shape
    n, d = a.shape
    check_cuda("sketch_gram_srht", rows=(rows, torch.int32, (k, b)),
               sigma=(sigma, torch.float32, (k, n)),
               a=(a, torch.float32, (n, d)),
               survivors=(survivors, torch.bool, (k,)))
    chunk = chunk_blocks(k, b, d)
    mask = survivors.to(torch.float32)
    g = torch.empty((d, d), dtype=torch.float32, device=a.device)
    scratch = torch.empty((chunk, b, d), dtype=torch.float32, device=a.device)
    SRHT_KERNEL.launch(rows.data_ptr(), sigma.data_ptr(), a.data_ptr(),
                       mask.data_ptr(), g.data_ptr(), scratch.data_ptr(), k, n,
                       d, b, chunk, stream(a))
    return g
