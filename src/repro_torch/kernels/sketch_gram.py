"""Fused sketch -> survivor-masked Gram, one kernel per sketch family.

CUDA kernels, replacing the Pallas kernels of
``repro/kernels/sketch_gram.py``:

  sketch_gram_count  ``csrc/sketch_gram.cu``       (sketch_gram_count)
  sketch_gram_sjlt   ``csrc/sketch_gram_sjlt.cu``  (sketch_gram_sjlt)
  sketch_gram_srht   ``csrc/sketch_gram_srht.cu``  (sketch_gram_srht)

Each kernel walks the sketch blocks in chunks whose ``A_tilde`` stays
under ``CHUNK_BYTES`` (the whole ``(K, b, d)`` ``A_tilde`` at the paths'
full width), and a masked block is neither sketched nor read.  Each
chunk is folded into G by the masked Gram of ``oversketch_matmul.py``,
whose scratch ``gram_scratch`` sizes.  CPU tensors take the plain
versions in ``ref.py``; CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import CudaKernel
from repro_torch.kernels._check import check_cuda, on_cpu, stream
from repro_torch.kernels.count_sketch import (GROUPED, apply_plan,
                                              rows_aligned)
from repro_torch.kernels.oversketch_matmul import gram_scratch
from repro_torch.obs.host import TRACER

KERNEL = CudaKernel(
    "sketch_gram_count", "sketch_gram.cu", "sketch_gram_count_launch",
    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [ctypes.c_void_p],
    replaces="src/repro/kernels/sketch_gram.py:275")
SJLT_KERNEL = CudaKernel(
    "sketch_gram_sjlt", "sketch_gram_sjlt.cu", "sketch_gram_sjlt_launch",
    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10 + [ctypes.c_float,
                                                    ctypes.c_void_p],
    replaces="src/repro/kernels/sketch_gram.py:296")
SRHT_KERNEL = CudaKernel(
    "sketch_gram_srht", "sketch_gram_srht.cu", "sketch_gram_srht_launch",
    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
    replaces="src/repro/kernels/sketch_gram.py:318")

# Budget for one chunk's A_tilde: 163 blocks at b = 256, d = 3,000, so all
# 150 of the blocks paths in one chunk (460 MB), and all 10 at b = 4,096.
# On an NVIDIA H100 80GB HBM3 at 700 W (scripts/sweep_sketch_gram_chunk.py,
# K = 150, 30 masked) one chunk of 150 blocks ran the SRHT call in 155.6 ms
# against 163.8-169.1 at 27 blocks (a transform grid per chunk, each with
# its own last wave), and the count-sketch (88.4-89.8 against 88.3-99.4)
# and SJLT (337.3-338.8 against 338.2-341.8) calls no slower; chunks of 6
# or 12 blocks, whose A_tilde fits in L2, were ~20% slower for the count
# sketch.
CHUNK_BYTES = 480 << 20


def chunk_blocks(k: int, block_size: int, d: int) -> int:
    """Sketch blocks per chunk: as many as keep the chunk's A_tilde under
    CHUNK_BYTES, at least one, at most k."""
    return min(max(CHUNK_BYTES // max(4 * block_size * d, 1), 1), k)


def _sketch_gram(kernel: CudaKernel, h: torch.Tensor, sigma: torch.Tensor,
                 a: torch.Tensor, block_size: int, survivors: torch.Tensor,
                 s: int) -> torch.Tensor:
    k, n = h.shape[0], h.shape[-1]
    d = a.shape[1]
    b = int(block_size)
    chunk = chunk_blocks(k, b, d)
    plan = apply_plan(k, s, n, b, rows_aligned(a))
    mask = survivors.to(torch.float32)
    g = torch.empty((d, d), dtype=torch.float32, device=a.device)
    scratch = torch.empty((chunk, b, d), dtype=torch.float32, device=a.device)
    iscratch = torch.empty(plan.scratch_ints, dtype=torch.int32,
                           device=a.device)
    slices, gscratch = gram_scratch(chunk, b, d, a.device)
    # The SJLT entry takes the layer count and the scale; the count
    # sketch's has neither.
    layered = kernel is SJLT_KERNEL
    layers = (s,) if layered else ()
    scale = (1.0 / math.sqrt(s),) if layered else ()
    kernel.launch(h.data_ptr(), sigma.data_ptr(), a.data_ptr(),
                  mask.data_ptr(), g.data_ptr(), scratch.data_ptr(),
                  iscratch.data_ptr(), gscratch.data_ptr(), k, *layers, n, d,
                  b, chunk, slices, plan.sort_chunks, plan.width, plan.group,
                  *scale, stream(a))
    if plan.group > 1:
        GROUPED.launches += -(-k // chunk)
    # The gather's group, on the innermost open host span: the
    # ``sketch_gram`` span of ``core.newton._hessian_phase``.
    TRACER.annotate(group=plan.group)
    return g


def sketch_gram_count(h: torch.Tensor, sigma: torch.Tensor, a: torch.Tensor,
                      block_size: int, survivors: torch.Tensor) -> torch.Tensor:
    """(K, n) int32, (K, n) float32, (n, d) float32, (K,) bool -> (d, d)."""
    if on_cpu(h, sigma, a, survivors):
        return ref.sketch_gram_count(h, sigma, a, block_size, survivors)
    k, n = h.shape
    d = a.shape[1]
    check_cuda("sketch_gram_count", h=(h, torch.int32, (k, n)),
               sigma=(sigma, torch.float32, (k, n)),
               a=(a, torch.float32, (n, d)),
               survivors=(survivors, torch.bool, (k,)))
    return _sketch_gram(KERNEL, h, sigma, a, block_size, survivors, 1)


def sketch_gram_sjlt(h: torch.Tensor, sigma: torch.Tensor, a: torch.Tensor,
                     block_size: int, survivors: torch.Tensor) -> torch.Tensor:
    """(K, s, n) int32, (K, s, n) float32, (n, d) float32, (K,) bool ->
    (d, d): s signed segment-sum layers per block, scaled by 1/sqrt(s)."""
    if on_cpu(h, sigma, a, survivors):
        return ref.sketch_gram_sjlt(h, sigma, a, block_size, survivors)
    k, s, n = h.shape
    d = a.shape[1]
    check_cuda("sketch_gram_sjlt", h=(h, torch.int32, (k, s, n)),
               sigma=(sigma, torch.float32, (k, s, n)),
               a=(a, torch.float32, (n, d)),
               survivors=(survivors, torch.bool, (k,)))
    return _sketch_gram(SJLT_KERNEL, h, sigma, a, block_size, survivors, s)


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
    slices, gscratch = gram_scratch(chunk, b, d, a.device)
    SRHT_KERNEL.launch(rows.data_ptr(), sigma.data_ptr(), a.data_ptr(),
                       mask.data_ptr(), g.data_ptr(), scratch.data_ptr(),
                       gscratch.data_ptr(), k, n, d, b, chunk, slices,
                       stream(a))
    return g
