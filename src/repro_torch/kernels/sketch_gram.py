"""Fused count-sketch -> survivor-masked Gram.

CUDA kernel: ``csrc/sketch_gram.cu``; replaces the Pallas kernel
``repro/kernels/sketch_gram.py::sketch_gram_count``.  The kernel walks the
sketch blocks in chunks whose ``A_tilde`` stays under ``CHUNK_BYTES``:
the full ``(K, b, d)`` ``A_tilde`` is never formed.  CPU tensors take the plain version in ``ref.py``; CUDA tensors
launch the kernel or raise.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import CudaKernel
from repro_torch.kernels._check import check_cuda, on_cpu, stream

KERNEL = CudaKernel(
    "sketch_gram_count", "sketch_gram.cu", "sketch_gram_count_launch",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    replaces="src/repro/kernels/sketch_gram.py:275")

# Budget for one chunk's A_tilde: 24 blocks at b = 256, d = 3,000.  On an
# H100 (scripts/sweep_sketch_gram_chunk.py) chunks of 24 to 144 blocks run
# the fused call within 5% of each other and ~20% faster than chunks of 6
# or 12, whose A_tilde fits in L2: more apply CTAs per chunk fill the last
# wave better, and the Gram half reads A_tilde from HBM at little cost.
CHUNK_BYTES = 80 << 20


def chunk_blocks(k: int, block_size: int, d: int) -> int:
    """Sketch blocks per chunk of the fused kernel: as many whole CTA
    groups of the apply as keep the chunk's A_tilde under CHUNK_BYTES, at
    least one group, at most k (0: block_size too large for one (b x 32)
    shared-memory tile)."""
    per_cta = KERNEL.host_function("sketch_gram_blocks_per_cta",
                                   [ctypes.c_int])(block_size)
    if per_cta < 1:
        return 0
    fit = CHUNK_BYTES // max(4 * block_size * d, 1)
    return min(max(fit // per_cta, 1) * per_cta, k)


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
    chunk = chunk_blocks(k, int(block_size), d)
    if chunk < 1:
        raise ValueError(f"sketch_gram_count: block_size {block_size} is too "
                         "large for one shared-memory tile")
    mask = survivors.to(torch.float32)
    g = torch.empty((d, d), dtype=torch.float32, device=a.device)
    scratch = torch.empty((chunk, int(block_size), d), dtype=torch.float32,
                          device=a.device)
    KERNEL.launch(h.data_ptr(), sigma.data_ptr(), a.data_ptr(), mask.data_ptr(),
                  g.data_ptr(), scratch.data_ptr(), k, n, d, int(block_size),
                  chunk, stream(a))
    return g
