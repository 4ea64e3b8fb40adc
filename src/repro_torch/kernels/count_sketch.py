"""Count-sketch apply ``A_tilde_k = S_k^T A`` for K blocks, and its layered
form, the SJLT apply.

CUDA kernel: ``csrc/count_sketch.cu``; replaces the Pallas kernel
``repro/kernels/count_sketch.py::count_sketch_apply``.  CPU tensors take
the plain version in ``ref.py``; CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import CudaKernel
from repro_torch.kernels._check import check_cuda, on_cpu, stream

KERNEL = CudaKernel(
    "count_sketch_apply", "count_sketch.cu", "count_sketch_apply_launch",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_float,
                                                  ctypes.c_void_p],
    replaces="src/repro/kernels/count_sketch.py:49")


def count_sketch_apply(h: torch.Tensor, sigma: torch.Tensor, a: torch.Tensor,
                       block_size: int) -> torch.Tensor:
    """(K, n) int32, (K, n) float32, (n, d) float32 -> (K, b, d) float32.

    Given (K, s, n) buckets and signs, the SJLT apply: each block sums its
    s layers and is scaled by 1/sqrt(s), as ``ref.sjlt_apply``; the kernel
    adds the layers into one tile instead of forming K s blocks."""
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
    out = torch.empty((k, block_size, d), dtype=torch.float32, device=a.device)
    KERNEL.launch(h.data_ptr(), sigma.data_ptr(), a.data_ptr(),
                  out.data_ptr(), k, s, n, d, int(block_size),
                  1.0 / math.sqrt(s), stream(a))
    return out
