"""Coded block mat-vec: every worker's (b, s) coded row-block times x, with
the straggler-erasure mask fused (paper Alg. 1 worker compute).

CUDA kernel: ``csrc/coded_matvec.cu``; replaces the Pallas kernel
``repro/kernels/coded_matvec.py::coded_block_matvec``.  CPU tensors take
the plain version in ``ref.py``; CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import CudaKernel
from repro_torch.kernels._check import check_cuda, on_cpu, stream

KERNEL = CudaKernel(
    "coded_block_matvec", "coded_matvec.cu", "coded_block_matvec_launch",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    replaces="src/repro/kernels/coded_matvec.py:44")

# Elements of x (and of each block row) one CTA takes: 4 KB of x in shared
# memory; the X^T encode (s = 300,000) splits into 293 tiles per worker.
TILE_S = 1024


def coded_block_matvec(enc: torch.Tensor, x: torch.Tensor,
                       erased: torch.Tensor) -> torch.Tensor:
    """(W, b, s) float32, (s,) float32, (W,) bool -> (W, b) float32; an
    erased worker's row is 0 and its block is never read."""
    if on_cpu(enc, x, erased):
        return ref.coded_block_matvec(enc, x, erased)
    w, b, s = enc.shape
    check_cuda("coded_block_matvec", enc=(enc, torch.float32, (w, b, s)),
               x=(x, torch.float32, (s,)), erased=(erased, torch.bool, (w,)))
    tiles = -(-s // TILE_S)
    partial = torch.empty((w, tiles, b), dtype=torch.float32,
                          device=enc.device)
    out = torch.empty((w, b), dtype=torch.float32, device=enc.device)
    KERNEL.launch(enc.data_ptr(), x.data_ptr(), erased.data_ptr(),
                  partial.data_ptr(), out.data_ptr(), w, b, s, TILE_S,
                  stream(enc))
    return out
