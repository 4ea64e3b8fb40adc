"""Coded block mat-vec: every worker's (b, s) coded row-block times x, with
the straggler-erasure mask fused (paper Alg. 1 worker compute).

CUDA kernel: ``csrc/coded_matvec.cu``, one launch over the live workers'
blocks that also writes the erased workers' zeros; replaces the Pallas kernel
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
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
    replaces="src/repro/kernels/coded_matvec.py:44")


def coded_block_matvec(enc: torch.Tensor, x: torch.Tensor,
                       erased: torch.Tensor) -> torch.Tensor:
    """(W, b, s) float32, (s,) float32, (W,) bool -> (W, b) float32; an
    erased worker's row is 0 and its block is never read."""
    if on_cpu(enc, x, erased):
        return ref.coded_block_matvec(enc, x, erased)
    w, b, s = enc.shape
    check_cuda("coded_block_matvec", enc=(enc, torch.float32, (w, b, s)),
               x=(x, torch.float32, (s,)), erased=(erased, torch.bool, (w,)))
    out = torch.empty((w, b), dtype=torch.float32, device=enc.device)
    KERNEL.launch(enc.data_ptr(), x.data_ptr(), erased.data_ptr(),
                  out.data_ptr(), w, b, s, stream(enc))
    return out
