"""Survivor-masked Gram of a materialized ``A_tilde``.

CUDA kernel: ``csrc/oversketch_gram.cu``; replaces the Pallas kernel
``repro/kernels/oversketch_matmul.py::oversketch_gram``.  CPU tensors take
the plain version in ``ref.py``; CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import CudaKernel
from repro_torch.kernels._check import check_cuda, on_cpu, stream

KERNEL = CudaKernel(
    "oversketch_gram", "oversketch_gram.cu", "oversketch_gram_launch",
    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
    replaces="src/repro/kernels/oversketch_matmul.py:45")


def oversketch_gram(a_tilde: torch.Tensor,
                    survivors: torch.Tensor) -> torch.Tensor:
    """(K, b, d) float32, (K,) bool -> (d, d) float32, divided by
    max(survivor count, 1)."""
    if on_cpu(a_tilde, survivors):
        return ref.oversketch_gram(a_tilde, survivors)
    k, b, d = a_tilde.shape
    check_cuda("oversketch_gram", a_tilde=(a_tilde, torch.float32, (k, b, d)),
               survivors=(survivors, torch.bool, (k,)))
    mask = survivors.to(torch.float32)
    g = torch.empty((d, d), dtype=torch.float32, device=a_tilde.device)
    KERNEL.launch(a_tilde.data_ptr(), mask.data_ptr(), g.data_ptr(), k, b, d,
                  stream(a_tilde))
    return g
