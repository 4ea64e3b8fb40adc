"""Orthonormal Walsh-Hadamard transform along axis 1 of ``(K, n, d)``.

CUDA kernels: ``csrc/fwht.cu``; replace the Pallas kernels
``repro/kernels/srht.py::fwht`` and ``::fwht_two_pass``.  A shared-memory
butterfly transforms a strip of columns by all n rows in one pass while
``n <= FWHT_MAX_ROWS``; past that, ``fwht`` takes the two-pass form (a
local pass over contiguous chunks, then an across pass, each a butterfly
held in registers with one shared-memory transpose while it has at most
1,024 rows), which ``fwht_two_pass`` forces at any n.  CPU tensors take
the plain butterfly in ``ref.py``; CUDA tensors launch the kernel or
raise.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import CudaKernel
from repro_torch.kernels._check import check_cuda, on_cpu, stream

_ARGS = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
FWHT_KERNEL = CudaKernel("fwht", "fwht.cu", "fwht_launch", _ARGS,
                         replaces="src/repro/kernels/srht.py:172")
TWO_PASS_KERNEL = CudaKernel("fwht_two_pass", "fwht.cu",
                             "fwht_two_pass_launch", _ARGS,
                             replaces="src/repro/kernels/srht.py:121")

# Largest n one shared-memory pass transforms (csrc/fwht.cu, FW_MAX_ROWS).
FWHT_MAX_ROWS = 4096


def _check(op: str, x: torch.Tensor) -> tuple:
    if x.dim() != 3:
        raise ValueError(f"{op}: x must be (K, n, d), got {tuple(x.shape)}")
    k, n, d = x.shape
    if n < 1 or n & (n - 1):
        raise ValueError(f"fwht length {n} must be a power of two")
    if n > FWHT_MAX_ROWS ** 2:
        raise ValueError(f"{op}: length {n} is past two passes of "
                         f"{FWHT_MAX_ROWS} rows")
    check_cuda(op, x=(x, torch.float32, (k, n, d)))
    return k, n, d


def fwht_two_pass(x: torch.Tensor) -> torch.Tensor:
    """The transform as a local and an across pass, at any n."""
    if on_cpu(x):
        return ref.fwht(x)
    k, n, d = _check("fwht_two_pass", x)
    out = torch.empty_like(x)
    TWO_PASS_KERNEL.launch(x.data_ptr(), out.data_ptr(), k, n, d, stream(x))
    return out


def fwht(x: torch.Tensor) -> torch.Tensor:
    """(K, n, d) float32 -> (K, n, d) float32, n a power of two; satisfies
    fwht(fwht(x)) == x.  The one-pass kernel while n <= FWHT_MAX_ROWS, else
    ``fwht_two_pass``: each launch counts once, under the kernel that ran."""
    if on_cpu(x):
        return ref.fwht(x)
    k, n, d = _check("fwht", x)
    if n > FWHT_MAX_ROWS:
        return fwht_two_pass(x)
    out = torch.empty_like(x)
    FWHT_KERNEL.launch(x.data_ptr(), out.data_ptr(), k, n, d, stream(x))
    return out
