"""jax.random.normal's float32 draws in one kernel launch.

CUDA kernel: ``csrc/normal.cu``, bit for bit ``prng.normal_plain``.  A
kernel of the port alone: it replaces no Pallas kernel (the reference
draws with XLA).  ``normal`` is the port's entry point for normal draws:
on a CUDA device it launches the kernel, where the plain version's
threefry on int64 tensors would take tens of seconds per Newton iteration
of the gaussian sketch family at full width; on the CPU it takes the plain
version; any other device raises.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from repro_torch import prng, resolve_device
from repro_torch.kernels._build import CudaKernel
from repro_torch.kernels._check import stream

KERNEL = CudaKernel(
    "normal", "normal.cu", "normal_launch",
    [ctypes.c_uint32] * 2 + [ctypes.c_void_p] * 2 + [ctypes.c_longlong,
                                                     ctypes.c_void_p],
    replaces="none: port-only, jax.random.normal's bits "
             "(src/repro/sketching/gaussian.py:44)")


def constants() -> np.ndarray:
    """prng's float32 constants in ``csrc/normal.cu``'s ``Consts`` order."""
    lo = np.float32(prng.NORMAL_LO)
    return np.array(
        [*prng._LOG_P, prng._LOG_Q1, prng._LOG_Q2, prng._SQRT_HALF,
         prng._MIN_NORMAL, prng._LOG1P_SMALL, *prng._LOG1P_NUM,
         *prng._LOG1P_DEN, *prng._ERFINV_W_LT5, *prng._ERFINV_W_GE5,
         lo, np.float32(1.0) - lo, prng.SQRT2], dtype=np.float32)


def normal(key: torch.Tensor, shape: prng.Shape = (),
           device=None) -> torch.Tensor:
    """float32 standard normal draws (``jax.random.normal``) of ``shape`` on
    ``device`` (the CUDA device when none is given): the kernel on a CUDA
    device, ``prng.normal_plain`` on the CPU."""
    device = resolve_device(device)
    if device.type == "cpu":
        return prng.normal_plain(key, shape, device)
    if device.type != "cuda":
        raise ValueError(f"normal: device must be the CPU or a CUDA device, "
                         f"got {device}")
    shape = prng._shape(shape)
    consts = constants()
    n_consts = KERNEL.host_function("normal_consts_count", [])()
    if n_consts != consts.size:
        raise RuntimeError(f"normal: csrc/normal.cu takes {n_consts} "
                           f"constants, prng.py gives {consts.size}")
    out = torch.empty(shape, dtype=torch.float32, device=device)
    k0, k1 = prng._words(key)
    dev_consts = torch.from_numpy(consts).to(device)
    KERNEL.launch(k0, k1, dev_consts.data_ptr(), out.data_ptr(),
                  math.prod(shape), stream(out))
    return out
