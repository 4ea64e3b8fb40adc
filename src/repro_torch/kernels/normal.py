"""jax.random.normal's float32 draws in one kernel launch.

CUDA kernel: ``csrc/normal.cu``, bit for bit ``prng.normal_plain``.  A
kernel of the port alone: it replaces no Pallas kernel (the reference
draws with XLA).  ``normal`` is the port's entry point for normal draws:
on a CUDA device it launches the kernel, where the plain version's
threefry on int64 tensors would take tens of seconds per Newton iteration
of the gaussian sketch family at full width; on the CPU it takes the plain
version; any other device raises.

A normal draw depends only on the top 23 bits of its 32-bit word
(``prng.normal_of_mantissas``), so the kernel reads each draw from a table
of all 2^23 of them (32 MiB of float32).  ``table`` builds it on a device
at first use, by the kernel's own computed form of the plain version's
float32 steps, in one launch of the table kernel (not counted as a launch
of ``normal``), waits for that launch, and keeps the table for the
process, so that a draw on any stream reads a finished table.

bfloat16 draws depend on 7 bits of the word (``prng.normal_bf16_plain``):
the kernel's bfloat16 mode reads a table of 128 draws, made on the host by
the plain steps and copied to the device once.

``normal_window`` draws a box of a draw of a whole shape, in either dtype,
bit for bit ``prng.normal_window``: each element hashes the counter of its
flat index in the whole shape, so a rank's shard of a sharded leaf is drawn
alone (``models.common.materialize`` with boxes).  Its launches are
counted apart, by ``WINDOW_KERNEL``.
"""
from __future__ import annotations

import ctypes
from typing import Dict

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

WINDOW_KERNEL = CudaKernel(
    "normal_window", "normal.cu", "normal_window_launch",
    [ctypes.c_uint32] * 2 + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 +
    [ctypes.c_void_p] * 4,
    replaces="none: port-only, a box of jax.random.normal's bits: a "
             "rank's shard of jax.jit(init, out_shardings=...) "
             "(src/repro/training/trainer.py:150)")

TABLE_SIZE = 1 << 23     # one draw per 23-bit mantissa
_TABLES: Dict[torch.device, torch.Tensor] = {}
_BF16_TABLES: Dict[torch.device, torch.Tensor] = {}


def constants() -> np.ndarray:
    """prng's float32 constants in ``csrc/normal.cu``'s ``Consts`` order."""
    lo = np.float32(prng.NORMAL_LO)
    return np.array(
        [*prng._LOG_P, prng._LOG_Q1, prng._LOG_Q2, prng._SQRT_HALF,
         prng._MIN_NORMAL, prng._LOG1P_SMALL, *prng._LOG1P_NUM,
         *prng._LOG1P_DEN, *prng._ERFINV_W_LT5, *prng._ERFINV_W_GE5,
         lo, np.float32(1.0) - lo, prng.SQRT2], dtype=np.float32)


def _cuda(device) -> torch.device:
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"normal: the table lives on a CUDA device, got "
                         f"{device}")
    return torch.device("cuda", device.index if device.index is not None
                        else torch.cuda.current_device())


def build_table(device) -> torch.Tensor:
    """A new table on the CUDA ``device``: ``table[m]`` is the normal draw
    of every word whose top 23 bits are m, by the table kernel."""
    device = _cuda(device)
    consts = constants()
    for symbol, want in (("normal_consts_count", consts.size),
                         ("normal_table_size", TABLE_SIZE)):
        got = KERNEL.host_function(symbol, [])()
        if got != want:
            raise RuntimeError(f"normal: csrc/normal.cu's {symbol} is {got}, "
                               f"kernels/normal.py's {want}")
    dev_consts = torch.from_numpy(consts).to(device)
    out = torch.empty(TABLE_SIZE, dtype=torch.float32, device=device)
    err = KERNEL.host_function("normal_table_launch", [ctypes.c_void_p] * 3)(
        dev_consts.data_ptr(), out.data_ptr(), stream(out))
    if err != 0:
        raise RuntimeError(f"normal: the table kernel failed with CUDA "
                           f"error {err}")
    return out


def table(device) -> torch.Tensor:
    """The device's table, built at first use on the current stream, which
    is then synchronized once: later draws on other streams need no event."""
    device = _cuda(device)
    if device not in _TABLES:
        built = build_table(device)
        torch.cuda.current_stream(device).synchronize()
        _TABLES[device] = built
    return _TABLES[device]


def table_plain(device) -> torch.Tensor:
    """The table by the plain version's steps, on any device."""
    m = torch.arange(TABLE_SIZE, dtype=torch.int32, device=device)
    return prng.normal_of_mantissas(m)


def bf16_table(device) -> torch.Tensor:
    """The 128 bfloat16 draws (``prng.normal_bf16_table``) on ``device``,
    kept for the process."""
    device = _cuda(device)
    if device not in _BF16_TABLES:
        _BF16_TABLES[device] = prng.normal_bf16_table().to(device)
    return _BF16_TABLES[device]


def normal(key: torch.Tensor, shape: prng.Shape = (), device=None,
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Standard normal draws (``jax.random.normal``) of ``shape`` and
    ``dtype`` (float32 or bfloat16) on ``device`` (the CUDA device when none
    is given): the kernel on a CUDA device, ``prng.normal_plain`` or
    ``prng.normal_bf16_plain`` on the CPU."""
    device = resolve_device(device)
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"normal: dtype must be float32 or bfloat16, got "
                         f"{dtype}")
    bf16 = dtype == torch.bfloat16
    if device.type == "cpu":
        return (prng.normal_bf16_plain if bf16 else prng.normal_plain)(
            key, shape, device)
    if device.type != "cuda":
        raise ValueError(f"normal: device must be the CPU or a CUDA device, "
                         f"got {device}")
    out = torch.empty(prng._shape(shape), dtype=dtype, device=device)
    if out.numel():
        k0, k1 = prng._words(key)
        tab = bf16_table(device) if bf16 else table(device)
        KERNEL.launch(k0, k1, tab.data_ptr(), out.data_ptr(), out.numel(),
                      stream(out), symbol="normal_bf16_launch" if bf16
                      else "")
    return out


def normal_window(key: torch.Tensor, shape: prng.Shape, box: prng.Box,
                  device=None, dtype: torch.dtype = torch.float32
                  ) -> torch.Tensor:
    """The box ((start, size) a dim) of the standard normal draw of
    ``shape`` and ``dtype`` (float32 or bfloat16) from ``key``, alone, on
    ``device`` (the CUDA device when none is given): the kernel's window
    mode on a CUDA device, ``prng.normal_window`` on the CPU."""
    device = resolve_device(device)
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"normal_window: dtype must be float32 or "
                         f"bfloat16, got {dtype}")
    if device.type == "cpu":
        return prng.normal_window(key, shape, box, dtype, device)
    if device.type != "cuda":
        raise ValueError(f"normal_window: device must be the CPU or a CUDA "
                         f"device, got {device}")
    shape = prng._shape(shape)
    box = prng.check_box(shape, box)
    out = torch.empty(tuple(n for _, n in box), dtype=dtype, device=device)
    if out.numel():
        rank = max(len(shape), 1)
        most = WINDOW_KERNEL.host_function("normal_window_max_rank", [])()
        if rank > most:
            raise ValueError(f"normal_window: rank {rank} past the "
                             f"kernel's {most}")
        dims = np.array([shape or (1,), [s for s, _ in box] or [0],
                         [n for _, n in box] or [1]], dtype=np.int64)
        k0, k1 = prng._words(key)
        bf16 = dtype == torch.bfloat16
        tab = bf16_table(device) if bf16 else table(device)
        WINDOW_KERNEL.launch(k0, k1, tab.data_ptr(), out.data_ptr(),
                             int(bf16), rank, dims[0].ctypes.data,
                             dims[1].ctypes.data, dims[2].ctypes.data,
                             stream(out))
    return out
