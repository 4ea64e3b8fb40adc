"""Survivor-masked Gram of a materialized ``A_tilde``.

CUDA kernel: ``csrc/oversketch_gram.cu`` (device code in
``csrc/sketch_common.cuh``, which the fused kernels share); replaces the
Pallas kernel ``repro/kernels/oversketch_matmul.py::oversketch_gram``.
CPU tensors take the plain version in ``ref.py``; CUDA tensors launch the
kernel or raise.

The kernel cuts the live rows into slices so that (upper-triangle tile,
slice) work items fill whole waves of the CTAs the card holds, then sums
each tile's partials in a fixed order.  ``gram_slices`` picks the slices
from the SM count read at run time; ``gram_scratch`` allocates the
partials.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import CudaKernel
from repro_torch.kernels._check import check_cuda, on_cpu, stream

KERNEL = CudaKernel(
    "oversketch_gram", "oversketch_gram.cu", "oversketch_gram_launch",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    replaces="src/repro/kernels/oversketch_matmul.py:45")

# sketch::gram_kernel's output tile edge, and the CTAs an SM holds
# (__launch_bounds__(256, 2), 96 KB of shared memory each).
GRAM_TILE = 128
GRAM_CTAS_PER_SM = 2
# A slice takes at least this many rows (a partial tile is 64 KB written
# and read once), and the slices stop growing once the work items fill
# this share of their last wave.  On an NVIDIA H100 80GB HBM3 at 700 W
# (scripts/time_sketch_kernels.py) the nystrom-shaped Gram (300 tiles)
# ran in 7.5 ms at 6 slices (97% of 7 waves) against 8.1 at 4 (91% of 5);
# the reduce of the partials took under 1% of either.
GRAM_MIN_SLICE_ROWS = 256
GRAM_WAVE_FILL = 0.97


def gram_tiles(d: int) -> int:
    """Upper-triangle output tiles of a (d, d) Gram."""
    t = -(-d // GRAM_TILE)
    return t * (t + 1) // 2


def gram_slices(rows: int, d: int, sms: int) -> int:
    """Slices of at most ``rows`` live rows for a (d, d) Gram on a card of
    ``sms`` SMs: the fewest whose tiles x slices fill the last wave to
    GRAM_WAVE_FILL, else the best fill; at least GRAM_MIN_SLICE_ROWS rows a
    slice."""
    tiles = gram_tiles(d)
    resident = GRAM_CTAS_PER_SM * sms
    most = max(1, min(rows // GRAM_MIN_SLICE_ROWS, resident))
    best, best_fill = 1, 0.0
    for s in range(1, most + 1):
        items = tiles * s
        fill = items / (-(-items // resident) * resident)
        if fill >= GRAM_WAVE_FILL:
            return s
        if fill > best_fill:
            best, best_fill = s, fill
    return best


def gram_scratch(blocks: int, block_size: int, d: int,
                 device: torch.device) -> Tuple[int, torch.Tensor]:
    """(slices, scratch) for the Gram of ``blocks`` blocks of
    ``block_size`` rows: the partial tiles (slices, tiles, 128, 128), the
    survivor count and the live-block list (blocks + 1 ints)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    slices = gram_slices(blocks * block_size, d, sms)
    floats = slices * gram_tiles(d) * GRAM_TILE ** 2 + blocks + 2
    return slices, torch.empty(floats, dtype=torch.float32, device=device)


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
    slices, scratch = gram_scratch(k, b, d, a_tilde.device)
    KERNEL.launch(a_tilde.data_ptr(), mask.data_ptr(), g.data_ptr(),
                  scratch.data_ptr(), k, b, d, slices, stream(a_tilde))
    return g
