"""jax.random's integer, sign, uniform and coin draws in one kernel launch.

CUDA kernel: ``csrc/draw.cu`` (the hash in ``csrc/threefry.cuh``), bit for
bit ``prng.randint``, ``rademacher``, ``uniform`` and ``bernoulli``.  A
kernel of the port alone: it replaces no Pallas kernel (the reference
draws with XLA).  These are the port's entry points for those draws: on a
CUDA device each launches the kernel once for the whole output, where the
plain version's threefry on int64 tensors takes ~130 elementwise launches
per 2^24 draws; on the CPU each takes the plain version; any other device
raises.  ``gumbel`` and ``categorical`` (the softmax dataset's labels)
draw their uniform the same way and transform it with ``prng``'s float32
steps.  ``bits`` draws the raw 32-bit words from any first counter, so
that the kernel's counters past 2^32 can be held against ``prng._bits``.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch import prng, resolve_device
from repro_torch.kernels._build import CudaKernel
from repro_torch.kernels._check import stream

KERNEL = CudaKernel(
    "draw", "draw.cu", "draw_launch",
    [ctypes.c_int] + [ctypes.c_uint32] * 6
    + [ctypes.c_ulonglong, ctypes.c_uint32, ctypes.c_float, ctypes.c_float,
       ctypes.c_void_p, ctypes.c_longlong, ctypes.c_ulonglong,
       ctypes.c_void_p],
    replaces="none: port-only, jax.random's randint, rademacher, uniform "
             "and bernoulli bits (src/repro/core/sketch.py:99-101)")

# Modes of csrc/draw.cu.
BITS, RANDINT, RADEMACHER, UNIFORM, BERNOULLI = range(5)
M64 = (1 << 64) - 1


def _device(op: str, device) -> torch.device:
    device = resolve_device(device)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{op}: device must be the CPU or a CUDA device, "
                         f"got {device}")
    return device


def _launch(mode: int, shape, dtype, device, keys=(), *, span: int = 1,
            mult: int = 0, lo: int = 0, flo=0.0, fscale=0.0,
            start: int = 0) -> torch.Tensor:
    """One launch of the kernel filling a new tensor of ``shape``; keys
    are up to two (k0, k1) word pairs; randint's remainders by ``span``
    take the magic ceil(2^64 / span) mod 2^64."""
    out = torch.empty(shape, dtype=dtype, device=device)
    words = [w for k in keys for w in prng._words(k)]
    words += [0] * (4 - len(words))
    if out.numel():
        KERNEL.launch(mode, *words, span, mult, (M64 // span + 1) & M64,
                      lo & prng.M32, float(flo), float(fscale),
                      out.data_ptr(), out.numel(), start, stream(out))
    return out


def bits(key: torch.Tensor, start: int, count: int,
         device=None) -> torch.Tensor:
    """The 32-bit words of counters [start, start + count) as int32 (two's
    complement): ``prng._bits``' words."""
    device = _device("bits", device)
    if device.type == "cpu":
        w = prng._bits(key, start, count, device)
        return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)
    return _launch(BITS, (count,), torch.int32, device, (key,), start=start)


def randint(key: torch.Tensor, shape: prng.Shape, minval: int, maxval: int,
            *, device=None) -> torch.Tensor:
    """int32 draws in [minval, maxval) (``jax.random.randint``): the kernel
    on a CUDA device, ``prng.randint`` on the CPU."""
    device = _device("randint", device)
    if device.type == "cpu":
        return prng.randint(key, shape, minval, maxval, device=device)
    lo, span, mult = prng._randint_params(minval, maxval)
    return _launch(RANDINT, prng._shape(shape), torch.int32, device,
                   tuple(prng.split(key)), span=span, mult=mult, lo=lo)


def rademacher(key: torch.Tensor, shape: prng.Shape = (), *,
               dtype=torch.float32, device=None) -> torch.Tensor:
    """+-1 draws (``jax.random.rademacher``): the kernel on a CUDA device
    (float32 only), ``prng.rademacher`` on the CPU."""
    device = _device("rademacher", device)
    if device.type == "cpu":
        return prng.rademacher(key, shape, dtype=dtype, device=device)
    if dtype != torch.float32:
        raise TypeError(f"rademacher: the kernel draws float32, got {dtype}")
    return _launch(RADEMACHER, prng._shape(shape), torch.float32, device,
                   (key,))


def uniform(key: torch.Tensor, shape: prng.Shape = (), minval: float = 0.0,
            maxval: float = 1.0, *, device=None) -> torch.Tensor:
    """float32 uniform on [minval, maxval) (``jax.random.uniform``): the
    kernel on a CUDA device, ``prng.uniform`` on the CPU."""
    device = _device("uniform", device)
    if device.type == "cpu":
        return prng.uniform(key, shape, minval, maxval, device=device)
    lo, scale = prng._uniform_params(minval, maxval)
    return _launch(UNIFORM, prng._shape(shape), torch.float32, device,
                   (key,), flo=lo, fscale=scale)


def bernoulli(key: torch.Tensor, p: float = 0.5, shape: prng.Shape = (), *,
              device=None) -> torch.Tensor:
    """bool draws with P[True] = p (``jax.random.bernoulli``): the kernel
    on a CUDA device, ``prng.bernoulli`` on the CPU."""
    device = _device("bernoulli", device)
    if device.type == "cpu":
        return prng.bernoulli(key, p, shape, device=device)
    return _launch(BERNOULLI, prng._shape(shape), torch.bool, device, (key,),
                   flo=np.float32(p))


def gumbel(key: torch.Tensor, shape: prng.Shape = (), *,
           device=None) -> torch.Tensor:
    """float32 Gumbel draws (``jax.random.gumbel``, its default mode): the
    kernel's uniform on [tiny, 1) through ``prng.gumbel_of_uniform`` on a
    CUDA device, ``prng.gumbel`` on the CPU."""
    device = _device("gumbel", device)
    if device.type == "cpu":
        return prng.gumbel(key, shape, device=device)
    return prng.gumbel_of_uniform(uniform(key, shape, prng.GUMBEL_MINVAL,
                                          1.0, device=device))


def categorical(key: torch.Tensor, logits: torch.Tensor, axis: int = -1,
                shape=None) -> torch.Tensor:
    """int32 categorical draws (``jax.random.categorical``, replace=True)
    on the logits' device: ``gumbel``'s draws plus the logits, argmax
    along ``axis``; ``prng.categorical`` on the CPU."""
    if logits.device.type == "cpu":
        return prng.categorical(key, logits, axis, shape)
    draw, axis, lead = prng.categorical_shapes(tuple(logits.shape), axis,
                                               shape)
    return prng.categorical_of_gumbel(gumbel(key, draw, device=logits.device),
                                      logits, axis, lead)
