"""Argument checks shared by the kernel wrappers."""
from __future__ import annotations

from typing import Tuple

import torch


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU: the plain version runs."""
    return all(t.device.type == "cpu" for t in tensors)


def check_cuda(op: str, **args: Tuple[torch.Tensor, torch.dtype, tuple]) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor of the given
    dtype and shape, all on one device."""
    for name, (t, dtype, shape) in args.items():
        if t.dtype != dtype:
            raise TypeError(f"{op}: {name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{op}: {name} must have shape {tuple(shape)}, "
                             f"got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{op}: {name} must be contiguous")
    devices = {t.device for t, _, _ in args.values()}
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"{op}: tensors must all lie on one CUDA device, got "
                         f"{sorted(str(d) for d in devices)}")


def stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
