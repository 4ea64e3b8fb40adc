"""What the problem generators share: the seeds of a run's purposes, the
data's ``torch.Generator``, and the fingerprint of the inputs.  Each
objective's generator (``objectives/<objective>.py``: ``generate``) draws
its problem in plain PyTorch on the device from the run's seed, with the
generator made here, in a few large calls.

The program under test receives only the tensors the generators make.  The
same seed gives the same bytes; the sizes never depend on the seed.
"""
from __future__ import annotations

import hashlib
from typing import Tuple

import torch

ROWS = 1 << 15      # rows a block when a pass over x works in float64


def derive(seed: int, *tags) -> int:
    """A 63-bit seed for one purpose of a run (data, a call, the warm-up)."""
    text = "/".join(str(t) for t in (int(seed),) + tags)
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8],
                          "little") >> 1


def generator(seed: int, device) -> torch.Generator:
    """The generator of a run's data, seeded from ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed(derive(seed, "data"))
    return g


def fingerprint(x: torch.Tensor, y: torch.Tensor) -> Tuple[float, ...]:
    """Float64 sums of the inputs and of their squares: read before the
    window and after it, they show that nothing wrote into the inputs."""
    sums = torch.zeros(4, dtype=torch.float64, device=x.device)
    for i in range(0, x.shape[0], ROWS):
        xb = x[i:i + ROWS].double()
        yb = y[i:i + ROWS].double()
        sums += torch.stack([xb.sum(), (xb * xb).sum(), yb.sum(),
                             (yb * yb).sum()])
    return tuple(sums.tolist())
