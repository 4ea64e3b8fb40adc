"""Marchenko-Pastur debiasing of the sketched Newton direction; port of
``repro/sketching/debias.py``.

For an m-row sketch of a rank-d Gram the sketched direction
p_hat = -H_hat^{-1} g is too long in expectation by 1/(1 - d/m) under
Marchenko-Pastur asymptotics, for any of the rotationally mixed families
(Romanov, Zhang & Pilanci 2024, Thm 3.1).  Rescaling by gamma = 1 - d/m
makes it asymptotically unbiased; m is the surviving sketch dimension, so
the correction follows whichever k-of-n subset arrived.  In float32, as
the reference computes it.
"""
from __future__ import annotations

import math

import torch

# Below this survivor-dim margin the correction extrapolates far outside
# its m > d regime; the clamp keeps a bad straggler round from flipping or
# zeroing the direction.
MIN_FACTOR = 0.05


def mp_factor(dim: int, sketch_rows) -> torch.Tensor:
    """Debias factor gamma = max(1 - d/m, MIN_FACTOR), a float32 scalar."""
    m = torch.as_tensor(sketch_rows, dtype=torch.float32).clamp_min(1.0)
    return (1.0 - float(dim) / m).clamp_min(MIN_FACTOR)


def debias_direction(p: torch.Tensor, dim: int, sketch_rows) -> torch.Tensor:
    """Rescale a sketched Newton direction to be asymptotically unbiased."""
    return p * mp_factor(dim, sketch_rows).to(p.dtype)


def mp_stalled(dim: int, sketch_rows, target: float) -> bool:
    """Is the sketch too biased to trust at this survivor dimension
    (gamma below ``target``)?"""
    return bool(mp_factor(dim, sketch_rows) < target)


def rows_for_target(dim: int, target: float) -> int:
    """Smallest sketch-row count whose MP factor meets ``target``."""
    if not 0.0 < target < 1.0:
        raise ValueError(f"target must be in (0, 1), got {target}")
    return int(math.ceil(dim / (1.0 - target)))
