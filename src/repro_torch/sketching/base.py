"""SketchFamily protocol: the pluggable block-structured sketch axis; port
of ``repro/sketching/base.py``.

A family's blocks ``S_i in R^{n x b}`` are independent with
``E[S_i S_i^T] = I``, so any surviving subset gives an unbiased masked
Gram and Alg. 2's "wait for any N of N+e" semantics hold for every
family:

  sample(key, num_rows, device) -> state   the family's sketch draw
  apply(state, a)          -> (total_blocks, b, d) per-block S_i^T A
  gram(state, a, survivors) -> (d, d) masked, rescaled Gram
  block_flops / comm_units  per-worker cost for the fleet clock

The reference's ``gram_fused`` hook, which returns None for families
without a fused kernel, is not ported: the one ported family always
fuses, inside its own ``gram``.
"""
from __future__ import annotations

import abc
import dataclasses
from typing import Any, Optional

import torch

from repro_torch.core.sketch import OverSketchConfig

SketchState = Any


@dataclasses.dataclass(frozen=True)
class SketchFamily(abc.ABC):
    """A configured block-structured sketch family; ``cfg`` carries the
    shared dimension accounting (m = N*b, b, zeta => N+e blocks)."""

    cfg: OverSketchConfig

    name = "abstract"

    @abc.abstractmethod
    def sample(self, key: torch.Tensor, num_rows: int,
               device=None) -> SketchState:
        """Draw all N+e blocks (fresh per Newton iteration) on ``device``
        (the CUDA device when none is given)."""

    @abc.abstractmethod
    def apply(self, state: SketchState, a: torch.Tensor,
              use_kernels: bool = False) -> torch.Tensor:
        """A (n, d) -> (total_blocks, b, d), unscaled by 1/sqrt(N)."""

    @abc.abstractmethod
    def gram(self, state: SketchState, a: torch.Tensor,
             survivors: Optional[torch.Tensor] = None,
             use_kernels: bool = False) -> torch.Tensor:
        """Masked H_hat = (1/N_avail) sum_i A_tilde_i^T A_tilde_i."""

    # Fleet-clock cost hooks: per-worker flops and master-I/O units for one
    # sketch-block worker (Alg. 2 step 3).  Sketching is folded into the
    # coded matmul workers, so a block worker pays its Gram tile only.
    def apply_flops(self, num_rows: int, d: int) -> float:
        return 0.0

    def block_flops(self, num_rows: int, d: int) -> float:
        b = self.cfg.block_size
        return 2.0 * b * min(d, b) ** 2 + self.apply_flops(num_rows, d)

    def comm_units(self, d: int) -> float:
        return 0.05
