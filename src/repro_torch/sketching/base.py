"""SketchFamily protocol: the pluggable block-structured sketch axis; port
of ``repro/sketching/base.py``.

A family's blocks ``S_i in R^{n x b}`` are independent with
``E[S_i S_i^T] = I``, so any surviving subset gives an unbiased masked
Gram and Alg. 2's "wait for any N of N+e" semantics hold for every
family:

  sample(key, num_rows, device) -> state   the family's sketch draw
  apply(state, a)          -> (total_blocks, b, d) per-block S_i^T A
  gram(state, a, survivors) -> (d, d) masked, rescaled Gram
  gram_fused(state, a, survivors) -> (d, d) or None: the family's fused
      sketch -> Gram kernel (A_tilde a chunk at a time), if it has one
  fused_path(d)            -> "fused" | "unfused": which path
      ``gram(use_kernels=True)`` takes.  The port's fused kernels have one
      form for every d, so it never reports the reference's "fused_tiled"
  block_flops / comm_units  per-worker cost for the fleet clock

The oversketch, sjlt and srht families have a fused Gram.  The gaussian,
nystrom and leverage families have none, as in the reference: on the
kernel path ``gram`` forms A_tilde with their ``apply`` and takes the
masked-Gram kernel ``oversketch_gram``, and ``fused_path`` says
"unfused".
"""
from __future__ import annotations

import abc
import dataclasses
from typing import Any, Optional

import torch

import repro_torch.core.sketch as core_sketch
from repro_torch.core.sketch import OverSketchConfig

SketchState = Any


@dataclasses.dataclass(frozen=True)
class SketchFamily(abc.ABC):
    """A configured block-structured sketch family; ``cfg`` carries the
    shared dimension accounting (m = N*b, b, zeta => N+e blocks)."""

    cfg: OverSketchConfig

    name = "abstract"

    # Families with a fused sketch -> Gram kernel set this True and
    # override gram_fused.
    has_fused_gram = False

    @abc.abstractmethod
    def sample(self, key: torch.Tensor, num_rows: int,
               device=None) -> SketchState:
        """Draw all N+e blocks (fresh per Newton iteration) on ``device``
        (the CUDA device when none is given)."""

    @abc.abstractmethod
    def apply(self, state: SketchState, a: torch.Tensor,
              use_kernels: bool = False) -> torch.Tensor:
        """A (n, d) -> (total_blocks, b, d), unscaled by 1/sqrt(N)."""

    def gram_fused(self, state: SketchState, a: torch.Tensor,
                   survivors: torch.Tensor) -> Optional[torch.Tensor]:
        """The fused sketch -> Gram kernel, or None when the family has
        none and ``gram`` takes the apply + Gram kernels."""
        return None

    def fused_path(self, d: int) -> str:
        return "fused" if self.has_fused_gram else "unfused"

    def gram(self, state: SketchState, a: torch.Tensor,
             survivors: Optional[torch.Tensor] = None,
             use_kernels: bool = False) -> torch.Tensor:
        """Masked H_hat = (1/N_avail) sum_i A_tilde_i^T A_tilde_i; on the
        kernel path the fused kernel when the family has one."""
        if use_kernels:
            if survivors is None:
                survivors = torch.ones(self.cfg.total_blocks,
                                       dtype=torch.bool, device=a.device)
            fused = self.gram_fused(state, a, survivors)
            if fused is not None:
                return fused
            a_t = self.apply(state, a, use_kernels=True)
            return core_sketch.sketched_gram(a_t, survivors, use_kernels=True)
        return core_sketch.sketched_gram(self.apply(state, a), survivors)

    # Fleet-clock cost hooks: per-worker flops and master-I/O units for one
    # sketch-block worker (Alg. 2 step 3).  The default charges the Gram
    # tile only: the OverSketch family folds sketching into the coded
    # matmul workers; families whose apply is a pass of its own override
    # ``apply_flops``.
    def apply_flops(self, num_rows: int, d: int) -> float:
        return 0.0

    def block_flops(self, num_rows: int, d: int) -> float:
        b = self.cfg.block_size
        return 2.0 * b * min(d, b) ** 2 + self.apply_flops(num_rows, d)

    def comm_units(self, d: int) -> float:
        return 0.05


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (Hadamard sizes)."""
    return 1 << max(0, (n - 1).bit_length())
