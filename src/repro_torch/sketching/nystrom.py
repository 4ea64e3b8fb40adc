"""Nystrom family: uniform row subsampling of hess_sqrt; port of
``repro/sketching/nystrom.py``.

Each block samples b rows of A uniformly with replacement and rescales by
sqrt(n/b): ``S_i^T = sqrt(n/b) P_i``, so ``E[S_i S_i^T] = I``.  The apply
is a gather; the Gram of the gathered blocks is the masked-Gram kernel
(``oversketch_gram``) on the kernel path.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels import ops as kops
from repro_torch.sketching.base import SketchFamily
from repro_torch.sketching.registry import register


@register("nystrom")
@dataclasses.dataclass(frozen=True)
class NystromFamily(SketchFamily):

    def sample(self, key: torch.Tensor, num_rows: int, device=None) -> dict:
        shape = (self.cfg.total_blocks, self.cfg.block_size)
        return {"rows": kops.randint(key, shape, 0, num_rows, device=device)}

    def apply(self, state: dict, a: torch.Tensor,
              use_kernels: bool = False) -> torch.Tensor:
        # sqrt of the float32 n/b, correctly rounded, as the reference.
        scale = float(np.sqrt(np.float32(a.shape[0] / self.cfg.block_size)))
        return a[state["rows"].long()] * scale

    def apply_flops(self, num_rows: int, d: int) -> float:
        return float(self.cfg.block_size * d)
