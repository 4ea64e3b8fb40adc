"""Dense Gaussian family: blocks of iid N(0, 1/b) entries; port of
``repro/sketching/gaussian.py``.

``S_i in R^{n x b}`` with entries N(0, 1/b) gives ``E[S_i S_i^T] = I``.
The state holds one key per block, not the (n, b) matrices: ``apply``
draws each block anew (``kernels.ops.normal``: on the card, the normal
kernel) and forms ``S_i^T A`` with ``torch.matmul``, as the reference
leaves that product to XLA.  It loops over the blocks, as the reference's ``lax.map``
does, so one (n, b) sketch lives at a time (307 MB at n = 300,000,
b = 256; all 150 blocks at once would be 46 GB).  The Gram of the formed
blocks is the masked-Gram kernel (``oversketch_gram``) on the kernel
path.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import prng, resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.sketching.base import SketchFamily
from repro_torch.sketching.registry import register


@register("gaussian")
@dataclasses.dataclass(frozen=True)
class GaussianFamily(SketchFamily):

    def sample(self, key: torch.Tensor, num_rows: int, device=None) -> dict:
        resolve_device(device)
        return {"keys": prng.split(key, self.cfg.total_blocks)}

    def apply(self, state: dict, a: torch.Tensor,
              use_kernels: bool = False) -> torch.Tensor:
        n, d = a.shape
        b = self.cfg.block_size
        # 1/sqrt(b) rounded as the reference rounds it: the float32 sqrt,
        # then the float32 reciprocal; the draws are multiplied by it.
        inv_sqrt_b = float(np.float32(1.0) / np.sqrt(np.float32(b)))
        keys = state["keys"]
        out = a.new_empty((keys.shape[0], b, d))
        for i in range(keys.shape[0]):
            g = kops.normal(keys[i], (n, b), device=a.device) * inv_sqrt_b
            torch.matmul(g.T, a, out=out[i])
        return out

    def apply_flops(self, num_rows: int, d: int) -> float:
        return 2.0 * num_rows * self.cfg.block_size * d
