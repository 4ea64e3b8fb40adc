"""SJLT family: the sparse Johnson-Lindenstrauss transform (blocked OSNAP);
port of ``repro/sketching/sjlt.py``.

Each block S_i has s nonzeros of value +-1/sqrt(s) per row of A (count
sketch is s = 1), applied as s signed segment-sums; two layers of one row
that land in one bucket add, and E[S_i S_i^T] = I still holds.  The kernel
path takes the fused SJLT -> Gram kernel; its apply is the count-sketch
kernel in its layered form, which adds the s layers of a block into one
tile (the reference flattens them into K s blocks and sums those: the same
sums in another order).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import prng, resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.sketching.base import SketchFamily
from repro_torch.sketching.registry import register


@register("sjlt")
@dataclasses.dataclass(frozen=True)
class SJLTFamily(SketchFamily):

    nnz_per_row: int = 4
    has_fused_gram = True

    def sample(self, key: torch.Tensor, num_rows: int, device=None) -> dict:
        device = resolve_device(device)
        kh, ks = prng.split(key)
        shape = (self.cfg.total_blocks, self.nnz_per_row, num_rows)
        return {"h": kops.randint(kh, shape, 0, self.cfg.block_size,
                                  device=device),
                "sigma": kops.rademacher(ks, shape, device=device)}

    def apply(self, state: dict, a: torch.Tensor,
              use_kernels: bool = False) -> torch.Tensor:
        apply = kops.count_sketch_apply if use_kernels else kref.sjlt_apply
        return apply(state["h"], state["sigma"], a, self.cfg.block_size)

    def gram_fused(self, state: dict, a: torch.Tensor,
                   survivors: torch.Tensor) -> torch.Tensor:
        return kops.sketch_gram_sjlt(state["h"], state["sigma"], a,
                                     self.cfg.block_size, survivors)

    def apply_flops(self, num_rows: int, d: int) -> float:
        return 2.0 * self.nnz_per_row * num_rows * d
