"""SRHT family: the blocked subsampled randomized Hadamard transform; port
of ``repro/sketching/srht.py``.

Each block is ``S_i^T = sqrt(n_pad/b) P_i H_norm D_i``: Rademacher signs
D_i, the orthonormal Walsh-Hadamard mix H_norm over n padded to
n_pad = next power of two, and b rows sampled uniformly with replacement
(P_i), so E[S_i S_i^T] = I.  The kernel path's Gram is the fused SRHT ->
Gram kernel; its apply runs the FWHT kernel one block at a time, so the
peak memory is one (n_pad, d) panel and its transform, never (K, n_pad, d).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch import prng, resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.sketching.base import SketchFamily, next_pow2
from repro_torch.sketching.registry import register


@register("srht")
@dataclasses.dataclass(frozen=True)
class SRHTFamily(SketchFamily):

    has_fused_gram = True

    def sample(self, key: torch.Tensor, num_rows: int, device=None) -> dict:
        device = resolve_device(device)
        ks, kp = prng.split(key)
        blocks = self.cfg.total_blocks
        return {"sigma": kops.rademacher(ks, (blocks, num_rows),
                                         device=device),
                "rows": kops.randint(kp, (blocks, self.cfg.block_size), 0,
                                     next_pow2(num_rows), device=device)}

    def apply(self, state: dict, a: torch.Tensor,
              use_kernels: bool = False) -> torch.Tensor:
        n, d = a.shape
        n_pad = next_pow2(n)
        fwht = kops.fwht if use_kernels else kref.fwht
        scale = torch.sqrt(torch.tensor(n_pad / self.cfg.block_size,
                                        dtype=a.dtype))
        sigma, rows = state["sigma"], state["rows"]
        out = a.new_empty((rows.shape[0], self.cfg.block_size, d))
        x = a.new_zeros((1, n_pad, d))
        for i in range(rows.shape[0]):
            torch.mul(a, sigma[i, :, None], out=x[0, :n])
            out[i] = fwht(x)[0][rows[i].long()] * scale
        return out

    def gram_fused(self, state: dict, a: torch.Tensor,
                   survivors: torch.Tensor) -> torch.Tensor:
        return kops.sketch_gram_srht(state["rows"], state["sigma"], a,
                                     survivors)

    def apply_flops(self, num_rows: int, d: int) -> float:
        n_pad = next_pow2(num_rows)
        return float(n_pad * max(1, int(math.log2(n_pad))) * d)
