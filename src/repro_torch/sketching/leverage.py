"""Leverage-score row sampling; port of ``repro/sketching/leverage.py``.

Each block samples b rows with replacement from ``p_i = l_i / d``, the
exact leverage scores of A (squared row norms of its thin-QR Q factor),
and rescales row i by ``1 / sqrt(b p_i)``, so ``E[S_i S_i^T] = I`` on the
rows with l_i > 0.  The scores depend on A, so the draw happens in
``apply``; the state keeps only the key.  The QR is the library's
(``torch.linalg.qr``), as the reference's is XLA's; the draw is
``prng.choice``, jax's inverse-CDF sampler.  The Gram of the gathered
blocks is the masked-Gram kernel (``oversketch_gram``) on the kernel path.

The port's QR and row sums differ from XLA's in the last bits, so ``p``
does too, and a row whose uniform draw falls within that distance of a
bucket boundary of the prefix sum can be drawn differently: the family
agrees with the reference to a tolerance, not bit for bit
(``tests/test_torch_modules.py`` states the share of rows that agree).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import prng, resolve_device
from repro_torch.sketching.base import SketchFamily
from repro_torch.sketching.registry import register


@register("leverage")
@dataclasses.dataclass(frozen=True)
class LeverageFamily(SketchFamily):

    def sample(self, key: torch.Tensor, num_rows: int, device=None) -> dict:
        resolve_device(device)
        return {"key": key}

    def probabilities(self, a: torch.Tensor) -> torch.Tensor:
        """Row-sampling probabilities: leverage scores over their sum."""
        q, _ = torch.linalg.qr(a, mode="reduced")
        lev = (q * q).sum(dim=1)
        return lev / lev.sum().clamp_min(1e-30)

    def apply(self, state: dict, a: torch.Tensor,
              use_kernels: bool = False) -> torch.Tensor:
        p = self.probabilities(a)
        b = self.cfg.block_size
        rows = prng.choice(state["key"], a.shape[0],
                           (self.cfg.total_blocks, b), p).long()
        scale = 1.0 / torch.sqrt((b * p[rows]).clamp_min(1e-30))
        return a[rows] * scale[..., None]

    def apply_flops(self, num_rows: int, d: int) -> float:
        # Master-side QR amortized over the fleet + the per-block gather.
        qr = 2.0 * num_rows * d * d / max(self.cfg.total_blocks, 1)
        return qr + float(self.cfg.block_size * d)
