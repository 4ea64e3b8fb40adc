"""Coded matrix-vector multiplication with a 2-D product code (paper
Alg. 1); port of ``repro/core/coded.py``.

The data matrix's row-blocks sit on a g x g grid extended with a parity
column (row sums), a parity row (column sums) and a corner, giving
(g+1)^2 worker tasks.  Every row and column of the extended grid is a
single-parity-check constraint, so a peeling decoder recovers any erasure
pattern that leaves some line with exactly one missing cell per round.
Encoding happens once; decoding runs ``grid + 1`` vectorized peel rounds.
The worker products go through the coded block mat-vec kernel
(``kernels/coded_matvec.py``) on a CUDA device, and through its plain
version, the reference's einsum, on the CPU.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import ops as kops


@dataclasses.dataclass(frozen=True)
class ProductCode:
    """Static geometry of the 2-D product code."""

    num_blocks: int   # T systematic row blocks (pre-padding)
    block_rows: int   # b rows per block
    grid: int         # g, where g*g >= T

    @property
    def num_workers(self) -> int:
        return (self.grid + 1) ** 2

    @property
    def padded_blocks(self) -> int:
        return self.grid * self.grid


def make_code(num_rows: int, block_rows: int) -> ProductCode:
    t = -(-num_rows // block_rows)
    g = int(math.ceil(math.sqrt(t)))
    return ProductCode(num_blocks=t, block_rows=block_rows, grid=g)


def encode_2d(a: torch.Tensor, code: ProductCode) -> torch.Tensor:
    """A (rows, s) -> encoded blocks ((g+1), (g+1), b, s): zero rows pad A
    to g^2 * b, parities are sums of blocks.  Writes straight into the
    output, with no padded copy of A."""
    g, b = code.grid, code.block_rows
    rows, s = a.shape
    out = torch.zeros((g + 1, g + 1, b, s), dtype=a.dtype, device=a.device)
    for r in range(g):
        lo, hi = r * g * b, min((r + 1) * g * b, rows)
        if lo < hi:
            out[r, :g].view(g * b, s)[:hi - lo] = a[lo:hi]
    out[:g, g] = out[:g, :g].sum(dim=1)
    out[g] = out[:g].sum(dim=0)
    return out


def coded_block_products(enc: torch.Tensor, x: torch.Tensor,
                         erased: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Every worker's task, its block times x: ((g+1),(g+1),b,s) -> (...,b).
    The ``erased`` ((g+1),(g+1)) workers' blocks are skipped and give 0."""
    g1, _, b, s = enc.shape
    if erased is None:
        erased = torch.zeros((g1, g1), dtype=torch.bool, device=enc.device)
    return kops.coded_block_matvec(enc.view(-1, b, s), x,
                                   erased.reshape(-1)).view(g1, g1, b)


def _peel_axis(vals: torch.Tensor, known: torch.Tensor,
               axis: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One peel round along rows (axis=0) or columns (axis=1).  Constraint
    per line: sum(systematic) - parity_cell = 0."""
    n = vals.shape[0]
    sgn = torch.ones(n, dtype=vals.dtype, device=vals.device)
    sgn[n - 1] = -1.0
    if axis == 0:
        sgn_rc, reduce_axis = sgn[None, :], 1
    else:
        sgn_rc, reduce_axis = sgn[:, None], 0
    kf = known.to(vals.dtype)
    line_sum = (vals * (sgn_rc * kf)[..., None]).sum(dim=reduce_axis,
                                                     keepdim=True)
    missing = (~known).sum(dim=reduce_axis, keepdim=True)
    candidate = -line_sum * sgn_rc[..., None]
    rec_mask = (missing == 1) & ~known
    vals = torch.where(rec_mask[..., None], candidate, vals)
    return vals, known | rec_mask


def peel_decode(products: torch.Tensor, known: torch.Tensor,
                code: ProductCode) -> Tuple[torch.Tensor, torch.Tensor]:
    """Peeling decoder: products ((g+1),(g+1),b) with erased cells
    arbitrary, known ((g+1),(g+1)) bool.  Returns (systematic blocks
    (g, g, b), success as a bool tensor)."""
    vals = torch.where(known[..., None], products,
                       torch.zeros((), dtype=products.dtype,
                                   device=products.device))
    for _ in range(code.grid + 1):
        vals, known = _peel_axis(vals, known, axis=0)
        vals, known = _peel_axis(vals, known, axis=1)
    g = code.grid
    return vals[:g, :g], known[:g, :g].all()


def decode_matvec(products: torch.Tensor, known: torch.Tensor,
                  code: ProductCode,
                  out_rows: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full decode back to y = A @ x of length out_rows."""
    sys_blocks, ok = peel_decode(products, known, code)
    return sys_blocks.reshape(code.padded_blocks * code.block_rows)[:out_rows], ok


def coded_matvec(enc: torch.Tensor, x: torch.Tensor, code: ProductCode,
                 out_rows: int, erased: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Straggler-resilient matvec from pre-encoded blocks; ``erased`` is the
    bool ((g+1),(g+1)) straggler mask (True = missing), None for none.  The
    products' zeros for erased cells change nothing, since the decoder
    zeroes unknown cells itself."""
    if erased is not None:
        erased = erased.to(enc.device)
    prods = coded_block_products(enc, x, erased)
    if erased is None:
        known = torch.ones(prods.shape[:2], dtype=torch.bool,
                           device=prods.device)
    else:
        known = ~erased
    return decode_matvec(prods, known, code, out_rows)
