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
version, the reference's einsum, on the CPU.  The same parity constraints
double as integrity checks: ``detect_corrupted`` flags corrupted (not
merely missing) products, and ``verified_decode`` demotes them to erasures,
peels, and rejects a decode that disagrees with the arrived cells.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import coded_matvec as kcm
from repro_torch.kernels import ops as kops
from repro_torch.obs import host


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
    # Each round's _peel_axis writes a host scalar into a device tensor: a
    # blocking copy from pageable memory, counted here for all rounds.
    rounds = 2 * (code.grid + 1)
    host.TRACER.copied(products.device, rounds * products.element_size(),
                       rounds)
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


def detect_corrupted(products: torch.Tensor, known: torch.Tensor,
                     code: ProductCode, rtol: float = 1e-3) -> torch.Tensor:
    """Parity-check detection of corrupted products: a corrupted known cell
    violates its row and its column constraint, while an erased cell only
    makes its two lines uncheckable.  A known cell is flagged when one of
    its checks fires and the other fires or cannot be checked: exact for
    one corrupted cell in a full grid, conservative where corruption
    shares lines with erasures (an innocent demoted to an erasure; an
    undecodable pattern then falls through to the master's billed
    relaunch, never to a wrong result).  Returns the ((g+1), (g+1)) bool
    grid of cells to demote."""
    del code   # the grid's shape carries the geometry
    row_res, row_mag, col_res, col_mag = kcm.parity_residuals(products,
                                                              known)
    full_rows = known.all(dim=1)
    full_cols = known.all(dim=0)
    tiny = torch.finfo(torch.float32).tiny
    rows_bad = full_rows & (row_res > rtol * (row_mag + tiny))
    cols_bad = full_cols & (col_res > rtol * (col_mag + tiny))
    flagged = ((rows_bad[:, None] & cols_bad[None, :])
               | (rows_bad[:, None] & ~full_cols[None, :])
               | (cols_bad[None, :] & ~full_rows[:, None]))
    return known & flagged


def verified_decode(products: torch.Tensor, arrived: torch.Tensor,
                    code: ProductCode, out_rows: int, rtol: float = 1e-3
                    ) -> Tuple[Optional[torch.Tensor], bool, int]:
    """Corruption-tolerant decode: detect, erase, peel, then verify that
    every surviving arrived cell agrees with the unique codeword the
    decoded systematic blocks extend to.  Returns ``(y, ok, flagged)``: y
    is None when the decode is undecodable or rejected.  The blind spot is
    fundamental: a corrupted systematic cell whose row parity, column
    parity and corner are all erased is consistent with a valid codeword.
    Callers relaunch on ``ok=False``."""
    flagged = detect_corrupted(products, arrived, code, rtol)
    with host.TRACER.sync("flagged"):
        n_flagged = int(flagged.sum())
    known = arrived & ~flagged
    sys_blocks, ok = peel_decode(products, known, code)
    with host.TRACER.sync("decode_ok"):
        ok = bool(ok)
    if not ok:
        return None, False, n_flagged
    row_par = sys_blocks.sum(dim=1, keepdim=True)
    top = torch.cat([sys_blocks, row_par], dim=1)
    full = torch.cat([top, top.sum(dim=0, keepdim=True)], dim=0)
    resid = torch.linalg.vector_norm(full - products, dim=-1)
    mag = (torch.linalg.vector_norm(full, dim=-1)
           + torch.finfo(torch.float32).tiny)
    mismatch = known & (resid > rtol * mag)
    with host.TRACER.sync("mismatch"):
        mismatch = bool(mismatch.any())
    if mismatch:
        return None, False, n_flagged
    y = sys_blocks.reshape(code.padded_blocks * code.block_rows)
    return y[:out_rows], True, n_flagged


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


# ---------------------------------------------------------------------------
# Distributed path: the worker tasks spread over the ranks of a group.
# ---------------------------------------------------------------------------

def distributed_coded_matvec(enc_flat: torch.Tensor, x: torch.Tensor,
                             erased_flat: torch.Tensor, code: ProductCode,
                             out_rows: int, *, group=None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Coded mat-vec with the worker tasks split over the ranks of
    ``group`` (the reference's ``mesh`` and ``worker_axis``).

    enc_flat: (W_pad, b, s) encoded blocks flattened row-major and
       zero-padded to a multiple of the world size (W_pad >= (g+1)^2),
       whole on every rank; each rank multiplies its W_pad / world.
    erased_flat: (W_pad,) straggler erasures.  An erased worker's product
       is zero before the gather ("the master never saw it"); the coded
       block mat-vec kernel skips it on the card.
    The products are all-gathered, then peeled (``decode_matvec``).
    """
    from repro_torch.distributed.collectives import (all_gather_rows,
                                                     rank_and_world)
    rank, world = rank_and_world(group)
    w_pad = enc_flat.shape[0]
    if w_pad % world:
        raise ValueError(f"{w_pad} worker tasks do not split over {world} "
                         "ranks")
    per = w_pad // world
    sl = slice(rank * per, (rank + 1) * per)
    erased_flat = erased_flat.to(enc_flat.device)
    prod = kops.coded_block_matvec(enc_flat[sl].contiguous(), x,
                                   erased_flat[sl].contiguous())
    prods_flat = all_gather_rows(prod, group)
    w, g1 = code.num_workers, code.grid + 1
    prods = prods_flat[:w].reshape(g1, g1, code.block_rows)
    known = (~erased_flat[:w]).reshape(g1, g1)
    return decode_matvec(prods, known, code, out_rows)
