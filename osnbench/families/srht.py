"""The SRHT sketch: block k's S_k^T[j, r] = (-1)^popcount(rows[k, j] & r)
sigma[k, r] / sqrt(b), the orthonormal Sylvester-Hadamard mix over A's
rows padded to a power of two n_pad, b of its rows sampled (uniform in
[0, n_pad)), scaled by sqrt(n_pad / b); signs sigma +-1.  The port's fused
kernel is ``kernels.ops.sketch_gram_srht``.

What the harness asks of a family is listed in ``osnbench/README.md``.
This module imports nothing of the program: it names the kernel's entry,
which the harness wraps.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from osnbench import counts
from osnbench.audit import host
from osnbench.reference import sketch

ENTRY = "sketch_gram_srht"
LABEL = "srht"  # its calls' name in ``spans.Recorder.sketch_calls``


def unpack(rows, sigma, a, survivors):
    """The entry's arguments as (draws, A)."""
    return {"rows": rows, "sigma": sigma, "live": survivors,
            "block_size": rows.shape[1]}, a


def pack(draws: Dict, a):
    """(draws, A) as the entry's arguments."""
    return draws["rows"], draws["sigma"], a, draws["live"]


def sizes(draws: Dict, a) -> Dict:
    """The call's sizes, as ``flops`` takes them."""
    return {"k": draws["rows"].shape[0], "n": a.shape[0], "d": a.shape[1],
            "b": draws["block_size"]}


def flops(live: int, k: int, n: int, d: int, b: int) -> float:
    return counts.srht_sketch_flops(n, d, b, live)


def bound_s(live: int, k: int, n: int, d: int, b: int) -> None:
    """None: the transform's bytes are not counted, so the call has no
    roofline yet."""
    return None


def compact(draws: Dict) -> Dict:
    """The sampled rows on the host."""
    return {"rows": host(draws["rows"], torch.int32)}


def _n_pad(n_rows: int) -> int:
    return 1 << max(0, (n_rows - 1).bit_length())


def draws_ok(draws: Dict, n_rows: int) -> bool:
    rows = draws["rows"]
    return bool(rows.shape == (draws["sigma"].shape[0],
                               int(draws["block_size"]))
                and int(rows.min()) >= 0 and int(rows.max()) < _n_pad(n_rows))


def _parity(v: torch.Tensor) -> torch.Tensor:
    for shift in (32, 16, 8, 4, 2, 1):
        v = v ^ (v >> shift)
    return v & 1


def q(draws: Dict, blocks: torch.Tensor, cf: torch.Tensor,
      r0: int) -> torch.Tensor:
    """(G, b, R, rows): Q of the blocks ``blocks`` over the chunk of
    samples that starts at sample ``r0`` (A rows r0 R on)."""
    rows, r, _ = cf.shape
    b, dt = int(draws["block_size"]), cf.dtype
    lo, hi = r0 * r, (r0 + rows) * r
    sigma = draws["sigma"][:, lo:hi][blocks].to(dt)
    g = sigma.shape[0]
    sel = draws["rows"][blocks].long()
    idx = torch.arange(lo, hi, device=cf.device)
    sign = 1.0 - 2.0 * _parity(sel[:, :, None] & idx).to(dt)
    t = sign * sigma[:, None, :] / math.sqrt(b)          # (G, b, rows R)
    return torch.einsum("gbnc,nci->gbin", t.view(g, b, rows, r), cf)


def draw(total_blocks: int, block_size: int, n_rows: int,
         gen: torch.Generator, device) -> Dict:
    """A fresh draw of every block, all live: the control's own sketch."""
    sigma = sketch.signs((total_blocks, n_rows), gen, device)
    return {"block_size": block_size, "sigma": sigma,
            "live": torch.ones(total_blocks, dtype=torch.bool),
            "rows": torch.randint(0, _n_pad(n_rows),
                                  (total_blocks, block_size), generator=gen,
                                  device=device, dtype=torch.int32)}


def dense(draws: Dict, k: int, n_rows: int) -> torch.Tensor:
    """Block k's S_k^T written out whole, (b, n_rows) float64."""
    hd = torch.ones((1, 1), dtype=torch.float64)
    while hd.shape[0] < _n_pad(n_rows):
        hd = torch.cat([torch.cat([hd, hd], 1), torch.cat([hd, -hd], 1)], 0)
    return (hd[draws["rows"][k].long()][:, :n_rows]
            * draws["sigma"][k].double() / int(draws["block_size"]) ** 0.5)
