"""The SJLT (OSNAP) sketch: block k's S_k^T[j, r] = (1 / sqrt(s)) sum_t
sigma[k, t, r] [h[k, t, r] = j], s signed entries a row of A (s = 4, the
port's ``SJLTFamily.nnz_per_row``), codes uniform in [0, b), signs +-1;
two layers of one row that land in one bucket add.  The sum of s
count-sketch layers, as ``repro_torch.kernels.ref.sjlt_apply`` defines it.
The port's fused kernel is ``kernels.ops.sketch_gram_sjlt``.

What the harness asks of a family is listed in ``osnbench/README.md``.
This module imports nothing of the program: it names the kernel's entry,
which the harness wraps.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from osnbench import counts
from osnbench.audit import compact_codes
from osnbench.reference import sketch

ENTRY = "sketch_gram_sjlt"
LABEL = "sjlt"  # its calls' name in ``spans.Recorder.sketch_calls``
LAYERS = 4          # s: the port's default, which its Newton path takes


def unpack(h, sigma, a, block_size, survivors):
    """The entry's arguments as (draws, A)."""
    return {"h": h, "sigma": sigma, "live": survivors,
            "block_size": int(block_size)}, a


def pack(draws: Dict, a):
    """(draws, A) as the entry's arguments."""
    return draws["h"], draws["sigma"], a, draws["block_size"], draws["live"]


def sizes(draws: Dict, a) -> Dict:
    """The call's sizes, as ``flops`` and ``bound_s`` take them."""
    k, s, _ = draws["h"].shape
    return {"k": k, "s": s, "n": a.shape[0], "d": a.shape[1],
            "b": draws["block_size"]}


def flops(live: int, k: int, s: int, n: int, d: int, b: int) -> float:
    return counts.sjlt_gram_intensity(k, s, n, d, b, live)[0]


def bound_s(live: int, k: int, s: int, n: int, d: int, b: int) -> float:
    return counts.roofline_s(*counts.sjlt_gram_intensity(k, s, n, d, b,
                                                         live))


def compact(draws: Dict) -> Dict:
    return compact_codes(draws["h"], int(draws["block_size"]))


def draws_ok(draws: Dict, n_rows: int) -> bool:
    lo, hi = draws["h_range"]
    return (0 <= lo and hi < int(draws["block_size"])
            and draws["h"].shape == draws["sigma"].shape
            and draws["h"].shape[1] == LAYERS)


def q(draws: Dict, blocks: torch.Tensor, cf: torch.Tensor,
      r0: int) -> torch.Tensor:
    """(G, b, R, rows): Q of the blocks ``blocks`` over the chunk of
    samples that starts at sample ``r0`` (A rows r0 R on)."""
    rows, r, _ = cf.shape
    lo, hi = r0 * r, (r0 + rows) * r
    h = draws["h"][:, :, lo:hi][blocks].long()
    sigma = draws["sigma"][:, :, lo:hi][blocks].to(cf.dtype)
    q_ = sketch.segment_q(h, sigma, cf, int(draws["block_size"]))
    return q_ / math.sqrt(h.shape[1])


def draw(total_blocks: int, block_size: int, n_rows: int,
         gen: torch.Generator, device) -> Dict:
    """A fresh draw of every block, all live: the control's own sketch."""
    shape = (total_blocks, LAYERS, n_rows)
    sigma = sketch.signs(shape, gen, device)
    return {"block_size": block_size, "sigma": sigma,
            "live": torch.ones(total_blocks, dtype=torch.bool),
            "h": torch.randint(0, block_size, shape, generator=gen,
                               device=device, dtype=torch.int32)}


def dense(draws: Dict, k: int, n_rows: int) -> torch.Tensor:
    """Block k's S_k^T written out whole, (b, n_rows) float64."""
    s = torch.zeros((int(draws["block_size"]), n_rows), dtype=torch.float64)
    cols = torch.arange(n_rows)
    for t in range(draws["h"].shape[1]):
        s.index_put_((draws["h"][k, t].long(), cols),
                     draws["sigma"][k, t].double(), accumulate=True)
    return s / math.sqrt(draws["h"].shape[1])
