"""Operations and bytes that the Newton iteration needs, from shapes alone:
the yardstick of the benchmark's shares of a peak or a roofline.

Peaks are the NVIDIA H100 SXM data sheet's, dense, at the full 700 W
power limit: 67e12 FLOP/s in float32 outside the tensor cores, 3.35e12 B/s
of HBM.  An operation is one floating-point add or multiply (an FMA is
two).  Each input byte is counted once and each output byte once, however
often a kernel reads it again; where the work depends on the inputs (the
sketch blocks that survive the fleet, the coded blocks that arrive), the
caller passes what these inputs needed.
"""
from __future__ import annotations

import math

FP32_FLOPS = 67e12      # H100 SXM data sheet, float32, no tensor cores
HBM_BW = 3.35e12        # H100 SXM data sheet, bytes a second
CANDIDATES = 6          # trial steps of the line search: 4^0 .. 4^-5


def sketch_gram_intensity(k: int, n: int, d: int, b: int,
                          k_live: int = None) -> dict:
    """(flops, HBM bytes) of the sketch -> Gram hot path at K blocks of b
    rows (``k_live`` of them surviving) over an (n, d) fp32 A.  A frozen
    copy of ``repro_torch.benchmarks.roofline.sketch_gram_intensity``.

    * fused (``kernels.ops.sketch_gram_count``): per chunk of blocks the
      strip-walking apply of the live blocks (``csrc/count_sketch.cu``: A
      from HBM about once, its K re-reads from L2) into an A_tilde
      scratch, then the masked Gram (the upper triangle, b d (d + 1) a
      block) reading it back: A once, the codes once, A_tilde written and
      read once, G written once.  At the paths' widths one chunk holds
      every block (``CHUNK_BYTES``).
    * unfused (``count_sketch_apply`` then ``oversketch_gram``): every
      block sketched, masked ones too, A_tilde written whole, then read
      by the Gram's live blocks.
    """
    k_live = k if k_live is None else k_live
    gram_fl = float(k_live) * b * d * (d + 1)
    a_read, codes, g_out = 4.0 * n * d, 4.0 * 2 * k * n, 4.0 * d * d
    return {
        "fused": (2.0 * k_live * n * d + gram_fl,
                  a_read + codes + 2 * 4.0 * k_live * b * d + g_out + k),
        "unfused": (2.0 * k * n * d + gram_fl,
                    a_read + codes + 4.0 * k * b * d +
                    4.0 * k_live * b * d + g_out + k),
    }


def roofline_s(flops: float, byts: float) -> float:
    """A call's least time: the larger of its operations over the float32
    peak and its bytes over HBM's."""
    return max(flops / FP32_FLOPS, byts / HBM_BW)


def sketch_gram_bound_s(k: int, n: int, d: int, b: int, k_live: int) -> float:
    """The fused count-sketch -> Gram call's roofline time."""
    return roofline_s(*sketch_gram_intensity(k, n, d, b, k_live)["fused"])


def sjlt_gram_intensity(k: int, s: int, n: int, d: int, b: int,
                        k_live: int) -> tuple:
    """(flops, HBM bytes) of the fused SJLT -> Gram call
    (``kernels.ops.sketch_gram_sjlt``, ``csrc/sketch_gram_sjlt.cu``) at K
    blocks of b rows, ``k_live`` of them surviving, each with s signed
    layers, over an (n, d) fp32 A.  A masked block is neither sorted nor
    gathered, so only the live blocks' draws count.

    * operations: per live block the apply's 2 s n d (each of the s
      entries of a row of A signed and added), the 1 / sqrt(s) scale at
      write-out (b d), and the upper-triangle Gram's b d (d + 1);
    * bytes: A once, the live blocks' codes and signs (int32 and float32,
      s n each), A_tilde written and read once, G written once, the mask.
    """
    flops = float(k_live) * (2.0 * s * n * d + b * d + b * d * (d + 1))
    byts = (4.0 * n * d + 8.0 * k_live * s * n + 2 * 4.0 * k_live * b * d
            + 4.0 * d * d + k)
    return flops, byts


def srht_sketch_flops(n: int, d: int, b: int, k_live: int,
                      panel: int = 256) -> float:
    """The fused SRHT -> Gram call: per live block and element of A one
    sign multiply, log2(P) butterfly additions of the partial Hadamard
    transform over panels of P rows, and b / P additions for the sampled
    rows; then the upper-triangle Gram, b d (d + 1) a live block."""
    p = min(panel, 1 << max(0, math.ceil(math.log2(max(n, 1)))))
    per_element = 1.0 + math.log2(p) + b / p
    return k_live * n * d * per_element + float(k_live) * b * d * (d + 1)


def coded_matvec_bytes(workers: int, b: int, s: int, live: int) -> float:
    """One coded block mat-vec launch: the live workers' (b, s) float32
    blocks read once (an erased worker's block is never read), x read
    once, every worker's b outputs written once."""
    return 4.0 * (live * b * s + s + workers * b)


def direction_flops(solver: str, dim: int) -> float:
    """The direction's solve of a (dim, dim) system: Cholesky's dim^3 / 3
    and two triangular solves; or the symmetric eigendecomposition with
    vectors (tridiagonal reduction 4/3 dim^3, back-transformation 2 dim^3)
    and the pinv's two products."""
    if solver == "chol":
        return dim ** 3 / 3.0 + 4.0 * dim * dim
    if solver == "pinv":
        return (4.0 / 3.0 + 2.0) * dim ** 3 + 4.0 * dim * dim
    raise ValueError(f"no count for solver {solver!r}")


def encode_flops(rows: int, cols: int) -> float:
    """One product-code encode of a (rows, cols) operand: the parity
    column sums each grid row's blocks and the parity row sums the grid's
    rows, about 2 rows cols additions (the zero padding and the corner's
    extra sum left out)."""
    return 2.0 * rows * cols
