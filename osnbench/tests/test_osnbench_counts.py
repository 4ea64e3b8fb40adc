"""The operation and byte counts against hand-worked and brute-force counts
at small shapes: a count set too high would let a share pass 100%."""
import itertools

import pytest

from osnbench import counts, spec


def test_sketch_gram_intensity_by_hand():
    # k=2 blocks of b=2 rows (1 live) over an (n=4, d=3) A.
    out = counts.sketch_gram_intensity(2, 4, 3, 2, 1)
    # apply 2 k_live n d = 24, Gram k_live b d (d + 1) = 24
    # bytes: A 4 n d = 48, codes 4 2 k n = 64, A_tilde 2 4 k_live b d = 48,
    # G 4 d^2 = 36, the mask k = 2
    assert out["fused"] == (48.0, 198.0)
    # every block sketched (48) plus the Gram (24); A_tilde written whole
    # (4 k b d = 48) and read for the live blocks (24)
    assert out["unfused"] == (72.0, 222.0)
    assert counts.sketch_gram_intensity(2, 4, 3, 2) == \
        counts.sketch_gram_intensity(2, 4, 3, 2, 2)


def _brute_gram_ops(b: int, d: int) -> int:
    """Multiplies and adds of the upper triangle of one block's Gram."""
    ops = 0
    for i, j in itertools.product(range(d), repeat=2):
        if j >= i:
            ops += b + b        # b products, b additions into the entry
    return ops


def _brute_apply_ops(n: int, d: int) -> int:
    """One count-sketch block: each element of A signed, then added."""
    return sum(2 for _ in range(n) for _ in range(d))


@pytest.mark.parametrize("n,d,b,k,live", [(5, 3, 2, 3, 2), (7, 4, 3, 2, 2),
                                          (9, 2, 4, 4, 1)])
def test_fused_flops_match_a_brute_count(n, d, b, k, live):
    flops, _ = counts.sketch_gram_intensity(k, n, d, b, live)["fused"]
    assert flops == live * (_brute_apply_ops(n, d) + _brute_gram_ops(b, d))


def test_srht_by_hand():
    # P = 4 (n = 4 pads to 4): a sign, log2 4 = 2 butterfly adds and
    # b / P = 0.5 sample adds an element: 3.5 x n d = 42, Gram 24.
    assert counts.srht_sketch_flops(4, 3, 2, 1, panel=4) == 66.0
    # the panel never exceeds the padded length
    assert counts.srht_sketch_flops(3, 1, 1, 1, panel=256) == \
        counts.srht_sketch_flops(3, 1, 1, 1, panel=4)


def test_coded_matvec_bytes_by_hand():
    # 3 live (2 x 3) blocks read, x (3) read, 4 x 2 outputs written
    assert counts.coded_matvec_bytes(4, 2, 3, 3) == 4.0 * (18 + 3 + 8)


def test_direction_by_hand():
    assert counts.direction_flops("chol", 3) == 9.0 + 36.0
    assert counts.direction_flops("pinv", 3) == pytest.approx(90.0 + 36.0)
    with pytest.raises(ValueError):
        counts.direction_flops("cg", 3)


def test_iteration_by_hand():
    # logistic p = n d = 20: (4 + 3 + 2 (1 + 6) + 6) p = 27 p
    logistic = spec.objective("logistic")
    assert logistic.iteration_flops({"n": 10, "d": 2}) == 540.0
    # softmax p = 60, D = 6: 36 p + 2 n K D + 2 D^2
    softmax = spec.objective("softmax")
    assert softmax.iteration_flops({"n": 10, "d": 2, "classes": 3}) == \
        2160 + 360 + 72
    assert counts.encode_flops(10, 2) == 40.0


def test_sjlt_by_hand():
    # k = 3 blocks (2 live) of b = 2 rows, s = 2 layers, over (n = 4, d = 3):
    # a live block 2 s n d = 48 (apply) + b d = 6 (scale) + b d (d + 1) = 24
    flops, byts = counts.sjlt_gram_intensity(3, 2, 4, 3, 2, 2)
    assert flops == 2 * (48 + 6 + 24)
    # A 4 n d = 48, codes and signs 8 live s n = 128, A_tilde 2 4 live b d
    # = 96, G 4 d^2 = 36, the mask k = 3
    assert byts == 48 + 128 + 96 + 36 + 3
    # one layer is the count sketch's work, plus the scale
    one, _ = counts.sjlt_gram_intensity(3, 1, 4, 3, 2, 2)
    fused, _ = counts.sketch_gram_intensity(3, 4, 3, 2, 2)["fused"]
    assert one == fused + 2 * 6


@pytest.mark.parametrize("n,d,b,k,live,s", [(5, 3, 2, 3, 2, 4),
                                            (9, 2, 4, 4, 1, 2)])
def test_sjlt_flops_match_a_brute_count(n, d, b, k, live, s):
    flops, _ = counts.sjlt_gram_intensity(k, s, n, d, b, live)
    # s entries a row, each signed and added; the scale at write-out
    brute = s * _brute_apply_ops(n, d) + b * d + _brute_gram_ops(b, d)
    assert flops == live * brute


def test_shares_stay_under_the_peak_at_the_kernels_best():
    """At the H100's data-sheet rates the fused call's bound time is the
    larger of its two terms, so no measured time below it exists."""
    for k, n, d, b, live in [(150, 300_000, 3_000, 256, 120),
                             (230, 1_800_000, 7_840, 256, 184)]:
        flops, byts = counts.sketch_gram_intensity(k, n, d, b, live)["fused"]
        bound = counts.sketch_gram_bound_s(k, n, d, b, live)
        assert bound >= flops / counts.FP32_FLOPS
        assert bound >= byts / counts.HBM_BW
    flops, byts = counts.sjlt_gram_intensity(150, 4, 300_000, 3_000, 256, 120)
    bound = counts.roofline_s(flops, byts)
    assert bound == max(flops / counts.FP32_FLOPS, byts / counts.HBM_BW)
    # the fused SJLT at the cell's shape is bound by its operations
    assert bound == flops / counts.FP32_FLOPS
