"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU and the CUDA toolkit, and skips
without them.  On the card:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py -q

The file imports neither jax nor the JAX package, so it runs where only
the port is installed.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch import prng
from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.cuda

# fp32 sums in another order than the plain version's: relative to the
# output's largest entry.
REL_TOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rel_err(got, want):
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def _inputs(device, k, n, d, b, seed=0):
    g = torch.Generator().manual_seed(seed)
    h = torch.randint(0, b, (k, n), generator=g, dtype=torch.int32)
    sigma = torch.randint(0, 2, (k, n), generator=g).float() * 2 - 1
    a = torch.randn(n, d, generator=g)
    return h.to(device), sigma.to(device), a.to(device)


SHAPES = [(6, 301, 37, 32), (5, 1000, 129, 64), (7, 2048, 260, 256),
          (3, 50, 1, 16)]


@pytest.mark.parametrize("k,n,d,b", SHAPES)
def test_count_sketch_apply(cuda, k, n, d, b):
    h, sigma, a = _inputs(cuda, k, n, d, b)
    got = ops.count_sketch_apply(h, sigma, a, b)
    assert _rel_err(got, ref.count_sketch_apply(h, sigma, a, b)) < REL_TOL


@pytest.mark.parametrize("k,n,d,b", SHAPES)
@pytest.mark.parametrize("mask", ["all", "some", "none", "one"])
def test_grams(cuda, k, n, d, b, mask):
    h, sigma, a = _inputs(cuda, k, n, d, b, seed=k + d)
    m = {"all": torch.ones(k, dtype=torch.bool),
         "some": torch.arange(k) % 2 == 0,
         "none": torch.zeros(k, dtype=torch.bool),
         "one": torch.arange(k) == k - 1}[mask].to(cuda)
    a_t = ref.count_sketch_apply(h, sigma, a, b)
    want = ref.oversketch_gram(a_t, m)
    for got in (ops.oversketch_gram(a_t, m),
                ops.sketch_gram_count(h, sigma, a, b, m)):
        if mask == "none":
            assert not got.any()
        else:
            assert _rel_err(got, want) < REL_TOL
            torch.testing.assert_close(got, got.T, rtol=0, atol=0)


def test_fused_kernel_walks_several_chunks(cuda, monkeypatch):
    from repro_torch.kernels import sketch_gram
    monkeypatch.setattr(sketch_gram, "CHUNK_BYTES", 1)   # one CTA group each
    h, sigma, a = _inputs(cuda, 40, 700, 90, 64)
    m = (torch.arange(40) % 3 != 0).to(cuda)
    got = ops.sketch_gram_count(h, sigma, a, 64, m)
    want = ref.sketch_gram_count(h, sigma, a, 64, m)
    assert sketch_gram.chunk_blocks(40, 64, 90) < 40
    assert _rel_err(got, want) < REL_TOL


def test_launches_are_counted(cuda):
    ops.reset_launch_counts()
    h, sigma, a = _inputs(cuda, 4, 100, 20, 32)
    m = torch.ones(4, dtype=torch.bool, device=cuda)
    ops.sketch_gram_count(h, sigma, a, 32, m)
    ops.sketch_gram_count(h, sigma, a, 32, m)
    ops.count_sketch_apply(h, sigma, a, 32)
    ops.fwht(torch.zeros((1, 8192, 3), device=cuda))   # the two-pass form
    ops.fwht(torch.zeros((1, 64, 3), device=cuda))
    ops.coded_block_matvec(torch.zeros((2, 3, 8), device=cuda),
                           torch.zeros(8, device=cuda),
                           torch.zeros(2, dtype=torch.bool, device=cuda))
    ops.normal(prng.PRNGKey(0), (5,), cuda)
    ops.normal_window(prng.PRNGKey(0), (5, 4), ((1, 2), (0, 4)), cuda)
    ops.randint(prng.PRNGKey(0), (5,), 0, 3, device=cuda)
    ops.uniform(prng.PRNGKey(0), (0,), device=cuda)     # nothing to launch
    ops.rademacher(prng.PRNGKey(0), (5,), device=cuda)
    # The normal table's build is no launch of normal.
    assert ops.launch_counts() == {"sketch_gram_count": 2,
                                   "count_sketch_apply": 1,
                                   "oversketch_gram": 0,
                                   "coded_block_matvec": 1,
                                   "sketch_gram_sjlt": 0,
                                   "sketch_gram_srht": 0,
                                   "fwht": 1, "fwht_two_pass": 1,
                                   "normal": 1, "normal_window": 1,
                                   "draw": 2}


# Past b ~ 1,700 no (b x 32) shared-memory tile fits: the apply's sort
# and gather must hold there, as at every b.
@pytest.mark.parametrize("k,n,d,b", [(3, 5000, 70, 4096), (4, 900, 33, 2000)])
def test_count_sketch_kernels_at_large_block_size(cuda, k, n, d, b):
    h, sigma, a = _inputs(cuda, k, n, d, b, seed=b)
    m = torch.arange(k, device=cuda) != 1
    a_t = ref.count_sketch_apply(h, sigma, a, b)
    assert _rel_err(ops.count_sketch_apply(h, sigma, a, b), a_t) < REL_TOL
    got = ops.sketch_gram_count(h, sigma, a, b, m)
    assert _rel_err(got, ref.oversketch_gram(a_t, m)) < REL_TOL


def _sjlt_inputs(device, k, s, n, d, b, seed=0):
    g = torch.Generator().manual_seed(seed)
    h = torch.randint(0, b, (k, s, n), generator=g, dtype=torch.int32)
    sigma = torch.randint(0, 2, (k, s, n), generator=g).float() * 2 - 1
    a = torch.randn(n, d, generator=g)
    return h.to(device), sigma.to(device), a.to(device)


MASKS = ["all", "some", "none"]


def _mask(kind, k, device):
    return {"all": torch.ones(k, dtype=torch.bool),
            "some": torch.arange(k) % 3 != 1,
            "none": torch.zeros(k, dtype=torch.bool)}[kind].to(device)


@pytest.mark.parametrize("k,s,n,d,b", [(6, 4, 301, 37, 32), (5, 3, 1000, 129, 64),
                                       (7, 4, 2048, 260, 256),
                                       (2, 2, 700, 20, 4096),
                                       (4, 1, 500, 30, 64)])
@pytest.mark.parametrize("mask", MASKS)
def test_sketch_gram_sjlt(cuda, k, s, n, d, b, mask):
    h, sigma, a = _sjlt_inputs(cuda, k, s, n, d, b, seed=n)
    # Two layers of one row in one bucket must add (one layer: none).
    h[:, 1:, :50] = h[:, :1, :50]
    m = _mask(mask, k, cuda)
    got = ops.sketch_gram_sjlt(h, sigma, a, b, m)
    if mask == "none":
        assert not got.any()
        return
    assert _rel_err(got, ref.sketch_gram_sjlt(h, sigma, a, b, m)) < REL_TOL
    torch.testing.assert_close(got, got.T, rtol=0, atol=0)


# The layered count-sketch apply is the SJLT apply of the distributed-avg
# path (b = 4,096 takes the sorted-gather form).
@pytest.mark.parametrize("k,s,n,d,b", [(6, 4, 301, 37, 32), (3, 4, 5000, 70, 4096),
                                       (2, 2, 700, 20, 2000)])
def test_layered_count_sketch_apply_is_the_sjlt_apply(cuda, k, s, n, d, b):
    h, sigma, a = _sjlt_inputs(cuda, k, s, n, d, b, seed=b)
    h[:, 1, :50] = h[:, 0, :50]
    got = ops.count_sketch_apply(h, sigma, a, b)
    assert _rel_err(got, ref.sjlt_apply(h, sigma, a, b)) < REL_TOL


# Block sizes on both sides of b ~ 1,700, past which no (b x 32) shared-
# memory tile fits: the sorted gather serves them all.
FORM_SIZES = [256, 1024, 1600, 1800, 2000, 4096]
# (n, d): n not a multiple of a sort chunk, d = 1, d not a multiple of a
# 32-column strip and not of 4, d a multiple of both.
GEOMS = [(3001, 45), (700, 1), (128, 33), (1000, 64)]
BUCKETS = ["one_bucket", "half_empty", "out_of_range"]


def _skewed(device, kind, k, s, n, d, b, seed):
    """Codes (K, s, n) with every row in one bucket, half of the buckets
    empty, or a third of the codes outside [0, b); layers 1.. repeat layer
    0's bucket on a quarter of the rows."""
    g = torch.Generator().manual_seed(seed)
    if kind == "one_bucket":
        h = torch.full((k, s, n), b // 3, dtype=torch.int32)
    elif kind == "half_empty":
        h = 2 * torch.randint(0, (b + 1) // 2, (k, s, n), generator=g,
                              dtype=torch.int32)
    else:
        h = torch.randint(-(b // 3), b + b // 3, (k, s, n), generator=g,
                          dtype=torch.int32)
    h[:, 1:, : n // 4] = h[:, :1, : n // 4]
    sigma = torch.randint(0, 2, (k, s, n), generator=g).float() * 2 - 1
    a = torch.randn(n, d, generator=g)
    return h.to(device), sigma.to(device), a.to(device)


def _in_range(h, sigma, b):
    """The codes the plain versions take: a bucket outside [0, b) adds
    nothing, as the reference's segment_sum drops it."""
    keep = (h >= 0) & (h < b)
    return torch.where(keep, h, 0), torch.where(keep, sigma, 0.0)


@pytest.mark.parametrize("b", FORM_SIZES)
@pytest.mark.parametrize("kind", BUCKETS)
@pytest.mark.parametrize("n,d", GEOMS[:2])
def test_count_sketch_apply_skewed_buckets(cuda, b, kind, n, d):
    h, sigma, a = _skewed(cuda, kind, 3, 1, n, d, b, seed=b + n)
    h, sigma = h[:, 0].contiguous(), sigma[:, 0].contiguous()
    got = ops.count_sketch_apply(h, sigma, a, b)
    want = ref.count_sketch_apply(*_in_range(h, sigma, b), a, b)
    assert _rel_err(got, want) < REL_TOL
    # One fixed order of summation: the same bits on every call.
    assert torch.equal(ops.count_sketch_apply(h, sigma, a, b), got)


@pytest.mark.parametrize("b", FORM_SIZES)
@pytest.mark.parametrize("s", [1, 2, 3, 4])
@pytest.mark.parametrize("n,d", GEOMS)
def test_layered_apply_with_layer_collisions(cuda, b, s, n, d):
    h, sigma, a = _skewed(cuda, "out_of_range", 3, s, n, d, b, seed=s * b)
    got = ops.count_sketch_apply(h, sigma, a, b)
    want = ref.sjlt_apply(*_in_range(h, sigma, b), a, b)
    assert _rel_err(got, want) < REL_TOL
    assert torch.equal(ops.count_sketch_apply(h, sigma, a, b), got)


@pytest.mark.parametrize("b", FORM_SIZES)
@pytest.mark.parametrize("kind", BUCKETS)
def test_fused_grams_skewed_buckets(cuda, b, kind):
    n, d = GEOMS[2]
    h, sigma, a = _skewed(cuda, kind, 5, 4, n, d, b, seed=b)
    m = torch.arange(5, device=cuda) != 2
    hc, sc = _in_range(h, sigma, b)
    got = ops.sketch_gram_sjlt(h, sigma, a, b, m)
    assert _rel_err(got, ref.sketch_gram_sjlt(hc, sc, a, b, m)) < REL_TOL
    assert torch.equal(ops.sketch_gram_sjlt(h, sigma, a, b, m), got)
    h1, s1 = h[:, 0].contiguous(), sigma[:, 0].contiguous()
    got = ops.sketch_gram_count(h1, s1, a, b, m)
    want = ref.sketch_gram_count(hc[:, 0], sc[:, 0], a, b, m)
    assert _rel_err(got, want) < REL_TOL
    assert torch.equal(ops.sketch_gram_count(h1, s1, a, b, m), got)


def test_apply_takes_a_misaligned_a(cuda):
    """A whose rows are not 16-byte aligned: the gather reads A a float at
    a time, so any alignment serves."""
    n, d, b = 777, 64, 256
    h, sigma, _ = _inputs(cuda, 4, n, d, b, seed=3)
    a = torch.randn(n * d + 1, generator=torch.Generator().manual_seed(3))
    a = a.to(cuda)[1:].view(n, d)
    assert a.data_ptr() % 16 != 0
    got = ops.count_sketch_apply(h, sigma, a, b)
    assert _rel_err(got, ref.count_sketch_apply(h, sigma, a, b)) < REL_TOL


@pytest.mark.parametrize("b", [256, 4096])
@pytest.mark.parametrize("s", [1, 4])
def test_segment_sums_multiply_by_sigma(cuda, b, s):
    """sigma of any value, zeros included, multiplies its row of A, as in
    the plain versions: the kernels keep sigma's value, not its sign."""
    k, n, d = 4, 1500, 40
    h, _, a = _sjlt_inputs(cuda, k, s, n, d, b, seed=b + s)
    g = torch.Generator().manual_seed(s)
    sigma = torch.rand(k, s, n, generator=g) * 4 - 2
    sigma[:, :, ::7] = 0.0
    sigma[:, :, 1::7] = 0.5
    sigma = sigma.to(cuda)
    m = torch.arange(k, device=cuda) != 1
    got = ops.count_sketch_apply(h, sigma, a, b)
    assert _rel_err(got, ref.sjlt_apply(h, sigma, a, b)) < REL_TOL
    got = ops.sketch_gram_sjlt(h, sigma, a, b, m)
    assert _rel_err(got, ref.sketch_gram_sjlt(h, sigma, a, b, m)) < REL_TOL
    h1, s1 = h[:, 0].contiguous(), sigma[:, 0].contiguous()
    got = ops.count_sketch_apply(h1, s1, a, b)
    assert _rel_err(got, ref.count_sketch_apply(h1, s1, a, b)) < REL_TOL
    got = ops.sketch_gram_count(h1, s1, a, b, m)
    assert _rel_err(got, ref.sketch_gram_count(h1, s1, a, b, m)) < REL_TOL


def _srht_inputs(device, k, n, d, b, seed=0):
    g = torch.Generator().manual_seed(seed)
    n_pad = 1 << max(0, (n - 1).bit_length())
    rows = torch.randint(0, n_pad, (k, b), generator=g, dtype=torch.int32)
    sigma = torch.randint(0, 2, (k, n), generator=g).float() * 2 - 1
    a = torch.randn(n, d, generator=g)
    return rows.to(device), sigma.to(device), a.to(device)


@pytest.mark.parametrize("k,n,d,b", [(6, 301, 37, 32), (5, 1024, 129, 64),
                                     (4, 3000, 260, 256), (3, 50, 1, 16)])
@pytest.mark.parametrize("mask", MASKS)
def test_sketch_gram_srht(cuda, k, n, d, b, mask):
    rows, sigma, a = _srht_inputs(cuda, k, n, d, b, seed=n)
    m = _mask(mask, k, cuda)
    got = ops.sketch_gram_srht(rows, sigma, a, m)
    if mask == "none":
        assert not got.any()
        return
    assert _rel_err(got, ref.sketch_gram_srht(rows, sigma, a, m)) < REL_TOL
    torch.testing.assert_close(got, got.T, rtol=0, atol=0)


# The SRHT kernel transforms panels of P = 256 rows: n below P, exactly a
# power of two, one past a panel edge; every sampled row at or past n;
# repeated sampled rows; b not a multiple of 32 and past one CTA's 256
# samples; d = 1; sigma of any value.
SRHT_CASES = [(3, 100, 37, 32, "any"), (3, 256, 37, 32, "any"),
              (3, 1024, 20, 64, "any"), (3, 257, 37, 32, "any"),
              (3, 513, 33, 37, "any"), (3, 600, 40, 64, "past_n"),
              (3, 700, 40, 64, "repeated"), (3, 900, 1, 64, "any"),
              (2, 3000, 70, 300, "any"), (3, 1500, 45, 50, "sigma_values")]


@pytest.mark.parametrize("k,n,d,b,kind", SRHT_CASES)
@pytest.mark.parametrize("mask", ["all", "one", "none"])
def test_sketch_gram_srht_panels(cuda, k, n, d, b, kind, mask):
    rows, sigma, a = _srht_inputs("cpu", k, n, d, b, seed=n + b)
    g = torch.Generator().manual_seed(b)
    n_pad = 1 << max(0, (n - 1).bit_length())
    if kind == "past_n":
        rows = torch.randint(n, n_pad, (k, b), generator=g, dtype=torch.int32)
    elif kind == "repeated":
        rows[:, 1::2] = rows[:, ::2][:, : b // 2]
        rows[:, -3:] = rows[:, :1]
    elif kind == "sigma_values":
        sigma = torch.rand(k, n, generator=g) * 4 - 2
        sigma[torch.rand(k, n, generator=g) < 0.125] = 0.0
    rows, sigma, a = rows.to(cuda), sigma.to(cuda), a.to(cuda)
    m = {"all": torch.ones(k, dtype=torch.bool),
         "one": torch.arange(k) == k - 1,
         "none": torch.zeros(k, dtype=torch.bool)}[mask].to(cuda)
    got = ops.sketch_gram_srht(rows, sigma, a, m)
    if mask == "none":
        assert not got.any()
        return
    assert _rel_err(got, ref.sketch_gram_srht(rows, sigma, a, m)) < REL_TOL
    assert torch.equal(got, got.T)
    assert torch.equal(ops.sketch_gram_srht(rows, sigma, a, m), got)


# The masked Gram cuts the live rows into slices (oversketch_matmul
# .gram_slices sizes them from the SM count): counts that do not divide the
# live rows, more slices than rows, and d at and past a 128-column tile edge.
@pytest.mark.parametrize("slices", [1, 3, 7, 64, 300])
@pytest.mark.parametrize("d", [1, 37, 128, 129, 257, 260])
def test_gram_of_any_slice_count(cuda, monkeypatch, slices, d):
    from repro_torch.kernels import oversketch_matmul
    monkeypatch.setattr(oversketch_matmul, "gram_slices",
                        lambda rows, d_, sms: slices)
    k, b = 7, 37
    g = torch.Generator().manual_seed(d + slices)
    a_t = torch.randn(k, b, d, generator=g).to(cuda)
    m = (torch.arange(k) % 3 != 1).to(cuda)   # 5 live blocks, 185 rows
    got = ops.oversketch_gram(a_t, m)
    assert _rel_err(got, ref.oversketch_gram(a_t, m)) < REL_TOL
    assert torch.equal(got, got.T)
    assert torch.equal(ops.oversketch_gram(a_t, m), got)


# The fused kernels fold chunks of 3 blocks: a chunk with one live block,
# one with every block masked, one with two (accumulate, then finalize on
# the last), with the Gram cut into slices that divide nothing.
@pytest.mark.parametrize("family", ["count", "sjlt", "srht"])
@pytest.mark.parametrize("slices", [1, 5])
@pytest.mark.parametrize("d", [37, 129])
def test_fused_grams_walk_masked_chunks(cuda, monkeypatch, family, slices, d):
    from repro_torch.kernels import oversketch_matmul, sketch_gram
    monkeypatch.setattr(oversketch_matmul, "gram_slices",
                        lambda rows, d_, sms: slices)
    k, n, b = 9, 700, 32
    monkeypatch.setattr(sketch_gram, "CHUNK_BYTES", 3 * 4 * b * d)
    assert sketch_gram.chunk_blocks(k, b, d) == 3
    m = torch.tensor([1, 0, 0, 0, 0, 0, 1, 1, 0], dtype=torch.bool).to(cuda)
    if family == "srht":
        rows, sigma, a = _srht_inputs(cuda, k, n, d, b, seed=d)
        got = ops.sketch_gram_srht(rows, sigma, a, m)
        want = ref.sketch_gram_srht(rows, sigma, a, m)
        again = ops.sketch_gram_srht(rows, sigma, a, m)
    else:
        s = 3 if family == "sjlt" else 1
        h, sigma, a = _sjlt_inputs(cuda, k, s, n, d, b, seed=d)
        if family == "count":
            h, sigma = h[:, 0].contiguous(), sigma[:, 0].contiguous()
        fused = ops.sketch_gram_sjlt if family == "sjlt" else \
            ops.sketch_gram_count
        plain = ref.sketch_gram_sjlt if family == "sjlt" else \
            ref.sketch_gram_count
        got = fused(h, sigma, a, b, m)
        want = plain(h, sigma, a, b, m)
        again = fused(h, sigma, a, b, m)
    assert _rel_err(got, want) < REL_TOL
    assert torch.equal(got, got.T)
    assert torch.equal(again, got)


# The softmax path's width: d K = 7,840 is no multiple of the Gram's
# 128-column tiles (a ragged last tile row and column).
@pytest.mark.parametrize("mask", ["all", "some"])
def test_fused_gram_at_the_softmax_width(cuda, mask):
    h, sigma, a = _inputs(cuda, 3, 2000, 7840, 256)
    m = torch.ones(3, dtype=torch.bool, device=cuda)
    if mask == "some":
        m[1] = False
    got = ops.sketch_gram_count(h, sigma, a, 256, m)
    want = ref.sketch_gram_count(h, sigma, a, 256, m)
    assert _rel_err(got, want) < REL_TOL
    torch.testing.assert_close(got, got.T, rtol=0, atol=0)


def test_gather_past_two_to_the_31_elements(cuda):
    """A of 300,000 x 7,840 (2.35e9 elements, 9.4 GB): only the rows past
    element 2^31 carry a bucket (the others' codes are out of range and
    dropped), so the apply and the fused Gram read A there alone."""
    n, d, b, k = 300_000, 7840, 256, 2
    r0 = (1 << 31) // d + 1
    gen = torch.Generator(device=cuda).manual_seed(0)
    a = torch.randn(n, d, generator=gen, device=cuda)
    h = torch.randint(0, b, (k, n), generator=gen, device=cuda,
                      dtype=torch.int32)
    h[:, :r0] = b
    sigma = torch.randint(0, 2, (k, n), generator=gen,
                          device=cuda).float() * 2 - 1
    want = ref.count_sketch_apply(h[:, r0:].contiguous(),
                                  sigma[:, r0:].contiguous(), a[r0:], b)
    assert _rel_err(ops.count_sketch_apply(h, sigma, a, b), want) < REL_TOL
    m = torch.ones(k, dtype=torch.bool, device=cuda)
    assert _rel_err(ops.sketch_gram_count(h, sigma, a, b, m),
                    ref.oversketch_gram(want, m)) < REL_TOL


# n = 2^11 splits into n1 = 32 != n2 = 64; (2^19, 33) is the full-width
# length with one partial 32-column strip; d = 1; n = 2^21 has a local
# pass of 2,048 rows, n = 2^23 passes of 2,048 and 4,096 rows, n = 2^24
# two of 4,096: the wide kernel's, past the register pass.  Then every
# length one pass takes (the register pass up to 1,024 rows, the wide
# kernel at 2,048 and 4,096), at odd widths: one column, a partial last
# strip of 8 and of 32 columns.
FWHT_CASES = [(3, 1, 5), (2, 64, 37), (1, 4096, 300), (2, 8192, 33),
              (1, 1 << 17, 20), (3, 1 << 11, 37), (1, 1 << 19, 33),
              (2, 1 << 15, 1), (1, 1 << 21, 3), (1, 1 << 23, 2),
              (1, 1 << 24, 1)]
FWHT_CASES += [(2, 1 << log_n, d) for log_n in range(13)
               for d in (1, 37, 3001) if (2, 1 << log_n, d) not in FWHT_CASES]


@pytest.mark.parametrize("k,n,d", FWHT_CASES)
def test_fwht_forms_match_the_butterfly(cuda, k, n, d):
    x = torch.randn(k, n, d, generator=torch.Generator().manual_seed(n)).to(cuda)
    want = ref.fwht(x)
    for fn in (ops.fwht, ops.fwht_two_pass):
        got = fn(x)
        assert _rel_err(got, want) < REL_TOL
    # Both forms add the butterfly's pairs in its order and scale as the
    # plain version does on the card: the same bits at every n.  The entry
    # takes one launch of the one-pass kernel while n <= 4,096.
    assert torch.equal(ops.fwht_two_pass(x), want)
    kernel = "fwht" if n <= 4096 else "fwht_two_pass"
    launches = ops.launch_counts()[kernel]
    assert torch.equal(ops.fwht(x), want)
    assert ops.launch_counts()[kernel] == launches + 1
    torch.testing.assert_close(ops.fwht(ops.fwht(x)), x, rtol=1e-4,
                               atol=1e-4)


# (W, b, s): s % 4 != 0 takes scalar loads; one worker; b = 37 and 257 not
# a multiple of the kernel's 8-row task; s below, at and past one sweep of
# a CTA's lanes over s (8 warps x 32 lanes x 2 vectors of 4 = 2,048); s at
# 12,288 (x of 48 KB, the last read through L1) and past it, where x is
# staged in tiles of 2,048 floats: a partial last tile, whole tiles, and
# the X^T encode's s.
@pytest.mark.parametrize("w,b,s", [(9, 16, 700), (1, 256, 3000), (25, 37, 5001),
                                   (6, 3, 7), (4, 256, 1024), (3, 64, 100003),
                                   (1, 37, 2048), (5, 257, 2048),
                                   (7, 257, 2052), (30, 37, 1000),
                                   (5, 8, 12288), (3, 37, 12292),
                                   (2, 257, 20480), (2, 16, 300000)])
def test_coded_block_matvec(cuda, w, b, s):
    g = torch.Generator().manual_seed(s)
    enc = torch.randn(w, b, s, generator=g).to(cuda)
    x = torch.randn(s, generator=g).to(cuda)
    erased = (torch.arange(w) % 3 == 1).to(cuda)
    got = ops.coded_block_matvec(enc, x, erased)
    want = ref.coded_block_matvec(enc, x, erased)
    assert _rel_err(got, want) < REL_TOL
    assert not got[erased].any()
    # One fixed order of summation: the same bits on every call.
    torch.testing.assert_close(ops.coded_block_matvec(enc, x, erased), got,
                               rtol=0, atol=0)
    none = torch.zeros(w, dtype=torch.bool, device=cuda)
    assert _rel_err(ops.coded_block_matvec(enc, x, none),
                    ref.coded_block_matvec(enc, x, none)) < REL_TOL
    every = torch.ones(w, dtype=torch.bool, device=cuda)
    out = ops.coded_block_matvec(enc, x, every)
    assert out.shape == (w, b) and not out.any()


@pytest.mark.parametrize("offset", [1, 2, 3])
def test_coded_block_matvec_misaligned_enc(cuda, offset):
    """enc (and x) off a 16-byte boundary take the scalar loads."""
    w, b, s = 6, 37, 1024
    g = torch.Generator().manual_seed(offset)
    flat = torch.randn(w * b * s + offset, generator=g).to(cuda)
    enc = flat[offset:].view(w, b, s)
    xs = torch.randn(s + offset, generator=g).to(cuda)
    x = xs[offset:]
    erased = (torch.arange(w) == 4).to(cuda)
    got = ops.coded_block_matvec(enc, x, erased)
    assert _rel_err(got, ref.coded_block_matvec(enc, x, erased)) < REL_TOL
    assert torch.equal(ops.coded_block_matvec(enc, x, erased), got)


@pytest.mark.parametrize("shape", [(0,), (1,), (1000,), (3, 4097),
                                   (1 << 20) + 3,
                                   # the corruption noise at both encodes
                                   (36, 36, 256), (5, 5, 256)])
def test_normal_kernel_is_the_plain_version_bit_for_bit(cuda, shape):
    key = prng.fold_in(prng.PRNGKey(5), 3)
    got = ops.normal(key, shape, cuda)
    want = prng.normal_plain(key, shape, cuda)
    assert got.shape == want.shape
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(got.cpu().view(torch.int32),
                       prng.normal_plain(key, shape, "cpu").view(torch.int32))
    assert torch.equal(ops.normal(key, shape).view(torch.int32),
                       got.view(torch.int32))


def test_normal_table_is_the_computed_form_on_every_mantissa(cuda):
    """The table kernel's 2^23 draws equal the plain version's steps, on
    the card and on the CPU, and the cached table is that table."""
    from repro_torch.kernels import normal
    got = normal.build_table(cuda)
    assert got.shape == (normal.TABLE_SIZE,)
    want = normal.table_plain(cuda)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(got.cpu().view(torch.int32),
                       normal.table_plain("cpu").view(torch.int32))
    assert torch.equal(normal.table(cuda).view(torch.int32),
                       got.view(torch.int32))


DRAW_SHAPES = [(0,), (1,), (1000,), (3, 4097), ((1 << 20) + 3,)]


def _same(got, want):
    """Equal dtype, shape and bits."""
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype == torch.float32:
        got, want = got.view(torch.int32), want.view(torch.int32)
    assert torch.equal(got.cpu(), want.cpu())


@pytest.mark.parametrize("shape", DRAW_SHAPES)
def test_draw_kernel_is_the_plain_version_bit_for_bit(cuda, shape):
    """Each draw of the kernel against prng's plain draw on the card and on
    the CPU."""
    key = prng.fold_in(prng.PRNGKey(6), 2)
    for entry, plain, args in (
            (ops.randint, prng.randint, (0, 256)),
            (ops.randint, prng.randint, (-3, 300_000)),
            (ops.rademacher, prng.rademacher, ()),
            (ops.uniform, prng.uniform, ()),
            (ops.uniform, prng.uniform, (-1.0, 1.0)),
            (ops.uniform, prng.uniform, (prng.NORMAL_LO, 1.0)),
            (ops.uniform, prng.uniform, (prng.GUMBEL_MINVAL, 1.0)),
            (ops.bernoulli, prng.bernoulli, ())):
        if entry is ops.bernoulli:
            got = entry(key, 0.3, shape, device=cuda)
            wants = [plain(key, 0.3, shape, device=d) for d in (cuda, "cpu")]
        else:
            got = entry(key, shape, *args, device=cuda)
            wants = [plain(key, shape, *args, device=d) for d in (cuda, "cpu")]
        assert got.is_cuda
        for want in wants:
            _same(got, want)


@pytest.mark.parametrize("shape", DRAW_SHAPES)
def test_gumbel_is_the_plain_draw_bit_for_bit(cuda, shape):
    """ops.gumbel on the card (the draw kernel's uniform on [tiny, 1),
    then two float32 logs) against prng.gumbel on the card and the CPU."""
    key = prng.fold_in(prng.PRNGKey(8), 3)
    launches = ops.launch_counts()["draw"]
    got = ops.gumbel(key, shape, device=cuda)
    assert got.is_cuda
    assert ops.launch_counts()["draw"] == launches + (math.prod(shape) > 0)
    for device in (cuda, "cpu"):
        _same(got, prng.gumbel(key, shape, device=device))


# (logits' shape, axis, shape): the dataset's labels (rows, K) along the
# last axis, K = 1, another axis, and leading dimensions of draws.
@pytest.mark.parametrize("logits_shape,axis,shape", [
    ((1000, 10), -1, None), ((180_001, 10), -1, None), ((7, 1), -1, None),
    ((10, 301), 0, None), ((3, 5, 4), 1, (2, 3, 4)), ((6,), -1, (4, 5))])
def test_categorical_is_the_plain_draw_bit_for_bit(cuda, logits_shape, axis,
                                                   shape):
    """ops.categorical on the card against prng.categorical on the same
    logits, on the card and on the CPU: the Gumbel draws are the same bits,
    so the argmax is too."""
    key = prng.fold_in(prng.PRNGKey(9), logits_shape[-1])
    logits = torch.from_numpy(np.random.default_rng(len(logits_shape)).normal(
        size=logits_shape).astype(np.float32) * 3)
    got = ops.categorical(key, logits.to(cuda), axis, shape)
    assert got.is_cuda and got.dtype == torch.int32
    for device in (cuda, "cpu"):
        want = prng.categorical(key, logits.to(device), axis, shape)
        _same(got, want)


def test_draw_counters_past_two_to_the_32(cuda):
    """The kernel hashes the 64-bit counter: words across 2^32 are
    prng._bits' at the same first counter."""
    from repro_torch.kernels import draw
    key = prng.PRNGKey(12)
    for start in ((1 << 32) - 5, (1 << 33) + 7, 0):
        got = draw.bits(key, start, 5000, device=cuda)
        want = prng._bits(key, start, 5000, cuda)
        assert torch.equal(got.long() & prng.M32, want)
        _same(got, draw.bits(key, start, 5000, device="cpu"))


@pytest.mark.parametrize("span", [1, 256, 300_000, 1 << 19, (1 << 31) - 1])
def test_draw_randint_at_every_span(cuda, span):
    """Spans of the paths (256, 300,000, 2^19), one and the largest, from a
    negative lower end; an empty range gives its lower end."""
    key = prng.PRNGKey(span % 1000)
    lo = -5
    got = ops.randint(key, (7, 3001), lo, lo + span, device=cuda)
    _same(got, prng.randint(key, (7, 3001), lo, lo + span, device=cuda))
    _same(got, prng.randint(key, (7, 3001), lo, lo + span, device="cpu"))
    assert int(got.min()) >= lo and int(got.max()) < lo + span
    empty = ops.randint(key, (100,), lo, lo - 1, device=cuda)
    _same(empty, prng.randint(key, (100,), lo, lo - 1, device="cpu"))
    assert bool((empty == lo).all())


def test_draw_refuses_what_it_does_not_draw(cuda):
    with pytest.raises(TypeError, match="float32"):
        ops.rademacher(prng.PRNGKey(0), (3,), dtype=torch.float64,
                       device=cuda)
    with pytest.raises(ValueError, match="int32"):
        ops.randint(prng.PRNGKey(0), (3,), 0, 1 << 31, device=cuda)


@pytest.mark.parametrize("family", ["gaussian", "nystrom", "leverage"])
@pytest.mark.parametrize("mask", MASKS)
def test_unfused_family_grams(cuda, family, mask):
    """A_tilde from the family's apply on the card, then the masked-Gram
    kernel, against the plain Gram of the same A_tilde."""
    from repro_torch import sketching
    from repro_torch.core import OverSketchConfig
    cfg = OverSketchConfig(256, 64, 0.25)
    fam = sketching.get(family, cfg)
    a = torch.randn(3000, 45, generator=torch.Generator().manual_seed(1)).to(cuda)
    state = fam.sample(prng.PRNGKey(4), 3000, device=cuda)
    m = _mask(mask, cfg.total_blocks, cuda)
    ops.reset_launch_counts()
    got = fam.gram(state, a, m, use_kernels=True)
    assert ops.launch_counts()["oversketch_gram"] == 1
    assert ops.launch_counts()["normal"] == (
        cfg.total_blocks if family == "gaussian" else 0)
    if mask == "none":
        assert not got.any()
        return
    want = ref.oversketch_gram(fam.apply(state, a), m)
    assert _rel_err(got, want) < REL_TOL
    torch.testing.assert_close(got, got.T, rtol=0, atol=0)


@pytest.mark.parametrize("overrides", [
    dict(),
    dict(sketch_family="sjlt"),
    dict(sketch_family="srht"),
    dict(sketch_mode="distributed-avg", debias=True),
    dict(sketch_mode="distributed-avg", debias=True, sketch_family="sjlt"),
    dict(sketch_mode="distributed-avg", debias=True, sketch_family="srht"),
    dict(sketch_family="gaussian"),
    dict(sketch_family="nystrom"),
    dict(sketch_family="leverage"),
    dict(gradient_policy="wait_all"),
])
def test_newton_on_the_card_matches_the_plain_path(cuda, overrides):
    from repro_torch.core import (LogisticRegression, NewtonConfig,
                                  OverSketchConfig, oversketched_newton)
    from repro_torch.data import make_logistic_dataset
    data = make_logistic_dataset(prng.PRNGKey(0), 1000, 20, 200,
                                 device="cpu")
    cfg = dict(iters=4, sketch=OverSketchConfig(512, 64, 0.25),
               coded_block_rows=128, track_test_error=True, **overrides)
    card = oversketched_newton(LogisticRegression(lam=1e-4), data,
                               np.zeros(20, np.float32),
                               NewtonConfig(use_kernels=True, **cfg))
    plain = oversketched_newton(LogisticRegression(lam=1e-4), data,
                                np.zeros(20, np.float32),
                                NewtonConfig(use_kernels=False, **cfg),
                                device="cpu")
    assert card.w.is_cuda
    assert card.history["step"] == plain.history["step"]
    np.testing.assert_allclose(card.history["fval"], plain.history["fval"],
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(card.w.cpu().numpy(), plain.w.numpy(),
                               rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(card.history["time"], plain.history["time"],
                               rtol=1e-12)


def test_softmax_newton_on_the_card_matches_the_plain_path(cuda):
    """Softmax regression at its CPU parity test's size (fig. 9's sketch
    rule, pinv, the weakly convex line search): the card's run with the
    kernels against the plain path on the CPU."""
    from repro_torch.core import (NewtonConfig, OverSketchConfig,
                                  SoftmaxRegression, oversketched_newton)
    from repro_torch.data import make_softmax_dataset
    data = make_softmax_dataset(prng.PRNGKey(3), 600, 12, 4, 100,
                                device="cpu")
    cfg = dict(iters=4, sketch=OverSketchConfig(512, 256, 0.25),
               solver="pinv", unit_step=False, coded_block_rows=256,
               track_test_error=True)
    card = oversketched_newton(SoftmaxRegression(4), data,
                               np.zeros(48, np.float32),
                               NewtonConfig(use_kernels=True, **cfg))
    plain = oversketched_newton(SoftmaxRegression(4), data,
                                np.zeros(48, np.float32),
                                NewtonConfig(use_kernels=False, **cfg),
                                device="cpu")
    assert card.w.is_cuda
    assert card.history["step"] == plain.history["step"]
    np.testing.assert_allclose(card.history["fval"], plain.history["fval"],
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(card.history["time"], plain.history["time"],
                               rtol=1e-12)


@pytest.mark.parametrize("count", [1, 1200, 60_000, (1 << 20) + 3])
def test_bits_mode_is_the_plain_bits(cuda, count):
    """ops.bits, the draw kernel's raw-bits mode (prng.permutation's sort
    keys), against prng._bits' words on the card and on the CPU."""
    key = prng.fold_in(prng.PRNGKey(13), count)
    ops.reset_launch_counts()
    got = ops.bits(key, 0, count, device=cuda)
    assert ops.launch_counts()["draw"] == 1
    assert got.is_cuda and got.dtype == torch.int32
    for device in (cuda, "cpu"):
        want = prng._bits(key, 0, count, device)
        assert torch.equal((got.long() & prng.M32).cpu(), want.cpu())
        _same(got, ops.bits(key, 0, count, device="cpu"))


@pytest.mark.parametrize("n,rounds", [(1, 0), (2, 1), (1200, 1),
                                      (65_537, 2), (300_000, 2)])
def test_permutation_on_the_card_is_the_plain_permutation(cuda, n, rounds):
    """jax's shuffle with its sort keys from the draw kernel: the CPU's
    permutation, one bits launch a sort round."""
    key = prng.PRNGKey(n % 97)
    ops.reset_launch_counts()
    got = prng.permutation(key, n, device=cuda)
    assert ops.launch_counts()["draw"] == rounds
    assert got.is_cuda
    _same(got, prng.permutation(key, n, device="cpu"))


OPTIMIZERS = [("giant", dict(policy="wait_all")),
              ("giant", dict(policy="gcode", schedule="sequential")),
              ("giant", dict(policy="ignore", unit_step=False)),
              ("first_order", dict(method="gd")),
              ("first_order", dict(method="nag", policy="wait_all")),
              ("first_order", dict(method="sgd", policy="gcode")),
              ("exact_newton", dict())]


@pytest.mark.parametrize("name,overrides", OPTIMIZERS)
def test_optimizer_on_the_card_matches_its_cpu_history(cuda, name,
                                                       overrides):
    """Each baseline optimizer at its CPU parity test's size (n = 1,200,
    d = 20): simulated time and cost and the steps equal, fval and gnorm
    within rtol 1e-4 of the CPU run's."""
    from repro_torch import optim
    from repro_torch.core import LogisticRegression
    from repro_torch.data import make_logistic_dataset
    data = make_logistic_dataset(prng.PRNGKey(0), 1200, 20, 200,
                                 device="cpu")
    w0 = np.zeros(20, np.float32)

    def run(device):
        obj = LogisticRegression(lam=1e-4)
        if name == "giant":
            return optim.giant(obj, data, w0, optim.GiantConfig(
                iters=4, num_workers=24, **overrides), device=device)
        if name == "first_order":
            return optim.first_order(obj, data, w0, optim.FirstOrderConfig(
                iters=6, **overrides), device=device)
        return optim.exact_newton(obj, data, w0, iters=4, device=device)
    card, cpu = run(cuda), run("cpu")
    assert card["w"].is_cuda
    for k in ("iter", "step", "time", "cost"):
        assert card[k] == cpu[k], k
    for k in ("fval", "gnorm"):
        np.testing.assert_allclose(card[k], cpu[k], rtol=1e-4, atol=1e-6)


def _corruption_engine(device, rows=1200, d=20, block_rows=64):
    from repro_torch.core import StragglerModel
    from repro_torch.core.newton import CodedMatvecEngine
    from repro_torch.data import make_logistic_dataset
    data = make_logistic_dataset(prng.PRNGKey(0), rows, d, 10, device=device)
    return CodedMatvecEngine(data, block_rows, StragglerModel())


@pytest.mark.parametrize("detection", [True, False])
@pytest.mark.parametrize("tag", ["X", "XT"])
def test_corrupted_decode_on_the_card_matches_the_cpu(cuda, tag, detection):
    """The master's rebuild of what it received (clean products, seeded
    noise at the corrupted cells: the normal kernel on the card) and its
    verified or blind decode: the same flags, verdict and latch as the
    CPU's, y within REL_TOL."""
    out = {}
    for device in (cuda, "cpu"):
        eng = _corruption_engine(device)
        eng.corruption_detection = detection
        code = eng.code_for(tag)
        g1 = code.grid + 1
        rng = np.random.default_rng(g1)
        arrived = rng.random(g1 * g1) < 0.9
        corrupt = arrived & (rng.random(g1 * g1) < 0.1)
        v = torch.randn(eng.enc_x.shape[-1] if tag == "X"
                        else eng.enc_xt.shape[-1],
                        generator=torch.Generator().manual_seed(1)).to(device)
        y, ok = eng._corrupted_decode(tag, v, prng.PRNGKey(9), None, corrupt,
                                      arrived)
        out[str(device)] = (y.cpu(), bool(ok), eng.paranoid)
    (yc, okc, pc), (yp, okp, pp) = out[str(cuda)], out["cpu"]
    assert (okc, pc) == (okp, pp)
    assert _rel_err(yc, yp) < REL_TOL


def test_parity_margin_on_the_card(cuda):
    """Clean lines' relative residual sits far under the detector's 1e-3."""
    from repro_torch.core import coded
    from repro_torch.kernels.coded_matvec import parity_residuals
    eng = _corruption_engine(cuda, rows=20_000, d=300)
    v = torch.randn(300, generator=torch.Generator().manual_seed(2)).to(cuda)
    prods = coded.coded_block_products(eng.enc_x, v)
    known = torch.ones(prods.shape[:2], dtype=torch.bool, device=cuda)
    rr, rm, cr, cm = parity_residuals(prods, known)
    assert float(torch.max(torch.cat([rr / rm, cr / cm]))) < 1e-5
    assert not coded.detect_corrupted(prods, known, eng.code_x).any()


@pytest.mark.parametrize("mode", ["corruption", "blind", "adaptive_mp",
                                  "adaptive_stall", "telemetry"])
def test_newton_modes_on_the_card_match_the_cpu(cuda, mode):
    """Corruption (detection on and off), adaptive growth and live
    telemetry at the CPU parity tests' size (n = 1,000, d = 20): the
    card's run against the CPU's, both through the kernel entry points
    (the plain versions on the CPU).  Time, cost, steps, sketch_dim and
    every telemetry row equal; fval within rtol 1e-4."""
    from repro_torch import obs
    from repro_torch.core import (LogisticRegression, NewtonConfig,
                                  OverSketchConfig, SimClock, StragglerModel,
                                  oversketched_newton)
    from repro_torch.data import make_logistic_dataset
    from repro_torch.runtime import get_scenario
    data = make_logistic_dataset(prng.PRNGKey(0), 1000, 20, 200,
                                 device="cpu")
    cfg = dict(iters=4, sketch=OverSketchConfig(512, 64, 0.25),
               coded_block_rows=64, use_kernels=True)
    if mode == "blind":
        cfg["corruption_detection"] = False
    if mode == "adaptive_mp":
        cfg.update(sketch=OverSketchConfig(64, 16, 0.25),
                   adaptive_sketch=True, adaptive_metric="mp")
    if mode == "adaptive_stall":
        cfg["adaptive_sketch"] = True

    def run(device):
        tel = obs.Telemetry(monitors=True) if mode == "telemetry" else None
        faults = (get_scenario("corruption", prob=0.3)
                  if mode in ("corruption", "blind") else None)
        clock = SimClock(StragglerModel(), faults=faults, telemetry=tel)
        res = oversketched_newton(LogisticRegression(lam=1e-4), data,
                                  np.zeros(20, np.float32),
                                  NewtonConfig(**cfg), clock, device=device)
        return res.history, tel
    (card, ctel), (plain, ptel) = run(cuda), run("cpu")
    for k in ("step", "time", "cost", "sketch_dim"):
        assert card[k] == plain[k], k
    np.testing.assert_allclose(card["fval"], plain["fval"], rtol=1e-4,
                               atol=1e-6)
    if mode == "adaptive_mp":
        assert card["sketch_dim"][-1] > card["sketch_dim"][0]
    if ctel is not None:
        assert obs.telemetry_rows(ctel) == obs.telemetry_rows(ptel)


def test_ops_profiler_on_cuda_tensors(cuda):
    from repro_torch import obs
    g = torch.Generator().manual_seed(4)
    enc = torch.randn(9, 16, 700, generator=g).to(cuda)
    x = torch.randn(700, generator=g).to(cuda)
    erased = torch.zeros(9, dtype=torch.bool, device=cuda)
    reg = obs.MetricsRegistry()
    ops.reset_launch_counts()
    ops.set_profiler(reg)
    try:
        got = ops.coded_block_matvec(enc, x, erased)
        ops.fwht(torch.randn(1, 1024, 8, generator=g).to(cuda))
    finally:
        ops.set_profiler(None)
    snap = reg.snapshot()
    assert snap["counters"] == {"kernel.coded_block_matvec.calls": 1.0,
                                "kernel.fwht.calls": 1.0}
    assert snap["histograms"]["kernel.coded_block_matvec.us"]["max"] > 0
    assert ops.launch_counts()["coded_block_matvec"] == 1
    assert torch.equal(got, ops.coded_block_matvec(enc, x, erased))


# ----------------------------------------------------- the dense model family
def _smoke(dtype):
    from repro_torch.configs import smoke_config
    from repro_torch.models import ModelBundle
    cfg = smoke_config("qwen3-4b").scaled(dtype=dtype)
    return cfg, ModelBundle(cfg)


@pytest.mark.parametrize("shape", [(5,), (1000, 7), (36, 64, 33)])
def test_normal_bf16_mode_is_the_plain_draw_bit_for_bit(cuda, shape):
    key = prng.PRNGKey(sum(shape))
    ops.reset_launch_counts()
    got = ops.normal(key, shape, cuda, dtype=torch.bfloat16)
    assert ops.launch_counts()["normal"] == 1
    want = prng.normal_bf16_plain(key, shape, "cpu")
    assert torch.equal(got.cpu().view(torch.int16), want.view(torch.int16))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_init_on_the_card_is_the_cpu_init(cuda, dtype):
    """One normal launch per drawn leaf, the CPU's bits."""
    from repro_torch.models.common import flatten
    cfg, bundle = _smoke(dtype)
    ops.reset_launch_counts()
    card = bundle.init(prng.PRNGKey(0), device=cuda)
    drawn = sum(1 for _, s in flatten(bundle.specs()) if s.init == "normal")
    assert ops.launch_counts()["normal"] == drawn
    cpu = bundle.init(prng.PRNGKey(0), device="cpu")
    for (name, a), (_, b) in zip(card.state_dict().items(),
                                 cpu.state_dict().items()):
        assert torch.equal(a.cpu(), b), name


# float32 products on the card sum in other orders than the CPU's; bfloat16
# rounds every operation, as the CPU parity tests state.
MODEL_TOL = {"float32": 1e-4, "bfloat16": 3e-2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_on_the_card_matches_the_cpu(cuda, dtype):
    from repro_torch.launch.serve import BatchedServer
    from repro_torch.models import transformer
    cfg, bundle = _smoke(dtype)
    cpu = bundle.init(prng.PRNGKey(0), device="cpu")
    card = bundle.init(prng.PRNGKey(0), device=cuda)
    rs = np.random.RandomState(0)
    toks = torch.from_numpy(rs.randint(1, cfg.vocab_size - 1, (2, 40)))
    want = transformer.forward(cfg, cpu, toks)[0][:, -1].float()
    got = transformer.forward(cfg, card, toks.to(cuda))[0][:, -1].float()
    assert _rel_err(got.cpu(), want) <= MODEL_TOL[dtype]
    if dtype == "float32":
        prompts = [rs.randint(1, cfg.vocab_size - 1, rs.randint(4, 16))
                   for _ in range(6)]
        outs = [BatchedServer(bundle, p, batch=4, max_seq=64).generate(
            prompts, max_new=8) for p in (cpu, card)]
        assert outs[0] == outs[1]


def test_decode_matches_forward_on_the_card(cuda):
    from repro_torch.models import transformer
    cfg, bundle = _smoke("float32")
    params = bundle.init(prng.PRNGKey(1), device=cuda)
    toks = torch.from_numpy(np.random.RandomState(2).randint(
        1, cfg.vocab_size - 1, (2, 24))).to(cuda)
    full = transformer.forward(cfg, params, toks)[0][:, -1]
    cache = bundle.init_cache(2, 64, device=cuda)
    _, cache = bundle.prefill(params, toks[:, :23], cache)
    dec, cache = bundle.decode(params, cache, toks[:, 23])
    assert cache["pos"] == 24
    assert _rel_err(dec, full) <= 1e-4


def test_normal_bf16_counters_past_two_to_the_32(cuda):
    """A bfloat16 draw of 2^32 + 4,096 elements (the MoE's expert leaves
    hold 9.7e9): the words around 2^32 and at the end are the plain
    draw's at the same counters."""
    key = prng.PRNGKey(21)
    size = (1 << 32) + 4096
    got = ops.normal(key, (size,), cuda, dtype=torch.bfloat16)
    for start in (0, (1 << 32) - 2048, size - 4096):
        want = prng.normal_window(key, (size,), ((start, 4096),),
                                  torch.bfloat16, cuda)
        assert torch.equal(got[start:start + 4096].view(torch.int16),
                           want.view(torch.int16))
    del got
    torch.cuda.empty_cache()


# Boxes of the window mode: split on dims 1 and 3 (the MoE expert leaves'
# layout), past counter 2^32 (the 235B expert leaf, 7.57e10 draws), and a
# whole leaf.
WINDOW_CASES = [((8, 128, 64, 96), ((0, 8), (32, 32), (0, 64), (48, 48))),
                ((94, 128, 4096, 1536),
                 ((93, 1), (96, 32), (0, 2048), (1152, 384))),
                ((3, 5, 700), ((0, 3), (0, 5), (0, 700)))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,box", WINDOW_CASES)
def test_normal_window_mode_is_the_plain_window(cuda, shape, box, dtype):
    """The window mode against ``prng.normal_window`` on the card, every
    bit, one launch; a whole box equals the whole draw's launch."""
    key = prng.PRNGKey(9)
    ops.reset_launch_counts()
    got = ops.normal_window(key, shape, box, cuda, dtype=dtype)
    assert ops.launch_counts()["normal_window"] == 1
    want = prng.normal_window(key, shape, box, dtype, cuda)
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    assert torch.equal(got.view(bits), want.view(bits))
    if all(s == 0 and n == d for (s, n), d in zip(box, shape)):
        assert torch.equal(got.view(bits), ops.normal(
            key, shape, cuda, dtype=dtype).view(bits))


# ------------------------------------ the MoE, SSM, hybrid, encdec families
FAMILIES = ["qwen3-moe-30b-a3b", "mamba2-780m", "recurrentgemma-2b",
            "whisper-large-v3"]


def _family_run(cfg, bundle, params, device, toks, frames):
    """(forward's last logits, prefill's logits, 4 decode steps' logits,
    the cache) of one model on one device."""
    from repro_torch.models import encdec, transformer
    toks = toks.to(device)
    extra = None if frames is None else frames.to(device)
    if cfg.family == "encdec":
        full = encdec.forward(cfg, params, toks, extra)[0][:, -1]
    else:
        full = transformer.forward(cfg, params, toks)[0][:, -1]
    cache = bundle.init_cache(2, 64, device=device)
    s = toks.shape[1] - 4
    first, cache = bundle.prefill(params, toks[:, :s], cache, extra)
    steps = []
    for i in range(s, toks.shape[1]):
        logits, cache = bundle.decode(params, cache, toks[:, i])
        steps.append(logits)
    return full, first, steps, cache


def _cache_tensors(cache, prefix=""):
    for name, t in sorted(cache.items()):
        if isinstance(t, dict):
            yield from _cache_tensors(t, f"{prefix}{name}/")
        elif name != "pos":
            yield prefix + name, t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_family_on_the_card_matches_the_cpu(cuda, arch, dtype):
    """Smoke width: the init's bits (one normal launch per drawn leaf),
    forward, prefill, 4 decode steps and every cache leaf of the card
    against the CPU; at float32 the server's tokens equal (the
    encoder-decoder has no server: the reference's passes no frames)."""
    from repro_torch.configs import smoke_config
    from repro_torch.launch.serve import BatchedServer
    from repro_torch.models import ModelBundle
    from repro_torch.models.common import flatten
    cfg = smoke_config(arch).scaled(dtype=dtype)
    bundle = ModelBundle(cfg)
    ops.reset_launch_counts()
    card = bundle.init(prng.PRNGKey(0), device=cuda)
    drawn = sum(1 for _, s in flatten(bundle.specs()) if s.init == "normal")
    assert ops.launch_counts()["normal"] == drawn
    cpu = bundle.init(prng.PRNGKey(0), device="cpu")
    for (name, a), (_, b) in zip(card.state_dict().items(),
                                 cpu.state_dict().items()):
        assert torch.equal(a.cpu(), b), name
    rs = np.random.RandomState(0)
    toks = torch.from_numpy(rs.randint(1, cfg.vocab_size - 1, (2, 40)))
    frames = None
    if cfg.family == "encdec":
        frames = torch.from_numpy(rs.standard_normal(
            (2, cfg.encoder_seq, cfg.d_model)).astype(np.float32)).to(
                cfg.compute_dtype)
    got = _family_run(cfg, bundle, card, cuda, toks, frames)
    want = _family_run(cfg, bundle, cpu, "cpu", toks, frames)
    tol = MODEL_TOL[dtype]
    for g, w in zip([got[0], got[1]] + got[2], [want[0], want[1]] + want[2]):
        assert _rel_err(g.float().cpu(), w.float()) <= tol
    assert got[3]["pos"] == want[3]["pos"] == 40
    for (name, g), (_, w) in zip(_cache_tensors(got[3]),
                                 _cache_tensors(want[3])):
        assert _rel_err(g.float().cpu(), w.float()) <= tol, name
    if dtype == "float32" and cfg.family != "encdec":
        prompts = [rs.randint(1, cfg.vocab_size - 1, rs.randint(4, 16))
                   for _ in range(6)]
        outs = [BatchedServer(bundle, p, batch=4, max_seq=64).generate(
            prompts, max_new=8) for p in (cpu, card)]
        assert outs[0] == outs[1]


def test_moe_routing_on_the_card_is_the_cpus(cuda):
    """The MoE's top-k (ties to the lower expert) and capacity positions
    from the same probabilities, on probabilities with many ties: the
    card's stable sorts and scatters give the CPU's, and drops occur."""
    from repro_torch.models import moe
    g = torch.Generator().manual_seed(0)
    probs = torch.randint(0, 6, (12, 256, 128), generator=g).float() / 6
    out = []
    for device in (cuda, "cpu"):
        _, expert = moe.top_k(probs.to(device), 8)
        pos, counts = moe.slot_positions(expert.reshape(12, -1), 128)
        out.append((expert.cpu(), pos.cpu(), counts.cpu()))
    for a, b in zip(*out):
        assert torch.equal(a, b)
    assert int((out[1][1] >= moe._capacity(256, _moe_cfg())).sum()) > 0


def _moe_cfg():
    from repro_torch.models import get_config
    return get_config("qwen3-moe-30b-a3b")


def test_osn_head_with_the_fused_kernel_matches_the_cpu(cuda):
    """train_osn_head with use_kernels=True on the card: the fused Gram
    once and the coded mat-vec 2 K times an iteration; the CPU's history
    (time and cost bit for bit, fval rtol 1e-4)."""
    from repro_torch.training import extract_features, train_osn_head
    cfg, bundle = _smoke("float32")
    params = bundle.init(prng.PRNGKey(0), device="cpu")
    rs = np.random.RandomState(0)
    k, n = 4, 512
    labels = rs.randint(0, k, n)
    toks = torch.from_numpy(rs.randint(1, cfg.vocab_size // k - 1, (n, 16)) +
                            labels[:, None] * (cfg.vocab_size // k))
    feats = extract_features(bundle, params, toks)
    onehot = prng.one_hot(torch.from_numpy(labels), k)
    ops.reset_launch_counts()
    _, card = train_osn_head(feats.to(cuda), onehot.to(cuda), num_classes=k,
                             iters=3, use_kernels=True)
    counts = ops.launch_counts()
    assert counts["sketch_gram_count"] == 3
    assert counts["coded_block_matvec"] == 2 * k * 3
    _, plain = train_osn_head(feats, onehot, num_classes=k, iters=3,
                              use_kernels=True)
    assert card["time"] == plain["time"] and card["cost"] == plain["cost"]
    np.testing.assert_allclose(card["fval"], plain["fval"], rtol=1e-4)


# ------------------------------------------------------------ training ----
def test_embed_lookup_backward_on_the_card(cuda):
    """The one-hot backward on the card against the CPU's (float32 within
    1e-6 of max |CPU|, bfloat16 within 1e-2), and the card's twice, bit
    for bit: no atomics."""
    from repro_torch.models import common
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, 64, (3, 700), generator=g)
    for dtype, tol in ((torch.float32, 1e-6), (torch.bfloat16, 1e-2)):
        grad = torch.randn(3, 700, 32, generator=g).to(dtype)
        want = common.embed_grad(toks, grad, 300, dtype)
        got = common.embed_grad(toks.to(cuda), grad.to(cuda), 300, dtype)
        assert torch.equal(got, common.embed_grad(toks.to(cuda),
                                                  grad.to(cuda), 300, dtype))
        assert _rel_err(got.float().cpu(), want.float()) <= tol


@pytest.mark.parametrize("tied", [False, True])
def test_chunked_cross_entropy_on_the_card(cuda, tied):
    """Value and gradients with chunk < S on the card against the CPU,
    within 1e-5 of max |CPU|."""
    from repro_torch.models import common
    g = torch.Generator().manual_seed(2)
    h = torch.randn(2, 40, 16, generator=g)
    head = torch.randn(*((50, 16) if tied else (16, 50)), generator=g)
    labels = torch.randint(0, 50, (2, 40), generator=g)
    labels[0, 5] = -1
    out = []
    for device in ("cpu", cuda):
        hh = h.detach().to(device).requires_grad_(True)
        hd = head.detach().to(device).requires_grad_(True)
        loss = common.chunked_cross_entropy(hh, hd, labels.to(device),
                                            transpose_head=tied, chunk=16)
        loss.backward()
        out.append((loss.detach().cpu(), hh.grad.cpu(), hd.grad.cpu()))
    for got, want in zip(out[1], out[0]):
        assert _rel_err(got.reshape(-1), want.reshape(-1)) <= 1e-5


def test_adamw_bf16_step_on_the_card_is_the_cpus(cuda):
    """One bf16 AdamW step (unclipped) on the card and on the CPU from one
    state: parameters and moments bit for bit; a clipped step (the scale
    from the card's own norm) within one bf16 ulp."""
    from repro_torch.optim import adamw
    g = torch.Generator().manual_seed(3)

    def tree(scale, dtype=torch.bfloat16):
        return {"a": (torch.randn(40, 16, generator=g) * scale).to(dtype),
                "b": {"c": (torch.randn(3, 7, 9, generator=g) * scale
                            ).to(dtype)}}
    params, mu = tree(1.0), tree(0.01)
    nu = {k: v for k, v in tree(1e-2, torch.float32).items()}
    nu = {"a": nu["a"].abs(), "b": {"c": nu["b"]["c"].abs()}}
    cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10)

    def to(t, device):
        """A copy on ``device`` (apply updates its inputs in place)."""
        if isinstance(t, dict):
            return {k: to(v, device) for k, v in t.items()}
        return t.clone().to(device)
    for scale, exact in ((0.01, True), (5.0, False)):
        grads = tree(scale)
        out = []
        for device in ("cpu", cuda):
            st = adamw.AdamWState(torch.tensor(3, dtype=torch.int32),
                                  to(mu, device), to(nu, device))
            p, st = adamw.apply(cfg, to(grads, device), st,
                                to(params, device))
            out.append([t.cpu() for _, t in common_flat((p, st.mu,
                                                         st.nu))])
        for a, b in zip(*out):
            if exact:
                assert torch.equal(a, b)
            elif a.dtype == torch.bfloat16:
                diff = (a.view(torch.int16).long() -
                        b.view(torch.int16).long()).abs()
                assert int(diff.max()) <= 1
            else:
                assert _rel_err(b, a) <= 1e-5


def common_flat(trees):
    from repro_torch.models import common
    return [pair for t in trees for pair in common.flatten(t)]


def test_trainer_on_the_card_is_deterministic(cuda):
    """Three float32 trainer steps at smoke width on the card, twice: the
    losses and norms bit for bit; and within 1e-4 of the CPU's."""
    from repro_torch import configs
    from repro_torch.training import trainer as tr
    base = configs.smoke_config
    configs.smoke_config = lambda name: base(name).scaled(dtype="float32")
    try:
        runs = []
        for device in (cuda, cuda, "cpu"):
            t = tr.Trainer(tr.TrainerConfig(arch="qwen3-4b", steps=3,
                                            batch=4, seq=64, lr=1e-3),
                           device=device)
            runs.append([(h["loss"], h["grad_norm"])
                         for h in t.run(*t.init_state())[2]])
    finally:
        configs.smoke_config = base
    assert runs[0] == runs[1]
    for (la, ga), (lb, gb) in zip(runs[0], runs[2]):
        assert abs(la - lb) <= 1e-4 * abs(lb)
        assert abs(ga - gb) <= 1e-4 * abs(gb)


@pytest.fixture
def nccl_world_one(cuda, tmp_path):
    """A one-rank NCCL default group on a file store, destroyed after."""
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    yield cuda
    dist.destroy_process_group()


def test_distributed_paths_on_nccl_world_one(nccl_world_one):
    """The three distributed functions on one NCCL rank against their
    local counterparts on the card; the count-sketch and coded mat-vec
    kernels launched once each."""
    from repro_torch.core import coded, linesearch, objectives, sketch
    dev = nccl_world_one
    g = torch.Generator().manual_seed(3)
    a = torch.randn(700, 23, generator=g).to(dev)
    cfg = sketch.OverSketchConfig(256, 32, 0.25)
    cs = sketch.sample_countsketch(prng.PRNGKey(4), 700, cfg, device=dev)
    surv = torch.ones(cfg.total_blocks, dtype=torch.bool, device=dev)
    surv[1] = False
    ops.reset_launch_counts()
    got = sketch.distributed_sketched_gram(a, cs, surv)
    assert ops.launch_counts()["count_sketch_apply"] == 1
    want = sketch.sketched_gram(sketch.apply_sketch(cs, a), surv)
    assert _rel_err(got, want) < REL_TOL
    m = torch.randn(640, 17, generator=g).to(dev)
    v = torch.randn(17, generator=g).to(dev)
    code = coded.make_code(640, 64)
    enc = coded.encode_2d(m, code)
    g1 = code.grid + 1
    erased = torch.zeros(g1 * g1, dtype=torch.bool, device=dev)
    erased[2] = True
    ops.reset_launch_counts()
    y, ok = coded.distributed_coded_matvec(
        enc.view(g1 * g1, 64, 17), v, erased, code, 640)
    assert ops.launch_counts()["coded_block_matvec"] == 1
    y_local, ok_local = coded.coded_matvec(enc, v, code, 640,
                                           erased.view(g1, g1))
    assert bool(ok) and bool(ok_local)
    assert _rel_err(y, y_local) < REL_TOL
    obj = objectives.LogisticRegression()
    data = objectives.Dataset(m, torch.sign(torch.randn(640, generator=g))
                              .to(dev))
    cand = torch.tensor([4.0 ** -i for i in range(6)], device=dev)
    w, p = torch.zeros(17, device=dev), v
    f = linesearch.distributed_f_trials(obj, data, w, p, cand)
    assert _rel_err(f, obj.value(w[None] + cand[:, None] * p[None], data)) \
        < REL_TOL


def test_mesh_trainer_on_nccl_world_one(nccl_world_one):
    """The float32 smoke trainer on a 1 x 1 mesh over NCCL: 3 steps equal
    to the unsharded trainer's on the card, bit for bit."""
    from repro_torch import configs
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.training import trainer as tr
    base = configs.smoke_config
    configs.smoke_config = lambda name: base(name).scaled(dtype="float32")
    try:
        runs = []
        for mesh in (make_mesh((1, 1), ("data", "model")), None):
            t = tr.Trainer(tr.TrainerConfig(arch="qwen3-4b", steps=3,
                                            batch=4, seq=64, lr=1e-3),
                           device=nccl_world_one, mesh=mesh)
            runs.append([(h["loss"], h["grad_norm"])
                         for h in t.run(*t.init_state())[2]])
    finally:
        configs.smoke_config = base
    assert runs[0] == runs[1]
