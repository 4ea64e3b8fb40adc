"""The port's kernel entry points on CPU tensors (their plain versions)
against the JAX package's Pallas kernels in interpret mode, plus the
wrappers' refusal to fall back for tensors off the CPU.  The CUDA kernels
themselves are held against these plain versions on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import _check, ops, ref

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5


def _inputs(seed, k, n, d, b):
    rng = np.random.default_rng(seed)
    h = rng.integers(0, b, (k, n)).astype(np.int32)
    sigma = rng.choice(np.array([-1.0, 1.0], np.float32), (k, n))
    a = rng.standard_normal((n, d)).astype(np.float32)
    return h, sigma, a


CASES = [  # (k, n, d, b, dropped blocks)
    (6, 301, 37, 32, [1, 4]),        # ragged n and d
    (5, 130, 129, 64, []),           # d one past a tile
    (4, 97, 20, 64, [0, 1, 2, 3]),   # every block masked
    (5, 200, 45, 32, [0, 1, 3, 4]),  # a single survivor
]


@pytest.mark.parametrize("k,n,d,b,drop", CASES)
def test_count_sketch_apply_matches_pallas(k, n, d, b, drop):
    h, sigma, a = _inputs(k * n, k, n, d, b)
    want = np.asarray(jops.count_sketch_apply(jnp.asarray(h),
                                              jnp.asarray(sigma),
                                              jnp.asarray(a), b))
    got = ops.count_sketch_apply(torch.from_numpy(h), torch.from_numpy(sigma),
                                 torch.from_numpy(a), b).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("k,n,d,b,drop", CASES)
def test_oversketch_gram_matches_pallas(k, n, d, b, drop):
    rng = np.random.default_rng(k + d)
    a_t = rng.standard_normal((k, b, d)).astype(np.float32)
    m = np.ones(k, bool)
    m[drop] = False
    want = np.asarray(jops.oversketch_gram(jnp.asarray(a_t), jnp.asarray(m)))
    got = ops.oversketch_gram(torch.from_numpy(a_t),
                              torch.from_numpy(m)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("k,n,d,b,drop", CASES)
def test_sketch_gram_count_matches_pallas(k, n, d, b, drop):
    h, sigma, a = _inputs(k + n + d, k, n, d, b)
    m = np.ones(k, bool)
    m[drop] = False
    want = np.asarray(jops.sketch_gram_count(
        jnp.asarray(h), jnp.asarray(sigma), jnp.asarray(a), b,
        jnp.asarray(m)))
    got = ops.sketch_gram_count(torch.from_numpy(h), torch.from_numpy(sigma),
                                torch.from_numpy(a), b,
                                torch.from_numpy(m)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    if not m.any():
        assert not got.any()


def _sjlt_inputs(seed, k, s, n, d, b):
    rng = np.random.default_rng(seed)
    h = rng.integers(0, b, (k, s, n)).astype(np.int32)
    h[:, 1, : n // 4] = h[:, 0, : n // 4]     # layers colliding in a row
    sigma = rng.choice(np.array([-1.0, 1.0], np.float32), (k, s, n))
    a = rng.standard_normal((n, d)).astype(np.float32)
    return h, sigma, a


@pytest.mark.parametrize("k,n,d,b,drop", CASES[:2])
def test_layered_count_sketch_apply_matches_pallas_flattened(k, n, d, b, drop):
    """The layered apply against the reference's SJLT kernel path: the
    Pallas count sketch over K s flattened blocks, summed, / sqrt(s)."""
    s = 4
    h, sigma, a = _sjlt_inputs(k + n, k, s, n, d, b)
    flat = jops.count_sketch_apply(jnp.asarray(h.reshape(k * s, n)),
                                   jnp.asarray(sigma.reshape(k * s, n)),
                                   jnp.asarray(a), b)
    want = np.asarray(flat.reshape(k, s, b, d).sum(axis=1) / jnp.sqrt(4.0))
    got = ops.count_sketch_apply(torch.from_numpy(h), torch.from_numpy(sigma),
                                 torch.from_numpy(a), b).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _srht_inputs(seed, k, n, d, b):
    rng = np.random.default_rng(seed)
    n_pad = 1 << max(0, (n - 1).bit_length())
    rows = rng.integers(0, n_pad, (k, b)).astype(np.int32)
    sigma = rng.choice(np.array([-1.0, 1.0], np.float32), (k, n))
    a = rng.standard_normal((n, d)).astype(np.float32)
    return rows, sigma, a


def _mask(k, drop):
    m = np.ones(k, bool)
    m[drop] = False
    return m


@pytest.mark.parametrize("k,n,d,b,drop", CASES)
def test_sketch_gram_sjlt_matches_pallas(k, n, d, b, drop):
    h, sigma, a = _sjlt_inputs(k * d, k, 3, n, d, b)
    m = _mask(k, drop)
    want = np.asarray(jops.sketch_gram_sjlt(
        jnp.asarray(h), jnp.asarray(sigma), jnp.asarray(a), b,
        jnp.asarray(m)))
    got = ops.sketch_gram_sjlt(torch.from_numpy(h), torch.from_numpy(sigma),
                               torch.from_numpy(a), b,
                               torch.from_numpy(m)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    if not m.any():
        assert not got.any()


@pytest.mark.parametrize("k,n,d,b,drop", CASES)
def test_sketch_gram_srht_matches_pallas(k, n, d, b, drop):
    rows, sigma, a = _srht_inputs(k + 2 * n, k, n, d, b)
    m = _mask(k, drop)
    want = np.asarray(jops.sketch_gram_srht(
        jnp.asarray(rows), jnp.asarray(sigma), jnp.asarray(a),
        jnp.asarray(m)))
    got = ops.sketch_gram_srht(torch.from_numpy(rows), torch.from_numpy(sigma),
                               torch.from_numpy(a),
                               torch.from_numpy(m)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    if not m.any():
        assert not got.any()


FWHT_CASES = [(2, 64, 37), (1, 256, 129), (3, 1, 5), (1, 1024, 20)]


@pytest.mark.parametrize("k,n,d", FWHT_CASES)
@pytest.mark.parametrize("form", ["fwht", "fwht_two_pass"])
def test_fwht_matches_pallas(k, n, d, form):
    x = np.random.default_rng(n + d).standard_normal((k, n, d)).astype(
        np.float32)
    want = np.asarray(getattr(jops, form)(jnp.asarray(x)))
    got = getattr(ops, form)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_fwht_refuses_a_length_not_a_power_of_two():
    with pytest.raises(ValueError, match="power of two"):
        ops.fwht(torch.zeros((1, 100, 4)))


@pytest.mark.parametrize("k,n,d,b,drop", CASES[:2])
def test_sjlt_and_srht_apply_match_reference(k, n, d, b, drop):
    h, sigma, a = _sjlt_inputs(n, k, 4, n, d, b)
    np.testing.assert_allclose(
        ref.sjlt_apply(torch.from_numpy(h), torch.from_numpy(sigma),
                       torch.from_numpy(a), b).numpy(),
        np.asarray(jref.sjlt_apply(jnp.asarray(h), jnp.asarray(sigma),
                                   jnp.asarray(a), b)),
        rtol=RTOL, atol=ATOL)
    rows, sg, a = _srht_inputs(d, k, n, d, b)
    np.testing.assert_allclose(
        ref.srht_apply(torch.from_numpy(rows), torch.from_numpy(sg),
                       torch.from_numpy(a)).numpy(),
        np.asarray(jref.srht_apply(jnp.asarray(rows), jnp.asarray(sg),
                                   jnp.asarray(a))),
        rtol=RTOL, atol=ATOL)


CODED_CASES = [  # (W, b, s, erased workers)
    (9, 16, 700, [2, 5]),        # s not a multiple of the Pallas tile (512)
    (1, 8, 130, []),             # one worker
    (4, 5, 1030, [0, 1, 2, 3]),  # every worker erased
    (6, 3, 7, [5]),              # s below one tile
]


@pytest.mark.parametrize("w,b,s,erased", CODED_CASES)
def test_coded_block_matvec_matches_pallas(w, b, s, erased):
    rng = np.random.default_rng(w * s)
    enc = rng.standard_normal((w, b, s)).astype(np.float32)
    x = rng.standard_normal(s).astype(np.float32)
    er = np.zeros(w, bool)
    er[erased] = True
    want = np.asarray(jops.coded_block_matvec(jnp.asarray(enc), jnp.asarray(x),
                                              jnp.asarray(er)))
    got = ops.coded_block_matvec(torch.from_numpy(enc), torch.from_numpy(x),
                                 torch.from_numpy(er)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert not got[er].any()
    np.testing.assert_allclose(
        got, np.asarray(jref.coded_block_matvec(jnp.asarray(enc),
                                                jnp.asarray(x),
                                                jnp.asarray(er))),
        rtol=RTOL, atol=ATOL)


def test_fused_plain_version_is_apply_then_gram():
    h, sigma, a = (torch.from_numpy(x) for x in _inputs(1, 7, 150, 30, 32))
    m = torch.tensor([True, False, True, True, False, True, True])
    fused = ref.sketch_gram_count(h, sigma, a, 32, m)
    chained = ref.oversketch_gram(ref.count_sketch_apply(h, sigma, a, 32), m)
    torch.testing.assert_close(fused, chained, rtol=0, atol=0)


def test_tensors_off_the_cpu_never_take_the_plain_version():
    """A tensor that is not on the CPU launches the kernel or raises: here
    ("meta" tensors) the argument check refuses it."""
    h = torch.zeros((3, 10), dtype=torch.int32, device="meta")
    sigma = torch.zeros((3, 10), device="meta")
    a = torch.zeros((10, 4), device="meta")
    m = torch.ones(3, dtype=torch.bool, device="meta")
    before = ops.launch_counts()
    with pytest.raises(ValueError, match="CUDA device"):
        ops.count_sketch_apply(h, sigma, a, 8)
    with pytest.raises(ValueError, match="CUDA device"):
        ops.oversketch_gram(torch.zeros((3, 8, 4), device="meta"), m)
    with pytest.raises(ValueError, match="CUDA device"):
        ops.sketch_gram_count(h, sigma, a, 8, m)
    with pytest.raises(ValueError, match="CUDA device"):
        ops.sketch_gram_sjlt(h[:, None], sigma[:, None], a, 8, m)
    with pytest.raises(ValueError, match="CUDA device"):
        ops.sketch_gram_srht(h[:, :8].contiguous(), sigma, a, m)
    for fn in (ops.fwht, ops.fwht_two_pass):
        with pytest.raises(ValueError, match="CUDA device"):
            fn(torch.zeros((2, 64, 4), device="meta"))
    with pytest.raises(ValueError, match="CUDA device"):
        ops.coded_block_matvec(torch.zeros((3, 8, 10), device="meta"),
                               sigma[0], m)
    assert ops.launch_counts() == before


def test_argument_checks_refuse_wrong_dtype_shape_layout():
    h = torch.zeros((3, 10), dtype=torch.int32, device="meta")
    sigma = torch.zeros((3, 10), device="meta")
    a = torch.zeros((10, 4), device="meta")
    with pytest.raises(TypeError, match="h must be torch.int32"):
        ops.count_sketch_apply(h.long(), sigma, a, 8)
    with pytest.raises(ValueError, match="sigma must have shape"):
        ops.count_sketch_apply(h, sigma[:, :9], a, 8)
    with pytest.raises(ValueError, match="a must be contiguous"):
        ops.count_sketch_apply(h, sigma, torch.zeros((4, 10),
                                                     device="meta").T, 8)
    assert _check.on_cpu(torch.zeros(2), torch.zeros(1))
    assert not _check.on_cpu(torch.zeros(2), torch.zeros(1, device="meta"))


def test_launch_counts_reset():
    for k in ops.KERNELS.values():
        k.launches = 3
    ops.reset_launch_counts()
    assert set(ops.launch_counts().values()) == {0}
    assert set(ops.KERNELS) == {"sketch_gram_count", "count_sketch_apply",
                                "oversketch_gram", "coded_block_matvec",
                                "sketch_gram_sjlt", "sketch_gram_srht",
                                "fwht", "fwht_two_pass", "normal", "draw"}


# (K, s, n, b) -> sort chunks: one per ~8,192 entries, 1 to 64.
PLANS = [(10, 4, 300_000, 4096, 64), (10, 1, 300_000, 4096, 37),
         (150, 1, 300_000, 256, 37), (120, 4, 300_000, 256, 64),
         (3, 1, 1000, 4096, 1), (2, 3, 50_000, 16, 19)]


@pytest.mark.parametrize("k,s,n,b,chunks", PLANS)
def test_apply_plan_sizes_the_sort(k, s, n, b, chunks):
    """The CUDA apply's plan at any b: the sort's chunks, the gather's
    width, and its scratch: the sorted (row, sigma) pairs, the bucket
    starts and the per-chunk counts, as int32 words."""
    from repro_torch.kernels import count_sketch as cs
    assert cs.apply_plan(k, s, n, b) == cs.ApplyPlan(
        chunks, cs.GATHER_WIDTH, 2 * k * s * n + k * (b + 1) + k * chunks * b)


def test_apply_plan_refuses_more_than_int_entries():
    from repro_torch.kernels import count_sketch as cs
    cs.apply_plan(1, 1, (1 << 31) - 1, 256)
    with pytest.raises(ValueError, match="below 2"):
        cs.apply_plan(1, 4, 1 << 29, 256)


def test_fused_kernels_chunk_blocks():
    """The fused kernels' chunks keep A_tilde under CHUNK_BYTES: all 150
    blocks at b = 256, d = 3,000 and all 10 at b = 4,096 (163 and 10 fit);
    one block at least, K at most."""
    from repro_torch.kernels import sketch_gram
    assert sketch_gram.chunk_blocks(150, 256, 3000) == 150
    assert sketch_gram.chunk_blocks(200, 256, 3000) == 163
    assert sketch_gram.chunk_blocks(10, 4096, 3000) == 10
    assert sketch_gram.chunk_blocks(5, 256, 3000) == 5
    assert sketch_gram.chunk_blocks(3, 1 << 20, 3000) == 1


# (live rows, d, SMs) -> slices of the masked Gram: the fewest whose
# (tile, slice) work items fill the last wave of the card's 2 CTAs an SM to
# 97%, else the best fill; at least 256 rows a slice.
GRAM_PLANS = [(30_720, 3000, 132, 6),   # nystrom: 300 tiles, 1,800 items
              (6_912, 3000, 132, 6),    # a chunk of 27 blocks
              (30_720, 3000, 114, 3),   # 114 SMs: 900 of 912 slots
              (1_024, 3000, 132, 4),    # 4 slices at most: the best fill
              (192, 37, 132, 1),        # fewer rows than one slice takes
              (30_720, 37, 132, 120),   # one tile: as many as rows allow
              (10 ** 6, 30_000, 132, 1),  # 27,730 tiles fill 99%
              (0, 3000, 132, 1)]


@pytest.mark.parametrize("rows,d,sms,slices", GRAM_PLANS)
def test_gram_slices_fill_whole_waves(rows, d, sms, slices):
    from repro_torch.kernels import oversketch_matmul as om
    assert om.gram_slices(rows, d, sms) == slices
    tiles = om.gram_tiles(d)
    resident = om.GRAM_CTAS_PER_SM * sms

    def fill(s):
        return tiles * s / (-(-tiles * s // resident) * resident)
    most = max(1, rows // om.GRAM_MIN_SLICE_ROWS)
    assert all(fill(s) < om.GRAM_WAVE_FILL for s in range(1, slices))
    if fill(slices) < om.GRAM_WAVE_FILL:
        assert all(fill(s) <= fill(slices) for s in range(1, most + 1))
    assert slices == 1 or rows // slices >= om.GRAM_MIN_SLICE_ROWS


@pytest.mark.parametrize("rows_per_run", [1, 37, 300])
def test_plain_apply_in_runs_of_rows_is_one_index_add(monkeypatch,
                                                      rows_per_run):
    """The plain apply adds A's signed rows a run at a time (its scratch
    bounded where A fills the card): on the CPU the same sums, in the same
    order, as one index_add_ over all rows, and the Pallas kernel's."""
    h, sigma, a = _inputs(3, 4, 301, 37, 32)
    th, ts, ta = (torch.from_numpy(v) for v in (h, sigma, a))
    whole = ref.count_sketch_apply(th, ts, ta, 32)
    monkeypatch.setattr(ref, "APPLY_CHUNK_ELEMENTS", rows_per_run * 37)
    assert torch.equal(ref.count_sketch_apply(th, ts, ta, 32), whole)
    np.testing.assert_allclose(
        whole.numpy(), np.asarray(jops.count_sketch_apply(
            jnp.asarray(h), jnp.asarray(sigma), jnp.asarray(a), 32)),
        rtol=RTOL, atol=ATOL)
