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
                                "oversketch_gram"}
