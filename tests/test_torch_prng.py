"""The port's key layer against jax.random: same key, same draws."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import convert, prng
from repro_torch.kernels import ops

torch.set_num_threads(1)

SEEDS = (0, 42, -5, 2**31 - 1)


def _pair(seed):
    return jax.random.PRNGKey(seed), prng.PRNGKey(seed)


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey_words(seed):
    jk, tk = _pair(seed)
    np.testing.assert_array_equal(np.asarray(jax.random.key_data(jk)),
                                  prng.key_data(tk))


@pytest.mark.parametrize("seed", SEEDS)
def test_split_and_fold_in_bit_exact(seed):
    jk, tk = _pair(seed)
    np.testing.assert_array_equal(np.asarray(jax.random.split(jk, 7)),
                                  prng.split(tk, 7).numpy())
    for data in (0, 1, 555, 0x7FFFFFFF):
        np.testing.assert_array_equal(
            np.asarray(jax.random.fold_in(jk, data)),
            prng.fold_in(tk, data).numpy())


def test_convert_key_round_trip():
    jk = jax.random.fold_in(jax.random.PRNGKey(3), 99)
    tk = convert.key(jax.random.key_data(jk))
    np.testing.assert_array_equal(
        np.asarray(jax.random.uniform(jk, (50,))),
        prng.uniform(tk, (50,), device="cpu").numpy())


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-1.0, 1.0), (0.3, 1.5)])
def test_uniform_bit_exact(lo, hi):
    jk, tk = _pair(11)
    np.testing.assert_array_equal(
        np.asarray(jax.random.uniform(jk, (64, 33), minval=lo, maxval=hi)),
        prng.uniform(tk, (64, 33), lo, hi, device="cpu").numpy())


def test_scalar_and_bernoulli_and_rademacher_bit_exact():
    jk, tk = _pair(5)
    assert float(jax.random.uniform(jk, ())) == float(
        prng.uniform(tk, (), device="cpu"))
    np.testing.assert_array_equal(
        np.asarray(jax.random.bernoulli(jk, 0.02, (4000,))),
        prng.bernoulli(tk, 0.02, (4000,), device="cpu").numpy())
    np.testing.assert_array_equal(
        np.asarray(jax.random.rademacher(jk, (17, 300), dtype=jnp.float32)),
        prng.rademacher(tk, (17, 300), device="cpu").numpy())


@pytest.mark.parametrize("span", [64, 256, 1000])
def test_randint_bit_exact(span):
    jk, tk = _pair(span)
    np.testing.assert_array_equal(
        np.asarray(jax.random.randint(jk, (12, 777), 0, span,
                                      dtype=jnp.int32)),
        prng.randint(tk, (12, 777), 0, span, device="cpu").numpy())


@pytest.mark.parametrize("lo,span", [(0, 65_536), (-3, 65_537),
                                     (0, 300_000), (-5, 1 << 19),
                                     (-5, (1 << 31) - 1)])
def test_randint_bit_exact_past_two_to_the_16(lo, span):
    """Spans past 2^16, where jax's multiplier (2^16 mod span)^2 wraps in
    uint32 (nystrom's rows: span n = 300,000), from a negative lower end."""
    jk, tk = _pair(span % 977)
    np.testing.assert_array_equal(
        np.asarray(jax.random.randint(jk, (3, 1001), lo, lo + span,
                                      dtype=jnp.int32)),
        prng.randint(tk, (3, 1001), lo, lo + span, device="cpu").numpy())


def test_chunked_draws_match_one_shot(monkeypatch):
    """bits[i] depends only on (key, i): a draw made in chunks is the same
    draw, chunk boundaries anywhere."""
    jk, tk = _pair(8)
    monkeypatch.setattr(prng, "CHUNK", 1000)
    np.testing.assert_array_equal(
        np.asarray(jax.random.uniform(jk, (37, 101), minval=-1.0,
                                      maxval=1.0)),
        prng.uniform(tk, (37, 101), -1.0, 1.0, device="cpu").numpy())
    np.testing.assert_array_equal(
        np.asarray(jax.random.randint(jk, (5, 999), 0, 256,
                                      dtype=jnp.int32)),
        prng.randint(tk, (5, 999), 0, 256, device="cpu").numpy())


def test_normal_within_stated_bound():
    """The stated bound is now zero: 2^20 draws equal jax's bit for bit."""
    jk, tk = _pair(3)
    ref = np.asarray(jax.random.normal(jk, (1 << 20,)))
    got = ops.normal(tk, (1 << 20,), device="cpu").numpy()
    np.testing.assert_array_equal(got, ref)


def test_log_and_log1p_match_xla_bit_for_bit():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(1e-30, 1.0, 1 << 16),
                        rng.uniform(0.0, 50.0, 1 << 14),
                        np.float32([0.0, 1.0, np.inf, 1e-39, -1.0, np.nan])]
                       ).astype(np.float32)
    np.testing.assert_array_equal(prng.log_f32(torch.from_numpy(x)).numpy(),
                                  np.asarray(jnp.log(jnp.asarray(x))))
    y = np.concatenate([-rng.uniform(-1, 1, 1 << 16) ** 2,
                        rng.uniform(-0.5, 0.5, 1 << 14)]).astype(np.float32)
    np.testing.assert_array_equal(
        prng.log1p_f32(torch.from_numpy(y)).numpy(),
        np.asarray(jnp.log1p(jnp.asarray(y))))


def test_erfinv_edges():
    x = torch.tensor([-1.0, 0.0, 1.0])
    out = prng.erfinv(x)
    assert out[0] == -np.inf and out[1] == 0.0 and out[2] == np.inf


def test_key_data_seeds_identical_numpy_streams():
    jk = jax.random.split(jax.random.PRNGKey(9), 3)[2]
    tk = prng.split(prng.PRNGKey(9), 3)[2]
    a = np.random.default_rng(
        np.asarray(jax.random.key_data(jk), dtype=np.uint32).ravel().tolist())
    b = np.random.default_rng(prng.key_data(tk).ravel().tolist())
    np.testing.assert_array_equal(a.random(100), b.random(100))


def _every_float32(lo, hi):
    """Every float32 in [lo, hi), both bounds of one sign."""
    a, b = np.float32(abs(lo)).view(np.int32), np.float32(abs(hi)).view(np.int32)
    bits = np.arange(min(a, b), max(a, b), dtype=np.int32)
    return (bits.view(np.float32) * np.float32(np.sign(lo + hi))).astype(
        np.float32)


def test_exp_matches_xla_bit_for_bit():
    """2^20 values of the fleet's lognormal exponent (0.08 N(0, 1)) and
    2^20 uniform on [-80, 80], every float32 near both ends of the range
    (the clamps, n = 127 and 128 near overflow, the flush to zero), the
    infinities, nan and subnormals, all equal to jnp.exp bit for bit."""
    rng = np.random.default_rng(5)
    x = np.concatenate([
        0.08 * rng.standard_normal(1 << 20), rng.uniform(-80, 80, 1 << 20),
        _every_float32(88.0, 89.0), _every_float32(-88.5, -87.0),
        [0.0, -0.0, 1e-45, -1e-45, 1e-39, np.inf, -np.inf, np.nan, 3.4e38,
         -3.4e38, 88.72283, 88.72284, -87.33654, -87.33655]]).astype(np.float32)
    want = np.asarray(jnp.exp(jnp.asarray(x)))
    got = prng.exp_f32(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("n", [1, 15, 16, 17, 257, 4097, 300_000])
def test_cumsum_matches_jnp_bit_for_bit(n):
    rng = np.random.default_rng(n)
    for x in (rng.random(n), rng.random(n) ** 4 / n,
              rng.standard_normal(n)):
        x = x.astype(np.float32)
        np.testing.assert_array_equal(
            prng.cumsum_f32(torch.from_numpy(x)).numpy(),
            np.asarray(jnp.cumsum(jnp.asarray(x))))


@pytest.mark.parametrize("n,shape", [(1, (5,)), (50, (7, 9)),
                                     (4000, (30, 64)), (300, (1000,))])
def test_choice_matches_jax_given_the_same_p(n, shape):
    """Bit for bit: the same indices from the same key and probabilities
    (a few of them zero, never drawn)."""
    rng = np.random.default_rng(n)
    p = (rng.random(n) ** 3).astype(np.float32)
    p[1::7] = 0.0
    p = (p / p.sum()).astype(np.float32)
    jk, tk = _pair(n)
    want = np.asarray(jax.random.choice(jk, n, shape, replace=True,
                                        p=jnp.asarray(p)))
    got = prng.choice(tk, n, shape, torch.from_numpy(p))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert not np.isin(got.numpy(), np.flatnonzero(p == 0)).any()
    with pytest.raises(ValueError, match="p must have shape"):
        prng.choice(tk, n + 1, shape, torch.from_numpy(p))


def test_normal_entry_point_is_the_plain_version_on_the_cpu():
    key = prng.PRNGKey(11)
    want = prng.normal_plain(key, (3, 1000), "cpu")
    np.testing.assert_array_equal(ops.normal(key, (3, 1000),
                                             device="cpu").numpy(),
                                  want.numpy())
    with pytest.raises(ValueError, match="CPU or a CUDA device"):
        ops.normal(key, (3,), "meta")


def test_normal_is_a_function_of_the_top_23_bits_for_every_mantissa():
    """Every one of the 2^23 normal draws: prng's steps on the mantissa m
    (the normal kernel's table, by its plain version) equal jax's sqrt(2)
    erf_inv(u) on the u jax builds from the word m << 9, bit for bit; and
    jax's own normal draws, and the port's, are the table read at their
    words' top 23 bits."""
    from repro_torch.kernels import normal
    lo = np.float32(prng.NORMAL_LO)

    @jax.jit
    def jax_normal_of_mantissas(m):
        f = jax.lax.bitcast_convert_type(
            m | jnp.uint32(0x3F800000), jnp.float32) - jnp.float32(1.0)
        u = jnp.maximum(lo, f * (jnp.float32(1.0) - lo) + lo)
        return u, jnp.float32(np.sqrt(2.0)) * jax.lax.erf_inv(u)

    m = np.arange(normal.TABLE_SIZE, dtype=np.uint32)
    u_jax, want = jax_normal_of_mantissas(jnp.asarray(m))
    lo_t, scale = prng._uniform_params(prng.NORMAL_LO, 1.0)
    u = prng._uniform_of(prng._mantissa_floats(torch.from_numpy(
        m.view(np.int32))), lo_t, scale)
    np.testing.assert_array_equal(u.numpy().view(np.uint32),
                                  np.asarray(u_jax).view(np.uint32))
    table = normal.table_plain("cpu").numpy()
    np.testing.assert_array_equal(table.view(np.uint32),
                                  np.asarray(want).view(np.uint32))
    jk, tk = _pair(17)
    words = np.asarray(jax.random.bits(jk, (1 << 16,)))
    np.testing.assert_array_equal(
        table[words >> 9].view(np.uint32),
        np.asarray(jax.random.normal(jk, (1 << 16,))).view(np.uint32))
    np.testing.assert_array_equal(
        table[words >> 9].view(np.uint32),
        prng.normal_plain(tk, (1 << 16,), "cpu").numpy().view(np.uint32))


@pytest.mark.parametrize("shape", [(0,), (1,), (1000,), (3, 4097)])
def test_draw_entry_points_are_the_plain_versions_on_the_cpu(shape):
    """``ops.randint``, ``rademacher``, ``uniform`` and ``bernoulli`` take
    prng's plain draws on the CPU, which equal jax's."""
    jk, tk = _pair(23)
    cases = [
        (ops.randint(tk, shape, -7, 300_000, device="cpu"),
         prng.randint(tk, shape, -7, 300_000, device="cpu"),
         jax.random.randint(jk, shape, -7, 300_000, dtype=jnp.int32)),
        (ops.rademacher(tk, shape, device="cpu"),
         prng.rademacher(tk, shape, device="cpu"),
         jax.random.rademacher(jk, shape, dtype=jnp.float32)),
        (ops.uniform(tk, shape, -1.0, 1.0, device="cpu"),
         prng.uniform(tk, shape, -1.0, 1.0, device="cpu"),
         jax.random.uniform(jk, shape, minval=-1.0, maxval=1.0)),
        (ops.bernoulli(tk, 0.3, shape, device="cpu"),
         prng.bernoulli(tk, 0.3, shape, device="cpu"),
         jax.random.bernoulli(jk, 0.3, shape)),
    ]
    for got, plain, want in cases:
        assert got.device.type == "cpu" and got.dtype == plain.dtype
        assert torch.equal(got, plain)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_draw_entry_points_refuse_other_devices():
    from repro_torch.kernels import draw
    key = prng.PRNGKey(0)
    for call in (lambda: ops.randint(key, (3,), 0, 4, device="meta"),
                 lambda: ops.rademacher(key, (3,), device="meta"),
                 lambda: ops.uniform(key, (3,), device="meta"),
                 lambda: ops.bernoulli(key, 0.5, (3,), device="meta"),
                 lambda: ops.gumbel(key, (3,), device="meta"),
                 lambda: ops.categorical(key, torch.zeros(3, 2,
                                                          device="meta")),
                 lambda: draw.bits(key, 0, 3, device="meta")):
        with pytest.raises(ValueError, match="CPU or a CUDA device"):
            call()


def test_draw_bits_are_prng_words_as_int32():
    from repro_torch.kernels import draw
    key = prng.PRNGKey(4)
    start = (1 << 32) - 5
    got = draw.bits(key, start, 100, device="cpu")
    assert got.dtype == torch.int32
    assert torch.equal(got.long() & prng.M32,
                       prng._bits(key, start, 100, "cpu"))
    np.testing.assert_array_equal(
        draw.bits(key, 0, 1000, device="cpu").numpy().view(np.uint32),
        np.asarray(jax.random.bits(jax.random.PRNGKey(4), (1000,))))


def test_normal_table_lives_on_a_cuda_device():
    from repro_torch.kernels import normal
    for call in (lambda: normal.table("cpu"),
                 lambda: normal.build_table("cpu")):
        with pytest.raises(ValueError, match="CUDA device"):
            call()


GUMBEL_SHAPES = [(), (1,), (1000,), (37, 11), (5, 3, 7), (3, 4097)]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", GUMBEL_SHAPES)
def test_gumbel_bit_exact(seed, shape):
    """jax.random.gumbel in its default mode: the uniform on [tiny, 1)
    through two of XLA's float32 logs; the entry point takes the plain
    version on the CPU."""
    jk, tk = _pair(seed)
    want = np.asarray(jax.random.gumbel(jk, shape))
    got = prng.gumbel(tk, shape, device="cpu").numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert torch.equal(ops.gumbel(tk, shape, device="cpu"),
                       torch.from_numpy(got))


def test_gumbel_of_every_uniform_draw():
    """All 2^23 uniform draws gumbel can make (one per 23-bit mantissa,
    the smallest being tiny): the transform equals XLA's, bit for bit."""
    lo, scale = prng._uniform_params(prng.GUMBEL_MINVAL, 1.0)
    m = torch.arange(1 << 23, dtype=torch.int32)
    u = prng._uniform_of(prng._mantissa_floats(m), lo, scale)
    assert float(u[0]) == np.finfo(np.float32).tiny
    want = jax.jit(lambda v: -jnp.log(-jnp.log(v)))(jnp.asarray(u.numpy()))
    got = prng.gumbel_of_uniform(u).numpy()
    np.testing.assert_array_equal(got.view(np.uint32),
                                  np.asarray(want).view(np.uint32))


CATEGORICAL_CASES = [((500, 10), -1, None), ((500, 10), 1, None),
                     ((7, 3, 5), 1, None), ((10, 4), 0, (2, 6, 4)),
                     ((6,), -1, (3, 2)), ((64, 2), -1, None)]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("logits_shape,axis,shape", CATEGORICAL_CASES)
def test_categorical_bit_exact(seed, logits_shape, axis, shape):
    """jax.random.categorical (replace=True): the argmax of Gumbel draws
    plus the logits, with jax's shapes for any axis and a leading shape."""
    jk, tk = _pair(seed)
    logits = np.random.default_rng(seed & 0xFFFF).standard_normal(
        logits_shape).astype(np.float32) * 3
    want = np.asarray(jax.random.categorical(jk, jnp.asarray(logits), axis,
                                             shape))
    for fn in (prng.categorical, ops.categorical):
        got = fn(tk, torch.from_numpy(logits), axis, shape)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_one_hot_matches_jax():
    x = np.array([[0, 3, 9], [2, 11, -1]], np.int32)
    np.testing.assert_array_equal(
        prng.one_hot(torch.from_numpy(x), 10).numpy(),
        np.asarray(jax.nn.one_hot(jnp.asarray(x), 10)))
