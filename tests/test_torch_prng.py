"""The port's key layer against jax.random: same key, same draws."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import convert, prng

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
    got = prng.normal(tk, (1 << 20,), device="cpu").numpy()
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
