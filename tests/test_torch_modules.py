"""Module-level parity of the port against the JAX package on the same
inputs: objectives, synthetic data, sketch, coded matvec, solvers, line
search, straggler model, fleet engine and DAG scheduler."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.coded as jcoded
import repro.core.linesearch as jls
import repro.core.objectives as jobj
import repro.core.sketch as jsketch
import repro.core.solvers as jsolvers
import repro.core.straggler as jstraggler
from repro import scheduler as jscheduler
from repro import sketching as jsketching
from repro.data import synthetic as jsynth
from repro.runtime import FleetConfig as JFleetConfig
from repro.runtime import FleetEngine as JFleetEngine

import repro_torch.core.coded as tcoded
import repro_torch.core.linesearch as tls
import repro_torch.core.objectives as tobj
import repro_torch.core.sketch as tsketch
import repro_torch.core.solvers as tsolvers
import repro_torch.core.straggler as tstraggler
from repro_torch import convert, prng, sketching
from repro_torch import scheduler as tscheduler
from repro_torch.data import synthetic as tsynth
from repro_torch.runtime import FleetConfig as TFleetConfig
from repro_torch.runtime import FleetEngine as TFleetEngine
from repro_torch.runtime import PhaseExhaustedError

torch.set_num_threads(1)

# Times are held bit for bit: every draw is bit-exact and the lognormal
# body factor takes XLA's float32 exp (prng.exp_f32).


def _key(seed):
    return jax.random.PRNGKey(seed), prng.PRNGKey(seed)


def _logistic(seed=0, n=300, d=12, n_test=50):
    jd = jsynth.make_logistic_dataset(jax.random.PRNGKey(seed), n, d, n_test)
    return jd, convert.dataset(*(np.asarray(a) for a in jd),
                               device="cpu")


# --------------------------------------------------------------- objectives
def test_logistic_objective_matches():
    jd, td = _logistic()
    rng = np.random.default_rng(0)
    w = rng.standard_normal(12).astype(np.float32) * 0.3
    ws = rng.standard_normal((4, 12)).astype(np.float32)
    jo, to = jobj.LogisticRegression(lam=1e-3), tobj.LogisticRegression(lam=1e-3)
    tw = torch.from_numpy(w)
    np.testing.assert_allclose(float(to.value(tw, td)),
                               float(jo.value(jnp.asarray(w), jd)), rtol=1e-6)
    np.testing.assert_allclose(
        to.value(torch.from_numpy(ws), td).numpy(),
        [float(jo.value(jnp.asarray(x), jd)) for x in ws], rtol=1e-6)
    np.testing.assert_allclose(to.gradient(tw, td).numpy(),
                               np.asarray(jo.gradient(jnp.asarray(w), jd)),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(to.hess_sqrt(tw, td).numpy(),
                               np.asarray(jo.hess_sqrt(jnp.asarray(w), jd)),
                               rtol=1e-5, atol=1e-7)
    assert float(to.error(tw, td.x_test, td.y_test)) == pytest.approx(
        float(jo.error(jnp.asarray(w), jd.x_test, jd.y_test)))


@pytest.mark.parametrize("cond", [1.0, 3.0, 7.5, 10.0, 100.0])
@pytest.mark.parametrize("d", [1, 2, 9, 50, 150, 1000, 3000, 4097])
def test_geomspace_bit_exact(d, cond):
    """The column spectrum is jax's bit for bit at every width, d = 3,000
    (the full-width profile) included."""
    np.testing.assert_array_equal(
        tsynth._geomspace(1.0, 1.0 / cond, d, "cpu").numpy(),
        np.asarray(jnp.geomspace(1.0, 1.0 / cond, d)))


@pytest.mark.parametrize("cond,sorted_layout", [(1.0, False), (10.0, True)])
def test_synthetic_dataset_matches(cond, sorted_layout):
    np.testing.assert_array_equal(
        tsynth._geomspace(1.0, 1.0 / cond, 150, "cpu").numpy(),
        np.asarray(jnp.geomspace(1.0, 1.0 / cond, 150)))
    jk, tk = _key(4)
    jd = jsynth.make_logistic_dataset(jk, 400, 9, 100, cond=cond,
                                      sorted_layout=sorted_layout)
    td = tsynth.make_logistic_dataset(tk, 400, 9, 100, cond=cond,
                                      sorted_layout=sorted_layout,
                                      device="cpu")
    # Bit for bit: the draws and the geomspace spectrum follow jax's
    # float32 steps.  (A label could still flip where its probability sits
    # on its uniform draw, since torch sums x @ w in another order; at this
    # size none does.)
    np.testing.assert_array_equal(td.x.numpy(), np.asarray(jd.x))
    np.testing.assert_array_equal(td.x_test.numpy(), np.asarray(jd.x_test))
    np.testing.assert_array_equal(td.y.numpy(), np.asarray(jd.y))
    np.testing.assert_array_equal(td.y_test.numpy(), np.asarray(jd.y_test))


@pytest.mark.parametrize("n,d,k,n_test", [(600, 12, 4, 100),
                                           (2000, 98, 10, 500),
                                           (20_000, 784, 10, 100)])
def test_softmax_dataset_matches(n, d, k, n_test):
    """Normal features and one-hot categorical labels, bit for bit, up to
    20,000 rows at the emnist profile's widths.  (A label could flip where
    its two largest scores tie within the rounding of x @ w^T, which torch
    sums in another order; none does here.)"""
    jk, tk = _key(7)
    jd = jsynth.make_softmax_dataset(jk, n, d, k, n_test)
    td = tsynth.make_softmax_dataset(tk, n, d, k, n_test, device="cpu")
    for got, want in zip(td, jd):
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert td.y.shape == (n, k) and bool((td.y.sum(1) == 1).all())


def test_profile_dataset_builds_the_softmax_profiles():
    jk, tk = _key(1)
    jd = jsynth.profile_dataset("emnist", jk)
    td = tsynth.profile_dataset("emnist", tk, device="cpu")
    assert td.x.shape == (2400, 98) and td.y.shape == (2400, 10)
    for got, want in zip(td, jd):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------------------- sketch
@pytest.mark.parametrize("n,b", [(500, 64), (257, 32)])
def test_sample_countsketch_bit_exact_and_gram(n, b):
    jk, tk = _key(n)
    jcfg, tcfg = jsketch.OverSketchConfig(256, b, 0.25), \
        tsketch.OverSketchConfig(256, b, 0.25)
    jcs = jsketch.sample_countsketch(jk, n, jcfg)
    tcs = tsketch.sample_countsketch(tk, n, tcfg, device="cpu")
    np.testing.assert_array_equal(tcs.h.numpy(), np.asarray(jcs.h))
    np.testing.assert_array_equal(tcs.sigma.numpy(), np.asarray(jcs.sigma))
    a = np.random.default_rng(1).standard_normal((n, 10)).astype(np.float32)
    m = np.ones(tcfg.total_blocks, bool)
    m[1] = False
    jg = jsketch.sketched_gram(jsketch.apply_sketch(jcs, jnp.asarray(a)),
                               jnp.asarray(m))
    tg = tsketch.sketched_gram(tsketch.apply_sketch(tcs, torch.from_numpy(a)),
                               torch.from_numpy(m))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(
        tsketch.oversketched_gram(tk, torch.from_numpy(a), tcfg).numpy(),
        np.asarray(jsketch.oversketched_gram(jk, jnp.asarray(a), jcfg)),
        rtol=1e-5, atol=1e-5)


def test_sketch_family_registry():
    cfg = tsketch.OverSketchConfig(128, 32)
    assert sketching.available() == jsketching.available() == [
        "gaussian", "leverage", "nystrom", "oversketch", "sjlt", "srht"]
    fam = sketching.get("oversketch", cfg)
    assert fam.block_flops(1000, 50) == 2.0 * 32 * 32 ** 2
    jcfg = jsketch.OverSketchConfig(128, 32)
    for name in sketching.available():
        tf, jf = sketching.get(name, cfg), jsketching.get(name, jcfg)
        assert tf.block_flops(1000, 50) == jf.block_flops(1000, 50)
        assert tf.apply_flops(1000, 50) == jf.apply_flops(1000, 50)
        assert tf.comm_units(50) == jf.comm_units(50)
        unfused = name in ("gaussian", "nystrom", "leverage")
        # The port's fused kernels have one form for every d, so where
        # the reference says "fused_tiled" (its VMEM budget) it says "fused".
        assert tf.fused_path(50) == jf.fused_path(50) == (
            "unfused" if unfused else "fused")
        assert tf.has_fused_gram is not unfused
    assert sketching.next_pow2(1000) == jsketching.next_pow2(1000) == 1024
    with pytest.raises(KeyError):
        sketching.get("nope", cfg)


def test_family_gram_paths_agree():
    cfg = tsketch.OverSketchConfig(192, 32)
    a = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (200, 17)).astype(np.float32))
    m = torch.ones(cfg.total_blocks, dtype=torch.bool)
    m[0] = False
    for name in sketching.available():
        fam = sketching.get(name, cfg)
        state = fam.sample(prng.PRNGKey(2), 200, device="cpu")
        torch.testing.assert_close(fam.gram(state, a, m, use_kernels=True),
                                   fam.gram(state, a, m), rtol=1e-5,
                                   atol=1e-6)
        torch.testing.assert_close(fam.apply(state, a, use_kernels=True),
                                   fam.apply(state, a), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name,n", [("sjlt", 300), ("srht", 300),
                                    ("srht", 256), ("nystrom", 300),
                                    ("gaussian", 300), ("gaussian", 64)])
def test_family_draws_bit_exact_and_gram_matches(name, n):
    jk, tk = _key(n + len(name))
    jcfg, tcfg = jsketch.OverSketchConfig(128, 32), \
        tsketch.OverSketchConfig(128, 32)
    jf, tf = jsketching.get(name, jcfg), sketching.get(name, tcfg)
    js, ts = jf.sample(jk, n), tf.sample(tk, n, device="cpu")
    # sjlt: h, sigma; srht: rows, sigma; nystrom: rows; gaussian: keys
    assert sorted(ts) == sorted(js)
    for field in js:
        np.testing.assert_array_equal(ts[field].numpy(), np.asarray(js[field]))
    a = np.random.default_rng(n).standard_normal((n, 11)).astype(np.float32)
    m = np.ones(tcfg.total_blocks, bool)
    m[2] = False
    for use_kernels in (False, True):
        np.testing.assert_allclose(
            tf.apply(ts, torch.from_numpy(a), use_kernels).numpy(),
            np.asarray(jf.apply(js, jnp.asarray(a), use_kernels)),
            rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(
            tf.gram(ts, torch.from_numpy(a), torch.from_numpy(m),
                    use_kernels).numpy(),
            np.asarray(jf.gram(js, jnp.asarray(a), jnp.asarray(m),
                               use_kernels)),
            rtol=1e-4, atol=1e-5)


def test_leverage_family_matches_reference():
    """The draw is bit-exact given the reference's own probabilities; the
    port's QR gives p within a few float32 ulps of XLA's, so rows whose
    uniform draw sits that close to a boundary of the prefix sum can be
    drawn differently.  At this size (n = 400, d = 11, 5 x 32 rows) every
    row agrees; the blocks agree within rtol 1e-4, and the Gram, whose
    entries cancel down to 1e-2 of its largest, within 1e-5 of its largest
    entry (each block's scale 1/sqrt(b p) carries p's ulps)."""
    n, d = 400, 11
    jk, tk = _key(3)
    jcfg, tcfg = jsketch.OverSketchConfig(128, 32), \
        tsketch.OverSketchConfig(128, 32)
    jf, tf = jsketching.get("leverage", jcfg), sketching.get("leverage", tcfg)
    js, ts = jf.sample(jk, n), tf.sample(tk, n, device="cpu")
    np.testing.assert_array_equal(ts["key"].numpy(), np.asarray(js["key"]))
    rng = np.random.default_rng(8)
    a = rng.standard_normal((n, d)).astype(np.float32)
    a[::37] *= 20.0                                  # uneven leverage
    q, _ = jnp.linalg.qr(jnp.asarray(a))
    lev = jnp.sum(q * q, axis=1)
    jp = lev / jnp.maximum(jnp.sum(lev), 1e-30)
    tp = tf.probabilities(torch.from_numpy(a))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-5)
    shape = (tcfg.total_blocks, tcfg.block_size)
    jrows = np.asarray(jax.random.choice(js["key"], n, shape, replace=True,
                                         p=jp))
    np.testing.assert_array_equal(
        prng.choice(ts["key"], n, shape, torch.from_numpy(np.array(jp)))
        .numpy(), jrows)
    assert (prng.choice(ts["key"], n, shape, tp).numpy() == jrows).mean() \
        == 1.0
    m = np.ones(tcfg.total_blocks, bool)
    m[0] = False
    for use_kernels in (False, True):
        np.testing.assert_allclose(
            tf.apply(ts, torch.from_numpy(a), use_kernels).numpy(),
            np.asarray(jf.apply(js, jnp.asarray(a), use_kernels)),
            rtol=1e-4, atol=1e-5)
        want = np.asarray(jf.gram(js, jnp.asarray(a), jnp.asarray(m),
                                  use_kernels))
        np.testing.assert_allclose(
            tf.gram(ts, torch.from_numpy(a), torch.from_numpy(m),
                    use_kernels).numpy(), want,
            rtol=0, atol=1e-5 * np.abs(want).max())


# ------------------------------------------------------------------- debias
def test_debias_functions_match():
    from repro.sketching import debias as jdebias
    p = np.random.default_rng(4).standard_normal((3, 7)).astype(np.float32)
    for dim, rows in ((20, 64), (20, 2560), (30, 31), (5, 0), (50, 40)):
        assert float(sketching.mp_factor(dim, rows)) == float(
            jdebias.mp_factor(dim, rows))
        np.testing.assert_array_equal(
            sketching.debias_direction(torch.from_numpy(p), dim, rows).numpy(),
            np.asarray(jdebias.debias_direction(jnp.asarray(p), dim, rows)))
        for target in (0.5, 0.75, 0.99):
            assert sketching.mp_stalled(dim, rows, target) == \
                jdebias.mp_stalled(dim, rows, target)
    assert float(sketching.mp_factor(50, 40)) == pytest.approx(0.05)
    for dim, target in ((20, 0.75), (3000, 0.5), (7, 0.9)):
        assert sketching.rows_for_target(dim, target) == \
            jdebias.rows_for_target(dim, target)
    with pytest.raises(ValueError, match="target"):
        sketching.rows_for_target(20, 1.0)


def test_distavg_worker_bytes_matches():
    for b, d in ((64, 20), (4096, 3000)):
        assert tscheduler.distavg_worker_bytes(b, d) == \
            jscheduler.distavg_worker_bytes(b, d)


# -------------------------------------------------------------------- coded
@pytest.mark.parametrize("rows,block", [(1000, 64), (37, 8), (20, 128)])
def test_encode_2d_matches(rows, block):
    a = np.random.default_rng(rows).standard_normal((rows, 7)).astype(
        np.float32)
    jcode, tcode = jcoded.make_code(rows, block), tcoded.make_code(rows, block)
    assert (jcode.num_blocks, jcode.block_rows, jcode.grid) == \
        (tcode.num_blocks, tcode.block_rows, tcode.grid)
    np.testing.assert_allclose(
        tcoded.encode_2d(torch.from_numpy(a), tcode).numpy(),
        np.asarray(jcoded.encode_2d(jnp.asarray(a), jcode)),
        rtol=1e-5, atol=1e-5)
    # the transposed operand, as the Newton loop encodes X^T
    np.testing.assert_allclose(
        tcoded.encode_2d(torch.from_numpy(a).T, tcoded.make_code(7, 4)).numpy(),
        np.asarray(jcoded.encode_2d(jnp.asarray(a).T, jcoded.make_code(7, 4))),
        rtol=1e-5, atol=1e-5)


def test_peel_decode_matches_over_erasure_patterns():
    rows, block = 600, 40
    code_j, code_t = jcoded.make_code(rows, block), tcoded.make_code(rows, block)
    g1 = code_t.grid + 1
    rng = np.random.default_rng(7)
    a = rng.standard_normal((rows, 9)).astype(np.float32)
    x = rng.standard_normal(9).astype(np.float32)
    enc_j = jcoded.encode_2d(jnp.asarray(a), code_j)
    enc_t = tcoded.encode_2d(torch.from_numpy(a), code_t)
    seen = set()
    for trial in range(40):
        erased = rng.random((g1, g1)) < (0.05 + 0.4 * trial / 40)
        yj, okj = jcoded.coded_matvec(enc_j, jnp.asarray(x), code_j, rows,
                                      jnp.asarray(erased))
        yt, okt = tcoded.coded_matvec(enc_t, torch.from_numpy(x), code_t,
                                      rows, torch.from_numpy(erased))
        assert bool(okt) == bool(okj)
        seen.add(bool(okt))
        if bool(okt):
            np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-4,
                                       atol=1e-4)
            np.testing.assert_allclose(yt.numpy(), a @ x, rtol=1e-3,
                                       atol=1e-3)
    assert seen == {True, False}   # decodable and undecodable patterns


@pytest.mark.parametrize("rows,block", [(600, 40), (37, 8)])
def test_coded_matvec_with_the_kernel_matches(rows, block):
    """The products by the coded block mat-vec (its plain version here),
    the erased cells zeroed, the same decode."""
    code_j, code_t = jcoded.make_code(rows, block), tcoded.make_code(rows, block)
    g1 = code_t.grid + 1
    rng = np.random.default_rng(rows)
    a = rng.standard_normal((rows, 9)).astype(np.float32)
    x = rng.standard_normal(9).astype(np.float32)
    enc_j = jcoded.encode_2d(jnp.asarray(a), code_j)
    enc_t = tcoded.encode_2d(torch.from_numpy(a), code_t)
    prods = tcoded.coded_block_products(enc_t, torch.from_numpy(x))
    np.testing.assert_allclose(
        prods.numpy(), np.asarray(jcoded.coded_block_products(
            enc_j, jnp.asarray(x))), rtol=1e-5, atol=1e-5)
    for trial in range(12):
        erased = rng.random((g1, g1)) < 0.05 + 0.05 * trial
        er = torch.from_numpy(erased)
        assert not tcoded.coded_block_products(
            enc_t, torch.from_numpy(x), er)[er].any()
        yj, okj = jcoded.coded_matvec(enc_j, jnp.asarray(x), code_j, rows,
                                      jnp.asarray(erased))
        yt, okt = tcoded.coded_matvec(enc_t, torch.from_numpy(x), code_t,
                                      rows, er)
        assert bool(okt) == bool(okj)
        if bool(okt):
            np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-4,
                                       atol=1e-4)


# ------------------------------------------------------------------ solvers
def _spd(d, seed):
    m = np.random.default_rng(seed).standard_normal((d + 5, d)).astype(
        np.float32)
    return m.T @ m / d + 0.1 * np.eye(d, dtype=np.float32)


def test_solvers_match():
    h = _spd(15, 0)
    g = np.random.default_rng(1).standard_normal(15).astype(np.float32)
    th, tg = torch.from_numpy(h), torch.from_numpy(g)
    jh, jg = jnp.asarray(h), jnp.asarray(g)
    kw = dict(rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tsolvers.psd_solve(th, tg).numpy(),
                               np.asarray(jsolvers.psd_solve(jh, jg)), **kw)
    np.testing.assert_allclose(tsolvers.psd_pinv_solve(th, tg).numpy(),
                               np.asarray(jsolvers.psd_pinv_solve(jh, jg)), **kw)
    np.testing.assert_allclose(
        tsolvers.conjugate_gradient(lambda v: th @ v, tg, torch.zeros(15),
                                    30).numpy(),
        np.asarray(jsolvers.conjugate_gradient(lambda v: jh @ v, jg,
                                               jnp.zeros(15), 30)), **kw)
    np.testing.assert_allclose(
        tsolvers.minres(lambda v: th @ v, tg, 15).numpy(),
        np.asarray(jsolvers.minres(lambda v: jh @ v, jg, 15)), **kw)


def test_linesearch_picks_the_same_step():
    jd, td = _logistic(seed=1)
    jo, to = jobj.LogisticRegression(lam=1e-3), tobj.LogisticRegression(lam=1e-3)
    rng = np.random.default_rng(3)
    w = rng.standard_normal(12).astype(np.float32) * 0.1
    g = np.array(jo.gradient(jnp.asarray(w), jd))
    for scale in (1.0, 8.0, 200.0):     # steps 1, smaller, and none qualifying
        p = (-g * scale).astype(np.float32)
        js = jls.linesearch_strongly_convex(jo, jd, jnp.asarray(w),
                                            jnp.asarray(p), jnp.asarray(g))
        ts = tls.linesearch_strongly_convex(to, td, torch.from_numpy(w),
                                            torch.from_numpy(p),
                                            torch.from_numpy(g))
        assert float(ts) == float(js)
        hg = g * 0.5
        jw = jls.linesearch_weakly_convex(jo, jd, jnp.asarray(w),
                                          jnp.asarray(p), jnp.asarray(g),
                                          jnp.asarray(hg))
        tw = tls.linesearch_weakly_convex(to, td, torch.from_numpy(w),
                                          torch.from_numpy(p),
                                          torch.from_numpy(g),
                                          torch.from_numpy(hg))
        assert float(tw) == float(jw)


# -------------------------------------------------------------------- fleet
@pytest.mark.parametrize("workers,flops", [(50, None), (300, 4e6), (7, 1e3)])
def test_sample_times_match(workers, flops):
    jk, tk = _key(workers)
    want = np.asarray(jstraggler.StragglerModel().sample_times(
        jk, workers, 2.0, flops))
    got = tstraggler.StragglerModel().sample_times(tk, workers, 2.0, flops)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def _grid_decodable(g1):
    from repro.core.newton import _decodable
    return lambda m: _decodable(~m.reshape(g1, g1))


FLEETS = [dict(), dict(cold_start_prob=0.3, failure_rate=0.2)]
POLICIES = [("wait_all", {}), ("k_of_n", {"k": 40}),
            ("coded_decode", {"k": 30, "decodable": _grid_decodable(7)}),
            ("speculative", {}), ("hedged", {})]


@pytest.mark.parametrize("fleet", FLEETS)
@pytest.mark.parametrize("policy,kw", POLICIES)
def test_run_phase_matches(policy, kw, fleet):
    jeng = JFleetEngine(jstraggler.StragglerModel(), fleet=JFleetConfig(**fleet))
    teng = TFleetEngine(tstraggler.StragglerModel(), fleet=TFleetConfig(**fleet))
    for i, mem in enumerate((None, 1.5)):
        jk, tk = _key(100 + i)
        je, jm = jeng.run_phase(jk, 49, flops_per_worker=3e6, policy=policy,
                                comm_units=2.0, memory_gb=mem, **kw)
        te, tm = teng.run_phase(tk, 49, flops_per_worker=3e6, policy=policy,
                                comm_units=2.0, memory_gb=mem, **kw)
        np.testing.assert_array_equal(tm, np.asarray(jm))
        np.testing.assert_array_equal(te, je)
    np.testing.assert_array_equal(teng.seconds, jeng.seconds)
    np.testing.assert_array_equal(teng.dollars, jeng.dollars)


def test_exhausted_phase_raises_like_the_reference():
    fleet = dict(failure_rate=0.9, max_retries=1, fail_open=False)
    jeng = JFleetEngine(jstraggler.StragglerModel(), fleet=JFleetConfig(**fleet))
    teng = TFleetEngine(tstraggler.StragglerModel(), fleet=TFleetConfig(**fleet))
    jk, tk = _key(5)
    from repro.runtime import PhaseExhaustedError as JExhausted
    with pytest.raises(JExhausted) as je:
        jeng.run_phase(jk, 20, policy="wait_all")
    with pytest.raises(PhaseExhaustedError) as te:
        teng.run_phase(tk, 20, policy="wait_all")
    np.testing.assert_array_equal(te.value.mask, je.value.mask)
    np.testing.assert_array_equal(teng.seconds, jeng.seconds)
    np.testing.assert_array_equal(teng.dollars, jeng.dollars)


def test_unported_fleet_options_raise():
    """Live telemetry is the one fleet option left unported (ROADMAP Queue
    1 item 10); record, replay, the warm pool and fault plans are ported
    (``tests/test_torch_fleet.py``) and accepted."""
    with pytest.raises(NotImplementedError, match="item 10"):
        tstraggler.SimClock(tstraggler.StragglerModel(), telemetry=object())
    from repro_torch.runtime import FaultPlan, TraceRecorder, TraceReplayer
    from repro_torch.scheduler import WarmPool
    for kw in ({"recorder": TraceRecorder()}, {"replay": TraceReplayer([])},
               {"pool": WarmPool()}, {"faults": FaultPlan()}):
        clock = tstraggler.SimClock(tstraggler.StragglerModel(), **kw)
        (name, value), = kw.items()
        assert getattr(clock.engine, name) is value


def test_dag_with_overlapping_phases_ends_at_the_same_clock():
    def run(pkg_clock, pkg_sched, key, fold):
        clock = pkg_clock.SimClock(pkg_clock.StragglerModel(), time=1.25)
        dag = pkg_sched.DagRun(clock, key=key)
        spec = pkg_sched.PhaseSpec
        dag.dispatch(spec("a", workers=30, policy="wait_all",
                          flops_per_worker=4e6, comm_units=1.0))
        dag.dispatch(spec("sketch", workers=40, policy="k_of_n", k=32,
                          flops_per_worker=9e6, comm_units=3.0,
                          memory_gb=0.5))
        dag.dispatch(spec("b", workers=30, policy="wait_all",
                          flops_per_worker=2e6, deps=("a",)))
        dag.dispatch(spec("c", workers=12, policy="speculative",
                          flops_per_worker=1e6, deps=("b",)),
                     key=fold(key, 17), min_start=clock.time + 0.5)
        dag.dispatch(spec("join", workers=5, deps=("c", "sketch")),
                     sequential=True)
        return clock, dag

    jclock, jdag = run(jstraggler, jscheduler, jax.random.PRNGKey(6),
                       jax.random.fold_in)
    tclock, tdag = run(tstraggler, tscheduler, prng.PRNGKey(6), prng.fold_in)
    # The sketch and "a" overlap: the DAG is shorter than its phases' sum.
    assert tdag.makespan < sum(r.elapsed for r in tdag.results.values())
    np.testing.assert_array_equal(tclock.time, jclock.time)
    np.testing.assert_array_equal(tclock.dollars, jclock.dollars)
    np.testing.assert_array_equal(tdag.makespan, jdag.makespan)
    for name, r in jdag.results.items():
        np.testing.assert_array_equal(tdag.results[name].mask.numpy(),
                                      np.asarray(r.mask))
        np.testing.assert_array_equal(tdag.results[name].finish, r.finish)
