"""The five objectives against ``repro/core/objectives.py`` on the same
inputs (made with numpy from a seed), then ``oversketched_newton`` on each
of the new ones in both packages: softmax at fig. 9's sketch rule with the
pinv direction, ridge, and one barrier stage of the LP and of the Lasso
dual at ``examples/interior_point.py``'s sizes, each on a fleet, with the
JAX package's Pallas kernels in interpret mode."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.newton as j_newton_mod
from repro.core import NewtonConfig as JConfig
from repro.core import OverSketchConfig as JSketch
from repro.core import SimClock as JClock
from repro.core import objectives as jobj
from repro.core import oversketched_newton as j_newton

from repro_torch import convert
from repro_torch.core import NewtonConfig as TConfig
from repro_torch.core import OverSketchConfig as TSketch
from repro_torch.core import SimClock as TClock
from repro_torch.core import objectives as tobj
from repro_torch.core import oversketched_newton as t_newton

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
N, D, K = 300, 12, 4


def _problem(name: str, seed: int = 0):
    """(reference objective, port objective, numpy (x, y, x_test, y_test),
    w) for one objective, at a point where every value is finite."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    x = rng.standard_normal((N, D)).astype(f32)
    xt = rng.standard_normal((50, D)).astype(f32)
    if name == "logistic":
        y = np.where(rng.random(N) < 0.5, 1.0, -1.0).astype(f32)
        yt = np.where(rng.random(50) < 0.5, 1.0, -1.0).astype(f32)
        w = (0.3 * rng.standard_normal(D)).astype(f32)
        return (jobj.LogisticRegression(lam=1e-3),
                tobj.LogisticRegression(lam=1e-3), (x, y, xt, yt), w)
    if name == "softmax":
        y = np.eye(K, dtype=f32)[rng.integers(0, K, N)]
        yt = np.eye(K, dtype=f32)[rng.integers(0, K, 50)]
        w = (0.3 * rng.standard_normal(K * D)).astype(f32)
        return (jobj.SoftmaxRegression(K, lam=1e-3),
                tobj.SoftmaxRegression(K, lam=1e-3), (x, y, xt, yt), w)
    if name == "ridge":
        y = (x @ rng.standard_normal(D) + 0.1 * rng.standard_normal(N))
        yt = xt @ rng.standard_normal(D)
        w = rng.standard_normal(D).astype(f32)
        return (jobj.RidgeRegression(lam=1e-3), tobj.RidgeRegression(lam=1e-3),
                (x, y.astype(f32), xt, yt.astype(f32)), w)
    if name == "lp":
        b = (1.0 + rng.random(N)).astype(f32)
        c = rng.standard_normal(D).astype(f32)
        w = (0.01 * rng.standard_normal(D)).astype(f32)
        return (jobj.LinearProgramIPM(c=jnp.asarray(c), tau=5.0),
                tobj.LinearProgramIPM(c=torch.from_numpy(c), tau=5.0),
                (x, b, None, None), w)
    if name == "lasso_dual":
        xm = (0.2 * rng.standard_normal((30, 50))).astype(f32)
        y = rng.standard_normal(30).astype(f32)
        z = (0.05 * rng.standard_normal(30)).astype(f32)
        return (jobj.LassoDualIPM(lam=2.0, tau=3.0),
                tobj.LassoDualIPM(lam=2.0, tau=3.0), (xm, y, None, None), z)
    raise ValueError(name)


OBJECTIVES = ["logistic", "softmax", "ridge", "lp", "lasso_dual"]


def _datasets(arrays):
    jd = jobj.Dataset(*(None if a is None else jnp.asarray(a)
                        for a in arrays))
    return jd, convert.dataset(*arrays, device="cpu")


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def _recording_mv(data, tags, to_array):
    def mv(tag, v):
        tags.append(tag)
        x = to_array(data.x)
        return x @ v if tag == "X" else x.T @ v
    return mv


@pytest.mark.parametrize("name", OBJECTIVES)
def test_value_single_and_batched(name):
    jo, to, arrays, w = _problem(name)
    jd, td = _datasets(arrays)
    rng = np.random.default_rng(1)
    ws = (w + 0.01 * rng.standard_normal((5, w.size))).astype(np.float32)
    _close(to.value(torch.from_numpy(w), td), jo.value(jnp.asarray(w), jd))
    _close(to.value(torch.from_numpy(ws), td),
           [float(jo.value(jnp.asarray(v), jd)) for v in ws])


@pytest.mark.parametrize("name", OBJECTIVES)
def test_gradients(name):
    """gradient, and gradient_via through a plain hook: the same matvecs in
    the same order (the Lasso dual's "XT" first, softmax's K each way)."""
    jo, to, arrays, w = _problem(name)
    jd, td = _datasets(arrays)
    tw = torch.from_numpy(w)
    _close(to.gradient(tw, td), jo.gradient(jnp.asarray(w), jd))
    j_tags, t_tags = [], []
    got = to.gradient_via(tw, td, _recording_mv(td, t_tags, lambda a: a))
    want = jo.gradient_via(jnp.asarray(w), jd,
                           _recording_mv(jd, j_tags, lambda a: a))
    _close(got, want)
    assert t_tags == j_tags
    if name == "softmax":
        assert t_tags == ["X"] * K + ["XT"] * K
    if name == "lasso_dual":
        assert t_tags == ["XT", "X"]


@pytest.mark.parametrize("name", OBJECTIVES)
def test_hess_sqrt(name):
    jo, to, arrays, w = _problem(name)
    jd, td = _datasets(arrays)
    got = to.hess_sqrt(torch.from_numpy(w), td)
    want = np.asarray(jo.hess_sqrt(jnp.asarray(w), jd))
    assert got.shape == want.shape and got.is_contiguous()
    _close(got, want)


def test_softmax_hess_sqrt_is_the_hessian_factor():
    """A^T A is the softmax Hessian (the reference's factor, row (n, c),
    column (i, j)), here against autograd's Hessian of the value."""
    jo, to, arrays, w = _problem("softmax")
    _, td = _datasets(arrays)
    to = tobj.SoftmaxRegression(K)
    tw = torch.from_numpy(w).double()
    td64 = tobj.Dataset(*(a.double() for a in td[:2]))
    a = to.hess_sqrt(tw, td64)
    assert a.shape == (N * K, K * D)
    hess = torch.autograd.functional.hessian(lambda v: to.value(v, td64), tw)
    torch.testing.assert_close(a.T @ a, hess, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("name", ["logistic", "softmax", "ridge"])
def test_masked_value_and_error(name):
    jo, to, arrays, w = _problem(name)
    jd, td = _datasets(arrays)
    ok = (np.random.default_rng(2).random(N) < 0.7).astype(np.float32)
    tw, jw = torch.from_numpy(w), jnp.asarray(w)
    _close(to.masked_value(tw, td, torch.from_numpy(ok)),
           jo.masked_value(jw, jd, jnp.asarray(ok)))
    _close(to.masked_value(tw, td, torch.zeros(N)),
           jo.masked_value(jw, jd, jnp.zeros(N)))
    _close(to.error(tw, td.x_test, td.y_test),
           jo.error(jw, jd.x_test, jd.y_test))


def test_lp_value_is_infinite_outside_the_interior_per_candidate():
    """The barrier is -inf where a slack is not positive, so the value is
    +inf there, candidate by candidate, as the reference's."""
    jo, to, arrays, w = _problem("lp")
    jd, td = _datasets(arrays)
    far = (w + 100.0 * np.sign(arrays[0][0])).astype(np.float32)
    ws = np.stack([w, far])
    got = to.value(torch.from_numpy(ws), td).numpy()
    assert np.isfinite(got[0]) and got[1] == np.inf
    assert float(jo.value(jnp.asarray(far), jd)) == np.inf


# --------------------------------------------------------- Newton histories
def _record_masks(monkeypatch, clock_cls):
    masks = []
    phase = clock_cls.phase

    def recording(self, *args, **kwargs):
        elapsed, mask = phase(self, *args, **kwargs)
        masks.append(np.asarray(mask, dtype=bool).copy())
        return elapsed, mask
    monkeypatch.setattr(clock_cls, "phase", recording)
    return masks


def _softmax_case():
    from repro.data import make_softmax_dataset
    n, d, k = 600, 12, 4
    jd = make_softmax_dataset(jax.random.PRNGKey(3), n, d, k, 100)
    dk = d * k
    m = ((6 * dk) // 256 + 1) * 256           # fig. 9's sketch rule
    return (jobj.SoftmaxRegression(num_classes=k),
            tobj.SoftmaxRegression(num_classes=k), jd, np.zeros(dk),
            (m, 256, 0.25), dict(solver="pinv", unit_step=False,
                                 coded_block_rows=256, track_test_error=True))


def _ridge_case():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((1000, 20)).astype(np.float32)
    y = (x @ rng.standard_normal(20) + 0.1 * rng.standard_normal(1000))
    jd = jobj.Dataset(x=jnp.asarray(x), y=jnp.asarray(y.astype(np.float32)),
                      x_test=jnp.asarray(x[:200]),
                      y_test=jnp.asarray(y[:200].astype(np.float32)))
    return (jobj.RidgeRegression(lam=1e-4), tobj.RidgeRegression(lam=1e-4),
            jd, np.zeros(20), (512, 64, 0.25),
            dict(coded_block_rows=128, track_test_error=True))


def _lp_case():
    """The first barrier stage of examples/interior_point.py's LP."""
    key = jax.random.PRNGKey(0)
    n, m = 400, 40
    a_mat = jax.random.normal(key, (n, m))
    b = 1.0 + jax.random.uniform(jax.random.fold_in(key, 1), (n,))
    c = jax.random.normal(jax.random.fold_in(key, 2), (m,))
    return (jobj.LinearProgramIPM(c=c, tau=2.0),
            tobj.LinearProgramIPM(c=torch.tensor(np.asarray(c)), tau=2.0),
            jobj.Dataset(x=a_mat, y=b), np.zeros(m), (512, 64, 0.25),
            dict(iters=6, coded_block_rows=64))


def _lasso_case():
    """The first barrier stage of examples/interior_point.py's Lasso dual."""
    key = jax.random.PRNGKey(0)
    x_mat = jax.random.normal(jax.random.fold_in(key, 3), (60, 200)) * 0.2
    y = jax.random.normal(jax.random.fold_in(key, 4), (60,))
    return (jobj.LassoDualIPM(lam=1.5, tau=4.0),
            tobj.LassoDualIPM(lam=1.5, tau=4.0),
            jobj.Dataset(x=x_mat, y=y), np.zeros(60), (256, 64, 0.25),
            dict(iters=6, coded_block_rows=32))


CASES = {"softmax": _softmax_case, "ridge": _ridge_case, "lp": _lp_case,
         "lasso_dual": _lasso_case}


@pytest.mark.parametrize("case", list(CASES))
def test_newton_history_matches_reference(monkeypatch, case):
    """Each objective through oversketched_newton on the default fleet,
    coded gradients, the kernel path: every phase's mask and the simulated
    seconds and dollars bit for bit, the iterates within the Newton parity
    tests' tolerances."""
    jo, to, jd, w0, sketch, extra = CASES[case]()
    # The reference caches its jitted Hessian by objective, which the LP's
    # array c cannot key (its hash is refused): take the uncached function,
    # the same computation.
    monkeypatch.setattr(j_newton_mod, "_jitted_sketched_hessian",
                        j_newton_mod._jitted_sketched_hessian.__wrapped__)
    kw = {"iters": 4, "gradient_policy": "coded", "use_kernels": True,
          **extra}
    j_masks = _record_masks(monkeypatch, JClock)
    rj = j_newton(jo, jd, jnp.asarray(w0, jnp.float32),
                  JConfig(sketch=JSketch(*sketch), **kw))
    t_masks = _record_masks(monkeypatch, TClock)
    rt = t_newton(to, convert.dataset(*[None if a is None else np.asarray(a)
                                        for a in jd], device="cpu"),
                  w0.astype(np.float32), TConfig(sketch=TSketch(*sketch),
                                                 **kw), device="cpu")

    assert len(j_masks) > 2 * kw["iters"]
    assert len(t_masks) == len(j_masks)
    for i, (mt, mj) in enumerate(zip(t_masks, j_masks)):
        np.testing.assert_array_equal(mt, mj, err_msg=f"phase call {i}")
    hj, ht = rj.history, rt.history
    assert ht["iter"] == [int(v) for v in hj["iter"]]
    assert ht["step"] == [float(v) for v in hj["step"]]
    for k in ("time", "cost"):
        assert ht[k] == [float(v) for v in hj[k]], k
    for k in ("fval", "gnorm"):
        np.testing.assert_allclose(ht[k], hj[k], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(rt.w.numpy(), np.asarray(rj.w), rtol=1e-4,
                               atol=1e-6)
    if extra.get("track_test_error"):
        np.testing.assert_allclose(ht["test_error"], hj["test_error"],
                                   atol=1.5 / jd.x_test.shape[0])
    f = ht["fval"]
    assert all(np.isfinite(f)) and f[-1] < f[0]
