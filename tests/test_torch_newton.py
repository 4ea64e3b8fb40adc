"""The slice as a whole: ``oversketched_newton`` in both packages on the
same dataset, ``w0`` and seed (the verify recipe: n = 1000, d = 20,
``OverSketchConfig(512, 64, 0.25)``, ``coded_block_rows=128``, coded
gradients, the kernel path)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import LogisticRegression as JLogistic
from repro.core import NewtonConfig as JConfig
from repro.core import OverSketchConfig as JSketch
from repro.core import oversketched_newton as j_newton
from repro.core import SimClock as JClock
from repro.core import StragglerModel as JModel
from repro.data import make_logistic_dataset
from repro.runtime import FleetConfig as JFleet

from repro_torch import convert
from repro_torch.core import LogisticRegression as TLogistic
from repro_torch.core import NewtonConfig as TConfig
from repro_torch.core import OverSketchConfig as TSketch
from repro_torch.core import oversketched_newton as t_newton
from repro_torch.core import SimClock as TClock
from repro_torch.core import StragglerModel as TModel
from repro_torch.runtime import FleetConfig as TFleet
from repro_torch.runtime import PhaseExhaustedError

torch.set_num_threads(1)

N, D = 1000, 20
ITERS = 4


@pytest.fixture(scope="module")
def data():
    jd = make_logistic_dataset(jax.random.PRNGKey(0), N, D, n_test=200)
    return jd, [np.asarray(a) for a in jd]


def _run(data, model="default", **overrides):
    jd, npd = data
    kw = dict(iters=ITERS, coded_block_rows=128, gradient_policy="coded",
              use_kernels=True, track_test_error=True)
    kw.update(overrides)
    jkw, tkw = {}, {}
    if model is None:
        jkw["model"] = tkw["model"] = None
    elif model == "fleet":
        fleet = dict(cold_start_prob=0.2, failure_rate=0.1)
        jkw["model"] = JClock(JModel(), fleet=JFleet(**fleet))
        tkw["model"] = TClock(TModel(), fleet=TFleet(**fleet))
    rj = j_newton(JLogistic(lam=1e-4), jd, jnp.zeros(D),
                  JConfig(sketch=JSketch(512, 64, 0.25), **kw), **jkw)
    rt = t_newton(TLogistic(lam=1e-4), convert.dataset(*npd, device="cpu"),
                  np.zeros(D, np.float32),
                  TConfig(sketch=TSketch(512, 64, 0.25), **kw),
                  device="cpu", **tkw)
    return rj, rt


def _assert_same_history(rj, rt):
    hj, ht = rj.history, rt.history
    assert ht["iter"] == hj["iter"]
    assert ht["step"] == hj["step"]
    for k in ("fval", "gnorm"):
        np.testing.assert_allclose(ht[k], hj[k], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(rt.w.numpy(), np.asarray(rj.w), rtol=1e-4,
                               atol=1e-6)
    # Simulated seconds and dollars: every fleet draw is bit-exact except
    # the normal body factor (prng.NORMAL_RTOL), hence a tolerance.
    for k in ("time", "cost"):
        np.testing.assert_allclose(ht[k], hj[k], rtol=1e-5)
    np.testing.assert_allclose(ht["test_error"], hj["test_error"],
                               atol=1.5 / 200)


@pytest.mark.parametrize("schedule", ["dag", "sequential"])
def test_history_matches_reference(data, schedule):
    rj, rt = _run(data, schedule=schedule)
    _assert_same_history(rj, rt)
    f = rt.history["fval"]
    assert all(b <= a for a, b in zip(f, f[1:]))


def test_history_matches_reference_without_fleet(data):
    rj, rt = _run(data, model=None)
    _assert_same_history(rj, rt)
    assert rt.history["time"] == [1.0, 2.0, 3.0, 4.0]


@pytest.mark.parametrize("overrides", [
    dict(use_kernels=False, gradient_policy="wait_all", phase_memory=True),
    dict(hessian_policy="exact", overlap_encode=False, schedule="sequential"),
])
def test_other_policies_match_reference(data, overrides):
    rj, rt = _run(data, **overrides)
    _assert_same_history(rj, rt)


def test_lifecycle_fleet_matches_reference(data):
    """Cold starts and retries on: the numpy lifecycle stream, seeded from
    the same keys, gives the same timeline."""
    rj, rt = _run(data, model="fleet")
    _assert_same_history(rj, rt)


@pytest.mark.parametrize("overrides,what", [
    (dict(sketch_mode="distributed-avg"), "distributed-avg"),
    (dict(debias=True), "debias"),
    (dict(adaptive_sketch=True), "adaptive_sketch"),
])
def test_unported_modes_are_refused(data, overrides, what):
    with pytest.raises(NotImplementedError, match=what):
        t_newton(TLogistic(), convert.dataset(*data[1], device="cpu"),
                 np.zeros(D, np.float32), TConfig(iters=1, **overrides),
                 device="cpu")


def test_exhausted_fleet_is_refused_not_degraded(data):
    fleet = TFleet(failure_rate=0.95, max_retries=0, fail_open=False)
    cfg = TConfig(iters=1, sketch=TSketch(512, 64, 0.25),
                  coded_block_rows=128)
    with pytest.raises(NotImplementedError, match="exhausted"):
        t_newton(TLogistic(), convert.dataset(*data[1], device="cpu"),
                 np.zeros(D, np.float32), cfg,
                 model=TClock(TModel(), fleet=fleet), device="cpu")
    with pytest.raises(PhaseExhaustedError):
        t_newton(TLogistic(), convert.dataset(*data[1], device="cpu"),
                 np.zeros(D, np.float32),
                 TConfig(iters=1, sketch=TSketch(512, 64, 0.25),
                         gradient_policy="exact", fault_fallback="raise"),
                 model=TClock(TModel(), fleet=fleet), device="cpu")
