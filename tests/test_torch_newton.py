"""The slice as a whole: ``oversketched_newton`` in both packages on the
same dataset, ``w0`` and seed (the verify recipe: n = 1000, d = 20,
``OverSketchConfig(512, 64, 0.25)``, ``coded_block_rows=128``, coded
gradients, the kernel path), for every ported sketch family, both sketch
modes (distributed-avg needs b = 64 > d = 20) and fleets whose phases
exhaust their retry budget."""
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


# Fleets whose phases exhaust their retry budget (fail_open=False): almost
# every phase, and some phases with survivors above the floor.
EXHAUSTED = dict(failure_rate=0.95, max_retries=0, fail_open=False)
THINNED = dict(failure_rate=0.5, max_retries=0, fail_open=False)


def _run(data, model="default", **overrides):
    """``model``: "default" (a fresh default fleet), None (no fleet),
    "fleet" (cold starts and retries) or a dict of FleetConfig fields."""
    jd, npd = data
    kw = dict(iters=ITERS, coded_block_rows=128, gradient_policy="coded",
              use_kernels=True, track_test_error=True)
    kw.update(overrides)
    jkw, tkw = {}, {}
    if model == "fleet":
        model = dict(cold_start_prob=0.2, failure_rate=0.1)
    if model is None:
        jkw["model"] = tkw["model"] = None
    elif isinstance(model, dict):
        jkw["model"] = JClock(JModel(), fleet=JFleet(**model))
        tkw["model"] = TClock(TModel(), fleet=TFleet(**model))
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
    # Simulated seconds and dollars, bit for bit: every fleet draw is
    # bit-exact and the lognormal body factor takes XLA's float32 exp.
    for k in ("time", "cost"):
        assert ht[k] == [float(v) for v in hj[k]], k
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


@pytest.mark.parametrize("family", ["sjlt", "srht"])
@pytest.mark.parametrize("schedule", ["dag", "sequential"])
def test_sketch_families_match_reference(data, family, schedule):
    rj, rt = _run(data, sketch_family=family, schedule=schedule)
    _assert_same_history(rj, rt)


@pytest.mark.parametrize("family", ["gaussian", "nystrom", "leverage"])
def test_unfused_families_match_reference(data, family):
    """The families without a fused Gram: apply, then the masked-Gram
    kernel's path.  Leverage's rows are drawn from the port's own QR; at
    this size they agree with the reference's."""
    rj, rt = _run(data, sketch_family=family)
    _assert_same_history(rj, rt)


@pytest.mark.parametrize("model,overrides", [
    ("default", {}),
    ("fleet", dict(schedule="sequential")),
    (THINNED, dict(iters=3)),
])
def test_coded_kernel_matches_reference(data, model, overrides):
    """The coded products by the coded block mat-vec, erased workers
    skipped: the reference's history, on fleets whose erasures the decoder
    peels and on one whose exhausted phases force the re-execution
    fallback."""
    rj, rt = _run(data, model=model, **overrides)
    _assert_same_history(rj, rt)


@pytest.mark.parametrize("family", ["oversketch", "sjlt", "srht"])
@pytest.mark.parametrize("solver", ["chol", "cg"])
def test_distributed_avg_matches_reference(data, family, solver):
    rj, rt = _run(data, sketch_mode="distributed-avg", debias=True,
                  sketch_family=family, distavg_solver=solver)
    _assert_same_history(rj, rt)


def test_distributed_avg_plain_path_on_a_sequential_schedule(data):
    rj, rt = _run(data, sketch_mode="distributed-avg", use_kernels=False,
                  sketch_family="srht", schedule="sequential")
    _assert_same_history(rj, rt)


def test_debias_in_blocks_mode_matches_reference(data):
    rj, rt = _run(data, debias=True)
    _assert_same_history(rj, rt)


def test_distributed_avg_refuses_a_block_not_past_d(data):
    with pytest.raises(ValueError, match="block_size > Hessian dim"):
        t_newton(TLogistic(), convert.dataset(*data[1], device="cpu"),
                 np.zeros(D, np.float32),
                 TConfig(iters=1, sketch_mode="distributed-avg",
                         sketch=TSketch(80, 16, 0.25)), device="cpu")


@pytest.mark.parametrize("overrides,what", [
    (dict(adaptive_sketch=True), "adaptive_sketch"),
])
def test_unported_modes_are_refused(data, overrides, what):
    with pytest.raises(NotImplementedError, match=what):
        t_newton(TLogistic(), convert.dataset(*data[1], device="cpu"),
                 np.zeros(D, np.float32), TConfig(iters=1, **overrides),
                 device="cpu")


def test_exhausted_fleet_is_refused_not_degraded(data):
    """An exhausted phase degrades as the reference degrades (the name is
    from when the port refused): the same history on the same failing
    fleet; with ``fault_fallback="raise"`` the error propagates."""
    rj, rt = _run(data, model=EXHAUSTED, iters=3)
    _assert_same_history(rj, rt)
    fleet = TFleet(**EXHAUSTED)
    with pytest.raises(PhaseExhaustedError):
        t_newton(TLogistic(), convert.dataset(*data[1], device="cpu"),
                 np.zeros(D, np.float32),
                 TConfig(iters=1, sketch=TSketch(512, 64, 0.25),
                         gradient_policy="exact", fault_fallback="raise"),
                 model=TClock(TModel(), fleet=fleet), device="cpu")


@pytest.mark.parametrize("fleet", [EXHAUSTED, THINNED])
@pytest.mark.parametrize("mode", ["blocks", "distributed-avg"])
def test_degraded_fleet_matches_reference(data, fleet, mode):
    rj, rt = _run(data, model=fleet, sketch_mode=mode, iters=3,
                  schedule="sequential" if fleet is THINNED else "dag")
    _assert_same_history(rj, rt)
