"""The baseline optimizers in both packages on the same numpy inputs:
every non-AdamW case of ``tests/test_optim.py`` (n = 1,200, d = 20
logistic regression), GIANT under each straggler policy on both schedules,
the first-order methods under each policy, exact Newton, gradient coding's
decode weights, and ``prng.permutation`` against ``jax.random``.

Histories are held as ``tests/test_torch_newton.py`` holds Newton's:
``iter``, ``step``, simulated ``time`` and ``cost`` equal, ``fval``,
``gnorm`` and ``w`` within rtol 1e-4, atol 1e-6."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Dataset as JDataset
from repro.core import LogisticRegression as JLogistic
from repro.core import SimClock as JClock
from repro.core import StragglerModel as JModel
from repro.optim import FirstOrderConfig as JFirstOrder
from repro.optim import GiantConfig as JGiant
from repro.optim import assignment as j_assignment
from repro.optim import decode_weights as j_decode_weights
from repro.optim import exact_newton as j_exact_newton
from repro.optim import first_order as j_first_order
from repro.optim import giant as j_giant
from repro.optim import gradient_coding_phase as j_gcode_phase

from repro_torch import prng
from repro_torch.core import Dataset as TDataset
from repro_torch.core import LogisticRegression as TLogistic
from repro_torch.core import SimClock as TClock
from repro_torch.core import StragglerModel as TModel
from repro_torch.optim import FirstOrderConfig as TFirstOrder
from repro_torch.optim import GiantConfig as TGiant
from repro_torch.optim import assignment as t_assignment
from repro_torch.optim import decode_weights as t_decode_weights
from repro_torch.optim import exact_newton as t_exact_newton
from repro_torch.optim import first_order as t_first_order
from repro_torch.optim import giant as t_giant
from repro_torch.optim import gradient_coding_phase as t_gcode_phase

torch.set_num_threads(1)

D = 20
HEAVY = dict(p_tail=0.2, tail_hi=4.0)   # tests/test_optim.py's heavy tail


@pytest.fixture(scope="module")
def problem():
    """tests/test_optim.py's logistic problem, and its numpy copy."""
    key = jax.random.PRNGKey(0)
    n = 1200
    kx, kw, ky = jax.random.split(key, 3)
    x = jax.random.uniform(kx, (n, D), minval=-1, maxval=1)
    wstar = jax.random.normal(kw, (D,))
    y = jnp.where(jax.random.uniform(ky, (n,)) < jax.nn.sigmoid(x @ wstar),
                  1.0, -1.0)
    return (JDataset(x=x, y=y),
            TDataset(x=torch.from_numpy(np.array(x)),
                     y=torch.from_numpy(np.array(y))))


def _models(model):
    """The same fleet in both packages: "default", None or a dict of
    StragglerModel fields."""
    if model == "default":
        return {}, {}
    if model is None:
        return {"model": None}, {"model": None}
    return {"model": JModel(**model)}, {"model": TModel(**model)}


def assert_same_history(hj, ht):
    assert ht["iter"] == hj["iter"]
    assert ht["step"] == [float(v) for v in hj["step"]]
    for k in ("time", "cost"):
        assert ht[k] == [float(v) for v in hj[k]], k
    for k in ("fval", "gnorm"):
        np.testing.assert_allclose(ht[k], hj[k], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(ht["w"].numpy(), np.asarray(hj["w"]),
                               rtol=1e-4, atol=1e-6)


def run_giant(problem, model="default", **cfg):
    jd, td = problem
    jkw, tkw = _models(model)
    hj = j_giant(JLogistic(lam=1e-4), jd, jnp.zeros(D), JGiant(**cfg), **jkw)
    ht = t_giant(TLogistic(lam=1e-4), td, np.zeros(D, np.float32),
                 TGiant(**cfg), device="cpu", **tkw)
    return hj, ht


def run_first_order(problem, model="default", **cfg):
    jd, td = problem
    jkw, tkw = _models(model)
    hj = j_first_order(JLogistic(lam=1e-4), jd, jnp.zeros(D),
                       JFirstOrder(**cfg), **jkw)
    ht = t_first_order(TLogistic(lam=1e-4), td, np.zeros(D, np.float32),
                       TFirstOrder(**cfg), device="cpu", **tkw)
    return hj, ht


@pytest.mark.parametrize("schedule", ["dag", "sequential"])
@pytest.mark.parametrize("policy", ["wait_all", "gcode", "ignore"])
def test_giant_matches_reference(problem, policy, schedule):
    """test_giant_policies_time_ordering's fleet, every policy on both
    schedules."""
    hj, ht = run_giant(problem, HEAVY, iters=4, num_workers=24,
                       policy=policy, schedule=schedule)
    assert_same_history(hj, ht)


def test_giant_ignore_beats_wait_all_in_time(problem):
    """The paper's Fig. 6/7 observation in the port, as the reference's
    test states it."""
    _, ignore = run_giant(problem, HEAVY, iters=4, num_workers=24,
                          policy="ignore")
    _, wait = run_giant(problem, HEAVY, iters=4, num_workers=24,
                        policy="wait_all")
    assert ignore["time"][-1] < wait["time"][-1]


@pytest.mark.parametrize("unit_step", [True, False])
def test_giant_without_fleet_matches_and_converges(problem, unit_step):
    """test_giant_converges_fast's run, and the same with the line search
    (and its phase on the default fleet)."""
    hj, ht = run_giant(problem, None, iters=5, num_workers=12,
                       unit_step=unit_step)
    assert_same_history(hj, ht)
    assert ht["gnorm"][-1] < 5e-2
    assert ht["fval"][-1] < ht["fval"][0]
    if not unit_step:
        hj, ht = run_giant(problem, "default", iters=3, num_workers=12,
                           unit_step=False)
        assert_same_history(hj, ht)


@pytest.mark.parametrize("policy", ["wait_all", "ignore", "gcode"])
@pytest.mark.parametrize("method", ["gd", "nag", "sgd"])
def test_first_order_matches_reference(problem, method, policy):
    """Backtracking on (fig. 11's setup), the default fleet; sgd draws its
    batch by prng.permutation, jax's choice without replacement."""
    hj, ht = run_first_order(problem, iters=6, method=method, policy=policy)
    assert_same_history(hj, ht)
    if method == "gd" and policy == "ignore":
        assert ht["fval"][-1] < ht["fval"][0]   # test_gd_decreases


@pytest.mark.parametrize("method", ["gd", "nag"])
def test_first_order_without_fleet_matches(problem, method):
    """test_nag_beats_gd_in_iterations's runs."""
    hj, ht = run_first_order(problem, None, iters=25, method=method)
    assert_same_history(hj, ht)
    assert ht["time"] == [float(t + 1) for t in range(25)]


def test_gradient_coding_charges_replication(problem):
    """test_gcode_charges_replication_cost's runs: r = 3 gradient coding
    against ignore, no backtracking."""
    fleet = dict(p_tail=0.02)
    hj, gc = run_first_order(problem, fleet, iters=4, policy="gcode",
                             gcode_redundancy=3, backtracking=False)
    assert_same_history(hj, gc)
    hj, ig = run_first_order(problem, fleet, iters=4, policy="ignore",
                             backtracking=False)
    assert_same_history(hj, ig)
    assert gc["time"][-1] > ig["time"][-1]


@pytest.mark.parametrize("model", [None, "default"])
def test_exact_newton_matches_reference(problem, model):
    """test_exact_newton_reaches_optimum's run, and the coded gradient and
    speculative exact Hessian on the default fleet."""
    jd, td = problem
    jkw, tkw = _models(model)
    iters = 7 if model is None else 4
    hj = j_exact_newton(JLogistic(lam=1e-4), jd, jnp.zeros(D), iters=iters,
                        **jkw)
    ht = t_exact_newton(TLogistic(lam=1e-4), td, np.zeros(D, np.float32),
                        iters=iters, device="cpu", **tkw)
    assert_same_history(hj, ht)
    if model is None:
        assert ht["gnorm"][-1] < 1e-4


@pytest.mark.parametrize("w,r,stragglers", [
    (12, 3, [2, 7]),        # r - 1 = 2 stragglers: decodable
    (8, 2, [0, 1]),         # an adjacent pair with r - 1 = 1: not
    (8, 2, [0, 4]),
    (10, 4, [1, 2, 3]),
    (10, 4, [0, 2, 5, 7]),
    (6, 1, []),
    (6, 2, list(range(6))),
])
def test_decode_weights_match_reference(w, r, stragglers):
    finished = np.ones(w, bool)
    finished[stragglers] = False
    np.testing.assert_array_equal(t_assignment(w, r), j_assignment(w, r))
    want = j_decode_weights(finished, w, r)
    got = t_decode_weights(finished, w, r)
    if want is None:
        assert got is None
        return
    np.testing.assert_array_equal(got, want)
    b = np.zeros((w, w))
    for i in range(w):
        b[i, t_assignment(w, r)[i]] = 1
    np.testing.assert_allclose(b.T @ got, np.ones(w), atol=1e-6)
    assert np.allclose(got[~finished], 0)


@pytest.mark.parametrize("flops", [None, 3e5])
def test_gradient_coding_phase_matches_reference(flops):
    jc, tc = JClock(JModel()), TClock(TModel())
    for i in range(3):
        j_gcode_phase(jc, jax.random.PRNGKey(i), 16, 3,
                      flops_per_worker=flops)
        t_gcode_phase(tc, prng.PRNGKey(i), 16, 3, flops_per_worker=flops)
    assert tc.time == jc.time
    assert tc.dollars == jc.dollars
    t_gcode_phase(None, prng.PRNGKey(0), 16, 3)   # no clock: a no-op


@pytest.mark.parametrize("n", [1, 2, 1200, 65537, 300000])
def test_permutation_matches_jax(n):
    """jax's _shuffle bit for bit (0, 1, 1, 2 and 2 sort rounds), and its
    head is choice(..., replace=False)."""
    for seed in (0, 11):
        got = prng.permutation(prng.PRNGKey(seed), n, device="cpu")
        want = np.asarray(jax.random.permutation(jax.random.PRNGKey(seed),
                                                 n))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        nb = max(1, n // 5)
        np.testing.assert_array_equal(
            got[:nb].numpy(),
            np.asarray(jax.random.choice(jax.random.PRNGKey(seed), n, (nb,),
                                         replace=False)))
