"""Adaptive sketch growth and the chunked sketch apply in both packages on
the same inputs: ``tests/test_extensions.py``'s stall cases (no fleet),
``tests/test_scheduler.py``'s Marchenko-Pastur cases and validation errors
(a fleet), and ``tests/test_sketch.py``'s chunked apply.

Tolerances: the ``sketch_dim`` history, simulated time and cost bit for
bit; ``fval`` within 1e-5 relative (over the first five iterations of
the diverging stall case, see there); the chunked apply within 1e-5 (sums of
a few hundred O(1) rows, in another order than the reference's segment
sum)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import newton as jnewton
from repro.core import sketch as jsketch
from repro.core.objectives import Dataset as JDataset
from repro.core.objectives import LogisticRegression as JLogistic
from repro.core.straggler import StragglerModel as JModel

from repro_torch.core import newton as tnewton
from repro_torch.core import sketch as tsketch
from repro_torch.core.objectives import Dataset as TDataset
from repro_torch.core.objectives import LogisticRegression as TLogistic
from repro_torch.core.straggler import StragglerModel as TModel

torch.set_num_threads(1)


def _both_data(jd):
    return jd, TDataset(x=torch.from_numpy(np.array(jd.x)),
                        y=torch.from_numpy(np.array(jd.y)))


def _extensions_data(seed, n=1500, d=40):
    """tests/test_extensions.py's ``_logistic``."""
    kx, kw, ky = jax.random.split(jax.random.PRNGKey(seed), 3)
    x = jax.random.uniform(kx, (n, d), minval=-1, maxval=1)
    wstar = jax.random.normal(kw, (d,))
    y = jnp.where(jax.random.uniform(ky, (n,)) < jax.nn.sigmoid(x @ wstar),
                  1.0, -1.0)
    return _both_data(JDataset(x=x, y=y))


def _scheduler_data(n=800, d=16):
    """tests/test_scheduler.py's ``_logistic``."""
    x = jax.random.normal(jax.random.PRNGKey(0), (n, d))
    y = jnp.sign(x @ jax.random.normal(jax.random.PRNGKey(1), (d,)))
    return _both_data(JDataset(x=x, y=y))


def run_both(data, lam, sketch_args, model_kw=None, fval_iters=None, **cfg):
    """One config through both packages; ``model_kw`` None runs with no
    fleet, else a ``StragglerModel(**model_kw)``; ``fval_iters`` holds
    only the leading iterations' ``fval`` (None: all)."""
    jd, td = data
    d = jd.x.shape[1]
    rj = jnewton.oversketched_newton(
        JLogistic(**lam), jd, jnp.zeros(d),
        jnewton.NewtonConfig(sketch=jsketch.OverSketchConfig(*sketch_args),
                             **cfg),
        model=None if model_kw is None else JModel(**model_kw))
    rt = tnewton.oversketched_newton(
        TLogistic(**lam), td, np.zeros(d, np.float32),
        tnewton.NewtonConfig(sketch=tsketch.OverSketchConfig(*sketch_args),
                             **cfg),
        model=None if model_kw is None else TModel(**model_kw),
        device="cpu")
    hj, ht = rj.history, rt.history
    assert ht["sketch_dim"] == hj["sketch_dim"]
    assert ht["time"] == [float(v) for v in hj["time"]]
    assert ht["cost"] == [float(v) for v in hj["cost"]]
    np.testing.assert_allclose(ht["fval"][:fval_iters],
                               hj["fval"][:fval_iters], rtol=1e-5)
    return hj, ht


def test_adaptive_sketch_grows_on_stall():
    data = _extensions_data(0)
    # Unit steps on this tiny sketch diverge in both runs: f grows
    # ~1,000-fold in the first five iterations, after which the iterates
    # amplify float32 rounding (1e-6 relative) past any tolerance, in
    # either package against the other.  fval is held over those five;
    # sketch_dim, time and cost over all twelve.
    base = dict(iters=12, coded_block_rows=128, unit_step=True,
                fval_iters=5)
    # The reference's claim that growth ends at a smaller gradient norm
    # than the fixed run is a property of those diverged trajectories, so
    # it is checked on the reference's runs only.
    j_fixed, _ = run_both(data, dict(lam=1e-4), (64, 32, 0.25), **base)
    j_adapt, adapt = run_both(data, dict(lam=1e-4), (64, 32, 0.25),
                              adaptive_sketch=True, **base)
    assert 64 < max(adapt["sketch_dim"]) <= 64 * 4
    assert j_adapt["gnorm"][-1] < j_fixed["gnorm"][-1]


def test_adaptive_sketch_untouched_when_progress_is_fine():
    _, ht = run_both(_extensions_data(1), dict(lam=1e-4), (1024, 128, 0.25),
                     iters=5, adaptive_sketch=True, coded_block_rows=128,
                     unit_step=True)
    assert ht["sketch_dim"][-1] <= 2048


MODEL = dict(p_tail=0.1, tail_hi=3.0)


def test_mp_metric_grows_from_iteration_zero():
    data = _scheduler_data()
    cfg = dict(iters=3, adaptive_sketch=True, adaptive_mp_target=0.75)
    _, mp = run_both(data, {}, (32, 16, 0.25), MODEL, adaptive_metric="mp",
                     **cfg)
    assert mp["sketch_dim"][1] == 2 * mp["sketch_dim"][0]
    _, stall = run_both(data, {}, (32, 16, 0.25), MODEL,
                        adaptive_metric="stall", **cfg)
    assert stall["sketch_dim"][1] == mp["sketch_dim"][0]


def test_mp_metric_leaves_ample_sketch_alone():
    _, ht = run_both(_scheduler_data(), {}, (256, 64, 0.25), MODEL, iters=3,
                     adaptive_sketch=True, adaptive_metric="mp",
                     adaptive_mp_target=0.75)
    assert ht["sketch_dim"] == [256, 256, 256]


@pytest.mark.parametrize("overrides", [
    dict(schedule="zigzag"),
    dict(adaptive_metric="psychic"),
    dict(adaptive_sketch=True, adaptive_metric="mp",
         sketch_mode="distributed-avg"),
    dict(adaptive_sketch=True, adaptive_metric="mp", hessian_policy="exact"),
], ids=["schedule", "metric", "mp_distavg", "mp_exact"])
def test_validation_errors_match_reference(overrides):
    jd, td = _scheduler_data(n=64)
    with pytest.raises(ValueError) as je:
        jnewton.oversketched_newton(
            JLogistic(), jd, jnp.zeros(16),
            jnewton.NewtonConfig(iters=1, **overrides), model=None)
    with pytest.raises(ValueError) as te:
        tnewton.oversketched_newton(
            TLogistic(), td, np.zeros(16, np.float32),
            tnewton.NewtonConfig(iters=1, **overrides), model=None,
            device="cpu")
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("chunks,chunk_rows", [(4, 96), (5, 96)],
                         ids=["exact", "last_clamped"])
def test_apply_sketch_chunked_matches_reference(chunks, chunk_rows):
    """tests/test_sketch.py's setup (n = 384, d = 17); with five chunks
    the last start (384) is clamped back to 288, in A's slice and the
    sketch's alike."""
    n, d = 384, 17
    a = np.random.default_rng(4).standard_normal((n, d)).astype(np.float32)
    jcfg = jsketch.OverSketchConfig(256, 64, 0.5)
    jcs = jsketch.sample_countsketch(jax.random.PRNGKey(5), n, jcfg)
    tcs = tsketch.CountSketch(h=torch.from_numpy(np.array(jcs.h)),
                              sigma=torch.from_numpy(np.array(jcs.sigma)),
                              block_size=64)
    ja, ta = jnp.asarray(a), torch.from_numpy(a)
    ref = jsketch.apply_sketch_chunked(
        jcs, lambda c: jax.lax.dynamic_slice_in_dim(ja, c * chunk_rows,
                                                    chunk_rows),
        chunks, chunk_rows, d)

    def t_rows(c):
        start = min(c * chunk_rows, n - chunk_rows)
        return ta[start:start + chunk_rows]
    out = tsketch.apply_sketch_chunked(tcs, t_rows, chunks, chunk_rows, d)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    if chunks == 4:
        np.testing.assert_allclose(out.numpy(),
                                   tsketch.apply_sketch(tcs, ta).numpy(),
                                   rtol=1e-5, atol=1e-5)
