"""The round's parity target: ``examples/quickstart.py``'s configuration
(n = 4,000, d = 150, ``OverSketchConfig(1536, 128, 0.25)``, 10 iterations,
coded gradients, the kernel path) in both packages on the CPU, with the
fleet's per-phase masks recorded in each (``SimClock.phase``'s returned
masks; the history holds none) and compared exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import LogisticRegression as JLogistic
from repro.core import NewtonConfig as JConfig
from repro.core import OverSketchConfig as JSketch
from repro.core import SimClock as JClock
from repro.core import oversketched_newton as j_newton
from repro.data import make_logistic_dataset

from repro_torch import convert
from repro_torch.core import LogisticRegression as TLogistic
from repro_torch.core import NewtonConfig as TConfig
from repro_torch.core import OverSketchConfig as TSketch
from repro_torch.core import SimClock as TClock
from repro_torch.core import oversketched_newton as t_newton

torch.set_num_threads(1)

N, D, N_TEST = 4000, 150, 1000


def _record_masks(monkeypatch, clock_cls):
    """Wrap ``clock_cls.phase`` so that every call's mask is kept, as numpy
    booleans, in call order."""
    masks = []
    phase = clock_cls.phase

    def recording(self, *args, **kwargs):
        elapsed, mask = phase(self, *args, **kwargs)
        masks.append(np.asarray(mask, dtype=bool).copy())
        return elapsed, mask
    monkeypatch.setattr(clock_cls, "phase", recording)
    return masks


def test_quickstart_history_and_masks_match_reference(monkeypatch):
    jd = make_logistic_dataset(jax.random.PRNGKey(0), N, D, n_test=N_TEST)
    kw = dict(iters=10, gradient_policy="coded", use_kernels=True,
              track_test_error=True)
    j_masks = _record_masks(monkeypatch, JClock)
    rj = j_newton(JLogistic(lam=1e-4), jd, jnp.zeros(D),
                  JConfig(sketch=JSketch(1536, 128, 0.25), **kw))
    t_masks = _record_masks(monkeypatch, TClock)
    rt = t_newton(TLogistic(lam=1e-4),
                  convert.dataset(*[np.asarray(a) for a in jd],
                                  device="cpu"),
                  np.zeros(D, np.float32),
                  TConfig(sketch=TSketch(1536, 128, 0.25), **kw),
                  device="cpu")

    assert len(j_masks) > 2 * kw["iters"]
    assert len(t_masks) == len(j_masks)
    for i, (mt, mj) in enumerate(zip(t_masks, j_masks)):
        np.testing.assert_array_equal(mt, mj, err_msg=f"phase call {i}")

    hj, ht = rj.history, rt.history
    assert ht["iter"] == [int(v) for v in hj["iter"]]
    assert ht["sketch_dim"] == [int(v) for v in hj["sketch_dim"]]
    for k in ("step", "time", "cost"):
        assert ht[k] == [float(v) for v in hj[k]], k
    np.testing.assert_allclose(ht["fval"], hj["fval"], rtol=1e-5, atol=0)
    # w relative to its largest entry: an entry near 0 carries the same
    # absolute float32 rounding as the others.
    wj = np.asarray(rj.w)
    np.testing.assert_allclose(rt.w.numpy(), wj, rtol=0,
                               atol=1e-5 * np.abs(wj).max())
    np.testing.assert_allclose(ht["gnorm"], hj["gnorm"], rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(ht["test_error"], hj["test_error"],
                               rtol=1e-4, atol=1e-6)
