"""The port's benches (``repro_torch.benchmarks``) against the JAX
package's on the CPU, at small sizes; ``test_torch_benchmarks_fleet``
holds the fleet, scheduler and tenancy sweeps.

- fig. 1 whole, in both packages.
- figs. 6, 7, 8, 10, 11 and 12 hard-code their n and d, so the port's
  body runs at a small size and the reference's rows are built here from
  the JAX library's runs on the same data, with the reference bench's
  settings and ``benchmarks.common``.  Every logistic figure takes one
  shape (N x D, N_TEST test rows), so that the JAX package compiles each
  of its operations once for all of them.
- fig. 9 takes d from its data: the reference module's own ``run`` runs
  with its data source patched to a small dataset.
- ``benchmarks.common`` and the runner.

Every optimizer run is held (both sides' entry points are wrapped):
simulated time and cost bit for bit, fval and gnorm at every iteration
within rtol 1e-4, atol 1e-6.  In the rows, ``us`` is bit for bit and the
printed numbers of ``derived`` agree to rtol 1e-4 (or the last printed
digit), except where a run's fval crosses the figure's target within
1e-4 of it: there the crossing may fall on another iteration.  The
figures run their bodies for 2-4 iterations: past ~3 Newton iterations a
small problem reaches the float32 floor, where the packages' rounding
picks other line-search steps."""
import json
import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import torch

import benchmarks.common as jcommon
import benchmarks.fig1_stragglers as jfig1
import benchmarks.fig9_softmax as jfig9
import benchmarks.run as jrun
import repro.data as jdata
import repro.sketching as jsketching
from repro.core import (LogisticRegression, NewtonConfig, OverSketchConfig,
                        oversketched_newton)
from repro.core.straggler import SimClock, StragglerModel
from repro.optim import (FirstOrderConfig, GiantConfig, exact_newton,
                         first_order, giant)
from repro.runtime import CostModel

import repro_torch.benchmarks.fig1_stragglers as tfig1
import repro_torch.benchmarks.fig6_logistic_synthetic as tfig6
import repro_torch.benchmarks.fig7_epsilon as tfig7
import repro_torch.benchmarks.fig8_small_datasets as tfig8
import repro_torch.benchmarks.fig9_softmax as tfig9
import repro_torch.benchmarks.fig10_coded_vs_spec as tfig10
import repro_torch.benchmarks.fig11_first_order as tfig11
import repro_torch.benchmarks.fig12_serverful as tfig12
from repro_torch import convert
from repro_torch.benchmarks import common as tcommon
from repro_torch.benchmarks import run as trun

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-6
# One shape for every logistic figure: GIANT's 30, 60 and 100 workers
# each fill their last shard at N rows.
N, D, N_TEST = 2400, 16, 400
# The optimizer entry points each figure module calls, wrapped on both
# sides to collect every history in call order.
ENTRY_POINTS = ("oversketched_newton", "exact_newton", "giant",
                "first_order")


# ----------------------------------------------------------------- helpers
def as_port(jax_data):
    """The JAX package's dataset carried across to the port, on the CPU."""
    return convert.dataset(*(None if a is None else np.asarray(a)
                             for a in jax_data), device="cpu")


class Recorder:
    """Wraps a module's optimizer entry points; keeps each history."""

    def __init__(self, monkeypatch, module):
        self.hists = []
        for name in ENTRY_POINTS:
            fn = getattr(module, name, None)
            if fn is not None:
                monkeypatch.setattr(module, name, self._wrap(fn))

    def _wrap(self, fn):
        def wrapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            self.hists.append(out.history if hasattr(out, "history")
                              else out)
            return out
        return wrapped


def assert_same_histories(jhists, thists):
    """Each run's simulated time and cost bit for bit; fval and gnorm at
    every iteration within rtol 1e-4, atol 1e-6 (``test_torch_optim``'s
    tolerance: a converged run's gnorm is float32 rounding)."""
    assert len(thists) == len(jhists)
    for i, (jh, th) in enumerate(zip(jhists, thists)):
        for k in ("time", "cost"):
            assert th[k] == [float(v) for v in jh[k]], (i, k)
        for k in ("fval", "gnorm"):
            np.testing.assert_allclose(th[k], np.asarray(jh[k], np.float64),
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"run {i} {k}")


def near(hists, key, target) -> bool:
    """Whether any of the runs' ``key`` values lies within 1e-4 of the
    target, so that its crossing may fall on another iteration."""
    return any(abs(float(v) - target) <= RTOL * abs(target)
               for h in hists for v in h[key])


NUMBER = re.compile(r"^[<>=]*(-?(?:inf|\d+(?:\.(\d+))?(?:e([-+]\d+))?))x?$")


def close(a: str, b: str) -> bool:
    """Two printed numbers agree to rtol 1e-4, atol 1e-6, or the last
    printed digit; any other text must be equal."""
    ma, mb = NUMBER.match(a), NUMBER.match(b)
    if not (ma and mb):
        return a == b
    x, y = float(ma.group(1)), float(mb.group(1))
    if math.isinf(x) or math.isinf(y):
        return x == y
    digits = len(mb.group(2) or "")
    unit = 10.0 ** (int(mb.group(3) or 0) - digits)
    return math.isclose(x, y, rel_tol=RTOL, abs_tol=max(unit * 1.0001, ATOL))


def assert_rows_match(jrows, trows, loose=()):
    """Row for row: names, ``us`` bit for bit and every ``derived`` value
    printed alike, except the rows in ``loose`` (a near crossing), whose
    ``us`` and crossing time may differ."""
    assert [r["name"] for r in trows] == [r["name"] for r in jrows]
    for j, t in zip(jrows, trows):
        dj = dict(kv.split("=", 1) for kv in j["derived"].split(";"))
        dt = dict(kv.split("=", 1) for kv in t["derived"].split(";"))
        assert list(dt) == list(dj), j["name"]
        crossing = {"t_to_target", "t_to_gtarget", "ratio", "ratio>"}
        if j["name"] in loose:
            dj = {k: v for k, v in dj.items() if k not in crossing}
            dt = {k: v for k, v in dt.items() if k not in crossing}
        else:
            assert t["us"] == float(j["us"]), j["name"]
        for k in dj:
            assert close(dt[k], dj[k]), (j["name"], k, dt[k], dj[k])


def loose_rows(names_hists, hists, key="fval", target=None):
    """The rows whose crossing is near the figure's target."""
    target = jcommon.best_f(*hists) if target is None else target
    return {name for name, hs in names_hists if near(hs, key, target)}


def logistic(seed, cond=10.0, sorted_layout=True):
    """The figure's generator at the shared shape, in the JAX package."""
    return jdata.make_logistic_dataset(jax.random.PRNGKey(seed), N, D,
                                       n_test=N_TEST, cond=cond,
                                       sorted_layout=sorted_layout)


# ----------------------------------------------------------------- fig. 1
def test_fig1_matches_reference():
    assert tfig1.run() == jfig1.run()


# --------------------------------------- figs. 6, 10, 12: reference rebuilt
def reference_fig6(data, iters, giant_iters):
    """``benchmarks/fig6_logistic_synthetic.py``'s body on ``data``."""
    d = data.x.shape[1]
    obj, w0, model = LogisticRegression(lam=1e-5), jnp.zeros(d), \
        StragglerModel()
    sk = OverSketchConfig(sketch_dim=((10 * d) // 256 + 1) * 256,
                          block_size=256, straggler_tolerance=0.25)
    osn = oversketched_newton(
        obj, data, w0, NewtonConfig(iters=iters, sketch=sk, unit_step=False,
                                    coded_block_rows=256),
        model=model).history
    exact = exact_newton(obj, data, w0, iters=iters, model=model,
                         unit_step=False)
    gs = [giant(obj, data, w0, GiantConfig(iters=giant_iters,
                                           num_workers=60, policy=p,
                                           unit_step=False), model=model)
          for p in ("wait_all", "gcode", "ignore")]
    hists = [osn, exact, *gs]
    target = jcommon.best_f(*hists)
    out = []
    for name, h in zip(tfig6.RUNS, hists):
        t = jcommon.time_to_target(h, target)
        out.append({
            "name": f"fig6_{name}",
            "us": (t if t != float("inf") else h["time"][-1]) * 1e6,
            "derived": (f"t_to_target={t:.2f};final_f={h['fval'][-1]:.5f};"
                        f"final_gnorm={h['gnorm'][-1]:.2e}")})
    t_osn = jcommon.time_to_target(osn, target)
    t_ex = jcommon.time_to_target(exact, target)
    out.append({"name": "fig6_speedup_osn_vs_exact", "us": 0.0,
                "derived": f"ratio={t_ex / max(t_osn, 1e-9):.2f}x"})
    return out, hists


def test_fig6_matches_reference(monkeypatch):
    jd = logistic(0)
    jrows, jhists = reference_fig6(jd, 3, 2)
    seen = []
    trows = tfig6._fig6(as_port(jd), 3, 2,
                        observe=lambda name, run: seen.append(name) or
                        seen.append(run()) or seen[-1])
    thists = seen[1::2]
    assert seen[::2] == list(tfig6.RUNS)
    assert_same_histories(jhists, thists)
    names = [f"fig6_{n}" for n in tfig6.RUNS]
    loose = loose_rows([(n, [h]) for n, h in zip(names, jhists)]
                       + [("fig6_speedup_osn_vs_exact", jhists[:2])], jhists)
    assert_rows_match(jrows, trows, loose)


def reference_fig10(data, iters):
    d = data.x.shape[1]
    obj, w0, model = LogisticRegression(lam=1e-5), jnp.zeros(d), \
        StragglerModel()
    sk = OverSketchConfig(((10 * d) // 256 + 1) * 256, 256, 0.25)
    hists = {name: oversketched_newton(
        obj, data, w0, NewtonConfig(iters=iters, sketch=sk, unit_step=False,
                                    coded_block_rows=256, **kw),
        model=model).history for name, kw in tfig10.CASES.items()}
    target = jcommon.best_f(*hists.values())
    rows = []
    for name, h in hists.items():
        t = jcommon.time_to_target(h, target)
        rows.append({
            "name": f"fig10_{name}",
            "us": (t if t != float("inf") else h["time"][-1]) * 1e6,
            "derived": (f"t_to_target={t:.2f};final_f={h['fval'][-1]:.5f};"
                        f"usd={h['cost'][-1]:.4f}")})
    return rows, list(hists.values())


def test_fig10_matches_reference(monkeypatch):
    jd = logistic(4)
    jrows, jhists = reference_fig10(jd, 2)
    rec = Recorder(monkeypatch, tfig10)
    trows = tfig10._fig10(as_port(jd), 2)
    assert_same_histories(jhists, rec.hists)
    loose = loose_rows([(r["name"], [h]) for r, h in zip(jrows, jhists)],
                       jhists)
    assert_rows_match(jrows, trows, loose)


def reference_fig12(data, osn_iters, giant_iters):
    d = data.x.shape[1]
    obj, w0 = LogisticRegression(lam=1e-5), jnp.zeros(d)
    serverless = StragglerModel(invoke_overhead=0.10, comm_per_unit=0.05,
                                p_tail=0.02)
    serverful = StragglerModel(invoke_overhead=0.005, comm_per_unit=0.01,
                               p_tail=0.005, tail_hi=0.5,
                               flops_per_second=1e6)
    ec2_meters = CostModel(memory_gb=4.0, billing="reserved",
                           usd_per_gb_second=3.22e-6,
                           usd_per_invocation=0.0, usd_per_s3_put=0.0,
                           usd_per_s3_get=0.0)
    sk = OverSketchConfig(((10 * d) // 256 + 1) * 256, 256, 0.25)
    osn = oversketched_newton(
        obj, data, w0, NewtonConfig(iters=osn_iters, sketch=sk,
                                    unit_step=False,
                                    coded_block_rows=max(32, d // 7)),
        model=serverless).history
    g_mpi = giant(obj, data, w0,
                  GiantConfig(iters=giant_iters, num_workers=60,
                              policy="wait_all", unit_step=False),
                  model=SimClock(serverful, cost=ec2_meters))
    target = jcommon.best_f(osn, g_mpi)
    rows = []
    for name, h in [("osn_serverless", osn), ("giant_serverful_mpi", g_mpi)]:
        t = jcommon.time_to_target(h, target)
        rows.append({
            "name": f"fig12_{name}",
            "us": (t if t != float("inf") else h["time"][-1]) * 1e6,
            "derived": (f"t_to_target={t:.2f};final_f={h['fval'][-1]:.5f};"
                        f"usd={h['cost'][-1]:.4f}")})
    return rows, [osn, g_mpi]


def test_fig12_matches_reference(monkeypatch):
    jd = logistic(6)
    jrows, jhists = reference_fig12(jd, 3, 5)
    rec = Recorder(monkeypatch, tfig12)
    trows = tfig12._fig12(as_port(jd), 3, 5)
    assert_same_histories(jhists, rec.hists)
    loose = loose_rows([(r["name"], [h]) for r, h in zip(jrows, jhists)],
                       jhists)
    assert_rows_match(jrows, trows, loose)


# ------------------------------------------------ figs. 7 and 8: profiles
def reference_fig7(data, iters, fam_iters, families):
    """``benchmarks/fig7_epsilon.py``'s body on ``data``, with its rows,
    the sweep over ``families``."""
    d = data.x.shape[1]
    obj, w0, model = LogisticRegression(lam=1e-5), jnp.zeros(d), \
        StragglerModel()
    sk = OverSketchConfig(((15 * d) // 256 + 1) * 256, 256, 0.25)
    osn = oversketched_newton(obj, data, w0, NewtonConfig(
        iters=iters, sketch=sk, unit_step=False, coded_block_rows=256,
        track_test_error=True), model=model).history
    exact = exact_newton(obj, data, w0, iters=iters, model=model,
                         unit_step=False, track_test_error=True)
    g_wait, g_code = (giant(obj, data, w0, GiantConfig(
        iters=iters + 6, num_workers=100, policy=policy, unit_step=False,
        track_test_error=True, **kw), model=model)
        for policy, kw in (("wait_all", {}), ("gcode",
                                              {"gcode_redundancy": 4})))
    hists = [osn, exact, g_wait, g_code]
    target = jcommon.best_f(*hists)
    rows = []
    for name, h in zip(("osn", "exact_newton", "giant_waitall",
                        "giant_gcode"), hists):
        t = jcommon.time_to_target(h, target)
        rows.append({
            "name": f"fig7_{name}",
            "us": (t if t != float("inf") else h["time"][-1]) * 1e6,
            "derived": (f"t_to_target={t:.2f};"
                        f"test_err={h['test_error'][-1]:.4f};"
                        f"final_f={h['fval'][-1]:.5f}")})
    rows.append({
        "name": "fig7_gcode_vs_waitall_periter", "us": 0.0,
        "derived": (f"gcode_t={g_code['time'][-1]:.1f};"
                    f"waitall_t={g_wait['time'][-1]:.1f}")})
    for fam in families:
        h = oversketched_newton(obj, data, w0, NewtonConfig(
            iters=fam_iters, sketch=sk, unit_step=False,
            coded_block_rows=256, sketch_family=fam,
            track_test_error=True), model=model).history
        hists.append(h)
        rows.append(jcommon.json_row(
            f"fig7_family_{fam}", h["time"][-1] * 1e6,
            family=fam, sim_t=h["time"][-1], final_f=h["fval"][-1],
            gnorm=h["gnorm"][-1], test_err=h["test_error"][-1]))
    return rows, hists


def test_fig7_matches_reference(monkeypatch):
    """Fig. 7 runs eight Newton iterations; on a small problem they reach
    the float32 floor, where the packages' rounding picks other steps, so
    its body runs here at 3 (and 3 for the family sweep) through the
    library.  The sweep is held on two families: every family's Newton
    history is held in ``test_torch_newton``, and the registries must
    list the same families."""
    assert tfig7.sketch_families() == jsketching.available()
    families = ("oversketch", "sjlt")
    monkeypatch.setattr(tfig7, "sketch_families", lambda: families)
    jd = logistic(1)
    jrows, jhists = reference_fig7(jd, 3, 3, families)
    trec = Recorder(monkeypatch, tfig7)
    trows = tfig7._fig7(as_port(jd), 3, 3)
    assert_same_histories(jhists, trec.hists)
    for jh, th in zip(jhists, trec.hists):
        assert np.abs(np.asarray(th["test_error"])
                      - np.asarray(jh["test_error"])).max() <= 1.5 / N_TEST
    names = [r["name"] for r in jrows[:4]]
    loose = loose_rows([(n, [h]) for n, h in zip(names, jhists[:4])],
                       jhists[:4])
    assert_rows_match(jrows, trows, loose)
    assert [r["name"] for r in trows[5:]] == [
        f"fig7_family_{f}" for f in families]


def reference_fig8(profile, data, iters):
    """``benchmarks/fig8_small_datasets.py``'s ``_one`` on ``data``."""
    d = data.x.shape[1]
    obj, w0, model = LogisticRegression(lam=1e-5), jnp.zeros(d), \
        StragglerModel()
    sk = OverSketchConfig(((10 * d) // 128 + 1) * 128, 128, 0.25)
    osn = oversketched_newton(obj, data, w0, NewtonConfig(
        iters=iters, sketch=sk, unit_step=False, coded_block_rows=128),
        model=model).history
    exact = exact_newton(obj, data, w0, iters=iters, model=model,
                         unit_step=False)
    g = giant(obj, data, w0, GiantConfig(iters=iters + 5, num_workers=30,
                                         unit_step=False), model=model)
    hists = [osn, exact, g]
    target = jcommon.best_f(*hists)
    rows = []
    for name, h in zip(("osn", "exact_newton", "giant"), hists):
        t = jcommon.time_to_target(h, target)
        rows.append({
            "name": f"fig8_{profile}_{name}",
            "us": (t if t != float("inf") else h["time"][-1]) * 1e6,
            "derived": f"t_to_target={t:.2f};final_f={h['fval'][-1]:.5f}"})
    return rows, hists


def test_fig8_matches_reference(monkeypatch):
    """One profile's body at 3 iterations (fig. 8 runs seven, which on a
    small problem reach the float32 floor; see fig. 7's test).  The other
    profile runs the same body; the profile enters only the row names."""
    trec = Recorder(monkeypatch, tfig8)
    jd = logistic(2, cond=1.0)
    jrows, jhists = reference_fig8("webpage", jd, 3)
    trows = tfig8._one("webpage", as_port(jd), 3)
    assert_same_histories(jhists, trec.hists)
    loose = loose_rows([(r["name"], [h]) for r, h in zip(jrows, jhists)],
                       jhists)
    assert_rows_match(jrows, trows, loose)


# ---------------------------------------- figs. 9 and 11: first order
def test_fig9_matches_reference(monkeypatch):
    jd = jdata.make_softmax_dataset(jax.random.PRNGKey(3), 600, 8, 10)
    monkeypatch.setattr(jdata, "make_softmax_dataset", lambda *a, **k: jd)
    jrec, trec = Recorder(monkeypatch, jfig9), Recorder(monkeypatch, tfig9)
    jrows = jfig9.run(quick=True)
    trows = tfig9._fig9(as_port(jd), 6, 30)
    assert_same_histories(jrec.hists, trec.hists)
    loose = {r["name"] for r, h in zip(jrows, jrec.hists)
             if near([h], "gnorm", 3e-2)}
    assert_rows_match(jrows, trows, loose)


def reference_fig11(data, osn_iters, fo_iters):
    """``benchmarks/fig11_first_order.py``'s body on ``data``."""
    d = data.x.shape[1]
    obj, w0, model = LogisticRegression(lam=1e-5), jnp.zeros(d), \
        StragglerModel()
    sk = OverSketchConfig(((15 * d) // 256 + 1) * 256, 256, 0.25)
    osn = oversketched_newton(
        obj, data, w0, NewtonConfig(iters=osn_iters, sketch=sk,
                                    unit_step=False, coded_block_rows=256),
        model=model).history
    fo = [first_order(obj, data, w0, FirstOrderConfig(
        iters=fo_iters, method=m, policy="ignore", num_workers=100,
        backtracking=True), model=model) for m in ("gd", "nag")]
    sgd = first_order(obj, data, w0, FirstOrderConfig(
        iters=fo_iters, method="sgd", batch_fraction=0.2, lr=0.5,
        backtracking=False, num_workers=100), model=model)
    hists = [osn, *fo, sgd]
    target = jcommon.best_f(osn)
    rows = []
    for name, h in zip(("osn", "gd_backtrack", "nag_backtrack", "sgd20"),
                       hists):
        t = jcommon.time_to_target(h, target)
        rows.append({
            "name": f"fig11_{name}",
            "us": (t if t != float("inf") else h["time"][-1]) * 1e6,
            "derived": (f"t_to_target={t if t != float('inf') else -1:.2f};"
                        f"final_f={h['fval'][-1]:.5f}")})
    t_osn = jcommon.time_to_target(osn, target)
    t_best_fo = min(jcommon.time_to_target(h, target) for h in fo)
    ratio = (t_best_fo / max(t_osn, 1e-9)) if t_best_fo != float("inf") \
        else float(fo[0]["time"][-1] / max(t_osn, 1e-9))
    rows.append({"name": "fig11_speedup_vs_first_order", "us": 0.0,
                 "derived": f"ratio>={ratio:.1f}x"})
    return rows, hists


def test_fig11_matches_reference(monkeypatch):
    jd = logistic(5, cond=100.0, sorted_layout=False)
    jrows, jhists = reference_fig11(jd, 4, 20)
    rec = Recorder(monkeypatch, tfig11)
    trows = tfig11._fig11(as_port(jd), 4, 20)
    assert_same_histories(jhists, rec.hists)
    target = jcommon.best_f(jhists[0])
    loose = {r["name"] for r, h in zip(jrows, jhists)
             if near([h], "fval", target)}
    if loose:
        loose.add("fig11_speedup_vs_first_order")
    assert_rows_match(jrows, trows, loose)


# ---------------------------------------------------------- the runner
def test_runner_prints_rows_and_writes_one_payload(tmp_path, capsys):
    out = tmp_path / "bench.json"
    assert trun.main(["--only", "fig1_", "--device", "cpu", "--out",
                      str(out)]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "name,us_per_call,derived"
    row = jfig1.run()[0]
    assert lines[1] == jcommon.row(row["name"], row["us"], row["derived"])
    payload = json.loads(out.read_text())
    assert payload["meta"]["device"] == "cpu"
    assert payload["meta"]["torch_version"] == torch.__version__
    assert set(payload["meta"]["module_seconds"]) == {"fig1_stragglers"}
    assert [r["name"] for r in payload["rows"]] == ["fig1_straggler_tail"]
    assert trun._artifact_path("x.json") == trun.ARTIFACTS / "x.json"
    assert trun.MODULES == [m for m in jrun.MODULES
                            if m not in ("kernels_bench", "roofline")]


def test_common_matches_reference():
    h = {"fval": [3.0, 2.0, 1.0], "time": [1.0, 2.0, 3.0]}
    assert tcommon.time_to_target(h, 2.0) == jcommon.time_to_target(h, 2.0)
    assert tcommon.best_f(h, h) == jcommon.best_f(h, h)
    assert tcommon.row("a", 1.25, "x=1") == jcommon.row("a", 1.25, "x=1")
    assert tcommon.json_row("a", 2.0, x=1.5, y="z") == \
        jcommon.json_row("a", 2.0, x=1.5, y="z")
    assert tcommon.time_fn(lambda: torch.ones(3), iters=3, warmup=1) > 0
