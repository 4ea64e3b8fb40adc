"""Live telemetry in the port: the ``obs`` package's cases, then the same
drives through both packages with every span, metric, alert and incident
compared.

1. Every case of ``tests/test_obs.py``, ``tests/test_health.py`` and
   ``tests/test_store_diff.py`` that exercises ``obs`` and the fleet runs
   with its module's names bound to the port's (``obs``, ``SimClock``,
   ``FleetConfig``, ``WarmPool``, ``run_dag``, the detectors, and
   ``jax.random.PRNGKey`` to ``prng.PRNGKey``): the Perfetto golden bytes,
   the store and diff goldens and the health monitors included.  The cases
   that drive Newton, GIANT or the kernels are written out below, and the
   one that drives the reference's ``benchmarks.make_report`` is not the
   port's.
2. The fleet, Newton (both schedules, the kernel path, a corruption plan)
   and GIANT drives in both packages: telemetry is observation only, the
   spans equal the reference's row for row (name, kind, start, end,
   track, attrs), and the metrics snapshot equals the reference's except
   for ``kernel.path.*``: the port's ``fused_path`` reports "fused" or
   "unfused", the reference's also "fused_tiled".
3. Every scenario drive of ``tests/test_incident.py`` attributes the same
   incidents in both packages, and ``render_console`` gives the same bytes.
4. The kernel profiler hook (``kernels.ops.set_profiler``)."""
import importlib
import inspect
import json
import pathlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_health
import test_obs
import test_store_diff

import repro.obs as jobs
import repro.runtime as jrt
import repro.scheduler as jsched
from repro.core import straggler as jstraggler
from repro.core.newton import NewtonConfig as JConfig
from repro.core.newton import oversketched_newton as j_newton
from repro.core.objectives import Dataset as JDataset
from repro.core.objectives import LogisticRegression as JLogistic
from repro.core.sketch import OverSketchConfig as JSketch
from repro.optim import GiantConfig as JGiant
from repro.optim import giant as j_giant

import repro_torch.obs as tobs
import repro_torch.runtime as trt
import repro_torch.scheduler as tsched
from repro_torch import prng
from repro_torch.core import straggler as tstraggler
from repro_torch.core.newton import NewtonConfig as TConfig
from repro_torch.core.newton import oversketched_newton as t_newton
from repro_torch.core.objectives import Dataset as TDataset
from repro_torch.core.objectives import LogisticRegression as TLogistic
from repro_torch.core.sketch import OverSketchConfig as TSketch
from repro_torch.kernels import ops as tops
from repro_torch.optim import GiantConfig as TGiant
from repro_torch.optim import giant as t_giant

torch.set_num_threads(1)

FIXTURES = pathlib.Path(__file__).parent / "fixtures"


# ------------------------------------------- 1. the reference's cases, ported
NOT_PORT_CASES = {
    # Written out below, in both packages.
    "test_newton_telemetry_is_observation_only",
    "test_giant_telemetry_is_observation_only",
    "test_ops_profiler_hook",
    # Drives the reference's benchmarks.make_report, which reads repro.obs.
    "test_make_report_diff_mode",
}
JAX_KEYS = types.SimpleNamespace(
    random=types.SimpleNamespace(PRNGKey=prng.PRNGKey),
    __version__=torch.__version__)


def _port_value(value):
    """The port's counterpart of a reference module global, or None."""
    if value is jax:
        return JAX_KEYS
    if isinstance(value, types.ModuleType):
        name = value.__name__
        if name == "repro" or name.startswith("repro."):
            return importlib.import_module("repro_torch" + name[5:])
        return None
    module = getattr(value, "__module__", None) or ""
    if module.startswith("repro."):
        return getattr(importlib.import_module("repro_torch" + module[5:]),
                       value.__name__)
    return None


REFERENCE_CASES = [
    pytest.param(mod, name, id=f"{mod.__name__}::{name}")
    for mod in (test_obs, test_health, test_store_diff)
    for name, fn in vars(mod).items()
    if name.startswith("test_") and inspect.isfunction(fn)
    and name not in NOT_PORT_CASES]


@pytest.mark.parametrize("mod,name", REFERENCE_CASES)
def test_reference_case_on_the_port(mod, name, monkeypatch, request):
    for glob, value in list(vars(mod).items()):
        port = _port_value(value)
        if port is not None:
            monkeypatch.setattr(mod, glob, port)
    assert mod.obs is tobs
    fn = getattr(mod, name)
    fn(**{arg: request.getfixturevalue(arg)
          for arg in inspect.signature(fn).parameters})


def test_perfetto_golden_bytes_from_the_port():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(test_obs, "obs", tobs)
        spans = test_obs._synthetic_spans()
    assert all(type(s) is tobs.Span for s in spans)
    assert tobs.dumps_stable(tobs.to_perfetto(spans)) == \
        (FIXTURES / "perfetto_golden.json").read_text()


def test_store_and_diff_match_reference(tmp_path):
    base, head = (json.loads((FIXTURES / f"bench_{n}_golden.json")
                             .read_text()) for n in ("base", "head"))
    out = {}
    for pkg in (jobs, tobs):
        path = tmp_path / f"{pkg.__name__}.jsonl"
        store = pkg.Store(path)
        store.append(pkg.bench_record(base))
        store.append(pkg.bench_record(head))
        report = pkg.diff_bench(base, head)
        out[pkg] = (store.records(), store.kernel_path_table(),
                    report.to_json(), report.summary(), report.table(),
                    pkg.diff_store(path, "kernels_bench").to_json())
    # As JSON text: the diff rows carry NaN ratios for added rows.
    assert json.dumps(out[tobs]) == json.dumps(out[jobs])


# --------------------------------------------------- 2. drives, both packages
class Package(types.SimpleNamespace):
    """One package's modules, so each drive is written once."""
    __hash__ = object.__hash__


J = Package(obs=jobs, rt=jrt, sched=jsched, sg=jstraggler,
            key=jax.random.PRNGKey)
T = Package(obs=tobs, rt=trt, sched=tsched, sg=tstraggler, key=prng.PRNGKey)


def rows(tel):
    """A run's exported rows, as JSON holds them."""
    pkg = tobs if isinstance(tel, tobs.Telemetry) else jobs
    return [json.loads(json.dumps(r)) for r in pkg.telemetry_rows(tel)]


def assert_same_telemetry(jtel, ttel):
    """Every row equal, the metrics row except ``kernel.path.*``."""
    jr, tr = rows(jtel), rows(ttel)
    assert len(tr) == len(jr)
    for a, b in zip(jr[:-1], tr[:-1]):
        assert b == a
    jm, tm = jr[-1], tr[-1]
    assert tm["kind"] == jm["kind"] == "metrics"
    for section in ("gauges", "histograms"):
        assert tm[section] == jm[section], section

    def plain(counters):
        return {k: v for k, v in counters.items()
                if not k.startswith("kernel.path.")}
    assert plain(tm["counters"]) == plain(jm["counters"])
    assert sum(v for k, v in tm["counters"].items()
               if k.startswith("kernel.path.")) == \
        sum(v for k, v in jm["counters"].items()
            if k.startswith("kernel.path."))
    # Beyond the snapshot: every gauge's series and every histogram's
    # values, with their simulated timestamps.
    for kind in ("gauges", "histograms"):
        jd, td = getattr(jtel.metrics, kind), getattr(ttel.metrics, kind)
        assert sorted(td) == sorted(jd)
        for name in jd:
            a, b = jd[name], td[name]
            assert (b.series if kind == "gauges" else b.values) == \
                (a.series if kind == "gauges" else a.values), name
            assert b.points == a.points, name


def fleet_drive(p, telemetry=None):
    """tests/test_obs.py's ``_fleet_drive``."""
    clock = p.sg.SimClock(p.sg.StragglerModel(p_tail=0.1, tail_hi=3.0),
                          fleet=p.rt.FleetConfig(failure_rate=0.2,
                                                 cold_start_prob=0.3),
                          pool=p.sched.WarmPool(ttl=5.0, prewarmed=2),
                          telemetry=telemetry)
    for r in range(3):
        clock.phase(p.key(r), 6, policy="k_of_n", k=4, flops_per_worker=2e5,
                    comm_units=1.0, phase_name=f"p{r}")
    clock.charge(0.125, phase_name="decode")
    return clock


def test_fleet_drive_matches_reference():
    tels = {p: p.obs.Telemetry(monitors=True) for p in (J, T)}
    plain = fleet_drive(T)
    live = {p: fleet_drive(p, tels[p]) for p in (J, T)}
    assert (live[T].time, live[T].dollars) == (plain.time, plain.dollars)
    assert (live[T].time, live[T].dollars) == (live[J].time,
                                               live[J].dollars)
    assert_same_telemetry(tels[J], tels[T])


@pytest.fixture(scope="module")
def newton_data():
    """tests/test_obs.py's ``_tiny_newton`` data (n = 128, d = 8)."""
    x = jax.random.normal(jax.random.PRNGKey(0), (128, 8))
    y = jnp.sign(x @ jax.random.normal(jax.random.PRNGKey(1), (8,)))
    return (JDataset(x=x, y=y),
            TDataset(x=torch.from_numpy(np.array(x)),
                     y=torch.from_numpy(np.array(y))))


def newton_drive(p, data, telemetry=None, **cfg):
    """``_tiny_newton``: 2 iterations of OverSketchConfig(64, 16, 0.25)."""
    kw = dict(iters=2, sketch=(TSketch if p is T else JSketch)(
        sketch_dim=64, block_size=16, straggler_tolerance=0.25))
    kw.update(cfg)
    clock = p.sg.SimClock(p.sg.StragglerModel(p_tail=0.05, tail_hi=3.0),
                          telemetry=telemetry)
    if p is T:
        res = t_newton(TLogistic(), data[1], np.zeros(8, np.float32),
                       TConfig(**kw), clock, device="cpu")
    else:
        res = j_newton(JLogistic(), data[0], jnp.zeros(8), JConfig(**kw),
                       clock)
    return res.history


@pytest.mark.parametrize("cfg", [
    dict(schedule="dag"), dict(schedule="sequential"),
    dict(use_kernels=True, solver="cg"),
], ids=["dag", "sequential", "kernels_cg"])
def test_newton_telemetry_matches_reference(newton_data, cfg):
    """(A Newton run under corruption is the incident test's drive.)"""
    def drive(p, tel=None):
        return newton_drive(p, newton_data, tel, **cfg)
    tels = {p: p.obs.Telemetry(monitors=True) for p in (J, T)}
    plain = drive(T)
    live = {p: drive(p, tels[p]) for p in (J, T)}
    for k in ("time", "cost", "fval", "step", "sketch_dim"):
        assert live[T][k] == plain[k], k
    for k in ("time", "cost", "step", "sketch_dim"):
        assert live[T][k] == [float(v) for v in live[J][k]], k
    assert_same_telemetry(tels[J], tels[T])

    tel = tels[T]
    runs = tel.trace.by_kind("run")
    assert len(runs) == 1 and runs[0].name == "newton"
    iters = tel.trace.by_kind("iteration")
    assert len(iters) == 2
    if cfg.get("schedule", "dag") == "dag":
        for s in iters:
            assert s.attrs["critical_path"][-1] == "linesearch"
            assert set(s.attrs["slack"]) >= {"hessian", "linesearch"}
    assert tel.metrics.snapshot()["gauges"]["sketch.m_eff"]["value"] > 0
    tobs.validate_trace(tobs.to_perfetto(tel.trace.spans),
                        require_phases=("hessian", "linesearch"))


def test_adaptive_growth_is_counted_like_the_reference(newton_data):
    tels = {p: p.obs.Telemetry() for p in (J, T)}
    for p in (J, T):
        newton_drive(p, newton_data, tels[p], iters=3,
                     sketch=(TSketch if p is T else JSketch)(16, 16, 0.25),
                     adaptive_sketch=True, adaptive_metric="mp")
    assert_same_telemetry(tels[J], tels[T])
    assert tels[T].metrics.snapshot()["counters"][
        "newton.adaptive_growth"] >= 1.0


def giant_drive(p, telemetry=None):
    """tests/test_obs.py's GIANT case (n = 96, d = 6, 8 workers)."""
    x = jax.random.normal(jax.random.PRNGKey(3), (96, 6))
    y = jnp.sign(x @ jax.random.normal(jax.random.PRNGKey(4), (6,)))
    clock = p.sg.SimClock(p.sg.StragglerModel(p_tail=0.05, tail_hi=3.0),
                          telemetry=telemetry)
    if p is T:
        return t_giant(TLogistic(), TDataset(x=torch.from_numpy(np.array(x)),
                                             y=torch.from_numpy(np.array(y))),
                       np.zeros(6, np.float32),
                       TGiant(iters=2, num_workers=8), model=clock,
                       device="cpu")
    return j_giant(JLogistic(), JDataset(x=x, y=y), jnp.zeros(6),
                   JGiant(iters=2, num_workers=8), model=clock)


def test_giant_telemetry_matches_reference():
    tels = {p: p.obs.Telemetry(monitors=True) for p in (J, T)}
    plain = giant_drive(T)
    live = {p: giant_drive(p, tels[p]) for p in (J, T)}
    for k in ("time", "cost"):
        assert live[T][k] == plain[k] == [float(v) for v in live[J][k]]
    assert_same_telemetry(tels[J], tels[T])
    assert tels[T].trace.by_kind("run")[0].name == "giant"
    assert {"grad", "local-newton"} <= {
        s.name for s in tels[T].trace.by_kind("phase")}


# ------------------------------------------- 3. incidents and the console
def monitored_drive(p, faults=None, *, rounds=14, pool=None, schedule=None):
    """tests/test_incident.py's ``_monitored_drive``."""
    tel = p.obs.Telemetry(monitors=True)
    clock = p.sg.SimClock(p.sg.StragglerModel(p_tail=0.05, tail_hi=3.0),
                          fleet=p.rt.FleetConfig(cold_start_prob=0.2),
                          pool=pool, faults=faults, telemetry=tel)
    for r in range(rounds):
        mem, ws = schedule(r) if schedule is not None else (None, None)
        clock.phase(p.key(600 + r), 24, policy="wait_all",
                    flops_per_worker=3e5, comm_units=1.0, memory_gb=mem,
                    working_set_gb=ws)
    return tel


def healthy_midpoint(p, rounds=7, pool=False):
    clock = p.sg.SimClock(
        p.sg.StragglerModel(p_tail=0.05, tail_hi=3.0),
        fleet=p.rt.FleetConfig(cold_start_prob=0.2),
        pool=p.sched.WarmPool(ttl=300.0, prewarmed=48) if pool else None)
    for r in range(rounds):
        clock.phase(p.key(600 + r), 24, policy="wait_all",
                    flops_per_worker=3e5, comm_units=1.0)
    return clock.time


def incident_newton(p, faults=None, telemetry=None):
    """``_newton_solve``: n = 256, d = 8, 8 iterations."""
    key = jax.random.PRNGKey(0)
    x = jax.random.normal(key, (256, 8))
    y = jnp.sign(x @ jax.random.normal(jax.random.fold_in(key, 1), (8,)))
    kw = dict(iters=8, coded_block_rows=32,
              sketch=(TSketch if p is T else JSketch)(64, 16, 0.25))
    clock = p.sg.SimClock(p.sg.StragglerModel(), faults=faults,
                          telemetry=telemetry)
    if p is T:
        t_newton(TLogistic(lam=1e-3),
                 TDataset(x=torch.from_numpy(np.array(x)),
                          y=torch.from_numpy(np.array(y))),
                 np.zeros(8, np.float32), TConfig(**kw), clock, device="cpu")
    else:
        j_newton(JLogistic(lam=1e-3), JDataset(x=x, y=y), jnp.zeros(8),
                 JConfig(**kw), clock)
    return clock


def scenario_drive(p, scen):
    """``_scenario_drive``: a chaotic monitored run and its plan."""
    rt = p.rt
    if scen == "corruption":
        t2 = 0.5 * incident_newton(p).time
        plan = rt.FaultPlan(corruption=rt.CorruptionSpec(prob=0.5,
                                                         t_start=t2))
        tel = p.obs.Telemetry(monitors=True)
        incident_newton(p, plan, tel)
        return tel, plan
    t_mid = healthy_midpoint(p)
    if scen == "az_burst":
        plan = rt.FaultPlan(burst=rt.BurstSpec(t_start=t_mid,
                                               kill_fraction=0.9))
    elif scen == "throttle":
        plan = rt.FaultPlan(throttle=rt.ThrottleSpec(max_concurrent=4,
                                                     t_start=t_mid))
    elif scen == "s3_transient":
        plan = rt.FaultPlan(s3=rt.S3Spec(get_fail_prob=0.7,
                                         put_fail_prob=0.3,
                                         retry_delay=0.2, t_start=t_mid))
    elif scen == "oom":
        plan = rt.get_scenario("oom")
        return monitored_drive(p, plan, schedule=lambda r: (
            (1.0, 0.5) if r < 8 else (0.25, 0.5))), plan
    else:
        assert scen == "pool_death"
        plan = rt.FaultPlan(pool_death=rt.PoolDeathSpec(
            t=healthy_midpoint(p, pool=True), fraction=1.0))
        return monitored_drive(p, plan, pool=p.sched.WarmPool(
            ttl=300.0, prewarmed=48)), plan
    return monitored_drive(p, plan), plan


@pytest.mark.parametrize("scen", trt.available_scenarios())
def test_incidents_and_console_match_reference(scen):
    out = {}
    for p in (J, T):
        tel, plan = scenario_drive(p, scen)
        incidents = p.obs.attribute(tel, faults=plan)
        out[p] = (tel, [json.loads(json.dumps(i.as_row()))
                        for i in incidents])
    (jtel, jinc), (ttel, tinc) = out[J], out[T]
    assert tinc == jinc
    assert tinc and tinc[0]["cause"] == scen
    assert_same_telemetry(jtel, ttel)
    if scen == "corruption":
        # The Newton loop's corruption path: injected, flagged, latched,
        # relaunched, and the per-phase error rate set.
        snap = ttel.metrics.snapshot()
        for name in ("coded.corruption_injected", "coded.corruption_detected",
                     "coded.decode_fallbacks"):
            assert snap["counters"][name] > 0, name
        assert snap["counters"]["coded.paranoid_mode"] == 1.0
        assert snap["gauges"]["coded.block_error_rate"]["n"] > 0
    trows = rows(ttel)
    bench = [{"name": "sched_demo", "us": 1234.5, "derived": "sim_s=1.2",
              "path": "dag"}]
    html = tobs.render_console(trows, bench=bench, title="fleet console")
    assert html == jobs.render_console(rows(jtel), bench=bench,
                                       title="fleet console")
    assert html == jobs.render_console(trows, bench=bench,
                                       title="fleet console")


# ------------------------------------------------ 4. the kernel profiler
def test_ops_profiler_hook():
    """The reference's case: one profiled ``fwht`` call, recorded under
    the reference's names, numerics untouched; no record once detached,
    and the launch counts move only on a CUDA device."""
    x = torch.ones((1, 8, 4), dtype=torch.float32)
    assert tops.get_profiler() is None
    launches = tops.launch_counts()
    baseline = tops.fwht(x)
    reg = tobs.MetricsRegistry()
    tops.set_profiler(reg)
    try:
        profiled = tops.fwht(x)
        tops.coded_block_matvec(torch.ones(3, 2, 4), torch.ones(4),
                                torch.zeros(3, dtype=torch.bool))
        snap = reg.snapshot()
        assert snap["counters"] == {"kernel.fwht.calls": 1.0,
                                    "kernel.coded_block_matvec.calls": 1.0}
        assert snap["histograms"]["kernel.fwht.us"]["count"] == 1
        assert snap["histograms"]["kernel.fwht.us"]["max"] > 0
    finally:
        tops.set_profiler(None)
    assert tops.get_profiler() is None
    tops.fwht(x)
    assert reg.snapshot()["counters"]["kernel.fwht.calls"] == 1.0
    assert torch.equal(baseline, profiled)
    assert tops.launch_counts() == launches


def test_profiled_entry_points_are_the_references():
    """The eight entry points the reference times, and none of the draws
    (the reference has no draw kernel)."""
    from repro.kernels import ops as jops
    for name in ("count_sketch_apply", "oversketch_gram",
                 "sketch_gram_count", "sketch_gram_sjlt", "sketch_gram_srht",
                 "fwht", "fwht_two_pass", "coded_block_matvec"):
        assert callable(getattr(jops, name))
        assert hasattr(getattr(tops, name), "__wrapped__"), name
    for name in ("normal", "bits", "randint", "rademacher", "uniform",
                 "bernoulli", "gumbel", "categorical"):
        assert not hasattr(getattr(tops, name), "__wrapped__"), name
