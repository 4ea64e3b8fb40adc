"""The multi-tenant scheduler in the port (``repro_torch.tenancy``) against
the JAX package's.

1. Every case of ``tests/test_tenancy.py`` runs with its module's names
   bound to the port's (``SimClock``, ``FleetConfig``, ``WarmPool``, the
   tenancy names, ``obs``, and ``jax.random.PRNGKey`` to
   ``prng.PRNGKey``), and so do the cases of ``tests/test_incident.py``
   that drive the scheduler: the incident fixture's bytes, its rerun,
   budget-aware admission, SLO observation and the console.  Module-level
   instances (``MODEL``, ``_TEN_FLEET``) become the port's, and the
   cases' own imports of ``repro.tenancy``, ``repro.runtime`` and
   ``repro.obs.store`` resolve to the port's modules.
2. The binding maps ``jax.__version__`` to torch's, so the reference
   cases' byte checks against the fixtures skip; they are written out
   below.  Both fixtures were recorded under jax 0.4.37, whose threefry
   layout neither package follows under this jax, so the port's bytes are
   held against the JAX package's live bytes, and against the fixture's
   whenever the running jax is the fixture's.
3. One drive in both packages with pool-aware dispatch, an autoscaler,
   per-tenant SLOs and budget-aware shedding: summary, phase log,
   per-tenant ledgers, spans and metrics bit for bit."""
import dataclasses
import importlib
import inspect
import json
import pathlib
import sys
import types

import jax
import pytest
import torch

import test_incident
import test_tenancy
from test_torch_obs import assert_same_telemetry, rows

import repro.obs as jobs
import repro.runtime as jrt
import repro.scheduler as jsched
import repro.tenancy as jten
from repro.core import straggler as jstraggler
from repro.obs.slo import SloPolicy as JSlo

import repro_torch.obs as tobs
import repro_torch.runtime as trt
import repro_torch.scheduler as tsched
import repro_torch.tenancy as tten
from repro_torch import prng
from repro_torch.core import straggler as tstraggler
from repro_torch.obs.slo import SloPolicy as TSlo

FIXTURES = pathlib.Path(__file__).parent / "fixtures"
JAX_KEYS = types.SimpleNamespace(
    random=types.SimpleNamespace(PRNGKey=prng.PRNGKey),
    __version__=torch.__version__)
# Modules the reference cases import inside their bodies.
LOCAL_IMPORTS = ("repro.tenancy", "repro.runtime", "repro.obs.store")
INCIDENT_CASES = (
    "test_incident_golden_fixture_is_byte_identical",
    "test_golden_attribution_is_rerun_deterministic",
    "test_budget_aware_admission_sheds_only_burning_tenant",
    "test_slo_tracking_alone_is_observation_only",
    "test_console_renders_all_sections_deterministically",
    "test_write_console_and_empty_rows")


def _port_module(name: str):
    return importlib.import_module("repro_torch" + name[len("repro"):])


def _port_value(value):
    """The port's counterpart of a reference module global, or None: a
    module, a class or function, or a dataclass instance rebuilt field
    for field from the port's class."""
    if value is jax:
        return JAX_KEYS
    if isinstance(value, types.ModuleType):
        name = value.__name__
        if name == "repro" or name.startswith("repro."):
            return _port_module(name)
        return None
    cls = value if isinstance(value, type) or callable(value) \
        else type(value)
    module = getattr(cls, "__module__", None) or ""
    if not module.startswith("repro."):
        return None
    port = getattr(_port_module(module), cls.__name__)
    if cls is value or (callable(value) and not dataclasses.is_dataclass(
            value)):
        return port
    return port(**{f.name: getattr(value, f.name)
                   for f in dataclasses.fields(value)})


REFERENCE_CASES = [
    pytest.param(test_tenancy, name, id=f"test_tenancy::{name}")
    for name, fn in vars(test_tenancy).items()
    if name.startswith("test_") and callable(fn)] + [
    pytest.param(test_incident, name, id=f"test_incident::{name}")
    for name in INCIDENT_CASES]


@pytest.mark.parametrize("mod,name", REFERENCE_CASES)
def test_reference_case_on_the_port(mod, name, monkeypatch, request):
    for glob, value in list(vars(mod).items()):
        port = _port_value(value)
        if port is not None:
            monkeypatch.setattr(mod, glob, port)
    for local in LOCAL_IMPORTS:
        monkeypatch.setitem(sys.modules, local, _port_module(local))
    assert mod.JobScheduler is tten.JobScheduler
    assert type(getattr(mod, "MODEL", tstraggler.StragglerModel())) \
        is tstraggler.StragglerModel
    fn = getattr(mod, name)
    fn(**{arg: request.getfixturevalue(arg)
          for arg in inspect.signature(fn).parameters})


def test_every_reference_case_is_bound():
    assert len([p for p in REFERENCE_CASES
                if p.values[0] is test_tenancy]) == 21


# ------------------------------------------------- 2. the fixtures, written out
class Package(types.SimpleNamespace):
    __hash__ = object.__hash__


J = Package(obs=jobs, rt=jrt, sched=jsched, sg=jstraggler, ten=jten,
            slo=JSlo, key=jax.random.PRNGKey)
T = Package(obs=tobs, rt=trt, sched=tsched, sg=tstraggler, ten=tten,
            slo=TSlo, key=prng.PRNGKey)


def tenancy_golden_drive(p, clock):
    """``test_tenancy._drive_tenancy``: matvec at 0.0, giant at 0.1."""
    jobs_ = p.ten.workload_from_trace([(0.0, "matvec"), (0.1, "giant")])
    p.ten.JobScheduler(clock, p.key(99), jobs_, p.ten.TenancyConfig()).run()
    return clock


def load_fixture(name):
    lines = [ln for ln in (FIXTURES / name).read_text().splitlines()
             if ln.strip()]
    meta = json.loads(lines[0])
    assert meta["kind"] == "meta"
    return meta, lines[1:]


def test_tenancy_golden_replays_bit_identical_in_both_packages():
    _, lines = load_fixture("tenancy_trace_golden.jsonl")
    rows_ = [json.loads(ln) for ln in lines]
    seconds, ledger = 0.0, trt.CostLedger()
    for r in rows_:
        seconds += r.get("advance", r["elapsed"])
        ledger.add(trt.CostLedger(gb_seconds=r["gb_seconds"],
                                  invocations=r["invocations"],
                                  s3_puts=r["s3_puts"], s3_gets=r["s3_gets"]))
    out = {p: tenancy_golden_drive(p, p.sg.SimClock(
        p.sg.StragglerModel(), replay=p.rt.TraceReplayer(rows_)))
        for p in (J, T)}
    assert out[T].time == seconds == out[J].time
    assert out[T].dollars == ledger.dollars(trt.CostModel()) \
        == out[J].dollars


def test_tenancy_golden_rerecord_matches_reference_row_for_row(tmp_path):
    meta, lines = load_fixture("tenancy_trace_golden.jsonl")
    fixture = [json.loads(ln) for ln in lines]
    recs, clocks = {}, {}
    for p in (J, T):
        recs[p] = p.rt.TraceRecorder(worker_times=True, lifecycle=True)
        clocks[p] = tenancy_golden_drive(p, p.sg.SimClock(
            p.sg.StragglerModel(),
            fleet=p.rt.FleetConfig(failure_rate=0.05, cold_start_prob=0.2),
            recorder=recs[p], pool=p.sched.WarmPool(ttl=30.0)))
    port = [json.dumps(r) for r in recs[T].rows]
    assert port == [json.dumps(r) for r in recs[J].rows]
    assert (clocks[T].time, clocks[T].dollars) == \
        (clocks[J].time, clocks[J].dollars)
    assert [(r["kind"], r.get("policy"), r.get("workers"), r.get("k"))
            for r in recs[T].rows] == \
        [(r["kind"], r.get("policy"), r.get("workers"), r.get("k"))
         for r in fixture]
    if jax.__version__ == meta["jax_version"]:
        assert [json.loads(r) for r in port] == fixture
    path = tmp_path / "rerecord.jsonl"
    recs[T].dump(path)
    replayed = tenancy_golden_drive(T, tstraggler.SimClock(
        tstraggler.StragglerModel(), replay=trt.load_trace(path)))
    assert (replayed.time, replayed.dollars) == \
        (clocks[T].time, clocks[T].dollars)


def incident_golden(p):
    """``test_incident._golden_incidents``: the two-tenant workload under
    an az_burst at half the healthy run's makespan."""
    def drive(faults=None, telemetry=None):
        trace = [(0.2 * i, "matvec") for i in range(10)] + [(0.3, "giant")]
        clock = p.sg.SimClock(
            p.sg.StragglerModel(p_tail=0.05, tail_hi=3.0),
            fleet=p.rt.FleetConfig(cold_start_prob=0.2),
            pool=p.sched.WarmPool(ttl=300.0, prewarmed=48), faults=faults,
            telemetry=telemetry)
        cfg = p.ten.TenancyConfig(slo={
            "serving": p.slo(latency_target_s=1.0, deadline_rate=0.9),
            "train": p.slo(latency_target_s=20.0, deadline_rate=0.5)})
        p.ten.JobScheduler(clock, p.key(7), p.ten.workload_from_trace(
            sorted(trace, key=lambda e: e[0])), cfg).run()
        return clock
    plan = p.rt.FaultPlan(burst=p.rt.BurstSpec(
        t_start=0.5 * drive().time, kill_fraction=0.9))
    tel = p.obs.Telemetry(monitors=True)
    drive(faults=plan, telemetry=tel)
    return p.obs.attribute(tel, faults=plan), tel


def test_incident_golden_bytes_match_reference(tmp_path):
    meta, fixture = load_fixture("incident_golden.jsonl")
    lines, tels = {}, {}
    for p in (J, T):
        incidents, tels[p] = incident_golden(p)
        out = tmp_path / f"{p is T}.jsonl"
        p.obs.dump_incidents(incidents, out)
        lines[p] = [ln for ln in out.read_text().splitlines() if ln.strip()]
    assert lines[T] == lines[J]
    assert json.loads(lines[T][0])["cause"] == "az_burst"
    assert [json.loads(ln)["cause"] for ln in lines[T]] == \
        [json.loads(ln)["cause"] for ln in fixture]
    if jax.__version__ == meta["jax_version"]:
        assert lines[T] == fixture
    assert_same_telemetry(tels[J], tels[T])
    html = tobs.render_console(rows(tels[T]), title="fleet console")
    assert html == jobs.render_console(rows(tels[J]), title="fleet console")


# ------------------------------------- 3. every knob at once, both packages
def knobs_drive(p):
    """Pool-aware dispatch, an autoscaler from an empty reserve, per-tenant
    SLOs with a serving objective tight enough to shed, a lossy fleet."""
    tel = p.obs.Telemetry(monitors=True)
    pool = p.sched.WarmPool(ttl=60.0, prewarmed=0)
    clock = p.sg.SimClock(p.sg.StragglerModel(),
                          fleet=p.rt.FleetConfig(failure_rate=0.05,
                                                 cold_start_prob=0.3),
                          pool=pool, telemetry=tel)
    slo = {"serving": p.slo(latency_target_s=0.15, deadline_rate=0.9,
                            fast_window_s=3.0, slow_window_s=10.0),
           "batch": p.slo(latency_target_s=60.0, deadline_rate=0.5),
           "train": p.slo(latency_target_s=60.0, deadline_rate=0.5)}
    cfg = p.ten.TenancyConfig(
        admission=p.ten.AdmissionPolicy(max_inflight=12, queue=True,
                                        slo_aware=True, budget_aware=True),
        autoscaler=p.ten.Autoscaler(max_provisioned=96), pool_aware=True,
        slo=slo)
    jobs_ = p.ten.generate_workload(p.ten.WorkloadConfig(seed=3, rate=20.0,
                                                         n_jobs=60))
    res = p.ten.JobScheduler(clock, p.key(11), jobs_, cfg).run()
    return res, tel, pool


def test_every_knob_drive_matches_reference():
    (jres, jtel, jpool), (tres, ttel, tpool) = (knobs_drive(p)
                                                for p in (J, T))
    js, ts = jres.summary(), tres.summary()
    assert json.dumps(ts) == json.dumps(js)
    assert ts["rejected"] > 0 and ts["provisioned_gb_seconds"] > 0
    assert tres.phase_log == [tuple(float(v) if isinstance(v, float) else v
                                    for v in e) for e in jres.phase_log]
    assert any(pool_aware_delay for pool_aware_delay in (
        e[3] > 0 and e[4] > 0 for e in tres.phase_log))
    assert sorted(tres.tenants) == sorted(jres.tenants)
    for name, led in jres.tenants.items():
        assert dataclasses.asdict(tres.tenants[name]) == \
            dataclasses.asdict(led), name
    assert [dataclasses.asdict(r) for r in tres.jobs] == \
        [dataclasses.asdict(r) for r in jres.jobs]
    assert (tpool.warm_hits, tpool.cold_starts, tpool.fresh) == \
        (jpool.warm_hits, jpool.cold_starts, jpool.fresh)
    shed = [n for n, c in ttel.metrics.counters.items()
            if n.endswith(".budget_shed") and c.value > 0]
    assert shed == ["tenant.serving.budget_shed"]
    assert_same_telemetry(jtel, ttel)


def test_templates_match_reference():
    def catalogue(pkg):     # the reference cases register "_test_*" ones
        return [n for n in pkg.available_templates()
                if not n.startswith("_test")]
    assert catalogue(tten) == catalogue(jten) == [
        "giant", "matvec", "newton_large", "newton_small"]
    model_j, model_t = jstraggler.StragglerModel(), tstraggler.StragglerModel()
    for name in catalogue(jten):
        a, b = jten.get_template(name), tten.get_template(name)
        assert (b.name, b.tenant, b.iters, b.deadline_s) == \
            (a.name, a.tenant, a.iters, a.deadline_s)
        assert [dataclasses.asdict(s) for s in b.specs] == \
            [dataclasses.asdict(s) for s in a.specs]
        assert b.expected_schedule(model_t) == a.expected_schedule(model_j)
        assert b.phase_slack(model_t) == a.phase_slack(model_j)
        assert b.expected_peak_workers(model_t) == \
            a.expected_peak_workers(model_j)
    cfg = dict(seed=7, rate=9.0, n_jobs=40)
    assert [(j.id, j.template.name, j.t_arrival) for j in
            tten.generate_workload(tten.WorkloadConfig(**cfg))] == \
        [(j.id, j.template.name, j.t_arrival) for j in
         jten.generate_workload(jten.WorkloadConfig(**cfg))]
