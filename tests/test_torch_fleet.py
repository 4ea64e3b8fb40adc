"""The rest of the fleet in both packages, on the same keys: the fault
plane (``tests/test_faults.py``'s scenario, billing and exhaustion cases),
trace record/replay and calibration (``tests/test_golden_trace.py``'s
non-telemetry cases on the three committed fixtures), the warm pool and
the DAG helpers (``tests/test_scheduler.py``), the straggler helpers
(``tests/test_straggler.py``), and the Newton loop and GIANT under fault
plans.  Simulated seconds, dollars, masks and trace rows are held bit for
bit.  Corruption detection has its own file
(``tests/test_torch_corruption.py``), the monitors and alerts theirs
(``tests/test_torch_obs.py``)."""
import dataclasses
import json
import pathlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.runtime as jrt
import repro.scheduler as jsched
from repro.core import straggler as jstraggler
from repro.core.newton import NewtonConfig as JNewtonConfig
from repro.core.newton import oversketched_newton as j_newton
from repro.core.objectives import Dataset as JDataset
from repro.core.objectives import LogisticRegression as JLogistic
from repro.core.sketch import OverSketchConfig as JSketch
from repro.optim import GiantConfig as JGiant
from repro.optim import giant as j_giant

import repro_torch.runtime as trt
import repro_torch.scheduler as tsched
from repro_torch import prng
from repro_torch.core import straggler as tstraggler
from repro_torch.core.newton import NewtonConfig as TNewtonConfig
from repro_torch.core.newton import oversketched_newton as t_newton
from repro_torch.core.objectives import Dataset as TDataset
from repro_torch.core.objectives import LogisticRegression as TLogistic
from repro_torch.core.sketch import OverSketchConfig as TSketch
from repro_torch.optim import GiantConfig as TGiant
from repro_torch.optim import giant as t_giant

torch.set_num_threads(1)

FIXTURES = pathlib.Path(__file__).parent / "fixtures"

class Package(types.SimpleNamespace):
    """One package's fleet modules, so each drive below is written once."""
    __hash__ = object.__hash__


J = Package(rt=jrt, sched=jsched, sg=jstraggler, key=jax.random.PRNGKey)
T = Package(rt=trt, sched=tsched, sg=tstraggler, key=prng.PRNGKey)
PKGS = (J, T)


def both(fn):
    """fn(pkg) for the reference and for the port."""
    return fn(J), fn(T)


def rows_of(rec):
    return [json.loads(json.dumps(r)) for r in rec.rows]


def assert_same_clock(a, b):
    assert b.time == a.time
    assert b.dollars == a.dollars


# ------------------------------------------------------------ the fault plane
def chaos_drive(p, faults=None, *, rounds=6, workers=16, policy="wait_all",
                k=None, fleet=None, pool=None, recorder=None, replay=None,
                memory_gb=None, working_set_gb=None, flops=3e5, key0=100):
    """tests/test_faults.py's fixed chaos workload: ``rounds`` identical
    fan-outs; returns the clock and the phases' masks."""
    clock = p.sg.SimClock(p.sg.StragglerModel(p_tail=0.05, tail_hi=3.0),
                          fleet=fleet if fleet is not None
                          else p.rt.FleetConfig(cold_start_prob=0.1),
                          pool=pool, faults=faults, recorder=recorder,
                          replay=replay)
    masks = []
    for r in range(rounds):
        _, mask = clock.phase(p.key(key0 + r), workers, policy=policy, k=k,
                              flops_per_worker=flops, comm_units=1.0,
                              memory_gb=memory_gb,
                              working_set_gb=working_set_gb)
        masks.append(np.asarray(mask))
    return clock, masks


def test_registry_and_spec_validation_match_reference():
    assert trt.available_scenarios() == jrt.available_scenarios()
    for name in trt.available_scenarios():
        assert dataclasses.asdict(trt.get_scenario(name, seed=3)) == \
            dataclasses.asdict(jrt.get_scenario(name, seed=3))
        assert trt.get_scenario(name).events() == \
            jrt.get_scenario(name).events()
    plan = trt.get_scenario("az_burst", kill_fraction=0.9, t_end=3.0, seed=4)
    assert (plan.burst.kill_fraction, plan.burst.t_end, plan.seed) == \
        (0.9, 3.0, 4)
    assert plan.active() and not trt.FaultPlan().active()
    with pytest.raises(ValueError, match="unknown scenario"):
        trt.get_scenario("meteor_strike")
    for bad in (lambda: trt.BurstSpec(kill_fraction=1.5),
                lambda: trt.BurstSpec(t_start=2.0, t_end=1.0),
                lambda: trt.ThrottleSpec(max_concurrent=0),
                lambda: trt.S3Spec(get_fail_prob=-0.1),
                lambda: trt.CorruptionSpec(prob=2.0),
                lambda: trt.PoolDeathSpec(fraction=1.5)):
        with pytest.raises(ValueError):
            bad()


# scenario -> (drive kwargs, fault-stat keys it must leave in the trace),
# as tests/test_faults.py has them, plus corruption: the engine marks it.
SCENARIO_DRIVES = {
    "az_burst": (dict(), ("burst_kills", "burst_exposed")),
    "throttle": (dict(), ("throttled", "peak_concurrency")),
    "s3_transient": (dict(), ("s3_get_retries", "s3_put_retries")),
    "oom": (dict(memory_gb=0.25, working_set_gb=0.5),
            ("oom_kills", "oom_escalations")),
    "pool_death": (dict(pool=True), ("pool_killed",)),
    "corruption": (dict(), ("corrupted",)),
}


def scenario_drive(p, scen, faults, **kw):
    drive_kw = dict(SCENARIO_DRIVES[scen][0], **kw)
    if drive_kw.pop("pool", False):
        drive_kw["pool"] = p.sched.WarmPool(ttl=300.0, prewarmed=32)
    return chaos_drive(p, faults, **drive_kw)


@pytest.mark.parametrize("scen", sorted(SCENARIO_DRIVES))
def test_scenario_matches_reference_and_replays(scen, tmp_path):
    """The same masks, seconds, dollars and trace rows in both packages;
    the port's recording replays with no plan attached, in the port and
    in the reference."""
    recs = {}

    def record(p):
        recs[p] = p.rt.TraceRecorder(lifecycle=True)
        return scenario_drive(p, scen, p.rt.get_scenario(scen),
                              recorder=recs[p])
    (jc, jm), (tc, tm) = both(record)
    assert_same_clock(jc, tc)
    for a, b in zip(jm, tm):
        np.testing.assert_array_equal(b, a)
    assert rows_of(recs[T]) == rows_of(recs[J])
    seen = {k for r in recs[T].rows for k in (r.get("faults") or {})}
    assert set(SCENARIO_DRIVES[scen][1]) <= seen
    if scen == "corruption":
        np.testing.assert_array_equal(tc.last_corruption, jc.last_corruption)
    path = tmp_path / f"{scen}.jsonl"
    recs[T].dump(path)
    for p in PKGS:
        replayed, masks = scenario_drive(p, scen, None,
                                         replay=p.rt.load_trace(path))
        assert_same_clock(tc, replayed)
        for a, b in zip(tm, masks):
            np.testing.assert_array_equal(b, a)
        if scen == "corruption":
            np.testing.assert_array_equal(replayed.last_corruption,
                                          tc.last_corruption)


def test_plan_seed_and_dormant_plan_match_reference():
    for p in PKGS:
        a, _ = chaos_drive(p, p.rt.get_scenario("s3_transient",
                                                get_fail_prob=0.5))
        b, _ = chaos_drive(p, p.rt.get_scenario("s3_transient",
                                                get_fail_prob=0.5, seed=1))
        assert a.time != b.time
    healthy, _ = chaos_drive(T, None)
    assert_same_clock(chaos_drive(J, None)[0], healthy)

    def dormant(p):
        return chaos_drive(p, p.rt.FaultPlan(
            burst=p.rt.BurstSpec(t_start=1e9, kill_fraction=1.0),
            throttle=p.rt.ThrottleSpec(max_concurrent=1, t_start=1e9),
            s3=p.rt.S3Spec(get_fail_prob=0.9, put_fail_prob=0.9,
                           t_start=1e9),
            corruption=p.rt.CorruptionSpec(prob=1.0, t_start=1e9)))[0]
    assert_same_clock(healthy, dormant(T))
    assert_same_clock(dormant(J), dormant(T))


def test_billing_matches_reference():
    """Throttle rejections and OOM escalations bill, sizing at the working
    set mitigates OOM, and relaunch policies bill their dead duplicates."""
    def drives(p):
        out = [chaos_drive(p, None)[0],
               chaos_drive(p, p.rt.FaultPlan(
                   throttle=p.rt.ThrottleSpec(max_concurrent=4)))[0]]
        for mem in (0.25, 0.5):
            out.append(chaos_drive(p, p.rt.get_scenario("oom"),
                                   memory_gb=mem, working_set_gb=0.5)[0])
        for policy in ("hedged", "speculative"):
            out.append(chaos_drive(p, None, policy=policy, rounds=4)[0])
            out.append(chaos_drive(p, p.rt.get_scenario(
                "az_burst", kill_fraction=0.8, t_end=30.0), policy=policy,
                rounds=4)[0])
        return out
    jclocks, tclocks = both(drives)
    for a, b in zip(jclocks, tclocks):
        assert_same_clock(a, b)
        assert b.ledger.invocations == a.ledger.invocations
        assert b.ledger.gb_seconds == a.ledger.gb_seconds
    healthy, throttled, oom, sized = tclocks[:4]
    assert throttled.ledger.invocations > healthy.ledger.invocations
    assert oom.ledger.gb_seconds > sized.ledger.gb_seconds
    assert sized.time < oom.time
    for plain, burst in (tclocks[4:6], tclocks[6:8]):
        assert burst.dollars > plain.dollars


def strict_fleet(p):
    return p.rt.FleetConfig(fail_open=False, max_retries=1,
                            cold_start_prob=0.0)


def lethal(p):
    return p.rt.FaultPlan(burst=p.rt.BurstSpec(t_start=0.0,
                                               kill_fraction=1.0))


def test_exhaustion_raises_after_billing_and_replays(tmp_path):
    errors, recs = {}, {}

    def exhaust(p):
        recs[p] = p.rt.TraceRecorder()
        clock = p.sg.SimClock(p.sg.StragglerModel(), fleet=strict_fleet(p),
                              recorder=recs[p], faults=lethal(p))
        with pytest.raises(p.rt.PhaseExhaustedError) as ei:
            clock.phase(p.key(0), 8, policy="wait_all",
                        flops_per_worker=3e5, comm_units=1.0)
        errors[p] = ei.value
        return clock
    jc, tc = both(exhaust)
    assert_same_clock(jc, tc)
    e = errors[T]
    assert (e.num_workers, int(e.mask.sum()), e.elapsed) == \
        (8, 0, errors[J].elapsed)
    assert tc.ledger.invocations == 16.0
    assert rows_of(recs[T]) == rows_of(recs[J])
    assert recs[T].rows[-1]["raised"] and recs[T].rows[-1]["exhausted"] == 8
    path = tmp_path / "exhausted.jsonl"
    recs[T].dump(path)
    rclock = T.sg.SimClock(T.sg.StragglerModel(),
                           replay=trt.load_trace(path))
    with pytest.raises(trt.PhaseExhaustedError) as rei:
        rclock.phase(prng.PRNGKey(0), 8, policy="wait_all",
                     flops_per_worker=3e5, comm_units=1.0)
    assert rei.value.elapsed == e.elapsed
    np.testing.assert_array_equal(rei.value.mask, e.mask)
    assert_same_clock(tc, rclock)


def test_partial_wait_survives_and_fail_open_never_raises():
    def drive(p):
        partial = p.sg.SimClock(
            p.sg.StragglerModel(), fleet=strict_fleet(p),
            faults=p.rt.FaultPlan(burst=p.rt.BurstSpec(
                t_start=0.0, kill_fraction=0.5)))
        _, m1 = partial.phase(p.key(1), 8, policy="k_of_n", k=4,
                              flops_per_worker=3e5, comm_units=1.0)
        fail_open = p.sg.SimClock(
            p.sg.StragglerModel(),
            fleet=p.rt.FleetConfig(max_retries=1, cold_start_prob=0.0),
            faults=lethal(p))
        _, m2 = fail_open.phase(p.key(0), 8, policy="wait_all",
                                flops_per_worker=3e5, comm_units=1.0)
        return partial, fail_open, np.asarray(m1), np.asarray(m2)
    j, t = both(drive)
    for a, b in zip(j[:2], t[:2]):
        assert_same_clock(a, b)
    np.testing.assert_array_equal(t[2], j[2])
    np.testing.assert_array_equal(t[3], j[3])
    assert int(t[2].sum()) >= 4 and int(t[3].sum()) == 8


# ---------------------------------------------------- Newton and GIANT
@pytest.fixture(scope="module")
def small_problem():
    """tests/test_faults.py's Newton problem (n = 256, d = 8)."""
    key = jax.random.PRNGKey(0)
    x = jax.random.normal(key, (256, 8))
    y = jnp.sign(x @ jax.random.normal(jax.random.fold_in(key, 1), (8,)))
    return (JDataset(x=x, y=y),
            TDataset(x=torch.from_numpy(np.array(x)),
                     y=torch.from_numpy(np.array(y))))


def newton_solve(p, data, faults=None, *, fleet=None, pool=None,
                 fallback="degrade", iters=4, replay=None):
    cfg_cls, sketch, obj = ((JNewtonConfig, JSketch, JLogistic) if p is J
                            else (TNewtonConfig, TSketch, TLogistic))
    cfg = cfg_cls(iters=iters, sketch=sketch(sketch_dim=64, block_size=16,
                                             straggler_tolerance=0.25),
                  coded_block_rows=32, fault_fallback=fallback)
    clock = p.sg.SimClock(p.sg.StragglerModel(), fleet=fleet, pool=pool,
                          faults=faults, replay=replay)
    if p is J:
        res = j_newton(obj(lam=1e-3), data[0], jnp.zeros(8), cfg, clock)
    else:
        res = t_newton(obj(lam=1e-3), data[1], np.zeros(8, np.float32), cfg,
                       clock, device="cpu")
    return res, clock


def assert_same_newton(rj, rt):
    hj, ht = rj.history, rt.history
    assert ht["step"] == [float(v) for v in hj["step"]]
    for k in ("time", "cost"):
        assert ht[k] == [float(v) for v in hj[k]], k
    for k in ("fval", "gnorm"):
        np.testing.assert_allclose(ht[k], hj[k], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(rt.w.numpy(), np.asarray(rj.w), rtol=1e-4,
                               atol=1e-6)


@pytest.mark.parametrize("scen", ["az_burst", "corruption", "oom",
                                  "pool_death", "s3_transient", "throttle"])
def test_newton_under_every_scenario_matches_reference(small_problem, scen):
    """test_newton_converges_under_every_scenario's fleet (a real retry
    budget and a warm pool), every scenario (corruption with the
    parity-check detection on, the default)."""
    (rj, jc), (rt, tc) = both(lambda p: newton_solve(
        p, small_problem, p.rt.get_scenario(scen),
        fleet=p.rt.FleetConfig(cold_start_prob=0.1, fail_open=False,
                               max_retries=2),
        pool=p.sched.WarmPool(ttl=300.0, prewarmed=32)))
    assert_same_newton(rj, rt)
    assert_same_clock(jc, tc)
    assert np.isfinite(rt.history["gnorm"][-1])


def test_strict_and_degraded_newton_match_reference(small_problem):
    for p in PKGS:
        with pytest.raises(p.rt.PhaseExhaustedError):
            newton_solve(p, small_problem, lethal(p), fleet=strict_fleet(p),
                         fallback="raise", iters=2)
    (rj, jc), (rt, tc) = both(lambda p: newton_solve(
        p, small_problem, p.rt.FaultPlan(burst=p.rt.BurstSpec(
            t_start=0.5, t_end=2.0, kill_fraction=0.9)),
        fleet=p.rt.FleetConfig(fail_open=False, max_retries=1)))
    assert_same_newton(rj, rt)
    assert_same_clock(jc, tc)


@pytest.mark.parametrize("schedule", ["dag", "sequential"])
def test_giant_under_an_exhausting_plan_matches_reference(small_problem,
                                                          schedule):
    """GIANT's stages drop the shards an exhausted phase lost."""
    def run(p):
        clock = p.sg.SimClock(
            p.sg.StragglerModel(),
            fleet=p.rt.FleetConfig(fail_open=False, max_retries=1),
            faults=p.rt.FaultPlan(burst=p.rt.BurstSpec(
                t_start=0.5, t_end=4.0, kill_fraction=0.6)))
        cfg = dict(iters=3, num_workers=8, schedule=schedule)
        if p is J:
            return j_giant(JLogistic(lam=1e-3), small_problem[0],
                           jnp.zeros(8), JGiant(**cfg), model=clock), clock
        return t_giant(TLogistic(lam=1e-3), small_problem[1],
                       np.zeros(8, np.float32), TGiant(**cfg), model=clock,
                       device="cpu"), clock
    (hj, jc), (ht, tc) = both(run)
    assert_same_clock(jc, tc)
    assert ht["time"] == [float(v) for v in hj["time"]]
    assert ht["cost"] == [float(v) for v in hj["cost"]]
    np.testing.assert_allclose(ht["fval"], hj["fval"], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(ht["w"].numpy(), np.asarray(hj["w"]),
                               rtol=1e-4, atol=1e-6)


def test_giant_dag_chain_equals_sequential():
    """tests/test_scheduler.py's GIANT case in the port."""
    key = jax.random.PRNGKey(0)
    x = np.array(jax.random.normal(key, (800, 16)))
    y = np.sign(x @ np.array(jax.random.normal(jax.random.PRNGKey(1),
                                               (16,))))
    data = TDataset(x=torch.from_numpy(x), y=torch.from_numpy(y))
    model = tstraggler.StragglerModel(p_tail=0.1, tail_hi=3.0)
    cfg = TGiant(iters=2, num_workers=8, schedule="dag")
    h_dag = t_giant(TLogistic(), data, np.zeros(16, np.float32), cfg,
                    model=model, device="cpu")
    h_seq = t_giant(TLogistic(), data, np.zeros(16, np.float32),
                    dataclasses.replace(cfg, schedule="sequential"),
                    model=model, device="cpu")
    for k in ("time", "cost", "fval"):
        assert h_dag[k] == h_seq[k], k


# ------------------------------------------------ golden traces (fixtures)
def load_fixture(name):
    rows = [json.loads(line) for line in
            (FIXTURES / name).read_text().splitlines() if line.strip()]
    assert rows[0]["kind"] == "meta"
    return rows[0], rows[1:]


def golden_drive(p, clock):
    clock.phase(p.key(0), 12, policy="wait_all", flops_per_worker=3e5,
                comm_units=1.0)
    clock.phase(p.key(1), 12, policy="k_of_n", k=10, flops_per_worker=3e5,
                not_before=0.0)
    clock.phase(p.key(2), 8, policy="hedged", flops_per_worker=1e5)
    clock.charge(0.125)
    clock.phase(p.key(3), 6, policy="speculative", flops_per_worker=2e5)
    return clock


def dag_drive(p, clock):
    spec = p.sched.PhaseSpec
    p.sched.run_dag(clock, p.key(42), [
        spec("gx", 10, policy="k_of_n", k=8, flops_per_worker=3e5,
             comm_units=1.0, memory_gb=0.5),
        spec("gxt", 10, policy="k_of_n", k=8, flops_per_worker=3e5,
             comm_units=1.0, deps=("gx",), memory_gb=0.5),
        spec("hess", 16, policy="k_of_n", k=13, flops_per_worker=6e5,
             comm_units=1.0, memory_gb=1.5),
        spec("ls", 6, flops_per_worker=1e5, comm_units=0.5,
             deps=("gxt", "hess")),
    ])
    clock.charge(0.0625)
    return clock


def chaos_schedule(p, clock):
    clock.phase(p.key(10), 16, policy="wait_all", flops_per_worker=3e5,
                comm_units=1.0)
    clock.phase(p.key(11), 16, policy="k_of_n", k=13, flops_per_worker=3e5,
                comm_units=1.0)
    clock.charge(0.1)
    clock.phase(p.key(12), 12, policy="hedged", flops_per_worker=2e5)
    return clock


def chaos_plan(p):
    return p.rt.FaultPlan(
        burst=p.rt.BurstSpec(t_start=0.3, t_end=1.5, kill_fraction=0.5),
        throttle=p.rt.ThrottleSpec(max_concurrent=10),
        s3=p.rt.S3Spec(get_fail_prob=0.3, put_fail_prob=0.15),
        corruption=p.rt.CorruptionSpec(prob=0.15), seed=7)


# fixture -> (drive, fleet kwargs, pool, plan, recorder kwargs), as
# tests/test_golden_trace.py records each.
GOLDEN = {
    "fleet_trace_golden.jsonl": (
        golden_drive, dict(failure_rate=0.15, cold_start_prob=0.25),
        None, None, dict(worker_times=True)),
    "dag_trace_golden.jsonl": (
        dag_drive, dict(failure_rate=0.15, cold_start_prob=0.25),
        lambda p: p.sched.WarmPool(ttl=20.0, prewarmed=4), None,
        dict(worker_times=True, lifecycle=True)),
    "chaos_trace_golden.jsonl": (
        chaos_schedule, dict(failure_rate=0.1, cold_start_prob=0.2),
        None, chaos_plan, dict(worker_times=True, lifecycle=True)),
}


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_golden_fixture_replays_bit_identical(name):
    """The committed fixture through the port's replayer: the totals of
    the raw rows in row order, and the reference's replay, bit for bit,
    with no fault plan attached."""
    _, rows = load_fixture(name)
    drive = GOLDEN[name][0]
    seconds, ledger = 0.0, trt.CostLedger()
    for r in rows:
        if r["kind"] == "phase":
            seconds += r.get("advance", r["elapsed"])
            ledger.add(trt.CostLedger(gb_seconds=r["gb_seconds"],
                                      invocations=r["invocations"],
                                      s3_puts=r["s3_puts"],
                                      s3_gets=r["s3_gets"]))
        else:
            seconds += r["elapsed"]
    jc, tc = both(lambda p: drive(p, p.sg.SimClock(
        p.sg.StragglerModel(), replay=p.rt.TraceReplayer(rows))))
    assert tc.time == seconds
    assert tc.dollars == ledger.dollars(trt.CostModel())
    assert_same_clock(jc, tc)


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_golden_schedule_rerecords_as_the_reference(name, tmp_path):
    """The fixture's schedule recorded live: the same rows as the
    reference records under this jax, the fixture's structure, and a
    record -> replay round trip in the port, bit for bit."""
    meta, rows = load_fixture(name)
    drive, fleet, pool, plan, rec_kw = GOLDEN[name]
    recs = {}

    def record(p):
        recs[p] = p.rt.TraceRecorder(**rec_kw)
        return drive(p, p.sg.SimClock(
            p.sg.StragglerModel(), fleet=p.rt.FleetConfig(**fleet),
            recorder=recs[p], pool=pool(p) if pool else None,
            faults=plan(p) if plan else None))
    jc, tc = both(record)
    assert_same_clock(jc, tc)
    assert rows_of(recs[T]) == rows_of(recs[J])
    assert [(r["kind"], r.get("policy"), r.get("workers"), r.get("k"))
            for r in recs[T].rows] == \
        [(r["kind"], r.get("policy"), r.get("workers"), r.get("k"))
         for r in rows]
    if jax.__version__ == meta["jax_version"]:
        assert rows_of(recs[T]) == rows
    path = tmp_path / "rerecord.jsonl"
    recs[T].dump(path)
    replayed = drive(T, T.sg.SimClock(T.sg.StragglerModel(),
                                      replay=trt.load_trace(path)))
    assert_same_clock(tc, replayed)


def test_golden_fixtures_calibrate_as_the_reference():
    for name in ("fleet_trace_golden.jsonl", "lambda_trace_synthetic.jsonl"):
        model = trt.calibrate_from_trace(FIXTURES / name)
        assert dataclasses.asdict(model) == dataclasses.asdict(
            jrt.calibrate_from_trace(FIXTURES / name))
        assert model.base_time > 0 and 0.0 <= model.p_tail <= 1.0
    for name in ("dag_trace_golden.jsonl", "lambda_trace_synthetic.jsonl"):
        fleet = trt.calibrate_fleet_from_trace(FIXTURES / name)
        assert dataclasses.asdict(fleet) == dataclasses.asdict(
            jrt.calibrate_fleet_from_trace(FIXTURES / name))
    lam = trt.calibrate_fleet_from_trace(
        FIXTURES / "lambda_trace_synthetic.jsonl")
    assert abs(lam.failure_rate - 0.2) < 0.05
    assert abs(lam.cold_start_prob - 0.3) < 0.05
    plan = trt.calibrate_faults_from_trace(
        FIXTURES / "chaos_trace_golden.jsonl")
    assert dataclasses.asdict(plan) == dataclasses.asdict(
        jrt.calibrate_faults_from_trace(
            FIXTURES / "chaos_trace_golden.jsonl"))
    assert plan.throttle.max_concurrent == 10
    assert 0.05 <= plan.throttle.backoff < 0.07
    np.testing.assert_array_equal(
        trt.calibrate_from_times([1.0, 1.1, 0.9, 3.0]).p_tail,
        jrt.calibrate_from_times([1.0, 1.1, 0.9, 3.0]).p_tail)


def test_calibration_needs_its_rows(tmp_path):
    rec = trt.TraceRecorder()          # no lifecycle, no faults
    clock = tstraggler.SimClock(tstraggler.StragglerModel(), recorder=rec)
    clock.phase(prng.PRNGKey(0), 4, flops_per_worker=1e5)
    (row,) = rec.rows
    for field in ("memory_gb", "pool", "retries", "cold_delays", "faults"):
        assert field not in row
    path = tmp_path / "v1.jsonl"
    rec.dump(path)
    with pytest.raises(ValueError, match="lifecycle"):
        trt.calibrate_fleet_from_trace(path)
    with pytest.raises(ValueError, match="fault rows"):
        trt.calibrate_faults_from_trace(path)
    with pytest.raises(ValueError, match="worker_times"):
        trt.calibrate_from_trace(path)
    replay = trt.TraceReplayer(rec.rows)
    with pytest.raises(ValueError, match="not the same schedule"):
        replay.next_phase(policy="k_of_n", num_workers=4)


# ------------------------------------------------- scheduler and the pool
MODEL = dict(p_tail=0.1, tail_hi=3.0)


def diamond(p, workers=12):
    spec = p.sched.PhaseSpec
    return [
        spec("gx", workers, policy="k_of_n", k=workers - 2,
             flops_per_worker=3e5, comm_units=1.0),
        spec("gxt", workers, policy="k_of_n", k=workers - 2,
             flops_per_worker=3e5, comm_units=1.0, deps=("gx",)),
        spec("hess", 2 * workers, policy="k_of_n", k=2 * workers - 3,
             flops_per_worker=6e5, comm_units=1.0),
        spec("ls", workers, flops_per_worker=1e5, comm_units=0.5,
             deps=("gxt", "hess")),
    ]


def test_dag_validation_and_canonical_order():
    spec = tsched.PhaseSpec
    for specs, match in (([spec("a", 2), spec("a", 3)], "duplicate"),
                         ([spec("a", 2, deps=("zz",))], "unknown"),
                         ([spec("a", 2, deps=("b",)),
                           spec("b", 2, deps=("a",))], "cycle")):
        with pytest.raises(ValueError, match=match):
            tsched.validate_dag(specs)
    specs = diamond(T)
    base = [s.name for s in tsched.canonical_order(specs)]
    assert base == [s.name for s in tsched.canonical_order(specs[::-1])]
    assert base == [s.name for s in jsched.canonical_order(diamond(J))]
    run = tsched.DagRun(tstraggler.SimClock(tstraggler.StragglerModel()),
                        key=prng.PRNGKey(0))
    with pytest.raises(ValueError, match="undispatched"):
        run.dispatch(spec("b", 2, deps=("a",)))
    run.dispatch(spec("a", 2))
    with pytest.raises(ValueError, match="already dispatched"):
        run.dispatch(spec("a", 2))


@pytest.mark.parametrize("sequential", [False, True])
@pytest.mark.parametrize("pool", [False, True])
def test_run_dag_matches_reference(sequential, pool):
    """The diamond in three topological declaration orders: one total in
    the port, the reference's; the DAG beats the barrier schedule at
    equal dollars, and a pool sees more cold starts on the burst."""
    def run(p, perm):
        wp = p.sched.WarmPool(ttl=300.0) if pool else None
        clock = p.sg.SimClock(p.sg.StragglerModel(**MODEL),
                              fleet=p.rt.FleetConfig(), pool=wp)
        specs = diamond(p)
        res = p.sched.run_dag(clock, p.key(2), [specs[i] for i in perm],
                              sequential=sequential)
        return (clock.time, clock.dollars, res.order, res.makespan,
                wp.cold_starts if pool else 0)
    outs = [run(T, perm) for perm in ([0, 1, 2, 3], [2, 0, 1, 3],
                                      [0, 2, 1, 3])]
    for o in outs[1:]:
        assert o[:2] == outs[0][:2] and o[4] == outs[0][4]
    want = run(J, [0, 1, 2, 3])
    assert outs[0][:2] == want[:2] and outs[0][3:] == want[3:]
    assert outs[0][2] == list(want[2])


def test_dag_beats_the_barrier_schedule_and_bursts_pay_colds():
    def run(sequential, pool=None):
        clock = tstraggler.SimClock(tstraggler.StragglerModel(**MODEL),
                                    fleet=trt.FleetConfig(), pool=pool)
        tsched.run_dag(clock, prng.PRNGKey(2), diamond(T),
                       sequential=sequential)
        return clock
    dag, seq = run(False), run(True)
    assert dag.time < seq.time and dag.dollars == seq.dollars
    pools = {s: tsched.WarmPool(ttl=300.0) for s in (False, True)}
    for s, p in pools.items():
        run(s, p)
    assert pools[False].cold_starts > pools[True].cold_starts


def test_pool_semantics_match_reference():
    """tests/test_scheduler.py's pool cases, step for step in both."""
    def steps(p):
        out = []
        pool = p.sched.WarmPool(ttl=10.0)
        out.append(pool.acquire(0.0))
        pool.release(1.0)
        out.append(pool.acquire(0.5))
        pool.release(2.0)
        out += [pool.acquire(5.0), pool.acquire(10.5), pool.acquire(10.6)]
        pool.release(3.0)
        out.append(pool.acquire(20.0))
        cap = p.sched.WarmPool(ttl=100.0, capacity=2, prewarmed=1)
        for t in (1.0, 2.0, 3.0):
            cap.release(t)
        out += [len(cap), cap.free_at(3.5), cap.acquire(3.5),
                cap.free_at(3.5), cap.snapshot(3.5)]
        big = p.sched.WarmPool(ttl=50.0, prewarmed=3)
        for t in np.linspace(0.0, 9.0, 10):
            big.release(float(t))
        big.prewarm(2)
        out += [big.cool(1), big.fresh, big.earliest_fit(2.0, 6, 8.0),
                big.cull(0.5, np.random.default_rng(3)), big.snapshot(9.0)]
        with pytest.raises(ValueError):
            p.sched.WarmPool(ttl=0.0)
        return out
    got, want = steps(T), steps(J)
    assert got == want
    assert got[:6] == [False, False, True, True, False, False]


def test_pool_in_the_engine_matches_reference():
    def run(p, prewarmed):
        pool = p.sched.WarmPool(ttl=50.0, prewarmed=prewarmed)
        clock = p.sg.SimClock(
            p.sg.StragglerModel(p_tail=0.0),
            fleet=p.rt.FleetConfig(cold_start_lo=1.0, cold_start_hi=2.0),
            pool=pool)
        elapsed, _ = clock.phase(p.key(5), 8, flops_per_worker=1e5)
        return elapsed, pool.warm_hits, pool.cold_starts
    for prewarmed in (0, 8):
        assert run(T, prewarmed) == run(J, prewarmed)
    assert run(T, 0)[0] > run(T, 8)[0] + 0.9


def test_dag_pool_memory_trace_matches_reference(tmp_path):
    recs = {}

    def record(p):
        recs[p] = p.rt.TraceRecorder(worker_times=True, lifecycle=True)
        clock = p.sg.SimClock(p.sg.StragglerModel(**MODEL),
                              fleet=p.rt.FleetConfig(failure_rate=0.1),
                              pool=p.sched.WarmPool(ttl=30.0),
                              recorder=recs[p])
        spec = p.sched.PhaseSpec
        p.sched.run_dag(clock, p.key(4), [
            spec("a", 8, flops_per_worker=2e5, memory_gb=1.5),
            spec("b", 8, flops_per_worker=2e5, deps=("a",)),
            spec("c", 12, policy="k_of_n", k=10, flops_per_worker=3e5,
                 memory_gb=0.5)])
        return clock
    jc, tc = both(record)
    assert_same_clock(jc, tc)
    assert rows_of(recs[T]) == rows_of(recs[J])
    assert any(r.get("memory_gb") == 1.5 for r in recs[T].rows)


def test_newton_dag_trace_round_trip_matches_reference(tmp_path):
    """The Newton loop on a DAG schedule, a warm pool and a recorder: the
    reference's rows; the port's replay gives the same time and cost."""
    key = jax.random.PRNGKey(0)
    x = jax.random.normal(key, (400, 16))
    y = jnp.sign(x @ jax.random.normal(jax.random.PRNGKey(1), (16,)))
    recs, hists = {}, {}

    def live(p, replay=None):
        cfg_cls, sketch = ((JNewtonConfig, JSketch) if p is J
                           else (TNewtonConfig, TSketch))
        cfg = cfg_cls(iters=2, schedule="dag",
                      sketch=sketch(sketch_dim=128, block_size=32,
                                    straggler_tolerance=0.25))
        if replay is None:
            recs[p] = p.rt.TraceRecorder()
            clock = p.sg.SimClock(p.sg.StragglerModel(**MODEL),
                                  pool=p.sched.WarmPool(ttl=60.0),
                                  fleet=p.rt.FleetConfig(),
                                  recorder=recs[p])
        else:
            clock = p.sg.SimClock(p.sg.StragglerModel(**MODEL),
                                  replay=replay)
        if p is J:
            return j_newton(JLogistic(), JDataset(x=x, y=y), jnp.zeros(16),
                            cfg, model=clock).history
        return t_newton(TLogistic(), TDataset(
            x=torch.from_numpy(np.array(x)),
            y=torch.from_numpy(np.array(y))), np.zeros(16, np.float32), cfg,
            model=clock, device="cpu").history
    hists = dict(zip(PKGS, both(live)))
    assert rows_of(recs[T]) == rows_of(recs[J])
    path = tmp_path / "newton_dag.jsonl"
    recs[T].dump(path)
    replayed = live(T, trt.load_trace(path))
    for k in ("time", "cost"):
        assert replayed[k] == hists[T][k] == [float(v) for v in hists[J][k]]


# ------------------------------------------------------ straggler helpers
def test_straggler_helpers_match_reference():
    for seed, k in ((0, 1), (3, 30), (7, 64)):
        jm = jstraggler.StragglerModel(p_tail=0.2)
        tm = tstraggler.StragglerModel(p_tail=0.2)
        jt = jm.sample_times(jax.random.PRNGKey(seed), 64)
        tt = tm.sample_times(prng.PRNGKey(seed), 64)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        assert float(tstraggler.wait_all_time(tt)) == \
            float(jstraggler.wait_all_time(jt))
        assert float(tstraggler.k_of_n_time(tt, k)) == \
            float(jstraggler.k_of_n_time(jt, k))
        mask = tstraggler.k_of_n_mask(tt, k)
        np.testing.assert_array_equal(mask.numpy(),
                                      np.asarray(jstraggler.k_of_n_mask(jt,
                                                                        k)))
        assert int(mask.sum()) >= k
        assert float(tstraggler.k_of_n_time(tt, k)) <= \
            float(tstraggler.wait_all_time(tt))
    heavy = dict(p_tail=0.2, tail_lo=5.0, tail_hi=5.0, invoke_overhead=0.0)
    jm, tm = jstraggler.StragglerModel(**heavy), \
        tstraggler.StragglerModel(**heavy)
    times = tm.sample_times(prng.PRNGKey(21), 100, work_per_worker=50.0)
    spec = tstraggler.speculative_time(times, prng.PRNGKey(1021), tm,
                                       work_per_worker=50.0)
    want = jstraggler.speculative_time(
        jm.sample_times(jax.random.PRNGKey(21), 100, work_per_worker=50.0),
        jax.random.PRNGKey(1021), jm, work_per_worker=50.0)
    assert spec.dtype == torch.float32
    assert float(spec) == float(want)
    deadline = float(torch.sort(times).values[89])
    assert deadline + 25.0 < float(spec) <= float(times.max()) + 1e-6


def test_clock_charge_and_ledger_match_reference():
    def drive(p):
        clock = p.sg.SimClock(p.sg.StragglerModel())
        e1, m1 = clock.phase(p.key(0), 16, policy="wait_all")
        e2, m2 = clock.phase(p.key(1), 16, policy="k_of_n", k=12)
        clock.charge(0.375)
        assert clock.time == float(e1) + float(e2) + 0.375
        assert bool(np.asarray(m1).all()) and int(np.asarray(m2).sum()) >= 12
        assert clock.last_corruption is None
        return clock
    jc, tc = both(drive)
    assert_same_clock(jc, tc)
    assert tc.ledger.as_dict() == jc.ledger.as_dict()
    assert tc.telemetry.enabled is False
