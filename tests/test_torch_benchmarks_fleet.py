"""The port's fleet, scheduler and tenancy sweeps against the JAX
package's on the CPU, through the sweeps' shared helpers at small sizes:
simulated seconds, dollars, ledgers, warm/cold counts and phase logs bit
for bit, rows equal."""
import dataclasses

import numpy as np
import pytest
import torch

import benchmarks.fleet_bench as jfleet
import benchmarks.scheduler_bench as jsched
import benchmarks.tenancy_bench as jten
import repro.tenancy as jtenancy

import repro_torch.benchmarks.fleet_bench as tfleet
import repro_torch.benchmarks.scheduler_bench as tsched
import repro_torch.benchmarks.tenancy_bench as tten
from repro_torch import scheduler as tscheduler, tenancy as ttenancy

torch.set_num_threads(1)

RTOL = 1e-4


def clock_totals(clock):
    return (clock.time, clock.dollars, dataclasses.asdict(clock.ledger))


@pytest.mark.parametrize("n,f,policy", [(32, 0.05, "k_of_n"),
                                        (32, 0.0, "hedged"),
                                        (16, 0.05, "speculative")])
def test_fleet_cells_match_reference(n, f, policy):
    assert clock_totals(tfleet._run_cell(n, f, policy)) == \
        clock_totals(jfleet._run_cell(n, f, policy))


def test_fleet_chaos_and_two_regime_match_reference():
    assert clock_totals(tfleet._two_regime_cell()) == \
        clock_totals(jfleet._two_regime_cell())
    assert clock_totals(tfleet._chaos_drive()) == \
        clock_totals(jfleet._chaos_drive())
    assert tfleet.CHAOS_MITIGATIONS == jfleet.CHAOS_MITIGATIONS
    assert tfleet.CHAOS_KNOBS == jfleet.CHAOS_KNOBS
    for scen in ("az_burst", "throttle"):
        plans = [m.get_scenario(scen, **jfleet.CHAOS_KNOBS.get(scen, {}))
                 for m in (tfleet, jfleet)]
        for kw in ({}, jfleet.CHAOS_MITIGATIONS[scen]):
            assert clock_totals(tfleet._chaos_drive(plans[0], **kw)) == \
                clock_totals(jfleet._chaos_drive(plans[1], **kw)), (scen, kw)


def test_fleet_corruption_newton_matches_reference():
    for detection in (True, False):
        jg, jc = jfleet._corruption_newton(
            jfleet.get_scenario("corruption"), detection=detection)
        tg, tc = tfleet._corruption_newton(
            tfleet.get_scenario("corruption"), detection=detection,
            device="cpu")
        assert clock_totals(tc) == clock_totals(jc)
        np.testing.assert_allclose(tg, float(jg), rtol=RTOL)


def test_scheduler_bench_matches_reference(tmp_path):
    for w in (16, 64):
        for sized in (False, True):
            specs = (tsched._newton_shaped_specs(w, sized),
                     jsched._newton_shaped_specs(w, sized))
            assert [dataclasses.asdict(s) for s in specs[0]] == \
                [dataclasses.asdict(s) for s in specs[1]]
            for seq in (False, True):
                assert clock_totals(tsched._run(specs[0], sequential=seq)) \
                    == clock_totals(jsched._run(specs[1], sequential=seq))
        chain = tsched._run(tsched._chain_specs(w))
        assert clock_totals(chain) == clock_totals(
            jsched._run(jsched._chain_specs(w)))
    pools = (tscheduler.WarmPool(ttl=1.0), jsched.WarmPool(ttl=1.0))
    assert clock_totals(tsched._run(tsched._newton_shaped_specs(64, False),
                                    pool=pools[0])) == \
        clock_totals(jsched._run(jsched._newton_shaped_specs(64, False),
                                 pool=pools[1]))
    assert (pools[0].warm_hits, pools[0].cold_starts) == \
        (pools[1].warm_hits, pools[1].cold_starts)
    for schedule in ("dag", "sequential"):
        assert tsched._newton_end_to_end(schedule, 2, device="cpu") == \
            tuple(float(v) for v in jsched._newton_end_to_end(schedule, 2))
    row = tsched._traced_newton_row(str(tmp_path / "t.perfetto.json"), 2,
                                    device="cpu")
    jrow = jsched._traced_newton_row(str(tmp_path / "j.perfetto.json"), 2)
    assert row == jrow
    assert "recorder_inert=1" in row["derived"]


def test_tenancy_bench_matches_reference():
    tjobs, jjobs = (p.generate_workload(p.WorkloadConfig(
        seed=tten.SEED, rate=60.0, n_jobs=60)) for p in (ttenancy, jtenancy))
    cfgs = [
        lambda m: (None, m.TenancyConfig(admission=m.OPEN)),
        lambda m: (m.WarmPool(ttl=m.POOL_TTL, prewarmed=m.POOL_PREWARMED),
                   m.TenancyConfig(admission=m.OPEN, pool_aware=True)),
        lambda m: (m.WarmPool(ttl=m.POOL_TTL, prewarmed=0),
                   m.TenancyConfig(admission=m.OPEN, pool_aware=True,
                                   autoscaler=m.Autoscaler(
                                       max_provisioned=400))),
        lambda m: (m.WarmPool(ttl=m.POOL_TTL, prewarmed=m.POOL_PREWARMED),
                   m.TenancyConfig(admission=m.AdmissionPolicy(
                       max_inflight=8, queue=True, slo_aware=True),
                       pool_aware=True)),
    ]
    for make in cfgs:
        (tpool, tcfg), (jpool, jcfg) = make(tten), make(jten)
        tres = tten._drive(tjobs, pool=tpool, config=tcfg)
        jres = jten._drive(jjobs, pool=jpool, config=jcfg)
        trow = tten._row("cell", 0.0, tres, pool=tpool)
        jrow = jten._row("cell", 0.0, jres, pool=jpool)
        assert trow == jrow
        assert tres.phase_log == jres.phase_log


def test_generate_workload_is_the_reference_s():
    cfg = dict(seed=0, rate=60.0, n_jobs=200)
    assert [(j.id, j.template.name, j.t_arrival) for j in
            ttenancy.generate_workload(ttenancy.WorkloadConfig(**cfg))] == \
        [(j.id, j.template.name, j.t_arrival)
         for j in jtenancy.generate_workload(jtenancy.WorkloadConfig(**cfg))]
