"""Multi-tenant frontier sweep: throughput vs latency vs dollars at scale;
port of ``benchmarks/tenancy_bench.py``.

Every cell pushes the same seeded workload (1k jobs quick / 10k full,
heterogeneous Newton/GIANT/matvec templates from ``tenancy``)
through one shared discrete-event fleet under a different platform
policy, and reports the three axes the paper's economics live on —
completed-jobs-per-second, job latency tail, and total dollars
(provisioned-concurrency idle billing included):

  - ``nopool_open``: no warm pool, admit everything — the baseline where
    every phase pays i.i.d. cold-start odds and the platform is free of
    provisioned cost.
  - ``shared_pool``: one ``WarmPool`` shared by every tenant, statically
    provisioned; idle reserve bills real provisioned-concurrency
    GB-seconds.
  - ``pool_aware``: same pool, plus slack-spending dispatch (delay an
    off-critical-path phase within its CPM slack to land on warm
    containers).
  - ``autoscale``: empty reserve at t=0, arrival-rate autoscaler sizes it
    (Little's-law target, EWMA-smoothed) — dollars follow load.
  - ``slo_admission``: SLO-aware admission on top — infeasible jobs are
    refused at arrival instead of admitted to fail.
  - ``burst``: the whole workload arrives in ~1 simulated second — peak
    in-flight concurrency ~= the full job count, the "thousands of
    concurrent jobs" regime of the ROADMAP item.
  - ``budget_slo``: per-tenant error budgets (``obs.slo``) with
    budget-aware admission — a tenant whose SLO burn pages sheds *its
    own* arrivals while every other tenant rides undisturbed; a sibling
    check shows tracking alone (``budget_aware=False``) is pure
    observation (bit-identical totals with and without SLO policies).

A final self-check row re-runs one policy cell twice and reports
bit-identity of (seconds, dollars, warm/cold phase log) — the tenancy
determinism contract, continuously measured.
"""
from __future__ import annotations

import dataclasses
import time

from repro_torch import obs, prng
from repro_torch.benchmarks.common import json_row
from repro_torch.core.straggler import SimClock, StragglerModel
from repro_torch.obs.slo import SloPolicy
from repro_torch.runtime import FleetConfig
from repro_torch.scheduler.pool import WarmPool
from repro_torch.tenancy import (AdmissionPolicy, Autoscaler,
                                 JobScheduler, TenancyConfig, WorkloadConfig,
                                 generate_workload)

SEED = 0
POOL_TTL = 120.0
POOL_PREWARMED = 200
#: Cold starts are real in every cell: without a pool each attempt flips
#: this i.i.d. coin; with a pool the coin is replaced by actual container
#: reuse — that substitution is the frontier being measured.
FLEET = FleetConfig(cold_start_prob=0.3)

#: Admit-everything policy for the open cells: the cap is never the
#: binding constraint, so the frontier isolates pool + dispatch effects.
OPEN = AdmissionPolicy(max_inflight=1_000_000, queue=True, slo_aware=False)


def _drive(jobs, pool=None, config=TenancyConfig(admission=OPEN)):
    clock = SimClock(StragglerModel(), fleet=FLEET, pool=pool)
    sched = JobScheduler(clock, prng.PRNGKey(SEED), jobs, config)
    return sched.run()


def _row(name: str, wall_s: float, res, pool=None) -> dict:
    s = res.summary()
    warm_rate = 0.0
    if pool is not None and (pool.warm_hits + pool.cold_starts):
        warm_rate = pool.warm_hits / (pool.warm_hits + pool.cold_starts)
    return json_row(
        name, s["seconds"] * 1e6,
        sim_s=s["seconds"], usd=s["dollars"],
        jobs=s["jobs"], completed=s["completed"],
        rejected=s["rejected"], slo_miss=s["slo_misses"],
        throughput=s["throughput"], peak_inflight=s["peak_inflight"],
        lat_p50=s["latency_p50"], lat_p95=s["latency_p95"],
        prov_gb_s=s["provisioned_gb_seconds"], warm_rate=warm_rate,
        wall_s=wall_s)


def run(quick: bool = True):
    n_jobs = 1_000 if quick else 10_000
    rate = 60.0 if quick else 150.0
    jobs = generate_workload(WorkloadConfig(seed=SEED, rate=rate,
                                            n_jobs=n_jobs))
    rows = []

    def cell(name, pool=None, config=TenancyConfig(admission=OPEN)):
        t0 = time.time()
        res = _drive(jobs, pool=pool, config=config)
        rows.append(_row(f"tenancy_{name}", time.time() - t0, res,
                         pool=pool))
        return res

    cell("nopool_open")
    cell("shared_pool", pool=WarmPool(ttl=POOL_TTL,
                                      prewarmed=POOL_PREWARMED))
    cell("pool_aware", pool=WarmPool(ttl=POOL_TTL,
                                     prewarmed=POOL_PREWARMED),
         config=TenancyConfig(admission=OPEN, pool_aware=True))
    cell("autoscale", pool=WarmPool(ttl=POOL_TTL, prewarmed=0),
         config=TenancyConfig(admission=OPEN, pool_aware=True,
                              autoscaler=Autoscaler(max_provisioned=400)))
    cell("slo_admission", pool=WarmPool(ttl=POOL_TTL,
                                        prewarmed=POOL_PREWARMED),
         config=TenancyConfig(
             admission=AdmissionPolicy(max_inflight=256, queue=True,
                                       slo_aware=True),
             pool_aware=True))

    # The "thousands of concurrent jobs" regime: the same job count
    # compressed into ~1 simulated second of arrivals, open admission —
    # peak_inflight approaches n_jobs.
    burst = generate_workload(WorkloadConfig(seed=SEED, rate=float(n_jobs),
                                             n_jobs=n_jobs))
    burst_pool = WarmPool(ttl=POOL_TTL, prewarmed=POOL_PREWARMED)
    t0 = time.time()
    res = _drive(burst, pool=burst_pool)
    rows.append(_row("tenancy_burst", time.time() - t0, res,
                     pool=burst_pool))

    # Error-budget plane (obs.slo): a deliberately-tight serving
    # objective burns its budget; budget-aware admission sheds exactly
    # that tenant's arrivals once fast+slow burn both page.
    slo_policies = {
        "serving": SloPolicy(latency_target_s=0.15, deadline_rate=0.9,
                             fast_window_s=10.0, slow_window_s=40.0),
        "batch": SloPolicy(latency_target_s=60.0, deadline_rate=0.5),
        "train": SloPolicy(latency_target_s=60.0, deadline_rate=0.5),
    }
    budget_adm = AdmissionPolicy(max_inflight=256, queue=True,
                                 slo_aware=False, budget_aware=True)
    tel = obs.Telemetry()
    pool = WarmPool(ttl=POOL_TTL, prewarmed=POOL_PREWARMED)
    t0 = time.time()
    clock = SimClock(StragglerModel(), fleet=FLEET, pool=pool,
                     telemetry=tel)
    res = JobScheduler(clock, prng.PRNGKey(SEED), jobs,
                       TenancyConfig(admission=budget_adm, pool_aware=True,
                                     slo=slo_policies)).run()
    shed = sum(c.value for n, c in tel.metrics.counters.items()
               if n.endswith(".budget_shed"))
    summ = tel.slo.summary()
    row = _row("tenancy_budget_slo", time.time() - t0, res, pool=pool)
    row["derived"] += (f";budget_shed={int(shed)}"
                       + "".join(f";{t}_budget="
                                 f"{summ[t]['budget_remaining']:.3f}"
                                 for t in sorted(summ)))
    rows.append(row)

    # Determinism self-check: same seed + same trace, twice, smaller run
    # (the contract is bit-identity, not speed).
    small = generate_workload(WorkloadConfig(seed=SEED, rate=rate,
                                             n_jobs=min(200, n_jobs)))
    cfg = TenancyConfig(admission=OPEN, pool_aware=True)
    a = _drive(small, pool=WarmPool(ttl=POOL_TTL, prewarmed=32),
               config=cfg)
    b = _drive(small, pool=WarmPool(ttl=POOL_TTL, prewarmed=32),
               config=cfg)
    exact = int(a.seconds == b.seconds and a.dollars == b.dollars
                and a.phase_log == b.phase_log)
    # SLO tracking alone must be pure observation: attach the policies
    # with budget_aware off and nothing simulated may move.
    c = _drive(small, pool=WarmPool(ttl=POOL_TTL, prewarmed=32),
               config=dataclasses.replace(cfg, slo=slo_policies))
    slo_inert = int(c.seconds == a.seconds and c.dollars == a.dollars
                    and c.phase_log == a.phase_log)
    rows.append(json_row("tenancy_determinism", a.seconds * 1e6,
                         sim_s=a.seconds, usd=a.dollars, exact=exact,
                         slo_inert=slo_inert))
    return rows
