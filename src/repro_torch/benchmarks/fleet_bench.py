"""Fleet-engine sweep: fleet size x failure rate x termination policy;
port of ``benchmarks/fleet_bench.py``.

Every cell runs the same fixed workload (a few distributed rounds at a
fixed per-worker flop count) through ``runtime.FleetEngine`` via the
SimClock facade and reports simulated seconds *and* simulated dollars —
the time-vs-cost Pareto data that the fig10/fig12 comparisons sit on.
One extra row self-checks trace record/replay bit-exactness; another runs
a two-regime fleet (per-worker work jumps 4x mid-run) under live health
monitors and reports that the straggler detectors fired on the shift
while attaching them changed no simulated totals.

The chaos sweep at the end drives the same fixed workload through every
registered fault scenario (``runtime.faults``), raw and with its
scenario-specific mitigation, and prices each against one shared healthy
baseline (``overhead_s`` / ``overhead_usd`` ratios) — what each failure
mode costs and what its mitigation buys back.  The ``corruption``
scenario is scored on an end-to-end coded Newton solve instead (the
generic drive never decodes anything, so silent corruption is free
there): detection off shows the poisoned solve stalling, detection on
recovers the healthy optimum and pays for it in relaunches.
"""
from __future__ import annotations

import os
import sys
import tempfile

import torch

from repro_torch import obs, prng, scheduler
from repro_torch.benchmarks.common import json_row
from repro_torch.core.straggler import SimClock, StragglerModel
from repro_torch.runtime import (FleetConfig, TraceRecorder,
                                 available_policies, available_scenarios,
                                 get_scenario, load_trace)

ROUNDS = 5
FLOPS_PER_WORKER = 4e5        # ~0.2 s of work at the default throughput

#: Chaos drive geometry: one shared healthy baseline, every scenario cell
#: a one-knob delta from it.
CHAOS_WORKERS = 32
CHAOS_ROUNDS = 8

#: scenario -> non-default fault knobs for its raw chaos cell.  The
#: registry defaults stay mild; the burst cell turns the dial to where
#: the failure mode is actually worth mitigating (the default AZ event
#: barely dents the drive — the engine's fast per-worker retries absorb
#: it at ~1.06x).
CHAOS_KNOBS = {
    "az_burst": dict(kill_fraction=0.85, t_end=6.0),
}

#: scenario -> the drive-knob delta that mitigates it.  ``run()`` iterates
#: ``available_scenarios()`` against this table, so registering a new
#: scenario without deciding its mitigation fails the bench loudly
#: instead of silently losing chaos coverage.
CHAOS_MITIGATIONS = {
    # Correlated burst deaths: the paper's own answer — provisioned
    # redundancy plus a partial wait, so the phase never needs the killed
    # workers' serial retry chains.  (Hedged duplicates do NOT help here:
    # the duplicates are exposed to the same burst window.)
    "az_burst": dict(policy="k_of_n", k=26),
    # Concurrency cap of 8: size the fleet under the cap and give each
    # worker 4x the work instead of paying rejection/backoff storms.
    "throttle": dict(num_workers=8, flops=4 * FLOPS_PER_WORKER),
    # Transient S3 errors fatten the per-attempt tail: the same
    # redundancy margin absorbs the unlucky GET/PUT retry chains
    # completely (the k-th arrival never sits in the retried tail).
    "s3_transient": dict(policy="k_of_n", k=26),
    # OOM kills fire iff memory < working set: provision at the declared
    # working set (costlier gb-seconds, no 90%-wasted killed runs).
    "oom": dict(memory_gb=1.0),
    # Idle-container cull: prewarm enough spares that the surviving 25%
    # still covers the fleet.
    "pool_death": dict(prewarmed=160),
}


def _run_cell(num_workers: int, failure_rate: float, policy: str,
              recorder=None, replay=None) -> SimClock:
    fleet = FleetConfig(failure_rate=failure_rate, cold_start_prob=0.1)
    clock = SimClock(StragglerModel(p_tail=0.05, tail_hi=3.0), fleet=fleet,
                     recorder=recorder, replay=replay)
    k = max(1, int(0.8 * num_workers))
    for r in range(ROUNDS):
        clock.phase(prng.PRNGKey(1000 * num_workers + r), num_workers,
                    policy=policy, k=k,
                    flops_per_worker=FLOPS_PER_WORKER, comm_units=1.0)
    return clock


def _two_regime_cell(telemetry=None) -> SimClock:
    """A fleet whose per-worker work jumps 2e5 -> 8e5 flops mid-run: the
    completion tail shifts 4x, exactly what the straggler monitors watch."""
    clock = SimClock(StragglerModel(p_tail=0.05, tail_hi=3.0),
                     fleet=FleetConfig(cold_start_prob=0.1),
                     telemetry=telemetry)
    for r in range(12):
        clock.phase(prng.PRNGKey(7000 + r), 32, policy="k_of_n",
                    k=25, flops_per_worker=2e5 if r < 6 else 8e5,
                    comm_units=1.0)
    return clock


def _chaos_drive(faults=None, *, policy="wait_all", num_workers=CHAOS_WORKERS,
                 flops=FLOPS_PER_WORKER, k=None, memory_gb=0.5,
                 prewarmed=CHAOS_WORKERS, telemetry=None) -> SimClock:
    """The fixed chaos workload: CHAOS_ROUNDS phases on a warm-pooled
    fleet.  Every phase declares a 1 GB working set against a 0.5 GB
    Lambda — inert unless an OomSpec is in the plan, exactly the trap the
    ``oom`` scenario springs."""
    pool = scheduler.WarmPool(ttl=300.0, prewarmed=prewarmed)
    clock = SimClock(StragglerModel(p_tail=0.05, tail_hi=3.0),
                     fleet=FleetConfig(cold_start_prob=0.3),
                     pool=pool, faults=faults, telemetry=telemetry)
    for r in range(CHAOS_ROUNDS):
        clock.phase(prng.PRNGKey(9000 + r), num_workers,
                    policy=policy, k=k, flops_per_worker=flops,
                    comm_units=1.0, memory_gb=memory_gb,
                    working_set_gb=1.0)
    return clock


def _corruption_newton(faults=None, detection=True, device=None):
    """Small coded Newton solve (the corruption scenario's scoreboard):
    returns (final gnorm, clock)."""
    from repro_torch.core.newton import NewtonConfig, oversketched_newton
    from repro_torch.core.objectives import Dataset, LogisticRegression
    from repro_torch.core.sketch import OverSketchConfig
    from repro_torch.kernels import ops

    key = prng.PRNGKey(0)
    n, d = 256, 8
    x = ops.normal(key, (n, d), device=device)
    y = torch.sign(x @ ops.normal(prng.fold_in(key, 1), (d,), device=device))
    cfg = NewtonConfig(iters=8,
                       sketch=OverSketchConfig(sketch_dim=64, block_size=16,
                                               straggler_tolerance=0.25),
                       coded_block_rows=32, corruption_detection=detection)
    clock = SimClock(StragglerModel(), faults=faults)
    res = oversketched_newton(LogisticRegression(lam=1e-3),
                              Dataset(x=x, y=y), torch.zeros(d), cfg, clock,
                              device=device)
    return res.history["gnorm"][-1], clock


def run(quick: bool = True, device=None):
    sizes = (32, 128) if quick else (32, 128, 512)
    failure_rates = (0.0, 0.05) if quick else (0.0, 0.05, 0.2)
    rows = []
    for n in sizes:
        for f in failure_rates:
            for policy in available_policies():
                clock = _run_cell(n, f, policy)
                rows.append(json_row(
                    f"fleet_n{n}_fail{int(100 * f)}_{policy}",
                    clock.time * 1e6,
                    sim_s=clock.time, usd=clock.dollars,
                    invocations=clock.ledger.invocations,
                    gb_s=clock.ledger.gb_seconds))

    # Record/replay self-check: one cell recorded, replayed, compared.
    rec = TraceRecorder()
    recorded = _run_cell(64, 0.1, "k_of_n", recorder=rec)
    with tempfile.NamedTemporaryFile("w", suffix=".jsonl",
                                     delete=False) as tmp:
        path = tmp.name
    try:
        rec.dump(path)
        replayed = _run_cell(64, 0.1, "k_of_n", replay=load_trace(path))
        exact = int(replayed.time == recorded.time
                    and replayed.dollars == recorded.dollars)
    finally:
        os.unlink(path)
    rows.append(json_row("fleet_trace_replay", recorded.time * 1e6,
                         sim_s=recorded.time, usd=recorded.dollars,
                         replay_exact=exact))

    # Health-monitor self-check: the 4x work shift must alert, and the
    # monitored run must land on the exact same simulated totals.
    plain = _two_regime_cell()
    tel = obs.Telemetry(monitors=True)
    monitored = _two_regime_cell(telemetry=tel)
    shift_alerts = [a for a in tel.health.alerts
                    if a.metric in ("worker.completion_s",
                                    "phase.tail_p95_s")]
    rows.append(json_row(
        "fleet_two_regime_monitored", monitored.time * 1e6,
        sim_s=monitored.time, usd=monitored.dollars,
        alerts=len(tel.health.alerts), shift_alerts=len(shift_alerts),
        monitor_inert=int(monitored.time == plain.time
                          and monitored.dollars == plain.dollars)))
    # ---------------------------------------------------------- chaos sweep
    # One shared healthy baseline; every registered fault scenario runs
    # raw and mitigated against it.  Ratios > 1 are the price of the
    # failure mode (or of its mitigation — OOM-safe sizing and extra
    # prewarm cost real gb-seconds, reported honestly).
    healthy = _chaos_drive()
    rows.append(json_row("chaos_healthy", healthy.time * 1e6,
                         sim_s=healthy.time, usd=healthy.dollars,
                         invocations=healthy.ledger.invocations))

    def chaos_row(nm, clock, **extra):
        rows.append(json_row(
            nm, clock.time * 1e6, sim_s=clock.time, usd=clock.dollars,
            invocations=clock.ledger.invocations,
            overhead_s=clock.time / healthy.time,
            overhead_usd=clock.dollars / healthy.dollars, **extra))

    for scen in available_scenarios():
        if scen == "corruption":
            continue   # scored on the coded Newton solve below
        if scen not in CHAOS_MITIGATIONS:
            raise KeyError(
                f"scenario {scen!r} has no entry in CHAOS_MITIGATIONS — "
                "decide its mitigation to keep chaos coverage total")
        plan = get_scenario(scen, **CHAOS_KNOBS.get(scen, {}))
        chaos_row(f"chaos_{scen}", _chaos_drive(plan))
        chaos_row(f"chaos_{scen}_mitigated",
                  _chaos_drive(plan, **CHAOS_MITIGATIONS[scen]))

    # Incident-attribution smoke (obs.incident): a mid-run AZ burst
    # under live monitors must attribute back to az_burst, and running
    # the attribution pipeline must change no simulated totals.  CI's
    # bench-smoke asserts cause_match and attribution_inert off this row.
    def _burst_plan():
        return get_scenario("az_burst", kill_fraction=0.85,
                            t_start=0.5 * healthy.time,
                            t_end=0.5 * healthy.time + 3.0)

    atel = obs.Telemetry(monitors=True)
    attributed = _chaos_drive(_burst_plan(), telemetry=atel)
    incidents = obs.attribute(atel, faults=_burst_plan())
    plain_burst = _chaos_drive(_burst_plan())
    top = incidents[0].cause if incidents else "none"
    chaos_row("chaos_attributed", attributed,
              incidents=len(incidents), top_cause=top,
              cause_match=int(top == "az_burst"),
              attribution_inert=int(attributed.time == plain_burst.time
                                    and attributed.dollars
                                    == plain_burst.dollars))

    # Corruption: silent wrong results only matter where something decodes
    # them, so this cell is an end-to-end coded Newton solve.  Blind
    # (detection off) converges to the wrong place for free; detection
    # pays relaunches/full-arrival waits to recover the healthy optimum.
    gn_h, ck_h = _corruption_newton(device=device)
    gtol = 1e-3
    rows.append(json_row("chaos_newton_healthy", ck_h.time * 1e6,
                         sim_s=ck_h.time, usd=ck_h.dollars,
                         converged=int(gn_h < gtol)))
    gn_b, ck_b = _corruption_newton(get_scenario("corruption"),
                                    detection=False, device=device)
    rows.append(json_row("chaos_corruption", ck_b.time * 1e6,
                         sim_s=ck_b.time, usd=ck_b.dollars,
                         overhead_s=ck_b.time / ck_h.time,
                         overhead_usd=ck_b.dollars / ck_h.dollars,
                         converged=int(gn_b < gtol)))
    gn_m, ck_m = _corruption_newton(get_scenario("corruption"),
                                    detection=True, device=device)
    rows.append(json_row("chaos_corruption_mitigated", ck_m.time * 1e6,
                         sim_s=ck_m.time, usd=ck_m.dollars,
                         overhead_s=ck_m.time / ck_h.time,
                         overhead_usd=ck_m.dollars / ck_h.dollars,
                         converged=int(gn_m < gtol)))

    print(obs.bench_rows_table(rows), file=sys.stderr)
    return rows
