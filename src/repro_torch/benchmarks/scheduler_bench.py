"""Phase-DAG scheduler sweep: DAG-vs-sequential makespan x warm-pool TTL x
per-phase Lambda sizing; port of ``benchmarks/scheduler_bench.py``.

Three questions, one grid:

  1. How much makespan does DAG dispatch buy?  A Newton-iteration-shaped
     DAG (gradient matvec chain || Hessian-sketch fan-out -> line search)
     under nonzero straggler tails: the DAG makespan must be strictly
     below sequential, and a fully serialized chain must equal it
     bit-for-bit.  A real ``oversketched_newton`` run (schedule="dag" vs
     "sequential") repeats the comparison end-to-end.
  2. What do bursty schedules pay in cold starts?  The same DAG under a
     ``WarmPool`` across TTLs: the DAG's concurrent fan-outs need more
     containers at once than the steady sequential schedule, so its cold
     count is never lower.
  3. What does per-phase sizing save?  The same workload billed at the
     paper's fleet-wide 3 GB vs each phase's declared ``memory_gb``.

One extra row self-checks that a DAG-scheduled, pool-enabled, per-phase-
sized trace replays to bit-identical ``(seconds, dollars)``.

Every row carries a ``path`` field (``dag`` | ``seq`` | ``pool`` |
``replay``) naming which dispatch mode produced it, mirroring the kernel
baseline's attribution convention.
"""
from __future__ import annotations

import os
import sys
import tempfile

import torch

from repro_torch import obs, prng
from repro_torch.benchmarks.common import json_row
from repro_torch.core.straggler import SimClock, StragglerModel
from repro_torch.runtime import TraceRecorder, load_trace
from repro_torch.scheduler import (PhaseSpec, WarmPool, lambda_memory_gb,
                                   run_dag)

MODEL = StragglerModel(p_tail=0.05, tail_hi=3.0)


def _newton_shaped_specs(workers: int, sized: bool):
    """One Newton-iteration-shaped DAG: a two-matvec gradient chain in
    parallel with a Hessian-sketch fan-out, joined by a line search."""
    mem = (lambda: lambda_memory_gb(256 * 64 * 4)) if sized else (lambda: None)
    return [
        PhaseSpec("grad/0:X", workers, policy="k_of_n",
                  k=max(1, int(0.8 * workers)), flops_per_worker=3e5,
                  comm_units=1.0, memory_gb=mem()),
        PhaseSpec("grad/1:XT", workers, policy="k_of_n",
                  k=max(1, int(0.8 * workers)), flops_per_worker=3e5,
                  comm_units=1.0, deps=("grad/0:X",), memory_gb=mem()),
        PhaseSpec("hessian", 2 * workers, policy="k_of_n",
                  k=max(1, int(0.8 * 2 * workers)), flops_per_worker=6e5,
                  comm_units=1.0,
                  memory_gb=lambda_memory_gb(256 * 256 * 8) if sized
                  else None),
        PhaseSpec("linesearch", workers, policy="wait_all",
                  flops_per_worker=1e5, comm_units=0.5,
                  deps=("grad/1:XT", "hessian"), memory_gb=mem()),
    ]


def _chain_specs(workers: int):
    names = ["a", "b", "c", "d"]
    return [PhaseSpec(n, workers, policy="wait_all", flops_per_worker=2e5,
                      deps=(names[i - 1],) if i else ())
            for i, n in enumerate(names)]


def _run(specs, *, sequential=False, pool=None, recorder=None, replay=None
         ) -> SimClock:
    clock = SimClock(MODEL, pool=pool, recorder=recorder, replay=replay)
    run_dag(clock, prng.PRNGKey(7), specs, sequential=sequential)
    return clock


def _newton_end_to_end(schedule: str, iters: int, telemetry=None,
                       device=None):
    from repro_torch.core import newton, sketch
    from repro_torch.core.objectives import Dataset, LogisticRegression
    from repro_torch.kernels import ops

    x = ops.normal(prng.PRNGKey(0), (1024, 16), device=device)
    y = torch.sign(x @ ops.normal(prng.PRNGKey(1), (16,), device=device))
    cfg = newton.NewtonConfig(
        iters=iters, schedule=schedule,
        sketch=sketch.OverSketchConfig(sketch_dim=256, block_size=64,
                                       straggler_tolerance=0.25))
    model = (SimClock(MODEL, telemetry=telemetry)
             if telemetry is not None else MODEL)
    res = newton.oversketched_newton(
        LogisticRegression(), Dataset(x=x, y=y), torch.zeros(16), cfg,
        model=model, device=device)
    return res.history["time"][-1], res.history["cost"][-1]


def _traced_newton_row(trace_out: str, iters: int, device=None):
    """The ``--trace-out`` path: re-run the DAG-scheduled Newton with live
    telemetry AND health monitors, export + validate a Perfetto trace
    (gradient chain || Hessian-sketch overlap with per-worker lifecycle
    slices), dump the JSONL sibling for ``benchmarks.make_report
    --trace``, and self-check that attaching the recorder + monitors
    changed nothing."""
    t_plain, c_plain = _newton_end_to_end("dag", iters, device=device)
    tel = obs.Telemetry(monitors=True)
    t_dag, c_dag = _newton_end_to_end("dag", iters, telemetry=tel,
                                      device=device)
    # Attribute any alerts before export so incident rows land in the
    # JSONL (and thus in make_report --trace / the HTML console), and
    # ship the timestamped gauge streams as Perfetto counter tracks.
    incidents = obs.attribute(tel)
    counters = obs.counter_series(tel)
    trace = obs.to_perfetto(tel.trace.spans, counters=counters)
    obs.perfetto.validate_trace(
        trace, require_phases=("hessian", "linesearch", "grad/0:X"),
        require_counters=tuple(sorted(counters))[:1])
    obs.dump_perfetto(trace, trace_out)
    jsonl = (trace_out[:-5] if trace_out.endswith(".json") else trace_out) \
        + ".jsonl"
    obs.dump_jsonl(tel, jsonl)
    print(f"# wrote {trace_out} + {jsonl}", file=sys.stderr)
    print(obs.phase_table(obs.telemetry_rows(tel)), file=sys.stderr)
    return json_row(
        "sched_newton_traced", t_dag * 1e6, sim_s=t_dag, usd=c_dag,
        spans=len(tel.trace.spans),
        events=len(trace["traceEvents"]),
        alerts=len(tel.health.alerts), incidents=len(incidents),
        counter_tracks=len(counters),
        recorder_inert=int(t_dag == t_plain and c_dag == c_plain)) \
        | {"path": "dag"}


def run(quick: bool = True, trace_out=None, device=None):
    rows = []
    sizes = (16, 64) if quick else (16, 64, 256)

    # --- 1. DAG vs sequential makespan --------------------------------
    for w in sizes:
        specs = _newton_shaped_specs(w, sized=False)
        dag = _run(specs)
        seq = _run(specs, sequential=True)
        rows.append(json_row(
            f"sched_dag_vs_seq_w{w}", dag.time * 1e6, sim_s=dag.time,
            seq_s=seq.time, speedup=seq.time / dag.time, usd=dag.dollars)
            | {"path": "dag"})
        assert dag.time < seq.time, "DAG makespan must beat sequential"
        assert dag.dollars == seq.dollars, "billing is schedule-invariant"
        chain = _chain_specs(w)
        cd, cs = _run(chain), _run(chain, sequential=True)
        rows.append(json_row(
            f"sched_chain_eq_w{w}", cd.time * 1e6, sim_s=cd.time,
            exact=int(cd.time == cs.time and cd.dollars == cs.dollars))
            | {"path": "seq"})

    # --- 2. warm-pool TTL sweep ---------------------------------------
    # Phase durations here are O(0.3 s) with straggler tails to ~1 s, so
    # ttl=0.05 expires containers released early behind a straggling
    # phase, 1.0 keeps intra-schedule reuse, 300 never expires.
    for ttl in (0.05, 1.0, 300.0):
        for label, sequential in (("dag", False), ("seq", True)):
            pool = WarmPool(ttl=ttl)
            clock = _run(_newton_shaped_specs(64, sized=False),
                         sequential=sequential, pool=pool)
            rows.append(json_row(
                f"sched_pool_ttl{ttl:g}_{label}", clock.time * 1e6,
                sim_s=clock.time, usd=clock.dollars, warm=pool.warm_hits,
                cold=pool.cold_starts) | {"path": "pool"})

    # --- 3. per-phase Lambda sizing -----------------------------------
    fixed = _run(_newton_shaped_specs(64, sized=False))
    sized = _run(_newton_shaped_specs(64, sized=True))
    rows.append(json_row(
        "sched_mem_fixed3gb", fixed.time * 1e6, usd=fixed.dollars,
        gb_s=fixed.ledger.gb_seconds) | {"path": "dag"})
    rows.append(json_row(
        "sched_mem_sized", sized.time * 1e6, usd=sized.dollars,
        gb_s=sized.ledger.gb_seconds,
        saving=1.0 - sized.dollars / fixed.dollars) | {"path": "dag"})

    # --- 4. Newton end-to-end, DAG vs sequential dispatch -------------
    iters = 3 if quick else 8
    t_dag, c_dag = _newton_end_to_end("dag", iters, device=device)
    t_seq, c_seq = _newton_end_to_end("sequential", iters, device=device)
    rows.append(json_row(
        "sched_newton_dag_vs_seq", t_dag * 1e6, sim_s=t_dag, seq_s=t_seq,
        speedup=t_seq / t_dag, usd=c_dag,
        cost_equal=int(c_dag == c_seq)) | {"path": "dag"})

    # --- 5. DAG + pool + sizing trace replay self-check ---------------
    rec = TraceRecorder(lifecycle=True)
    recorded = _run(_newton_shaped_specs(32, sized=True),
                    pool=WarmPool(ttl=30.0), recorder=rec)
    with tempfile.NamedTemporaryFile("w", suffix=".jsonl",
                                     delete=False) as tmp:
        path = tmp.name
    try:
        rec.dump(path)
        replayed = _run(_newton_shaped_specs(32, sized=True),
                        replay=load_trace(path))
        exact = int(replayed.time == recorded.time
                    and replayed.dollars == recorded.dollars)
    finally:
        os.unlink(path)
    rows.append(json_row("sched_trace_replay", recorded.time * 1e6,
                         sim_s=recorded.time, usd=recorded.dollars,
                         replay_exact=exact) | {"path": "replay"})

    # --- 6. telemetry export (opt-in via --trace-out) -----------------
    if trace_out:
        rows.append(_traced_newton_row(trace_out, iters, device=device))
    print(obs.bench_rows_table(rows), file=sys.stderr)
    return rows
