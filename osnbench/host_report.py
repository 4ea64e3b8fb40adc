"""What the program's host spans show in one cell, on the card:

    python3 -m osnbench.host_report --workload <cell> --seed <n> --seconds <s>
        [--out <file.json>]

1. ``syncs``: one call of the cell's solver with
   ``torch.cuda.set_sync_debug_mode("warn")``; every synchronizing call
   that torch reports is placed inside a ``sync`` span, inside a counted
   pageable copy (``to_device``), or neither (with where it was made), and
   each iteration's reports are set beside its ``host.syncs`` and
   ``host.h2d_pageable_copies``.
2. ``clock``: one call under ``torch.profiler``; each program span against
   the profiler's record of its range (start and end differences, ns).
3. ``cost``: host microseconds an iteration spends in the tracer's
   methods, timed inside a plain call and a call under the profiler, and
   one iteration's calls replayed in a loop; and the spans an iteration
   records.
4. ``traced``: one ``--trace 1`` run of the cell (``run.run_cell``), with
   its per-layer metrics and the traced span's device-idle ms an
   iteration by the program's innermost open span.

One JSON object a step on standard output, and all of them in ``--out``
when it is given.
"""
from __future__ import annotations

import argparse
import json
import time
import traceback
import warnings
from pathlib import Path


def _solver(cell, seed, device):
    import torch
    from osnbench import run
    x, y = cell["objective"].generate(cell["config"], seed, device)
    solve = run.Solver(cell, x, y, device)
    zeros = torch.zeros(solve.dim, dtype=torch.float32, device=device)
    solve(zeros, run.call_seed(seed, -1),
          iters=int(cell["traffic"]["warmup_iters"]))
    torch.cuda.synchronize()
    return solve, zeros


#: The tracer's methods that the program calls (``cost`` times them).
METHODS = ("_open", "begin", "end", "annotate", "sync", "span", "copied")
#: Functions whose synchronizing copies the program counts as copies.
COPY_SITES = ("to_device", "_peel_axis")


def _call_spans(tr, first):
    return list(tr.spans)[-(tr.appended - first):]


def syncs(solve, zeros, seed) -> dict:
    import torch
    from osnbench import run
    from repro_torch.obs import host
    tr = host.TRACER
    reports = []

    def hook(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        stack = traceback.extract_stack()[:-1]
        open_ = tr.open_spans()
        where = [f"{Path(f.filename).name}:{f.lineno} {f.name}"
                 for f in stack if "repro_torch" in f.filename][-3:] or [
            f"{Path(f.filename).name}:{f.lineno} {f.name}"
            for f in stack[-4:]]
        reports.append({
            "iteration": open_[-1].iteration if open_ else -1,
            "sync": bool(open_) and open_[-1].name == "sync",
            "site": open_[-1].attrs.get("site") if open_ else None,
            "copy": any(f.name in COPY_SITES for f in stack),
            "where": where})

    first = tr.appended
    with warnings.catch_warnings():     # restores showwarning on leaving
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            solve(zeros, run.call_seed(seed, 0))
        finally:
            torch.cuda.set_sync_debug_mode(0)
    its = [s for s in _call_spans(tr, first) if s.name == "iteration"]
    rows = []
    for it in its:
        mine = [r for r in reports if r["iteration"] == it.iteration]
        rows.append({"iteration": it.iteration, "reported": len(mine),
                     "in_sync_spans": sum(r["sync"] for r in mine),
                     "counted_copies": sum(r["copy"] for r in mine),
                     "host.syncs": it.attrs[host.SYNCS],
                     "host.h2d_pageable_copies": it.attrs[host.H2D_COPIES],
                     "sites": sorted({r["site"] for r in mine if r["sync"]})})
    other = [r for r in reports if not (r["sync"] or r["copy"])]
    return {"iterations": rows, "outside_iterations":
            sum(1 for r in reports if r["iteration"] < 0),
            "neither": other[:20], "neither_count": len(other)}


def clock(solve, zeros, seed) -> dict:
    import torch
    from osnbench import run
    from repro_torch.obs import host
    tr = host.TRACER
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    first = tr.appended
    with torch.profiler.profile(activities=acts) as prof:
        solve(zeros, run.call_seed(seed, 1), iters=2)
        torch.cuda.synchronize()
    mine = sorted((s.name, s.start, s.end) for s in _call_spans(tr, first))
    events, on_device = [], 0
    for e in prof.profiler.kineto_results.events():
        if not e.name().startswith(host.PREFIX):
            continue
        if e.device_type() != torch.autograd.DeviceType.CPU:
            on_device += 1
            continue
        events.append((e.name()[len(host.PREFIX):], e.start_ns(),
                       e.start_ns() + e.duration_ns()))
    events.sort()
    same = [m[0] for m in mine] == [e[0] for e in events]
    ds = [abs(m[1] - e[1]) for m, e in zip(mine, events)] if same else []
    de = [abs(m[2] - e[2]) for m, e in zip(mine, events)] if same else []
    return {"spans": len(mine), "ranges": len(events), "matched": same,
            "max_start_ns": max(ds, default=None),
            "max_end_ns": max(de, default=None),
            "device_side_ranges": on_device}


def _replay(tr, calls, reps: int) -> float:
    """Host ns of ``reps`` replays of recorded tracer calls on ``tr``."""
    t0 = time.perf_counter_ns()
    for _ in range(reps):
        ids = {}
        for m, args, kwargs, out in calls:
            if m == "end":
                tr.end(ids[args[0]])
            else:
                got = getattr(tr, m)(*args, **kwargs)
                if m in ("_open", "begin"):
                    ids[out] = got
    return time.perf_counter_ns() - t0


class _StubScope:
    def __init__(self, tr, name):
        self.tr, self.name = tr, name

    def __enter__(self):
        self.sid = self.tr._open(self.name, {})
        return self

    def __exit__(self, *exc):
        self.tr.end(self.sid)
        return False


def _stubs(tr) -> dict:
    """Methods that record nothing, called as the tracer's are."""
    return {"_open": lambda name, attrs, kind=None, start=None: 0,
            "begin": lambda name, kind=None, start=None, **attrs: 0,
            "end": lambda span_id, end=None: None,
            "annotate": lambda **attrs: None,
            "sync": lambda site: _StubScope(tr, "sync"),
            "span": lambda name, **attrs: _StubScope(tr, name),
            "copied": lambda device, nbytes, copies=1: None}


def cost(solve, zeros, seed) -> dict:
    """What the tracer costs the host an iteration, in microseconds.
    ``in_call``: inside calls of the solver, the time in the tracer's
    methods less the time in stubs that record nothing, called the same
    way (what the timing's own layer and cold caches cost either way), a
    plain call and one under the profiler.  ``replayed``: one iteration's
    recorded calls replayed in a loop (warm), without and under the
    profiler."""
    import torch
    from osnbench import run
    from repro_torch.obs import host
    tr = host.TRACER
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    state = {"ns": 0, "n": 0, "depth": 0, "calls": []}

    def timed(m, fn):
        def inner(*args, **kwargs):
            state["depth"] += 1
            t0 = time.perf_counter_ns()
            out = None
            try:
                out = fn(*args, **kwargs)
                return out
            finally:
                state["depth"] -= 1
                if state["depth"] == 0:
                    state["ns"] += time.perf_counter_ns() - t0
                    state["n"] += 1
                    state["calls"].append((m, args, kwargs, out))
        return inner

    def in_call(i, profiled, methods):
        for m in METHODS:       # instance attributes shadow the methods
            setattr(tr, m, timed(m, methods.get(m) or getattr(tr, m)))
        state.update(ns=0, n=0, calls=[])
        key = run.call_seed(seed, 2 + i)
        try:
            if profiled:
                with torch.profiler.profile(activities=acts):
                    solve(zeros, key)
            else:
                solve(zeros, key)
        finally:
            for m in METHODS:
                delattr(tr, m)
        return state["ns"], state["n"], list(state["calls"])

    out = {"in_call": {}, "replayed": {}}
    iters = int(solve.cfg.iters)
    for i, (mode, profiled) in enumerate((("off", False),
                                          ("profiler", True))):
        ns, n, calls = in_call(2 * i, profiled, {})
        stub_ns, stub_n, _ = in_call(2 * i + 1, profiled, _stubs(tr))
        out["in_call"][mode] = (ns - n * stub_ns / stub_n) / 1e3 / iters
        out["in_call"][mode + "_raw"] = ns / 1e3 / iters
        if mode == "off":
            recorded = calls
    # one middle iteration's calls, from its span's opening to its closing
    opens = [k for k, c in enumerate(recorded)
             if c[0] in ("_open", "begin") and c[1][0] == "iteration"]
    a = opens[len(opens) // 2]
    b = next(k for k, c in enumerate(recorded) if k > a and c[0] == "end"
             and c[1][0] == recorded[a][3])
    one, reps = recorded[a:b + 1], 2000
    out["replayed"]["off"] = _replay(host.HostTracer(), one, reps) / 1e3 / reps
    with torch.profiler.profile(activities=acts):
        out["replayed"]["profiler"] = _replay(
            host.HostTracer(), one, reps // 10) / 1e3 / (reps // 10)
    first = tr.appended
    solve(zeros, run.call_seed(seed, 6))
    spans = _call_spans(tr, first)
    per: dict = {}
    for s in spans:
        if s.iteration >= 0:
            per[s.name] = per.get(s.name, 0) + 1 / iters
    out.update(calls_per_iteration=len(one), spans_per_iteration=per)
    return out


def traced(cell, seed, seconds, device) -> dict:
    from osnbench import hostspans, run, spec
    seen = {}
    real = spec.metric_reader

    def reader(name, root=None):
        return _Capture(real(name, root), seen)

    spec.metric_reader = reader
    try:
        out = run.run_cell(cell, seed, seconds, True, device)
    finally:
        spec.metric_reader = real
    ctx = seen["ctx"]
    rows = hostspans.idle_by_leaf(ctx)
    sites = hostspans.idle_by_leaf(ctx, lambda s: s.name if s.name != "sync"
                                   else "sync:" + s.attrs["site"])
    idle = (ctx["window_s"] - ctx["busy_s"]) / ctx["iterations"] * 1e3
    prefixed = sum(1 for o in ctx["trace"]["ops"]
                   if o[0].startswith("repro_torch."))
    return {"correct": out["correct"], "metrics": out["metrics"],
            "device": out["device"], "iterations": ctx["iterations"],
            "idle_ms_by_leaf": rows, "idle_ms_by_leaf_and_site": sites,
            "idle_ms_rows_sum": sum(rows.values()) if rows else None,
            "idle_ms_span": idle, "program_ranges_as_device_ops": prefixed,
            "check": out["check"]}


class _Capture:
    """A metric reader that keeps the ``ctx`` it was given."""

    def __init__(self, mod, seen):
        self.mod, self.seen = mod, seen

    def read(self, ctx):
        self.seen["ctx"] = ctx
        return self.mod.read(ctx)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    import torch
    from osnbench import run, spec
    run.program()
    cell = spec.cell(args.workload)
    device = torch.device("cuda")
    report = {"cell": cell["name"], "card": torch.cuda.get_device_name(0),
              "torch": torch.__version__}
    failed = 0

    def step(name, fn, *a):
        # a step that fails is reported and the next one still runs
        nonlocal failed
        try:
            report[name] = fn(*a)
        except Exception:
            traceback.print_exc()
            report[name] = None
            failed += 1
        print(json.dumps({name: report[name]}), flush=True)

    solve, zeros = _solver(cell, args.seed, device)
    step("syncs", syncs, solve, zeros, args.seed)
    step("cost", cost, solve, zeros, args.seed)
    step("clock", clock, solve, zeros, args.seed)
    del solve, zeros
    torch.cuda.empty_cache()
    step("traced", traced, cell, args.seed, args.seconds, device)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(report, indent=1))
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
