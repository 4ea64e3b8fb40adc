"""The benchmark of ``repro_torch``, OverSketched Newton on one NVIDIA H100.

    python -m osnbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

One run is one cell of ``BENCHMARK.json``: its problem is drawn on the card
from ``--seed`` (its objective's ``generate``, ``objectives/``), one short
call of the solver warms every shape and kernel (set-up), then the window
drives whole calls of ``repro_torch.core.oversketched_newton``
(``use_kernels=True``, the default ``StragglerModel`` fleet and DAG
schedule) until ``--seconds`` have passed, closing at the end of the call
in progress.  With ``--trace 1`` the window
runs with the layer spans of ``spans.py`` (they count the work), then a
further span of calls, a third of the window long, runs under
``torch.profiler`` for the device's times, and the line carries the
per-layer metrics instead of the end-to-end ones.  At iterations drawn
from the seed the window's path is audited (``audit.py``).  After the
window every call's answer and every audit is judged against the float64
reference (``reference/judge.py``) and the limits of the cell's traffic
file.

The last line of standard output is one JSON object: ``correct``,
``attempted`` and ``failed`` calls, ``metrics``, ``device``, with
``--trace 1`` a ``breakdown``, and last ``check``, the numbers compared
beside their limits (also the last lines of standard error).  The run
fails, printing no result, without a CUDA device, and when a module of
JAX or of the JAX package ``repro`` is loaded once the window has closed.
"""
import time

T_START = time.time()   # set-up is timed from here, before the imports

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
TRACED_SHARE = 3    # a traced run profiles a span a third of the window
JUDGED = ("opt_gap", "fval_gap", "gnorm_gap", "grad_ratio", "grad_gap",
          "gram_gap", "dir_gap")


def forbidden_modules():
    """Top-level names of loaded modules that the port may not load,
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def call_seed(seed: int, i: int) -> int:
    """The solver's int32 seed for call ``i`` of the window (``-1``: the
    warm-up call)."""
    # datagen imports torch, which waits until main has set the threads
    from osnbench.datagen import derive
    return derive(seed, "call", i) % (1 << 31)


def program():
    """The port's modules: the package under ``src/`` of the checkout."""
    src = str(REPO / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    from repro_torch import core
    from repro_torch.core import straggler
    return core, straggler


class Solver:
    """Calls of the port's solver on the cell's problem."""

    def __init__(self, cell: dict, x, y, device):
        core, straggler = program()
        self.core, self.straggler, self.device = core, straggler, device
        cfg, tr, obj = cell["config"], cell["traffic"], cell["objective"]
        self.objective = obj.program(core, cfg)
        self.dim = int(cfg["d"]) * obj.rows_per_sample(cfg)
        self.data = core.Dataset(x=x, y=y)
        self.cfg = core.NewtonConfig(
            iters=int(tr["iters"]),
            sketch=core.OverSketchConfig(int(tr["sketch_dim"]),
                                         int(tr["block_size"]),
                                         float(tr["straggler_tolerance"])),
            solver=tr["solver"], sketch_family=tr["sketch_family"],
            gradient_policy=tr["gradient_policy"],
            coded_block_rows=int(tr["coded_block_rows"]), use_kernels=True)

    def attach_audit(self, audit) -> None:
        audit.install()

    def detach_audit(self, audit) -> None:
        audit.remove()

    def __call__(self, w0, seed: int, iters: int = 0):
        cfg = dataclasses.replace(self.cfg, seed=seed,
                                  iters=iters or self.cfg.iters)
        return self.core.oversketched_newton(
            self.objective, self.data, w0, cfg,
            model=self.straggler.StragglerModel(), device=self.device)


def window(solve, seed: int, seconds: float, warm: bool, w0, first: int = 0,
           audit=None):
    """Whole calls until ``seconds`` have passed, the first numbered
    ``first`` and starting at ``w0``: each call's answer (None for a call
    that raised), the window's seconds and the last iterate."""
    import torch
    zeros = torch.zeros_like(w0)
    w, calls = w0, []
    t0 = time.perf_counter()
    while True:
        start = w if warm else zeros
        i = first + len(calls)
        if audit is not None:
            audit.begin_call(i)
        try:
            res = solve(start, call_seed(seed, i))
        except Exception:       # a failed call is counted, the window goes on
            traceback.print_exc()
            calls.append(None)
        else:
            h = res.history
            calls.append({"w0": start, "w": res.w, "fval": h["fval"][-1],
                          "gnorm": h["gnorm"][-1], "wall_s": h["wall_s"]})
            if warm:
                w = res.w
        if time.perf_counter() - t0 >= seconds:
            break
    if audit is not None:
        audit.end_window()
    return calls, time.perf_counter() - t0, w


def end_to_end(name: str, run: dict):
    iters_s = [t for c in run["good"] for t in c["wall_s"]]
    if name == "setup_s":
        return run["setup_s"]
    if name == "iter_ms":
        return 1e3 * run["window_s"] / len(iters_s) if iters_s else None
    if name == "call_ms":
        good = run["good"]
        return 1e3 * run["window_s"] / len(good) if good else None
    if name == "iter_ms_p95":
        if len(iters_s) < 20:
            return None
        return 1e3 * statistics.quantiles(iters_s, n=20)[18]
    if name == "peak_mem_gib":
        return run["peak_bytes"] / 2 ** 30
    raise KeyError(f"no end-to-end metric {name!r}")


def run_cell(cell: dict, seed: int, seconds: float, trace_on: bool,
             device, t_start: float = T_START, make_solver=None) -> dict:
    """One run of ``cell`` on ``device``; returns the result line.
    ``make_solver(cell, x, y, device)`` builds what the window calls (the
    port's ``Solver`` unless a stand-in is given, as the control is)."""
    import torch
    from osnbench import audit, datagen, spans, spec, trace
    from osnbench.reference import judge

    cuda = torch.device(device).type == "cuda"
    cfg, tr = cell["config"], cell["traffic"]
    warm = tr["start"] == "warm"
    x, y = cell["objective"].generate(cfg, seed, device)
    before = datagen.fingerprint(x, y)
    solve = (make_solver or Solver)(cell, x, y, device)
    zeros = torch.zeros(solve.dim, dtype=torch.float32, device=device)
    solve(zeros, call_seed(seed, -1), iters=int(tr["warmup_iters"]))
    if trace_on and cuda:
        trace.warm_up(device)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    aud = audit.Audit(audit.plan(seed, tr), cell["family"])
    solve.attach_audit(aud)
    plain = spans.Recorder().install() if trace_on else None
    setup_s = time.time() - t_start
    try:
        calls, window_s, w = window(solve, seed, seconds, warm, zeros,
                                    audit=aud)
    finally:
        solve.detach_audit(aud)
        if plain is not None:
            plain.remove()
    traced, red, rec = [], None, None
    if trace_on:
        # The profiler's own host work slows the host's share of an
        # iteration, so the window above is timed without it and a span
        # after it is traced for the device's times.
        rec = spans.Recorder().install()
        prof = trace.start(cuda)
        try:
            traced, span_s, _ = window(solve, seed, seconds / TRACED_SHARE,
                                       warm, w, first=len(calls))
            if cuda:
                torch.cuda.synchronize()
        finally:
            prof.stop()
            rec.remove()
        red = trace.reduce(prof)
        del prof
    if cuda:
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    del solve
    good = [c for c in calls + traced if c is not None]
    if cuda:
        torch.cuda.empty_cache()

    verdict = judge.judge(cell, x, y, [c for c in good if judge.finite(c)])
    verdict.update(judge.audit(cell, x, y, aud.records, verdict["g0n"]))
    # The stated accuracy judges each call; a call outside it has failed.
    acc = tr["accuracy"]
    off = sum(1 for one in verdict["per_call"]
              if any(one[k] > limit for k, limit in acc.items()))
    attempted = len(calls) + len(traced)
    failed = attempted - len(verdict["per_call"]) + off
    check = {k: {"value": verdict[k], "limit": limit}
             for k, limit in {**acc, **tr["limits"]}.items()}
    same = datagen.fingerprint(x, y) == before
    check["inputs_changed"] = {"value": 0 if same else 1, "limit": 0}
    correct = bool(good) and failed == 0 and all(
        c["value"] is not None and c["value"] <= c["limit"]
        for c in check.values())

    metrics = {}
    if not trace_on:
        run = {"good": [c for c in calls if c is not None],
               "setup_s": setup_s, "window_s": window_s, "peak_bytes": peak}
        for m in cell["end_to_end"]:
            v = end_to_end(m["name"], run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell["chips"], "memory_peak_bytes": peak}
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": dev}
    if trace_on:
        busy_s = red["busy_ns"] / 1e9
        dev.update(busy_s=busy_s, window_s=span_s)
        t_good = [c for c in traced if c is not None]
        p_good = [c for c in calls if c is not None]
        ctx = {"config": cfg, "traffic": tr, "objective": cell["objective"],
               "trace": red, "recorder": rec,
               "calls": len(t_good), "window_s": span_s, "busy_s": busy_s,
               "iterations": sum(len(c["wall_s"]) for c in t_good),
               "plain": {"recorder": plain, "calls": len(p_good),
                         "window_s": window_s,
                         "iterations": sum(len(c["wall_s"])
                                           for c in p_good)}}
        for m in cell["per_layer"]:
            v = spec.metric_reader(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        out["breakdown"] = trace.breakdown(red)
    # the numbers that the cell reads but does not compare
    out["judged"] = {"calls": len(verdict["per_call"]),
                     "audits": verdict["audits"],
                     **{k: verdict[k] for k in JUDGED if k in verdict
                        and k not in check}}
    out["check"] = check
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from osnbench import spec
    cell = spec.cell(args.workload)
    # One process, few threads: the host's share of an iteration steadier.
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell["chips"]:
        print(f"osnbench: {cell['name']} needs {cell['chips']} CUDA "
              "device(s); none or too few are available", file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda"))
    bad = forbidden_modules()
    if bad:
        print(f"osnbench: forbidden modules loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    for key, c in out["check"].items():
        print(f"check {key} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
