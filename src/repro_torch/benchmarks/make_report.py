"""The dry-run and roofline tables from sweep JSONs, telemetry tables
from an obs JSONL export, or a diff of two bench files (the counterpart
of ``benchmarks/make_report.py``: the same text from the same inputs,
through the port's ``obs``).

  PYTHONPATH=src python -m repro_torch.benchmarks.make_report \
      --single sweep_single_pod.json --multi sweep_multi_pod.json
  PYTHONPATH=src python -m repro_torch.benchmarks.make_report \
      --trace artifacts/run.perfetto.jsonl
  PYTHONPATH=src python -m repro_torch.benchmarks.make_report \
      --diff base.json new.json
  PYTHONPATH=src python -m repro_torch.benchmarks.make_report \
      --console artifacts/run.perfetto.jsonl --bench bench.json \
      --out artifacts/console.html

The sweep JSONs are ``python -m repro_torch.launch.dryrun --all
--json-out`` (the reference's column names are kept: "HLO coll" is the
collective bytes per chip the dry run counts).  ``--trace`` takes the
JSONL sibling that ``benchmarks.run --trace-out`` writes next to the
Perfetto file: the per-phase time and dollar breakdown, a critical-path
and slack table per recorded iteration DAG, the alert log and detector
state when health monitors were attached, and the incidents.
``--console`` renders the same JSONL as the self-contained HTML fleet
console (``obs.console``), with ``--bench``'s row table.  ``--diff``
renders ``obs.diff``'s noise-aware row-by-row comparison.
"""
from __future__ import annotations

import argparse
import json


def _fmt_bytes(b):
    return f"{b/1e9:.2f}"


def dryrun_table(cells):
    lines = [
        "| arch | shape | mesh | status | args GB/chip | temps GB/chip | "
        "HLO coll GB/chip | collectives |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for c in cells:
        mesh = "x".join(str(v) for v in c.get("mesh", {}).values()) or "-"
        if "skipped" in c:
            lines.append(f"| {c['arch']} | {c['shape']} | {mesh} | SKIP "
                         f"({c['skipped'][:40]}...) | - | - | - | - |")
            continue
        if "error" in c:
            lines.append(f"| {c['arch']} | {c['shape']} | {mesh} | "
                         f"FAIL {c['error'][:60]} | - | - | - | - |")
            continue
        mem = c["memory"]
        colls = ",".join(f"{k.split('-')[-1][:3]}:{v/1e9:.1f}G"
                         for k, v in sorted(c.get("collectives", {}).items()))
        lines.append(
            f"| {c['arch']} | {c['shape']} | {mesh} | ok | "
            f"{_fmt_bytes(mem['argument_bytes'])} | "
            f"{_fmt_bytes(mem['temp_bytes'])} | "
            f"{_fmt_bytes(c['collective_bytes_per_chip'])} | {colls} |")
    return "\n".join(lines)


def roofline_table(cells):
    lines = [
        "| arch | shape | c (ms) | m (ms) | x (ms) | bound | "
        "MODEL_FLOPs/chip | useful/HLO | MFU bound |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for c in cells:
        if "skipped" in c or "error" in c or "analytic" not in c:
            continue
        a = c["analytic"]
        t = a["roofline_seconds"]
        lines.append(
            f"| {c['arch']} | {c['shape']} | {1e3*t['compute']:.2f} | "
            f"{1e3*t['memory']:.2f} | {1e3*t['collective']:.2f} | "
            f"{a['bottleneck']} | {c['model_flops_per_chip']:.2e} | "
            f"{c['useful_flop_fraction']:.2f} | {a['mfu_bound']:.3f} |")
    return "\n".join(lines)


def summarize(cells):
    ok = [c for c in cells if "skipped" not in c and "error" not in c]
    skip = [c for c in cells if "skipped" in c]
    fail = [c for c in cells if "error" in c]
    return ok, skip, fail


def trace_report(rows):
    """Per-phase breakdown + per-DAG critical-path tables from obs rows,
    plus alert/detector tables when health monitors were attached."""
    from repro_torch import obs
    out = ["### Per-phase breakdown\n", obs.phase_table(rows)]
    reports = obs.dag_reports_from_rows(rows)
    for i, rep in enumerate(reports):
        out.append(f"\n### Iteration DAG {i}: critical path\n")
        out.append(obs.critical_path_table(rep))
    if not reports:
        out.append("\n(no DAG-dispatched phases with recorded deps)")
    health = next((r for r in rows if r.get("kind") == "health"), None)
    if health is not None:
        alerts = obs.alerts_from_rows(rows)
        out.append(f"\n### Health monitors: {len(alerts)} alert(s)\n")
        if alerts:
            out.append(obs.alert_table(rows))
            out.append("")
        out.append(obs.detector_table(rows))
    incidents = [r for r in rows if r.get("kind") == "incident"]
    if incidents:
        out.append(f"\n### Incidents: {len(incidents)} attributed\n")
        out.append(obs.incident_table(incidents))
    return "\n".join(out)


def diff_report(base_path, new_path):
    from repro_torch.obs import diff as obs_diff
    with open(base_path) as f:
        base = json.load(f)
    with open(new_path) as f:
        new = json.load(f)
    rep = obs_diff.diff_bench(base, new)
    return "### Bench diff: " + rep.summary() + "\n\n" + rep.table()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--single", type=str, default=None)
    ap.add_argument("--multi", type=str, default=None)
    ap.add_argument("--trace", type=str, default=None,
                    help="obs JSONL export (from benchmarks.run --trace-out)")
    ap.add_argument("--diff", type=str, nargs=2, default=None,
                    metavar=("BASE", "NEW"),
                    help="render a noise-aware diff of two BENCH_*.json")
    ap.add_argument("--console", type=str, default=None,
                    help="obs JSONL export -> self-contained HTML fleet "
                         "console (span timeline, incidents, SLO burn)")
    ap.add_argument("--bench", type=str, default=None,
                    help="BENCH_*.json whose rows the console tabulates "
                         "(only with --console)")
    ap.add_argument("--out", type=str, default=None)
    args = ap.parse_args(argv)
    modes = sum(bool(m) for m in (args.single, args.trace, args.diff,
                                  args.console))
    if modes != 1:
        ap.error("pass exactly one of --single / --trace / --diff / "
                 "--console")

    if args.console:
        from repro_torch import obs
        rows = obs.load_jsonl(args.console)
        bench_rows = None
        if args.bench:
            with open(args.bench) as f:
                bench_rows = json.load(f).get("rows", [])
        text = obs.render_console(rows, bench=bench_rows,
                                  title="fleet console")
        if args.out:
            with open(args.out, "w") as f:
                f.write(text)
        else:
            print(text)
        return 0

    if args.trace or args.diff:
        if args.trace:
            from repro_torch import obs
            text = trace_report(obs.load_jsonl(args.trace))
        else:
            text = diff_report(*args.diff)
        if args.out:
            with open(args.out, "w") as f:
                f.write(text)
        else:
            print(text)
        return 0

    with open(args.single) as f:
        single = json.load(f)
    out = []
    ok, skip, fail = summarize(single)
    out.append(f"### Single-pod (16x16): {len(ok)} ok, {len(skip)} skipped "
               f"(documented), {len(fail)} failed\n")
    out.append(dryrun_table(single))
    out.append("\n### Roofline (single-pod, analytic terms)\n")
    out.append(roofline_table(single))
    if args.multi:
        with open(args.multi) as f:
            multi = json.load(f)
        ok, skip, fail = summarize(multi)
        out.append(f"\n### Multi-pod (2x16x16): {len(ok)} ok, {len(skip)} "
                   f"skipped, {len(fail)} failed\n")
        out.append(dryrun_table(multi))
    text = "\n".join(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    else:
        print(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
