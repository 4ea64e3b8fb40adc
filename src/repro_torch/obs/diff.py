"""Noise-aware regression diff over BENCH payloads / store snapshots.

``BENCH_*.json`` rows carry two kinds of numbers with very different
noise profiles:

  - ``us`` (wall-clock microseconds) — noisy on shared CI runners, so the
    gate uses a generous relative threshold plus an absolute floor
    (a 40 us -> 60 us jitter on a trivial row is not a regression).
  - simulated metrics in ``derived`` (``sim_s``, ``usd``, ``gb_s``) —
    deterministic given the same jax version, so drift there is a real
    behaviour change and the threshold is tight.

``diff_bench`` matches rows by name, classifies each as ``ok`` /
``regression`` / ``improvement`` / ``added`` / ``removed``, and returns a
``DiffReport`` with the table/summary renderers ``make_report --diff``
uses.  Per-row threshold overrides let known-noisy rows (prefix match)
carry their own tolerance.

The CLI is the CI regression gate::

    python -m repro_torch.obs.diff BASE.json NEW.json [--gate]
    python -m repro_torch.obs.diff --store artifacts/bench_history.jsonl \\
        --name kernels_bench [--gate]

Without ``--gate`` it always exits 0 (report-only — how the gate first
lands in CI); with ``--gate`` it exits 2 when any material regression
survives the thresholds, which is what flips the bench trajectory from
"archived" to "guarded".
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import Dict, List, Optional, Sequence, Tuple

#: Wall-clock (us) default thresholds: generous, CI runners are shared.
DEFAULT_REL_TOL = 0.35
DEFAULT_ABS_FLOOR_US = 50.0
#: Deterministic simulated metrics ride in ``derived``; tight threshold.
SIM_KEYS = ("sim_s", "usd", "gb_s", "seq_s")
DEFAULT_SIM_REL_TOL = 0.02


def parse_derived(derived: str) -> Dict[str, float]:
    """Numeric k=v pairs out of a ``derived`` blob; non-numeric skipped."""
    out: Dict[str, float] = {}
    for part in str(derived or "").split(";"):
        if "=" not in part:
            continue
        k, v = part.split("=", 1)
        try:
            out[k] = float(v)
        except ValueError:
            continue
    return out


@dataclasses.dataclass
class RowDiff:
    """One matched row's verdict."""

    name: str
    status: str            # ok | regression | improvement | added | removed
    base_us: float = float("nan")
    new_us: float = float("nan")
    ratio: float = float("nan")          # new/base wall-clock
    detail: str = ""                     # which threshold fired, or ""

    def as_row(self) -> Tuple[object, ...]:
        return (self.name, self.status, self.base_us, self.new_us,
                self.ratio, self.detail)


@dataclasses.dataclass
class DiffReport:
    rows: List[RowDiff]
    base_meta: dict
    new_meta: dict

    @property
    def regressions(self) -> List[RowDiff]:
        return [r for r in self.rows if r.status == "regression"]

    @property
    def improvements(self) -> List[RowDiff]:
        return [r for r in self.rows if r.status == "improvement"]

    def table(self, only_changed: bool = False) -> str:
        from repro_torch.obs.export import format_table
        rows = [r for r in self.rows
                if not only_changed or r.status != "ok"]
        return format_table(("row", "status", "base_us", "new_us", "ratio",
                             "detail"), [r.as_row() for r in rows])

    def summary(self) -> str:
        n = {"ok": 0, "regression": 0, "improvement": 0, "added": 0,
             "removed": 0}
        for r in self.rows:
            n[r.status] += 1
        ident = " vs ".join(
            f"{m.get('git_sha', '?')}/{m.get('backend', '?')}"
            for m in (self.base_meta, self.new_meta))
        return (f"diff {ident}: {n['regression']} regression(s), "
                f"{n['improvement']} improvement(s), {n['ok']} ok, "
                f"{n['added']} added, {n['removed']} removed")

    def to_json(self) -> dict:
        return {"summary": self.summary(),
                "regressions": [r.name for r in self.regressions],
                "rows": [dataclasses.asdict(r) for r in self.rows]}


def _row_tol(name: str, rel_tol: float,
             per_row: Optional[Dict[str, float]]) -> float:
    """Longest-prefix per-row override, else the global tolerance."""
    if per_row:
        best = None
        for prefix, tol in per_row.items():
            if name.startswith(prefix) and \
                    (best is None or len(prefix) > len(best[0])):
                best = (prefix, tol)
        if best is not None:
            return best[1]
    return rel_tol


def diff_rows(base_rows: Sequence[dict], new_rows: Sequence[dict], *,
              rel_tol: float = DEFAULT_REL_TOL,
              abs_floor_us: float = DEFAULT_ABS_FLOOR_US,
              sim_rel_tol: float = DEFAULT_SIM_REL_TOL,
              per_row: Optional[Dict[str, float]] = None) -> List[RowDiff]:
    """Match rows by name and classify; see module docstring for the
    noise model.  Smaller is better for ``us`` and every SIM_KEY."""
    base = {r["name"]: r for r in base_rows}
    new = {r["name"]: r for r in new_rows}
    out: List[RowDiff] = []
    for name in base:
        if name not in new:
            out.append(RowDiff(name=name, status="removed",
                               base_us=float(base[name]["us"])))
    for name, nr in new.items():
        if name not in base:
            out.append(RowDiff(name=name, status="added",
                               new_us=float(nr["us"])))
            continue
        br = base[name]
        b_us, n_us = float(br["us"]), float(nr["us"])
        tol = _row_tol(name, rel_tol, per_row)
        ratio = n_us / b_us if b_us else float("inf")
        status, detail = "ok", ""
        if n_us > b_us * (1.0 + tol) and n_us - b_us > abs_floor_us:
            status = "regression"
            detail = f"us +{100 * (ratio - 1):.0f}% > {100 * tol:.0f}%"
        elif n_us < b_us * (1.0 - tol) and b_us - n_us > abs_floor_us:
            status, detail = "improvement", f"us {100 * (ratio - 1):.0f}%"
        # Deterministic simulated metrics: tight, overrides wall-clock ok.
        bd, nd = parse_derived(br.get("derived", "")), \
            parse_derived(nr.get("derived", ""))
        for key in SIM_KEYS:
            if key not in bd or key not in nd or bd[key] == 0:
                continue
            drift = nd[key] / bd[key] - 1.0
            if drift > sim_rel_tol:
                status = "regression"
                detail = (detail + "; " if detail else "") + \
                    f"{key} +{100 * drift:.1f}% > {100 * sim_rel_tol:.1f}%"
            elif drift < -sim_rel_tol and status == "ok":
                status = "improvement"
                detail = f"{key} {100 * drift:.1f}%"
        out.append(RowDiff(name=name, status=status, base_us=b_us,
                           new_us=n_us, ratio=ratio, detail=detail))
    out.sort(key=lambda r: ({"regression": 0, "improvement": 1, "added": 2,
                             "removed": 3, "ok": 4}[r.status], r.name))
    return out


def diff_bench(base_payload: dict, new_payload: dict, **kw) -> DiffReport:
    """Diff two BENCH payloads (or store ``bench`` records — both carry
    ``rows`` and key/meta fields)."""

    def meta(p):
        return p.get("meta") or {k: p.get(k) for k in
                                 ("git_sha", "backend", "jax_version",
                                  "config_hash")}
    return DiffReport(rows=diff_rows(base_payload.get("rows", []),
                                     new_payload.get("rows", []), **kw),
                      base_meta=meta(base_payload),
                      new_meta=meta(new_payload))


def diff_store(store_path, name: str, **kw) -> Optional[DiffReport]:
    """Diff the last two store snapshots for ``name`` (None if < 2)."""
    from repro_torch.obs.store import Store
    pair = Store(store_path).last_two(kind="bench", name=name)
    if pair is None:
        return None
    return diff_bench(pair[0], pair[1], **kw)


# ----------------------------------------------------------------------- CLI
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.obs.diff",
        description="noise-aware BENCH regression diff / CI gate")
    ap.add_argument("base", nargs="?", help="base BENCH_*.json")
    ap.add_argument("new", nargs="?", help="new BENCH_*.json")
    ap.add_argument("--store", default=None,
                    help="diff the last two store records instead of files")
    ap.add_argument("--name", default=None,
                    help="bench module name inside --store")
    ap.add_argument("--rel-tol", type=float, default=DEFAULT_REL_TOL)
    ap.add_argument("--abs-floor-us", type=float,
                    default=DEFAULT_ABS_FLOOR_US)
    ap.add_argument("--sim-rel-tol", type=float, default=DEFAULT_SIM_REL_TOL)
    ap.add_argument("--gate", action="store_true",
                    help="exit 2 on material regressions (default: report "
                         "only)")
    ap.add_argument("--all-rows", action="store_true",
                    help="print every row, not just changed ones")
    ap.add_argument("--json", dest="json_out", default=None,
                    help="also write the machine-readable verdict here")
    args = ap.parse_args(argv)

    kw = dict(rel_tol=args.rel_tol, abs_floor_us=args.abs_floor_us,
              sim_rel_tol=args.sim_rel_tol)
    if args.store is not None:
        if args.name is None:
            ap.error("--store needs --name")
        report = diff_store(args.store, args.name, **kw)
        if report is None:
            print(f"store has < 2 '{args.name}' records — nothing to diff "
                  "(gate passes vacuously)")
            return 0
    else:
        if not (args.base and args.new):
            ap.error("pass BASE NEW files or --store/--name")
        with open(args.base) as f:
            base = json.load(f)
        with open(args.new) as f:
            new = json.load(f)
        report = diff_bench(base, new, **kw)

    print(report.summary())
    print(report.table(only_changed=not args.all_rows))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(report.to_json(), f, indent=1)
    if args.gate and report.regressions:
        print(f"GATE FAILED: {len(report.regressions)} material "
              "regression(s)", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
