"""Self-contained static HTML fleet console.

One run's exported telemetry rows (``repro_torch.obs.export.telemetry_rows`` /
a loaded JSONL file) render into a single HTML file with **zero external
dependencies** — inline CSS, hand-built SVG, no JavaScript required, no
fonts or CDNs — so CI can archive it as a build artifact and anyone can
open it from disk.  Sections:

  - header: run extent, dollars, span/alert/incident counts;
  - an SVG **span timeline**: greedily lane-packed phase/charge spans,
    alert ticks, and translucent incident bands, every phase anchored as
    ``id="span-<id>"`` so incident evidence can deep-link into it;
  - **incident narratives** (``repro_torch.obs.incident``): ranked cause, the
    full hypothesis table, and the evidence list with anchor links back
    to the supporting spans;
  - per-tenant **SLO burn charts** (``repro_torch.obs.slo``): budget remaining
    and fast/slow burn rates over simulated time;
  - the familiar phase / alert / detector / incident summary tables, and
    the benchmark row table when a BENCH payload is passed.

Rendering is a pure function of the rows: no wall-clock timestamps, no
randomness (colors come from a deterministic string hash), so the same
telemetry yields byte-identical HTML.
"""
from __future__ import annotations

import html
import zlib
from typing import List, Optional, Sequence

from repro_torch.obs.export import (alert_table, bench_rows_table, detector_table,
                              phase_table)
from repro_torch.obs.incident import incident_table

_CSS = """
body { font-family: -apple-system, 'Segoe UI', Roboto, sans-serif;
       margin: 2em auto; max-width: 1000px; color: #1c2733;
       background: #fafbfc; }
h1 { font-size: 1.4em; border-bottom: 2px solid #d0d7de; }
h2 { font-size: 1.1em; margin-top: 2em; color: #30445c; }
pre { background: #f2f4f7; border: 1px solid #d0d7de; border-radius: 6px;
      padding: 0.8em; overflow-x: auto; font-size: 12px; }
svg { background: #fff; border: 1px solid #d0d7de; border-radius: 6px; }
.inc { border-left: 4px solid #c0392b; background: #fff;
       border-radius: 4px; padding: 0.6em 1em; margin: 0.8em 0;
       box-shadow: 0 1px 2px rgba(27,31,35,.08); }
.inc h3 { margin: 0 0 0.3em 0; font-size: 1em; }
.inc ul { margin: 0.3em 0; padding-left: 1.4em; font-size: 0.85em; }
.kpi { display: inline-block; background: #fff; border: 1px solid #d0d7de;
       border-radius: 6px; padding: 0.4em 0.9em; margin-right: 0.6em;
       font-size: 0.9em; }
.kpi b { display: block; font-size: 1.2em; }
a { color: #0969da; text-decoration: none; }
"""

_PALETTE = ("#4c78a8", "#f58518", "#54a24b", "#b279a2", "#e45756",
            "#72b7b2", "#eeca3b", "#9d755d", "#79706e", "#d67195")


def _esc(s) -> str:
    return html.escape(str(s), quote=True)


def _color(name: str) -> str:
    # crc32, not hash(): str hashing is salted per process and the console
    # must be byte-stable across runs.
    return _PALETTE[zlib.crc32(name.encode()) % len(_PALETTE)]


def _lane_pack(spans: List[dict]) -> List[int]:
    """Greedy first-fit lanes for possibly-overlapping intervals."""
    lanes: List[float] = []
    out = []
    for r in sorted(range(len(spans)), key=lambda i: (spans[i]["start"],
                                                      spans[i]["end"])):
        s = spans[r]
        for li, free_at in enumerate(lanes):
            if s["start"] >= free_at - 1e-12:
                lanes[li] = s["end"]
                break
        else:
            li = len(lanes)
            lanes.append(s["end"])
        out.append((r, li))
    lane_of = [0] * len(spans)
    for r, li in out:
        lane_of[r] = li
    return lane_of


def _timeline_svg(rows: Sequence[dict], width: int = 960) -> str:
    phases = [r for r in rows if r.get("kind") == "span"
              and r.get("span_kind") in ("phase", "charge")]
    alerts = [r for r in rows if r.get("kind") == "alert"]
    incidents = [r for r in rows if r.get("kind") == "incident"]
    if not phases:
        return "<p>(no phase spans recorded)</p>"
    t0 = min(r["start"] for r in phases)
    t1 = max(r["end"] for r in phases)
    extent = max(t1 - t0, 1e-9)
    lane_of = _lane_pack(phases)
    n_lanes = max(lane_of) + 1
    row_h, pad_top = 18, 24
    height = pad_top + n_lanes * row_h + 26

    def x(t: float) -> float:
        return round(10 + (t - t0) / extent * (width - 20), 2)

    parts = [f'<svg width="{width}" height="{height}" '
             'xmlns="http://www.w3.org/2000/svg" font-size="10">']
    # incident bands first, behind everything
    for inc in incidents:
        bx0, bx1 = x(inc["t_start"]), x(inc["t_end"])
        parts.append(
            f'<rect id="incident-band-{inc["id"]}" x="{bx0}" y="{pad_top}" '
            f'width="{max(bx1 - bx0, 2.0)}" '
            f'height="{n_lanes * row_h}" fill="#e45756" opacity="0.15">'
            f'<title>incident {inc["id"]}: {_esc(inc["cause"])}</title>'
            '</rect>')
    for r, lane in zip(phases, lane_of):
        px0, px1 = x(r["start"]), x(r["end"])
        y = pad_top + lane * row_h
        name = r["name"]
        dollars = float((r.get("attrs") or {}).get("dollars", 0.0))
        parts.append(
            f'<rect id="span-{r.get("id", 0)}" x="{px0}" y="{y + 2}" '
            f'width="{max(px1 - px0, 1.5)}" height="{row_h - 5}" '
            f'rx="2" fill="{_color(name.split("/")[-1].split(":")[0])}">'
            f'<title>{_esc(name)} [{r["start"]:.3f}s – {r["end"]:.3f}s] '
            f'${dollars:.6f}</title></rect>')
        if px1 - px0 > 7 * len(name) * 0.45:
            parts.append(f'<text x="{px0 + 3}" y="{y + row_h - 6}" '
                         f'fill="#fff">{_esc(name)}</text>')
    tick_y = pad_top + n_lanes * row_h
    for a in alerts:
        ax = x(a["t"])
        parts.append(
            f'<path d="M{ax} {tick_y} l-4 8 l8 0 z" fill="#c0392b">'
            f'<title>alert {_esc(a["metric"])} @ {a["t"]:.3f}s '
            f'({_esc(a["detector"])})</title></path>')
    for frac in (0.0, 0.25, 0.5, 0.75, 1.0):
        t = t0 + frac * extent
        parts.append(f'<text x="{x(t)}" y="14" fill="#666" '
                     f'text-anchor="middle">{t:.2f}s</text>')
    parts.append(f'<text x="10" y="{tick_y + 22}" fill="#666">'
                 f'{len(phases)} phase spans, {len(alerts)} alerts, '
                 f'{len(incidents)} incidents</text>')
    parts.append("</svg>")
    return "".join(parts)


def _burn_chart_svg(slo_row: dict, width: int = 460,
                    height: int = 130) -> str:
    series = slo_row.get("series") or []
    if not series:
        return "<p>(no jobs recorded)</p>"
    ts = [p[0] for p in series]
    t0, t1 = min(ts), max(ts)
    extent = max(t1 - t0, 1e-9)
    burns = [max(p[2], p[3]) for p in series]
    ymax = max(1.5, max(burns), 1.0)

    def x(t):
        return round(36 + (t - t0) / extent * (width - 46), 2)

    def y_budget(v):   # budget axis: [-0.2, 1.05] -> pixels
        v = max(-0.2, min(1.05, v))
        return round(10 + (1.05 - v) / 1.25 * (height - 30), 2)

    def y_burn(v):     # burn axis: [0, ymax]
        v = max(0.0, min(ymax, v))
        return round(10 + (ymax - v) / ymax * (height - 30), 2)

    def poly(pts, color, dash=""):
        path = " ".join(f"{px},{py}" for px, py in pts)
        d = f' stroke-dasharray="{dash}"' if dash else ""
        return (f'<polyline points="{path}" fill="none" '
                f'stroke="{color}" stroke-width="1.5"{d}/>')

    parts = [f'<svg width="{width}" height="{height}" '
             'xmlns="http://www.w3.org/2000/svg" font-size="9">']
    zero = y_budget(0.0)
    parts.append(f'<line x1="36" y1="{zero}" x2="{width - 8}" y2="{zero}" '
                 'stroke="#d0d7de"/>')
    parts.append(poly([(x(p[0]), y_budget(p[1])) for p in series],
                      "#2e7d32"))
    parts.append(poly([(x(p[0]), y_burn(p[2])) for p in series],
                      "#c0392b", dash="4 2"))
    parts.append(poly([(x(p[0]), y_burn(p[3])) for p in series],
                      "#f58518", dash="2 2"))
    parts.append(f'<text x="4" y="{y_budget(1.0) + 3}" '
                 'fill="#2e7d32">1.0</text>')
    parts.append(f'<text x="4" y="{zero + 3}" fill="#666">0.0</text>')
    parts.append(
        f'<text x="36" y="{height - 4}" fill="#666">'
        f'budget (green, left) · burn fast/slow (red/orange, right, '
        f'max {ymax:.1f}x) · t ∈ [{t0:.2f}s, {t1:.2f}s]</text>')
    parts.append("</svg>")
    return "".join(parts)


def _incident_html(inc: dict) -> str:
    hyp = ", ".join(f"{_esc(c)}={s:.2f}" for c, s in inc["hypotheses"])
    ev_items = []
    for e in inc["evidence"]:
        link = (f' <a href="#span-{e["span"]}">span {e["span"]}</a>'
                if e.get("span") else "")
        ev_items.append(f'<li>[{e["kind"]}, w={e["weight"]:.2f}] '
                        f'{_esc(e["detail"])}{link}</li>')
    blamed = []
    if inc.get("tenant"):
        blamed.append(f'tenant <b>{_esc(inc["tenant"])}</b>')
    if inc.get("phase"):
        cp = inc.get("on_critical_path")
        tag = "" if cp is None else (" (on critical path)" if cp
                                     else " (off critical path)")
        blamed.append(f'phase <b>{_esc(inc["phase"])}</b>{tag}')
    blame = " — blames " + ", ".join(blamed) if blamed else ""
    return (
        f'<div class="inc" id="incident-{inc["id"]}">'
        f'<h3><a href="#incident-band-{inc["id"]}">#{inc["id"]}</a> '
        f'{_esc(inc["cause"])} (score {inc["score"]:.2f}) '
        f'[{inc["t_start"]:.3f}s – {inc["t_end"]:.3f}s]</h3>'
        f'<p>{inc["n_alerts"]} alert(s) on '
        f'{_esc(", ".join(inc["alert_metrics"]))}{blame}. '
        f'Impact: {inc["impact_seconds"]:.3f}s, '
        f'${inc["impact_dollars"]:.6f}. Hypotheses: {hyp}.</p>'
        f'<ul>{"".join(ev_items)}</ul></div>')


def render(rows: Sequence[dict], *, bench: Optional[Sequence[dict]] = None,
           title: str = "fleet console") -> str:
    """Render telemetry rows (plus an optional BENCH payload's ``rows``
    list) into one self-contained HTML page.  Pure function of its
    inputs: byte-identical output for identical rows."""
    rows = list(rows)
    spans = [r for r in rows if r.get("kind") == "span"]
    phases = [r for r in spans if r.get("span_kind") in ("phase", "charge")]
    alerts = [r for r in rows if r.get("kind") == "alert"]
    incidents = [r for r in rows if r.get("kind") == "incident"]
    slo_rows = [r for r in rows if r.get("kind") == "slo"]
    extent = (max(r["end"] for r in phases)
              - min(r["start"] for r in phases)) if phases else 0.0
    dollars = sum(float((r.get("attrs") or {}).get("dollars", 0.0))
                  for r in phases)

    kpis = [("span rows", str(len(spans))),
            ("run extent", f"{extent:.3f}s"),
            ("phase dollars", f"${dollars:.6f}"),
            ("alerts", str(len(alerts))),
            ("incidents", str(len(incidents))),
            ("tenants w/ SLO", str(len(slo_rows)))]
    kpi_html = "".join(f'<span class="kpi"><b>{_esc(v)}</b>{_esc(k)}</span>'
                       for k, v in kpis)

    body = [f"<h1>{_esc(title)}</h1>", f"<p>{kpi_html}</p>",
            "<h2>Timeline</h2>", _timeline_svg(rows)]

    body.append("<h2>Incidents</h2>")
    if incidents:
        body.extend(_incident_html(inc) for inc in incidents)
        body.append("<pre>" + _esc(incident_table(incidents)) + "</pre>")
    else:
        body.append("<p>No incidents attributed.</p>")

    if slo_rows:
        body.append("<h2>Per-tenant SLO burn</h2>")
        for s in sorted(slo_rows, key=lambda r: r["tenant"]):
            shed = (' — <b style="color:#c0392b">budget exhausted</b>'
                    if s["budget_remaining"] <= 0 else "")
            body.append(
                f'<p><b>{_esc(s["tenant"])}</b>: {s["jobs"]} jobs, '
                f'{s["bad_jobs"]} bad, budget remaining '
                f'{s["budget_remaining"]:.3f}, burn fast/slow '
                f'{s["burn_fast"]:.2f}x / {s["burn_slow"]:.2f}x, '
                f'${s["dollars"]:.6f} spent{shed}</p>')
            body.append(_burn_chart_svg(s))

    if phases:
        body.append("<h2>Phases</h2>")
        body.append("<pre>" + _esc(phase_table(rows)) + "</pre>")
    if alerts:
        body.append("<h2>Alerts</h2>")
        body.append("<pre>" + _esc(alert_table(rows)) + "</pre>")
        body.append("<h2>Detectors</h2>")
        body.append("<pre>" + _esc(detector_table(rows)) + "</pre>")
    if bench:
        body.append("<h2>Benchmark rows</h2>")
        body.append("<pre>" + _esc(bench_rows_table(bench)) + "</pre>")

    return ("<!DOCTYPE html>\n<html><head><meta charset=\"utf-8\">"
            f"<title>{_esc(title)}</title><style>{_CSS}</style></head>"
            "<body>\n" + "\n".join(body) + "\n</body></html>\n")


def write_console(path, rows: Sequence[dict], *,
                  bench: Optional[Sequence[dict]] = None,
                  title: str = "fleet console") -> None:
    with open(path, "w") as f:
        f.write(render(rows, bench=bench, title=title))
