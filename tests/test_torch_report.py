"""The port's report, roofline and kernels bench against the JAX
package's.

``make_report``: the same text as the reference's
``benchmarks/make_report.py`` on the same inputs, in every mode: a sweep
JSON of dry-run cells (ok, skipped, failed; single and multi pod), the
committed trace JSONL fixtures (phases, DAGs, incidents), the committed
bench pair (``--diff``) and the HTML console.  The roofline's rows and
the sketch -> Gram intensities (arithmetic, checked by hand), and the
kernels bench's CPU rows (plain versions only, every field).
"""
import json
import os

import pytest

from benchmarks import make_report as jreport
from repro_torch.benchmarks import kernels_bench, make_report, roofline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures")


def _cell(arch, shape, mesh, scale):
    return {
        "arch": arch, "shape": shape, "mesh": mesh,
        "memory": {"argument_bytes": 3.1e9 * scale, "output_bytes": 3e9,
                   "temp_bytes": 1.19e10 * scale, "alias_bytes": 3e9},
        "collective_bytes_per_chip": 3.01e11 * scale,
        "collectives": {"all-gather": 2.2e11 * scale,
                        "reduce-scatter": 8.1e10, "all-reduce": 4.5e7},
        "model_flops_per_chip": 1.08e14 * scale,
        "useful_flop_fraction": 0.437 * scale,
        "analytic": {"roofline_seconds": {"compute": 0.15328 * scale,
                                          "memory": 0.00267,
                                          "collective": 0.32457},
                     "bottleneck": "collective", "mfu_bound": 0.338}}


@pytest.fixture(scope="module")
def sweeps(tmp_path_factory):
    d = tmp_path_factory.mktemp("sweep")
    single = [_cell("qwen3-4b", "train_4k", {"data": 16, "model": 16}, 1.0),
              _cell("mamba2-780m", "decode_32k", {"data": 16, "model": 16},
                    0.37),
              {"arch": "qwen3-32b", "shape": "long_500k",
               "skipped": "full-attention architecture: 500k decode needs "
                          "sub-quadratic attention (skip per assignment)"},
              {"arch": "gemma3-27b", "shape": "prefill_32k",
               "error": "RuntimeError: something in the cell failed"}]
    multi = [_cell("qwen3-4b", "train_4k",
                   {"pod": 2, "data": 16, "model": 16}, 0.5)]
    paths = {}
    for name, cells in (("single", single), ("multi", multi)):
        paths[name] = str(d / f"{name}.json")
        with open(paths[name], "w") as f:
            json.dump(cells, f)
    return paths


def _text(module, argv, capsys):
    assert module.main(argv) == 0
    return capsys.readouterr().out


def test_dryrun_and_roofline_tables_equal(sweeps, capsys):
    argv = ["--single", sweeps["single"], "--multi", sweeps["multi"]]
    got = _text(make_report, argv, capsys)
    assert got == _text(jreport, argv, capsys)
    assert "SKIP" in got and "FAIL" in got and "Multi-pod" in got


@pytest.mark.parametrize("fixture", ["dag_trace_golden.jsonl",
                                     "incident_golden.jsonl",
                                     "chaos_trace_golden.jsonl",
                                     "fleet_trace_golden.jsonl"])
def test_trace_report_equal(fixture, capsys):
    argv = ["--trace", os.path.join(FIXTURES, fixture)]
    assert _text(make_report, argv, capsys) == _text(jreport, argv, capsys)


def test_diff_and_console_equal(capsys, tmp_path):
    base = os.path.join(FIXTURES, "bench_base_golden.json")
    head = os.path.join(FIXTURES, "bench_head_golden.json")
    argv = ["--diff", base, head]
    assert _text(make_report, argv, capsys) == _text(jreport, argv, capsys)
    outs = []
    for module, name in ((make_report, "t.html"), (jreport, "j.html")):
        assert module.main(["--console", os.path.join(
            FIXTURES, "incident_golden.jsonl"), "--bench", head, "--out",
            str(tmp_path / name)]) == 0
        outs.append((tmp_path / name).read_text())
    assert outs[0] == outs[1]


def test_sketch_gram_intensity_by_hand():
    """K = 4 blocks of b = 2 over a (10, 3) A, 3 live."""
    cell = roofline.sketch_gram_intensity(4, 10, 3, 2, 3)
    gram = 3 * 2 * 3 * 4
    assert cell["fused"] == (2 * 3 * 10 * 3 + gram,
                             4 * 30 + 4 * 80 + 2 * 4 * 18 + 4 * 9 + 4)
    assert cell["unfused"] == (2 * 4 * 10 * 3 + gram,
                               4 * 30 + 4 * 80 + 4 * 24 + 4 * 18 + 4 * 9
                               + 4)


def test_roofline_rows(monkeypatch):
    """The quick rows: the reduced dry-run cell (stubbed here; the dry-run
    tests run it), both hot-path pairs, and the analytic terms of three
    architectures' supported cells over the H100's denominators."""
    monkeypatch.setattr(roofline, "dryrun_cell", lambda: {
        "roofline_seconds": {"compute": 1e-3, "memory": 2e-3,
                             "collective": 5e-3,
                             "memory_unfused_upper_bound": 0.3},
        "bottleneck": "collective",
        "analytic": {"flops_ratio": 2.0, "counted_over_expected": 0.99}})
    rows = roofline.run(quick=True)
    names = [r["name"] for r in rows]
    assert names[0] == "roofline_dryrun_qwen3-4b_train_4k_smoke_4x2"
    # the unfused bytes' upper bound names no bottleneck and sets no time
    assert rows[0]["us"] == pytest.approx(5e3)
    assert "bound=collective" in rows[0]["derived"]
    assert "m_unfused_upper_ms=300.000" in rows[0]["derived"]
    assert "roofline_sketch_gram_fused" in names
    assert "roofline_qwen3-4b_train_4k" in names
    assert "roofline_qwen3-4b_long_500k" not in names      # skipped cell
    assert "roofline_mamba2-780m_long_500k" in names
    assert len(names) == 1 + 4 + 3 + 3 + 4


def test_kernels_bench_cpu_rows(tmp_path):
    """On the CPU: one plain row per kernel, every field, the JSON at
    --out; it refuses the reference's BENCH file before it runs."""
    out = tmp_path / "kb.json"
    assert kernels_bench.main(["--device", "cpu", "--out", str(out)]) == 0
    rows = json.loads(out.read_text())["rows"]
    assert [r["kernel"] for r in rows] == list(kernels_bench.KERNELS)
    for r in rows:
        assert r["path"] == "plain" and r["device"] == "cpu"
        assert r["ms"] > 0 and r["shape"]
    assert [r["table_row"] for r in rows] == [1, 2, 3, 4, 5, 6, 7, 8, None,
                                              None, None]
    bench = os.path.join(REPO, "BENCH_kernels.json")
    before = open(bench, "rb").read() if os.path.exists(bench) else None
    with pytest.raises(SystemExit):
        kernels_bench.main(["--device", "cpu", "--out", bench])
    assert (open(bench, "rb").read() if os.path.exists(bench)
            else None) == before


def test_kernels_bench_rows_of_timings():
    """``bench_rows``, the format the smoke writes from its own timings:
    a kernel's cuda, plain and library rows; no library row where PyTorch
    has no call."""
    rows = kernels_bench.bench_rows("oversketch_gram", {"K": 150}, "card",
                                    13.9, 7.45, 1e-7, 10.8)
    assert [r["path"] for r in rows] == ["cuda", "plain", "library"]
    assert rows[0]["max_abs_err"] == 1e-7 and rows[2]["ms"] == 10.8
    assert rows[2]["call"] == kernels_bench.KERNELS["oversketch_gram"][1]
    assert all(r["table_row"] == 3 and r["device"] == "card" for r in rows)
    rows = kernels_bench.bench_rows("fwht", {}, "card", 1.5, 0.05, 0.0, 9.9)
    assert [r["path"] for r in rows] == ["cuda", "plain"]
