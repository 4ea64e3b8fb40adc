"""What the benchmark loads and where it finds its cells: no module of JAX
or of the JAX package ``repro`` in a run, a reference that imports nothing
of the program, and cells, mixes, configurations and metrics found by name
from files of their own."""
import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from osnbench import run, spec

REPO = Path(__file__).resolve().parents[2]
BENCH = REPO / "osnbench"


def _py(code: str, cwd: Path = REPO, timeout: int = 240):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd,
                          capture_output=True, text=True, timeout=timeout)


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    loaded = dict.fromkeys(["torch", "repro_torch.core", "reprox",
                            "jax_like.x"])
    monkeypatch.setattr(sys, "modules", loaded)
    assert run.forbidden_modules() == []
    loaded.update(dict.fromkeys(["repro.core.newton", "jaxlib"]))
    assert run.forbidden_modules() == ["jaxlib", "repro"]


def test_a_cpu_run_loads_neither_jax_nor_repro():
    code = """
import sys, json, time, torch
sys.path[:0] = ["src", "."]
from osnbench import run, spec
cell = spec.cell("logistic-oversketch")
cell["config"].update(n=2000, d=40)
cell["traffic"].update(sketch_dim=512, block_size=64, coded_block_rows=128,
                       warmup_iters=1)
out = run.run_cell(cell, 5, 0.1, True, torch.device("cpu"), time.time())
print(json.dumps({"correct": out["correct"], "bad": run.forbidden_modules(),
                  "torch_port": "repro_torch" in sys.modules}))
"""
    res = _py(code)
    assert res.returncode == 0, res.stderr[-2000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out == {"correct": True, "bad": [], "torch_port": True}


def test_the_reference_imports_nothing_of_the_program():
    """Nor do the objectives and families, whose reference halves the
    judge and the control call."""
    for path in sorted([*(BENCH / "reference").glob("*.py"),
                        *(BENCH / "objectives").glob("*.py"),
                        *(BENCH / "families").glob("*.py")]):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for name in names:
                assert name.split(".")[0] not in (
                    "repro_torch", "repro", "jax", "jaxlib"), (path, name)
    res = _py("import sys; sys.path[:0] = ['src', '.'];"
              "import osnbench.reference.judge, osnbench.reference.control;"
              "from osnbench import spec;"
              "[spec.cell(w['name']) for w in "
              "spec.load_benchmark()['workloads']];"
              "print(sorted(m for m in sys.modules if m.split('.')[0] in "
              "('repro_torch', 'repro', 'jax')))")
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip() == "[]"


def test_no_result_without_a_card_or_outside_a_checkout(tmp_path):
    """Without CUDA the command exits non-zero and prints no result line;
    so it does in a directory holding only BENCHMARK.json and osnbench/."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "osnbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for cwd in (REPO, tmp_path):
        res = subprocess.run(
            [sys.executable, "-m", "osnbench.run", "--workload",
             "logistic-oversketch", "--seed", str(2 ** 31 + 7), "--seconds",
             "1", "--trace", "0"], cwd=cwd, capture_output=True, text=True,
            timeout=240)
        assert res.returncode != 0
        assert not any(line.startswith("{")
                       for line in res.stdout.splitlines())


def test_new_files_are_found_by_name(tmp_path):
    """A new configuration, traffic mix, cell and metric are files of their
    own and entries in BENCHMARK.json: nothing existing is edited."""
    root = tmp_path / "osnbench"
    shutil.copytree(BENCH, root, ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "configs" / "synthetic-logistic.json")
                     .read_text())
    cfg.update(name="new-problem", n=1000)
    (root / "configs" / "new-problem.json").write_text(json.dumps(cfg))
    traffic = json.loads((root / "traffic" / "logistic-srht.json")
                         .read_text())
    traffic.update(iters=5)
    (root / "traffic" / "new-mix.json").write_text(json.dumps(traffic))
    (root / "metrics" / "new_metric.py").write_text(
        'LAYER = "device"\nUNIT = "ms"\n\n\ndef read(ctx):\n'
        '    return ctx["window_s"] * 1e3\n')
    bench["configs"].append({"name": "new-problem", "source": "x",
                             "file": "osnbench/configs/new-problem.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "new-cell", "config": "new-problem",
                               "traffic": "new-mix", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "new_metric", "unit": "ms",
                               "better": "lower", "source": "host_clock",
                               "layer": "device", "moves": "iter_ms",
                               "workloads": ["new-cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.cell("new-cell", repo=tmp_path, root=root)
    assert cell["config"]["n"] == 1000 and cell["traffic"]["iters"] == 5
    assert "new_metric" in [m["name"] for m in cell["per_layer"]]
    assert "iter_ms_p95" not in [m["name"] for m in cell["end_to_end"]]
    reader = spec.metric_reader("new_metric", root=root)
    assert reader.read({"window_s": 2.0}) == 2000.0
    old = spec.cell("logistic-srht", repo=tmp_path, root=root)
    assert "new_metric" not in [m["name"] for m in old["per_layer"]]


def test_every_metric_file_matches_benchmark_json():
    bench = spec.load_benchmark()
    for m in bench["per_layer"]:
        reader = spec.metric_reader(m["name"])
        assert reader.LAYER == m["layer"] and reader.UNIT == m["unit"]
    for w in bench["workloads"]:
        cell = spec.cell(w["name"])
        assert {m["name"] for m in cell["end_to_end"]} >= {"setup_s",
                                                           "iter_ms"}
        assert cell["per_layer"]


@pytest.mark.cuda
def test_a_card_run_prints_a_correct_line_and_loads_no_jax():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    res = subprocess.run(
        [sys.executable, "-m", "osnbench.run", "--workload",
         "logistic-oversketch", "--seed", str(2 ** 31 + 11), "--seconds", "2",
         "--trace", "0"], cwd=REPO, capture_output=True, text=True,
        timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
    assert list(out)[-1] == "check"
