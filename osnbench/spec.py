"""What a cell is, read from data: ``BENCHMARK.json`` names the cell, its
configuration and its traffic; ``configs/<config>.json`` holds the problem,
``traffic/<traffic>.json`` the solve mix and the comparison's limits,
``objectives/<objective>.py`` the code of the configuration's objective,
``families/<sketch_family>.py`` that of the traffic's sketch family, and
``metrics/<metric>.py`` each per-layer metric's reader.  A new cell, mix,
configuration, objective, family or metric is a new file and a new entry:
nothing here changes.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
REPO = HERE.parent


def load_benchmark(repo: Path = REPO) -> dict:
    with open(repo / "BENCHMARK.json") as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, repo: Path = REPO, root: Optional[Path] = None) -> Dict:
    """The cell ``name``: its entry, configuration, traffic, the modules of
    its objective and sketch family, and the metrics it reports, each in
    BENCHMARK.json's order."""
    root = HERE if root is None else root
    bench = load_benchmark(repo)
    entry = {w["name"]: w for w in bench["workloads"]}.get(name)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cfg_entry = {c["name"]: c for c in bench["configs"]}[entry["config"]]
    with open(repo / cfg_entry["file"]) as f:
        config = json.load(f)
    with open(root / "traffic" / f"{entry['traffic']}.json") as f:
        traffic = json.load(f)
    return {"name": name, "chips": int(entry["chips"]), "config": config,
            "traffic": traffic,
            "objective": objective(config["objective"], root),
            "family": family(traffic["sketch_family"], root),
            "end_to_end": [m for m in bench["end_to_end"]
                           if _applies(m, name)],
            "per_layer": [m for m in bench["per_layer"]
                          if _applies(m, name)]}


def _module(kind: str, name: str, root: Optional[Path]) -> ModuleType:
    """``<root>/<kind>/<name>.py`` as a module, its ``NAME`` set to
    ``name``."""
    path = (HERE if root is None else root) / kind / f"{name}.py"
    mod_name = f"osnbench_{kind}_" + "".join(
        c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    mod.NAME = name
    spec.loader.exec_module(mod)
    return mod


def objective(name: str, root: Optional[Path] = None) -> ModuleType:
    """``objectives/<name>.py``: a configuration's problem (see README)."""
    return _module("objectives", name, root)


def family(name: str, root: Optional[Path] = None) -> ModuleType:
    """``families/<name>.py``: a traffic's sketch family (see README)."""
    return _module("families", name, root)


def families(root: Optional[Path] = None) -> List[ModuleType]:
    """Every sketch family under ``families/``, in the order of their
    names."""
    base = (HERE if root is None else root) / "families"
    return [family(p.stem, root) for p in sorted(base.glob("*.py"))]


def metric_reader(name: str, root: Optional[Path] = None) -> ModuleType:
    """``metrics/<name>.py`` as a module (its ``read(ctx)``)."""
    return _module("metrics", name, root)
