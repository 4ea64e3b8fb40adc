"""The port stands alone: it imports neither jax nor the JAX package, and
its entry points refuse to run without a device when no GPU is present."""
import ast
import json
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

SRC = Path(__file__).resolve().parents[1] / "src"


def _modules():
    import repro_torch
    names = ["repro_torch"]
    for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
        names.append(m.name)
    return names


def test_port_imports_neither_jax_nor_repro():
    names = _modules()
    for name in ("core.newton", "core.objectives", "data.synthetic",
                 "kernels.sketch_gram", "kernels.srht",
                 "kernels.coded_matvec", "kernels.normal", "kernels.draw",
                 "sketching.sjlt",
                 "sketching.srht", "sketching.debias", "sketching.gaussian",
                 "sketching.nystrom", "sketching.leverage",
                 "optim.gradient_coding", "optim.exact_newton",
                 "optim.first_order", "optim.giant", "runtime.faults",
                 "runtime.trace", "runtime.engine", "scheduler.pool",
                 "scheduler.dag", "scheduler.spec", "core.coded", "obs",
                 "obs.span", "obs.metrics", "obs.critical_path",
                 "obs.health", "obs.slo", "obs.perfetto", "obs.export",
                 "obs.incident", "obs.store", "obs.diff", "obs.console",
                 "tenancy", "tenancy.workload", "tenancy.scheduler",
                 "benchmarks", "benchmarks.common", "benchmarks.run",
                 "benchmarks.fig1_stragglers",
                 "benchmarks.fig6_logistic_synthetic",
                 "benchmarks.fig7_epsilon", "benchmarks.fig8_small_datasets",
                 "benchmarks.fig9_softmax", "benchmarks.fig10_coded_vs_spec",
                 "benchmarks.fig11_first_order", "benchmarks.fig12_serverful",
                 "benchmarks.fleet_bench", "benchmarks.scheduler_bench",
                 "benchmarks.tenancy_bench", "models", "models.common",
                 "models.attention", "models.transformer",
                 "models.registry", "models.moe", "models.ssd",
                 "models.rglru", "models.encdec", "configs", "configs.paper",
                 "configs.qwen3_4b", "configs.qwen3_32b", "configs.qwen2_7b",
                 "configs.gemma3_27b", "configs.llava_next_34b",
                 "configs.mamba2_780m", "configs.qwen3_moe_30b_a3b",
                 "configs.qwen3_moe_235b_a22b", "configs.recurrentgemma_2b",
                 "configs.whisper_large_v3", "launch", "launch.serve",
                 "launch.analytic", "training", "training.osn_head",
                 "training.trainer", "optim.adamw", "data.pipeline",
                 "checkpoint", "checkpoint.manager", "distributed",
                 "distributed.collectives", "launch.train",
                 "distributed.sharding", "distributed.shard_ops",
                 "launch.mesh", "launch.dryrun", "benchmarks.roofline",
                 "benchmarks.kernels_bench", "benchmarks.make_report"):
        assert f"repro_torch.{name}" in names
    code = (
        "import importlib, json, sys\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or\n"
        "             m.startswith('jax.') or m == 'repro' or\n"
        "             m.startswith('repro.') or m == 'ml_dtypes')\n"
        "print(json.dumps(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=str(SRC),
                         env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"})
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_entry_points_raise_without_a_device():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: entry points run on it by default")
    from repro_torch import convert, prng, resolve_device, sketching
    from repro_torch.core import (Dataset, LogisticRegression, NewtonConfig,
                                  OverSketchConfig, oversketched_newton,
                                  sample_countsketch)
    from repro_torch.data import (make_logistic_dataset, make_softmax_dataset,
                                  profile_dataset)
    from repro_torch.kernels import ops
    from repro_torch.models import get_bundle
    from repro_torch.optim import (FirstOrderConfig, GiantConfig,
                                   exact_newton, first_order, giant)
    from repro_torch.launch import train
    from repro_torch.training import Trainer, TrainerConfig
    key = prng.PRNGKey(0)
    cfg = OverSketchConfig(64, 32)
    data = Dataset(x=torch.zeros(8, 2), y=torch.ones(8))
    calls = [
        resolve_device,
        lambda: oversketched_newton(LogisticRegression(), data, np.zeros(2),
                                    NewtonConfig(iters=1)),
        lambda: giant(LogisticRegression(), data, np.zeros(2),
                      GiantConfig(iters=1, num_workers=2)),
        lambda: first_order(LogisticRegression(), data, np.zeros(2),
                            FirstOrderConfig(iters=1, num_workers=2)),
        lambda: exact_newton(LogisticRegression(), data, np.zeros(2),
                             iters=1),
        lambda: prng.permutation(key, 8),
        lambda: ops.bits(key, 0, 8),
        lambda: make_logistic_dataset(key, 8, 2),
        lambda: profile_dataset("a9a", key),
        lambda: make_softmax_dataset(key, 8, 2, 3),
        lambda: profile_dataset("emnist", key),
        lambda: sample_countsketch(key, 8, cfg),
        lambda: sketching.get("oversketch", cfg).sample(key, 8),
        lambda: sketching.get("sjlt", cfg).sample(key, 8),
        lambda: sketching.get("srht", cfg).sample(key, 8),
        lambda: sketching.get("gaussian", cfg).sample(key, 8),
        lambda: sketching.get("nystrom", cfg).sample(key, 8),
        lambda: sketching.get("leverage", cfg).sample(key, 8),
        lambda: prng.uniform(key, (3,)),
        lambda: prng.bernoulli(key, 0.5, (3,)),
        lambda: prng.rademacher(key, (3,)),
        lambda: prng.randint(key, (3,), 0, 4),
        lambda: prng.gumbel(key, (3,)),
        lambda: ops.gumbel(key, (3,)),
        lambda: ops.normal(key, (3,)),
        lambda: convert.vector(np.zeros(2)),
        lambda: convert.dataset(np.zeros((8, 2)), np.ones(8)),
        lambda: convert.tensor(np.zeros(2)),
        lambda: ops.normal(key, (3,), dtype=torch.bfloat16),
        lambda: get_bundle("qwen3-4b").init(key),
        lambda: get_bundle("qwen3-4b").init_cache(1, 8),
        *(call for arch in ("qwen3-moe-30b-a3b", "mamba2-780m",
                            "recurrentgemma-2b", "whisper-large-v3")
          for call in (lambda a=arch: get_bundle(a).init(key),
                       lambda a=arch: get_bundle(a).init_cache(1, 8))),
        lambda: Trainer(TrainerConfig(arch="qwen3-4b")),
        lambda: train.main(["--steps", "1"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")
    assert sample_countsketch(key, 8, cfg, device="cpu").h.device.type == "cpu"


def test_kernel_build_needs_nvcc():
    """Without the CUDA toolkit the kernels cannot build, and say so."""
    import shutil
    from repro_torch.kernels import _build
    if shutil.which("nvcc") or Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("nvcc is installed here")
    missing = [s for s, p in ((s, _build.library_path(s))
                              for s in _build.SOURCES) if not p.exists()]
    if not missing:
        pytest.skip("the kernels are already built")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(missing[:1])


PLAIN_DRAWS = {"randint", "rademacher", "uniform", "bernoulli", "gumbel",
               "categorical"}


def test_mesh_modules_touch_no_group_or_environment():
    """Importing the dry run, the meshes and the sharding policy (and
    building a production mesh's arithmetic) creates no process group and
    changes no environment variable: the dry run's fake group is made in
    the process that runs the cells."""
    code = (
        "import json, os\n"
        "before = dict(os.environ)\n"
        "import torch.distributed as dist\n"
        "import repro_torch.launch.dryrun, repro_torch.launch.mesh\n"
        "import repro_torch.distributed.sharding\n"
        "import repro_torch.distributed.shard_ops\n"
        "from repro_torch.launch.mesh import make_production_mesh\n"
        "m = make_production_mesh(multi_pod=True)\n"
        "print(json.dumps([dist.is_initialized(), dict(os.environ) == before,"
        " m.size]))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=str(SRC),
                         env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"})
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [False, True,
                                                               512]


def _prng_calls(names):
    """(file, line, function, device keyword) of every call ``prng.<name>``
    in the port's modules outside ``prng`` and ``kernels``."""
    root = SRC / "repro_torch"
    out = []
    for path in sorted(root.rglob("*.py")):
        rel = path.relative_to(root).as_posix()
        if rel == "prng.py" or rel.startswith("kernels/"):
            continue
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.module == \
                    "repro_torch.prng":
                assert not {a.name for a in node.names} & set(names), rel
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id == "prng"
                    and node.func.attr in names):
                continue
            device = next((k.value for k in node.keywords
                           if k.arg == "device"), None)
            out.append((rel, node.lineno, node.func.attr,
                        device.value if isinstance(device, ast.Constant)
                        else None))
    return out


def test_plain_draws_run_only_on_the_cpu_outside_prng_and_kernels():
    """No module outside ``prng`` and ``kernels`` calls prng's plain
    randint, rademacher, uniform, bernoulli, gumbel or categorical on
    anything but the CPU: the sketch samplers and the datasets draw through
    ``kernels.ops``.  The one
    exception left is ``prng.choice``, whose uniform draw runs plain on p's
    device, called by the leverage family alone."""
    calls = _prng_calls(PLAIN_DRAWS)
    assert calls, "the fleet's coin flips draw on the CPU by name"
    for rel, line, name, device in calls:
        assert device == "cpu", f"{rel}:{line}: prng.{name} on {device!r}"
    assert {rel for rel, *_ in calls} == {"core/straggler.py"}
    assert {rel for rel, *_ in _prng_calls({"choice"})} == {
        "sketching/leverage.py"}


def test_samplers_draw_through_the_kernel_entry_points(monkeypatch):
    """On the CPU, every plain draw the samplers and the datasets make is
    made inside a ``kernels.ops`` draw entry point (the softmax labels'
    Gumbel draws and their uniform included)."""
    from repro_torch import prng, sketching
    from repro_torch.core import OverSketchConfig, sample_countsketch
    from repro_torch.data import make_logistic_dataset, make_softmax_dataset
    from repro_torch.kernels import ops
    depth, entries, outside = [0], [], []
    for name in PLAIN_DRAWS:
        entry, plain = getattr(ops, name), getattr(prng, name)

        def through(*a, _entry=entry, _name=name, **k):
            entries.append(_name)
            depth[0] += 1
            try:
                return _entry(*a, **k)
            finally:
                depth[0] -= 1

        def guarded(*a, _plain=plain, _name=name, **k):
            if depth[0] == 0:
                outside.append(_name)
            return _plain(*a, **k)
        monkeypatch.setattr(ops, name, through)
        monkeypatch.setattr(prng, name, guarded)
    key = prng.PRNGKey(1)
    cfg = OverSketchConfig(64, 16)
    samplers = {
        "countsketch": lambda: sample_countsketch(key, 40, cfg,
                                                  device="cpu"),
        "dataset": lambda: make_logistic_dataset(key, 40, 3, 10,
                                                 device="cpu"),
        "softmax_dataset": lambda: make_softmax_dataset(key, 40, 3, 4, 10,
                                                        device="cpu"),
        **{fam: (lambda fam=fam: sketching.get(fam, cfg).sample(
            key, 40, device="cpu")) for fam in ("oversketch", "sjlt",
                                                "srht", "nystrom")}}
    for label, sample in samplers.items():
        entries.clear()
        sample()
        assert entries, f"{label} drew through no kernels.ops entry point"
        assert not outside, f"{label} called prng.{outside} directly"
