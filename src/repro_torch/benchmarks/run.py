"""Benchmark runner — one module per paper table/figure; the port's
counterpart of ``benchmarks/run.py``.

  PYTHONPATH=src python -m repro_torch.benchmarks.run [--full]
      [--only fig6,fig9] [--out FILE] [--trace-out FILE] [--device cpu]

Prints ``name,us_per_call,derived`` CSV rows, as the reference does, and
each module's wall seconds on stderr.  Default is the quick profile
(CPU-scaled dataset sizes, same generative models and worker ratios as
the paper's experiments; see ``configs/paper.py``).  The optimizers run on
the CUDA device unless ``--device`` names another; the fleet always runs
on the host.

``--out`` writes every row of the invocation as one JSON payload in the
reference's schema (``{"meta": ..., "rows": ...}``; the meta names the
device, the torch version, the git sha and each module's wall seconds).
It never writes a ``BENCH_*.json`` at the repo root: those are the JAX
package's tracked baselines.  Bare filenames given to ``--out`` and
``--trace-out`` land in the git-ignored ``artifacts/`` directory.
"""
from __future__ import annotations

import argparse
import importlib
import inspect
import json
import pathlib
import sys
import time

REPO_ROOT = pathlib.Path(__file__).resolve().parents[3]
ARTIFACTS = REPO_ROOT / "artifacts"

MODULES = [
    "fig1_stragglers",
    "fig6_logistic_synthetic",
    "fig7_epsilon",
    "fig8_small_datasets",
    "fig9_softmax",
    "fig10_coded_vs_spec",
    "fig11_first_order",
    "fig12_serverful",
    "fleet_bench",
    "scheduler_bench",
    "tenancy_bench",
]


def _artifact_path(name: str) -> pathlib.Path:
    """Bare filenames land in the git-ignored ``artifacts/`` directory;
    paths with an explicit directory component are honored as-is."""
    p = pathlib.Path(name)
    if p.parent == pathlib.Path("."):
        p = ARTIFACTS / p
    p.parent.mkdir(parents=True, exist_ok=True)
    return p


def _device_name(device) -> str:
    import torch
    dev = torch.device(device) if device is not None else (
        torch.device("cuda") if torch.cuda.is_available() else None)
    if dev is None:
        return "none"
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return dev.type


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="larger problem sizes (slower)")
    ap.add_argument("--only", type=str, default=None,
                    help="comma-separated module prefixes")
    ap.add_argument("--out", type=str, default=None,
                    help="write every row, with device/torch/git metadata, "
                         "as one JSON payload here (bare filenames go "
                         "under artifacts/)")
    ap.add_argument("--trace-out", type=str, default=None,
                    help="write a Perfetto trace of an instrumented run "
                         "here (modules whose run() accepts trace_out; "
                         "bare filenames go under artifacts/)")
    ap.add_argument("--device", type=str, default=None,
                    help="device of the optimizers' tensors (default: the "
                         "CUDA device)")
    args = ap.parse_args(argv)

    mods = MODULES
    if args.only:
        keys = args.only.split(",")
        mods = [m for m in MODULES if any(m.startswith(k) for k in keys)]

    print("name,us_per_call,derived")
    failures = 0
    all_rows, seconds = [], {}
    for mod_name in mods:
        mod = importlib.import_module(f"repro_torch.benchmarks.{mod_name}")
        params = inspect.signature(mod.run).parameters
        kwargs = {}
        if "device" in params:
            kwargs["device"] = args.device
        if args.trace_out and "trace_out" in params:
            kwargs["trace_out"] = str(_artifact_path(args.trace_out))
        t0 = time.time()
        try:
            rows = mod.run(quick=not args.full, **kwargs)
        except Exception as e:   # noqa: BLE001 — surface and continue
            print(f"{mod_name},NaN,ERROR:{type(e).__name__}:{e}",
                  file=sys.stderr)
            failures += 1
            continue
        seconds[mod_name] = time.time() - t0
        for r in rows:
            print(f"{r['name']},{r['us']:.1f},{r['derived']}")
            all_rows.append({**r, "module": mod_name})
        print(f"# {mod_name} done in {seconds[mod_name]:.1f}s",
              file=sys.stderr)

    if args.out:
        import torch

        from repro_torch.obs import store as obs_store
        profile = "full" if args.full else "quick"
        payload = {
            "meta": {
                "module": "+".join(seconds),
                "profile": profile,
                "device": _device_name(args.device),
                "torch_version": torch.__version__,
                "cuda_version": torch.version.cuda,
                "git_sha": obs_store.git_sha(REPO_ROOT),
                "config_hash": obs_store.config_hash(
                    {"modules": list(seconds), "profile": profile}),
                "module_seconds": seconds,
                "utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
            },
            "rows": all_rows,
        }
        out = _artifact_path(args.out)
        if out.resolve().parent == REPO_ROOT and out.name.startswith(
                "BENCH_"):
            raise SystemExit(f"refusing to write {out}: the BENCH_*.json "
                             "files at the repo root are the JAX "
                             "package's tracked baselines")
        out.write_text(json.dumps(payload, indent=1) + "\n")
        print(f"# wrote {out}", file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
