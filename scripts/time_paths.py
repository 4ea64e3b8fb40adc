#!/usr/bin/env python3
"""Time full-width Newton paths of one source tree on one GPU.

    python3 scripts/time_paths.py [--src DIR] [--label NAME]
        [--paths newton,families_sjlt] [--iters 3]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``),
so that two versions of the port can be timed in one run on one card: run
it once per tree, alternating (A, B, B, A).  Only public entry points are
called, which every version of the port has: ``profile_dataset`` builds
the paper's synthetic profile at full width on the card (n = 300,000,
d = 3,000, 100,000 test rows; its seconds are printed as ``data_s``), then
``oversketched_newton`` runs each path with the kernels and coded
gradients, seed 0, with the sketch configurations of this checkout's
``chip_smoke.py`` (``sketch_configs``, ``path_config``):

  newton         the oversketch family (the main path)
  families_X     the sketch family X (sjlt, srht, nystrom, leverage,
                 gaussian)
  distavg_X      distributed-avg with debias, family X

Prints one JSON line per path with each iteration's wall milliseconds
(``history["wall_s"]``), the sum of the final w (to compare versions'
results) and the seconds of the whole call, then the nvidia-smi line.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="")
    ap.add_argument("--paths", default="newton,families_sjlt")
    ap.add_argument("--iters", type=int, default=3)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke

    import torch
    if not torch.cuda.is_available():
        print("time_paths: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch import core, prng
    from repro_torch.configs import WORKER_SETUP
    from repro_torch.data import profile_dataset

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    data = profile_dataset("synthetic", prng.PRNGKey(0), full_scale=True,
                           device=dev)
    torch.cuda.synchronize()
    print(json.dumps({"label": args.label, "data_s":
                      time.perf_counter() - t0}), flush=True)
    n, d = data.x.shape
    objective = core.LogisticRegression()
    w0 = torch.zeros(d, device=dev)
    scfg, dcfg = chip_smoke.sketch_configs(
        core, d, WORKER_SETUP["synthetic"]["sketch_dim_mult"])
    for path in filter(None, args.paths.split(",")):
        cfg = chip_smoke.path_config(core, path, scfg, dcfg,
                                     iters=args.iters,
                                     gradient_policy="coded",
                                     use_kernels=True, seed=0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = core.oversketched_newton(
            objective, data, w0, cfg, device=dev)
        torch.cuda.synchronize()
        print(json.dumps({
            "label": args.label, "path": path,
            "wall_ms": [t * 1e3 for t in res.history["wall_s"]],
            "fval": res.history["fval"], "w_sum": float(res.w.sum()),
            "seconds": time.perf_counter() - t0}), flush=True)
        del res
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
