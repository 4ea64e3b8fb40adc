"""The readings that the limits of ``correct`` are set from, in one process
on the card, each a run of ``run.run_cell`` with a short window at the
cell's own sizes and calls:

* ``program``: the port, the sound runs whose largest reading is a limit's
  lower end;
* ``control``: the plain reference solver of ``reference/control.py`` put
  in the program's place and computed in TF32 (``--rounding``), judged by
  the harness's own verdict;
* ``fault:<name>``: the port with a fault of ``faults.py`` planted
  underneath.

    python -m osnbench.calibrate --workload <cell> --side program \\
        --seeds 11,12,... --seconds 16

Prints one JSON line a seed: ``{"side", "seed", "correct", "attempted",
"failed", "judged", "check"}``.  The benchmark's own runs never run it.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import torch

from osnbench import faults, run, spec
from osnbench.reference import control


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--side", default="program")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--rounding", default="tf32",
                    choices=sorted(control.ROUNDINGS))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("osnbench.calibrate: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    make_solver, fault = None, None
    if args.side == "control":
        def make_solver(cell, x, y, device):
            return control.Control(cell, x, y, device, args.rounding)
    elif args.side.startswith("fault:"):
        fault = args.side[len("fault:"):]
        if fault not in faults.FAULTS:
            raise SystemExit(f"no fault {fault!r}: {', '.join(faults.FAULTS)}")
    elif args.side != "program":
        raise SystemExit(f"unknown side {args.side!r}")
    for seed in (int(s) for s in args.seeds.split(",") if s):
        cell = spec.cell(args.workload)
        with (faults.plant(fault, cell["family"]) if fault
              else contextlib.nullcontext()):
            out = run.run_cell(cell, seed, args.seconds, False, dev,
                               t_start=time.time(), make_solver=make_solver)
        print(json.dumps({"side": args.side, "seed": seed,
                          "correct": out["correct"],
                          "attempted": out["attempted"],
                          "failed": out["failed"], "judged": out["judged"],
                          "check": out["check"],
                          "metrics": out["metrics"]}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
