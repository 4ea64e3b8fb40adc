#!/usr/bin/env python3
"""Time the segment-sum apply's strip width on one GPU.

    python3 scripts/sweep_apply.py [--widths 8,16,32] [--reps 3]

``count_sketch_apply`` and the fused count-sketch and SJLT Grams sort each
block's entries by bucket and gather A's rows a column strip at a time
(``kernels/count_sketch.py``, ``apply_plan``).  This script sets
``GATHER_WIDTH`` to each width in turn and times each call with CUDA
events, each result against the plan's own width within 1e-5 of its
largest entry (the width sets the order of each bucket's sum):

  apply   b = 256 for the count sketch (K = 150, s = 1) and the SJLT
          (K = 120, s = 4: the live blocks of the families_sjlt path);
          b = 4,096, K = 10 (distributed-avg), s = 1 and s = 4
  fused   sketch_gram_count and sketch_gram_sjlt (s = 4) at the blocks
          paths' shape: K = 150, b = 256, 30 blocks masked

Inputs have n = 300,000, d = 3,000 and are drawn on the card with torch's
generator: the kernels' work does not depend on A's values, and the
buckets are uniform as the paths' are.  Prints one JSON line per timing,
the nvidia-smi line, and a summary line last.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--widths", default="8,16,32")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("sweep: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.kernels import count_sketch as cs
    from repro_torch.kernels import ops

    n, d = 300_000, 3_000
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(args.seed)
    a = torch.randn(n, d, generator=g, device=dev)

    def codes(k, s, b):
        shape = (k, s, n) if s > 1 else (k, n)
        h = torch.randint(0, b, shape, generator=g, device=dev,
                          dtype=torch.int32)
        sigma = torch.randint(0, 2, shape, generator=g, device=dev).float()
        return h, sigma * 2 - 1

    def ms(fn) -> float:
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / args.reps

    mask = torch.ones(150, dtype=torch.bool, device=dev)
    mask[torch.randperm(150, generator=g, device=dev)[:30]] = False
    cases = [("apply", 150, 1, 256), ("apply", 120, 4, 256),
             ("apply", 10, 1, 4096), ("apply", 10, 4, 4096),
             ("fused", 150, 1, 256), ("fused", 150, 4, 256)]
    width0 = cs.GATHER_WIDTH
    rows = []
    for kind, k, s, b in cases:
        h, sigma = codes(k, s, b)
        if kind == "apply":
            def call():
                return ops.count_sketch_apply(h, sigma, a, b)
        elif s == 1:
            def call():
                return ops.sketch_gram_count(h, sigma, a, b, mask)
        else:
            def call():
                return ops.sketch_gram_sjlt(h, sigma, a, b, mask)
        want = call()
        for width in (int(w) for w in args.widths.split(",")):
            cs.GATHER_WIDTH = width
            err = float((call() - want).abs().max() / want.abs().max())
            if not err <= 1e-5:
                raise AssertionError(f"{kind} K={k} s={s} b={b}, width "
                                     f"{width}: relative error {err}")
            row = {"kind": kind, "K": k, "s": s, "b": b, "width": width,
                   "plan": width == width0, "rel_err": err, "ms": ms(call)}
            print(json.dumps(row), flush=True)
            rows.append(row)
        cs.GATHER_WIDTH = width0
        del h, sigma, want
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    best = {}
    for r in rows:
        key = f"{r['kind']} b={r['b']} s={r['s']}"
        if key not in best or r["ms"] < best[key]["ms"]:
            best[key] = r
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "fastest": best}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
