#!/usr/bin/env python3
"""Time the segment-sum apply's strip width and its grouped gather on one GPU.

    python3 scripts/sweep_apply.py [--part width|group|all] [--widths 8,16,32]
                                   [--groups 2,3,4] [--reps 3]

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

At b = 256 the plan takes the grouped gather, whose width is fixed: there
each width times the same kernel, at the plan's group.  Inputs
have n = 300,000, d = 3,000 and are drawn on the card with torch's
generator: the kernels' work does not depend on A's values, and the
buckets are uniform as the paths' are.

The group part (``--part group``) times sketch_gram_count at the two
benchmark cells' shapes, b = 256: logistic-oversketch (K = 150, 120 live,
n = 300,000, d = 3,000) and softmax-emnist (K = 230, 184 live, n K =
1,800,000, d K = 7,840).  It sets ``GROUP_MAX`` to each group G in turn,
and times the per-bucket gather (G = 1, width 32) in the same call; every
grouped result must equal the per-bucket one bit for bit (both sum in
ascending row order).  The grouped gather's width is 32 (a thread holds
its output row's 32 columns) and its stage 256 rows (the kernel's
GG_STAGE; 128 ran slower).  Prints one JSON line per timing, the nvidia-smi line, and a
summary line last.
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
    ap.add_argument("--part", choices=("width", "group", "all"),
                    default="all")
    ap.add_argument("--widths", default="8,16,32")
    ap.add_argument("--groups", default="2,3,4")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("sweep: no CUDA device is available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(args.seed)

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

    rows = []
    if args.part in ("width", "all"):
        rows += sweep_widths(args, g, dev, ms)
    if args.part in ("group", "all"):
        rows += sweep_groups(args, g, dev, ms)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    best = {}
    for r in rows:
        key = f"{r['kind']} b={r['b']} s={r['s']} K={r['K']}"
        if key not in best or r["ms"] < best[key]["ms"]:
            best[key] = r
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "fastest": best}))
    return 0


def sweep_groups(args, g, dev, ms) -> list:
    """sketch_gram_count at the cells' shapes: the per-bucket gather, then
    each group of the grouped one (see the module docstring)."""
    import torch
    from repro_torch.kernels import count_sketch as cs
    from repro_torch.kernels import ops

    b = 256
    max0 = cs.GROUP_MAX
    rows = []
    for cell, k, live, n, d in (("logistic-oversketch", 150, 120, 300_000,
                                 3_000),
                                ("softmax-emnist", 230, 184, 1_800_000,
                                 7_840)):
        a = torch.randn(n, d, generator=g, device=dev)
        h = torch.randint(0, b, (k, n), generator=g, device=dev,
                          dtype=torch.int32)
        sigma = torch.randint(0, 2, (k, n), generator=g,
                              device=dev).float() * 2 - 1
        mask = torch.zeros(k, dtype=torch.bool, device=dev)
        mask[torch.randperm(k, generator=g, device=dev)[:live]] = True

        def call():
            return ops.sketch_gram_count(h, sigma, a, b, mask)
        planned = cs.apply_plan(k, 1, n, b).group
        want = None
        for group in [1] + [int(gr) for gr in args.groups.split(",")]:
            cs.GROUP_MAX = group
            plan = cs.apply_plan(k, 1, n, b)
            assert plan.group == group, (plan, group)
            got = call()
            if want is None:
                want = got
            elif not torch.equal(got, want):
                raise AssertionError(f"{cell}: group {group} differs from "
                                     "the per-bucket gather")
            row = {"kind": "group", "cell": cell, "K": k, "live": live,
                   "s": 1, "b": b, "n": n, "d": d, "group": group,
                   "plan": group == planned, "ms": ms(call)}
            print(json.dumps(row), flush=True)
            rows.append(row)
        cs.GROUP_MAX = max0
        del a, h, sigma, want, got
        torch.cuda.empty_cache()
    return rows


def sweep_widths(args, g, dev, ms) -> list:
    """The per-bucket gather's widths at the paths' shapes, the group as
    planned."""
    import torch
    from repro_torch.kernels import count_sketch as cs
    from repro_torch.kernels import ops

    n, d = 300_000, 3_000
    a = torch.randn(n, d, generator=g, device=dev)

    def codes(k, s, b):
        shape = (k, s, n) if s > 1 else (k, n)
        h = torch.randint(0, b, shape, generator=g, device=dev,
                          dtype=torch.int32)
        sigma = torch.randint(0, 2, shape, generator=g, device=dev).float()
        return h, sigma * 2 - 1

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
    del a
    torch.cuda.empty_cache()
    return rows


if __name__ == "__main__":
    sys.exit(main())
