#!/usr/bin/env python3
"""Time the sketch and Gram kernels of one source tree on one GPU.

    python3 scripts/time_sketch_kernels.py [--src DIR] [--label NAME]
        [--only NAME,...]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``),
so that two versions of the kernels can be timed in one run on one
card: run it once per tree, alternating (A, B, B, A).  Only the public
entry points of ``repro_torch.kernels.ops`` are called, which every
version of the port has.  Shapes are the paths' at full width, n = 300,000
and d = 3,000:

  sketch_gram_count   K = 150, b = 256, 30 blocks masked (the main path)
  sketch_gram_sjlt    the same with s = 4 layers (families_sjlt)
  sketch_gram_srht    the same with b sampled Hadamard rows in [0, 2^19)
                      (families_srht)
  oversketch_gram     a (150, 256, 3,000) A_tilde, the same 30 blocks
                      masked (families_nystrom, _leverage, _gaussian)
  count_sketch_apply  K = 10, b = 4,096, s = 1 and s = 4 (distributed-
                      avg); K = 150, s = 1 and K = 120, s = 4 at b = 256

``--only`` keeps the named kernels.

Inputs are drawn on the card with torch's generator from ``--seed``, the
same in every run.  Each call is timed with CUDA events over ``--reps``
calls after one warm-up.  Prints one JSON line per kernel with its time
and the sum of its output (to compare versions' results), then the
nvidia-smi line.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", default="",
                    help="comma-separated kernel names (default: all)")
    args = ap.parse_args()
    only = set(filter(None, args.only.split(",")))
    sys.path.insert(0, str(Path(args.src).resolve()))

    import torch
    if not torch.cuda.is_available():
        print("time_sketch_kernels: no CUDA device is available",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import ops

    n, d = 300_000, 3_000
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(args.seed)
    a = torch.randn(n, d, generator=g, device=dev)
    mask = torch.ones(150, dtype=torch.bool, device=dev)
    mask[torch.randperm(150, generator=g, device=dev)[:30]] = False

    def codes(k, s, b):
        shape = (k, s, n) if s > 1 else (k, n)
        h = torch.randint(0, b, shape, generator=g, device=dev,
                          dtype=torch.int32)
        sigma = torch.randint(0, 2, shape, generator=g, device=dev).float()
        return h, sigma * 2 - 1

    def ms(fn) -> float:
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / args.reps

    n_pad = 1 << (n - 1).bit_length()
    cases = [("sketch_gram_count", 150, 1, 256),
             ("sketch_gram_sjlt", 150, 4, 256),
             ("sketch_gram_srht", 150, 1, 256),
             ("oversketch_gram", 150, 1, 256),
             ("count_sketch_apply", 10, 1, 4096),
             ("count_sketch_apply", 10, 4, 4096),
             ("count_sketch_apply", 150, 1, 256),
             ("count_sketch_apply", 120, 4, 256)]
    for name, k, s, b in cases:
        if only and name not in only:
            continue
        h, sigma = codes(k, s, b)
        if name == "count_sketch_apply":
            def call():
                return ops.count_sketch_apply(h, sigma, a, b)
        elif name == "sketch_gram_srht":
            h = torch.randint(0, n_pad, (k, b), generator=g, device=dev,
                              dtype=torch.int32)
            sigma = torch.randint(0, 2, (k, n), generator=g,
                                  device=dev).float() * 2 - 1

            def call():
                return ops.sketch_gram_srht(h, sigma, a, mask)
        elif name == "oversketch_gram":
            h = torch.randn(k, b, d, generator=g, device=dev)

            def call():
                return ops.oversketch_gram(h, mask)
        else:
            def call():
                return getattr(ops, name)(h, sigma, a, b, mask)
        out = call()
        print(json.dumps({"label": args.label, "kernel": name, "K": k,
                          "s": s, "b": b, "ms": ms(call),
                          "out_sum": float(out.double().sum()),
                          "out_abs_max": float(out.abs().max())}),
              flush=True)
        del h, sigma, out
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
