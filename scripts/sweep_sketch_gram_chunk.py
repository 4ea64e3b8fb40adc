#!/usr/bin/env python3
"""Time a fused sketch -> Gram kernel at several chunk sizes on one GPU.

    python3 scripts/sweep_sketch_gram_chunk.py [--chunks 6,12,24] [--layers 4]
        [--srht]

The fused kernels walk the blocks in chunks: per chunk they write the
chunk's A_tilde (the count sketch's and the SJLT's by the segment-sum
gather, after one sort of every block's codes; the SRHT's by the partial
Hadamard transform) and fold it into G with the Gram kernel.
``kernels/sketch_gram.py::CHUNK_BYTES`` sets the chunk; this script sets
it to each chunk size in turn (in blocks) and times one fused call with
CUDA events: ``sketch_gram_count`` with ``--layers 1`` (the default),
``sketch_gram_sjlt`` with s = ``--layers`` layers otherwise, and
``sketch_gram_srht`` with ``--srht`` (b sampled rows in [0, 2^19)).

Inputs have the blocks paths' shapes at full width: n = 300,000,
d = 3,000, K = 150, b = 256, 30 blocks masked.  They are drawn on the card with
torch's generator: the kernel's work does not depend on A's values, and
the buckets are uniform as the main path's are.  Every chunk size is timed
in two rounds, the second in reverse order, and its result is held
against the first chunk size's within 1e-4 of max |G|.  Prints one JSON
line per timing, the nvidia-smi line, and a summary line last.
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
    ap.add_argument("--chunks", default="6,12,24,48,96,144",
                    help="chunk sizes in sketch blocks")
    ap.add_argument("--layers", type=int, default=1,
                    help="1: sketch_gram_count; s > 1: sketch_gram_sjlt")
    ap.add_argument("--srht", action="store_true",
                    help="sketch_gram_srht instead")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("sweep: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.kernels import ops, sketch_gram

    k, n, d, b, masked = 150, 300_000, 3_000, 256, 30
    s = args.layers
    shape = (k, n) if s == 1 else (k, s, n)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(args.seed)
    if args.srht:
        s, shape = 1, (k, n)
        h = torch.randint(0, 1 << (n - 1).bit_length(), (k, b), generator=g,
                          device=dev, dtype=torch.int32)

        def fused(rows, sigma, a, b, mask):
            return ops.sketch_gram_srht(rows, sigma, a, mask)
    else:
        fused = ops.sketch_gram_count if s == 1 else ops.sketch_gram_sjlt
        h = torch.randint(0, b, shape, generator=g, device=dev,
                          dtype=torch.int32)
    sigma = torch.randint(0, 2, shape, generator=g, device=dev).float() * 2 - 1
    a = torch.randn(n, d, generator=g, device=dev)
    mask = torch.ones(k, dtype=torch.bool, device=dev)
    mask[torch.randperm(k, generator=g, device=dev)[:masked]] = False

    default_bytes = sketch_gram.CHUNK_BYTES
    chunks = [int(c) for c in args.chunks.split(",")]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    first = None
    times = {c: [] for c in chunks}
    for rnd, order in enumerate((chunks, chunks[::-1])):
        for c in order:
            sketch_gram.CHUNK_BYTES = c * 4 * b * d
            got_chunk = sketch_gram.chunk_blocks(k, b, d)
            if got_chunk != c:
                raise ValueError(f"chunk {c}: the kernel would take "
                                 f"{got_chunk}")
            out = fused(h, sigma, a, b, mask)   # warm-up
            if first is None:
                first = out
            err = float((out - first).abs().max() / first.abs().max())
            if not err <= 1e-4:
                raise AssertionError(f"chunk {c}: relative error {err}")
            torch.cuda.synchronize()
            start.record()
            for _ in range(args.reps):
                fused(h, sigma, a, b, mask)
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end) / args.reps
            times[c].append(ms)
            print(json.dumps({"round": rnd, "chunk_blocks": c,
                              "chunk_mb": c * 4 * b * d / 1e6, "ms": ms,
                              "rel_err_vs_first": err}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(json.dumps({"kernel": fused.__name__ if not args.srht
                      else "sketch_gram_srht",
                      "shapes": {"K": k, "s": s, "n": n, "d": d, "b": b,
                                 "masked": masked},
                      "reps": args.reps,
                      "ms_by_chunk": {str(c): t for c, t in times.items()},
                      "default_chunk_bytes": default_bytes}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
