#!/usr/bin/env python3
"""Time the sketch, Gram, coded mat-vec and FWHT kernels of one source tree
on one GPU.

    python3 scripts/time_sketch_kernels.py [--src DIR] [--label NAME]
        [--only NAME,...] [--reps 3] [--encode]

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
  coded_X             coded_block_matvec at the X encode: W = 1,296 blocks
                      of (256, 3,000), 65 erased (5%, as chip_smoke.py
                      erases)
  coded_XT            the X^T encode: W = 25 blocks of (256, 300,000),
                      1 erased
  fwht_two_pass       one (1, 2^19, 3,000) block (distavg_srht's), beside
                      a copy of the block (``copy_ms``: what one pass's
                      bytes take when nothing else is done)
  fwht                the one-pass transform at (1, n, 3,000) for n =
                      1,024, 2,048 and 4,096 (the smoke's check_fwht
                      lengths), timed from CUDA graphs as chip_smoke.py
                      times it (``graph_ms``: 20 calls a graph, 5
                      replays), beside a copy of x

``--only`` keeps the named kernels.

Inputs are drawn on the card with torch's generator from ``--seed``, the
same in every run.  With ``--encode`` the coded rows take the product-code
encodes of the paper's synthetic profile instead (``profile_dataset`` at
full width, then ``core.coded.encode_2d`` of X and X^T, as chip_smoke.py
builds them), and each is timed twice on the same tensors: as encoded, and
again after RELEASE_GB of other tensors were allocated, freed and returned
to CUDA with ``torch.cuda.empty_cache()`` (as chip_smoke.py does between
its checks).  Each call but fwht's is timed with CUDA events over
``--reps`` calls after one warm-up; the coded rows also time one PyTorch call of the same
function (``torch.mv`` over all blocks, then ``torch.where``) and give
their bound at the card's published HBM rate.  Prints one JSON line per
kernel with its time, the sum of its output (to compare versions' results)
and the card's SM and memory clocks, power draw and temperature just
after, then the nvidia-smi line.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from chip_smoke import (HBM_BYTES_PER_S, clocks, graph_ms,  # noqa: E402
                        nvidia_smi)

ERASED = 0.05
RELEASE_GB = 42


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", default="",
                    help="comma-separated kernel names (default: all)")
    ap.add_argument("--encode", action="store_true",
                    help="time the coded mat-vec on the profile's encodes")
    args = ap.parse_args()
    only = set(filter(None, args.only.split(",")))
    sys.path.insert(0, str(Path(args.src).resolve()))

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("time_sketch_kernels: no CUDA device is available",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import ops

    n, d = 300_000, 3_000
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(args.seed)

    def wanted(name: str) -> bool:
        return not only or name in only

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

    def emit(row: dict) -> None:
        print(json.dumps({"label": args.label, **row, "clocks": clocks()}),
              flush=True)

    cases = [("sketch_gram_count", 150, 1, 256),
             ("sketch_gram_sjlt", 150, 4, 256),
             ("sketch_gram_srht", 150, 1, 256),
             ("oversketch_gram", 150, 1, 256),
             ("count_sketch_apply", 10, 1, 4096),
             ("count_sketch_apply", 10, 4, 4096),
             ("count_sketch_apply", 150, 1, 256),
             ("count_sketch_apply", 120, 4, 256)]
    if any(wanted(c[0]) for c in cases):
        a = torch.randn(n, d, generator=g, device=dev)
        mask = torch.ones(150, dtype=torch.bool, device=dev)
        mask[torch.randperm(150, generator=g, device=dev)[:30]] = False
    n_pad = 1 << (n - 1).bit_length()

    def codes(k, s, b):
        shape = (k, s, n) if s > 1 else (k, n)
        h = torch.randint(0, b, shape, generator=g, device=dev,
                          dtype=torch.int32)
        sigma = torch.randint(0, 2, shape, generator=g, device=dev).float()
        return h, sigma * 2 - 1

    for name, k, s, b in cases:
        if not wanted(name):
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
        emit({"kernel": name, "K": k, "s": s, "b": b, "ms": ms(call),
              "out_sum": float(out.double().sum()),
              "out_abs_max": float(out.abs().max())})
        del h, sigma, out
    a = mask = None
    torch.cuda.empty_cache()

    data = None
    if args.encode and (wanted("coded_X") or wanted("coded_XT")):
        from repro_torch import prng
        from repro_torch.core import coded
        from repro_torch.data import profile_dataset
        data = profile_dataset("synthetic", prng.PRNGKey(args.seed),
                               full_scale=True, device=dev)
    for name, w, b, s in (("coded_X", 1296, 256, d),
                          ("coded_XT", 25, 256, n)):
        if not wanted(name):
            continue
        if data is None:
            encs = {"": torch.randn(w, b, s, generator=g, device=dev)}
        else:
            x2 = data.x if name == "coded_X" else data.x.T
            enc = coded.encode_2d(x2, coded.make_code(x2.shape[0], b))
            encs = {"_encoded": enc.view(w, b, s)}
            encs["_after_release"] = encs["_encoded"]
        x = torch.randn(s, generator=g, device=dev)
        erased = torch.zeros(w, dtype=torch.bool)
        erased[np.random.default_rng(args.seed).choice(
            w, max(1, round(ERASED * w)), replace=False)] = True
        erased = erased.to(dev)
        live = int((~erased).sum())
        for tag, enc in encs.items():
            if tag == "_after_release":
                held = [torch.empty(1 << 30, dtype=torch.uint8, device=dev)
                        for _ in range(RELEASE_GB)]
                del held
                torch.cuda.empty_cache()
            out = ops.coded_block_matvec(enc, x, erased)
            flat = enc.view(-1, s)
            emit({"kernel": name + tag,
                  "ms": ms(lambda: ops.coded_block_matvec(enc, x, erased)),
                  "library_ms": ms(lambda: torch.where(
                      erased[:, None], 0.0, (flat @ x).view(w, b))),
                  "bound_ms": 4.0 * (live * b * s + s + w * b)
                  / HBM_BYTES_PER_S * 1e3,
                  "out_sum": float(out.double().sum()),
                  "shape": [w, b, s], "erased": w - live})
        del encs, enc, flat, out
        torch.cuda.empty_cache()
    del data
    torch.cuda.empty_cache()

    if wanted("fwht_two_pass"):
        x = torch.randn(1, n_pad, d, generator=g, device=dev)
        out = ops.fwht_two_pass(x)
        buf = torch.empty_like(x)
        emit({"kernel": "fwht_two_pass",
              "ms": ms(lambda: ops.fwht_two_pass(x)),
              "copy_ms": ms(lambda: buf.copy_(x)),
              "out_sum": float(out.double().sum()), "shape": [1, n_pad, d]})
        del x, out, buf
    if wanted("fwht"):
        for n1 in (1024, 2048, 4096):
            x = torch.randn(1, n1, d, generator=g, device=dev)
            out = ops.fwht(x)
            buf = torch.empty_like(x)
            emit({"kernel": "fwht", "ms": graph_ms(lambda: ops.fwht(x)),
                  "copy_ms": graph_ms(lambda: buf.copy_(x)),
                  "out_sum": float(out.double().sum()), "shape": [1, n1, d],
                  "timing": "CUDA graph of 20 calls, 5 replays"})
    print(nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
