"""Roofline extraction (the counterpart of ``benchmarks/roofline.py``): a
reduced-mesh dry-run cell (qwen3-4b's smoke config on a 4x2 fake mesh, in
a subprocess of its own, as the dry run wants its process), the analytic
full-mesh terms for every (arch x shape) cell, and the sketch -> Gram hot
path's arithmetic intensity, the port's fused kernel beside the unfused
two-kernel pipeline.

Denominators are the H100 SXM's data-sheet figures (``launch.analytic``):
989e12 dense bf16 FLOP/s for the models, 67e12 fp32 FLOP/s for the
sketch path (it computes in IEEE fp32), 3.35e12 B/s of HBM, 450e9 B/s of
NVLink each way (the collective term a lower bound).  Every number here
is arithmetic; none is a measurement.

  PYTHONPATH=src python -m repro_torch.benchmarks.roofline [--full]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

from repro_torch.launch import analytic
from repro_torch.launch.analytic import HBM_BW, NVLINK_BW, PEAK_FLOPS
from repro_torch.models.registry import SHAPES, get_bundle, get_config

FP32_FLOPS = 67e12            # H100 SXM data sheet, fp32 (no tensor cores)
SRC = Path(__file__).resolve().parents[2]


def sketch_gram_intensity(k: int, n: int, d: int, b: int,
                          k_live: int = None) -> dict:
    """(flops, HBM bytes) of the sketch -> Gram hot path at K blocks of b
    rows (``k_live`` of them surviving) over an (n, d) fp32 A.

    * fused (``kernels.ops.sketch_gram_count``): per chunk of blocks the
      strip-walking apply of the live blocks (``csrc/count_sketch.cu``: A
      from HBM about once, its K re-reads from L2) into an A_tilde
      scratch, then the masked Gram (the upper triangle, b d (d + 1) a
      block) reading it back: A once, the codes once, A_tilde written and
      read once, G written once.  At the paths' widths one chunk holds
      every block (``CHUNK_BYTES``).
    * unfused (``count_sketch_apply`` then ``oversketch_gram``): every
      block sketched, masked ones too, A_tilde written whole, then read
      by the Gram's live blocks.
    """
    k_live = k if k_live is None else k_live
    gram_fl = float(k_live) * b * d * (d + 1)
    a_read, codes, g_out = 4.0 * n * d, 4.0 * 2 * k * n, 4.0 * d * d
    return {
        "fused": (2.0 * k_live * n * d + gram_fl,
                  a_read + codes + 2 * 4.0 * k_live * b * d + g_out + k),
        "unfused": (2.0 * k * n * d + gram_fl,
                    a_read + codes + 4.0 * k * b * d +
                    4.0 * k_live * b * d + g_out + k),
    }


def dryrun_cell(arch: str = "qwen3-4b", shape: str = "train_4k",
                mesh: str = "4x2") -> dict:
    """One reduced dry-run cell (smoke config, fake mesh) in a subprocess
    -> its analyze() record."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "cell.json")
        env = dict(os.environ, PYTHONPATH=str(SRC))
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--smoke", "--mesh", mesh,
             "--json-out", out], capture_output=True, text=True, env=env,
            timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"dry run failed: {proc.stderr[-2000:]}")
        with open(out) as f:
            return json.load(f)[0]


def run(quick: bool = True):
    rows = []
    cell = dryrun_cell()
    t = cell["roofline_seconds"]
    # The bound and its time from the counted compute and collective terms
    # and the analytic HBM term; the unfused bytes' term is an upper bound
    # and names nothing.
    bound = {k: t[k] for k in ("compute", "memory", "collective")}
    rows.append({
        "name": "roofline_dryrun_qwen3-4b_train_4k_smoke_4x2",
        "us": max(bound.values()) * 1e6,
        "derived": (f"bound={cell['bottleneck']};"
                    f"c_ms={t['compute']*1e3:.3f};m_ms={t['memory']*1e3:.3f}"
                    f";m_unfused_upper_ms="
                    f"{t['memory_unfused_upper_bound']*1e3:.3f}"
                    f";x_ms={t['collective']*1e3:.3f};"
                    f"flops_ratio={cell['analytic']['flops_ratio']:.3f};"
                    f"counted_over_expected="
                    f"{cell['analytic']['counted_over_expected']:.3f}")})
    ridge = FP32_FLOPS / HBM_BW
    for kk, nn, dd, bb, live, suffix in (
            (150, 300_000, 3_000, 256, 120, ""),
            (10, 300_000, 3_000, 4_096, 10, "_distavg")):
        cell = sketch_gram_intensity(kk, nn, dd, bb, live)
        for tag in ("fused", "unfused"):
            flops, byts = cell[tag]
            ai = flops / byts
            rows.append({
                "name": f"roofline_sketch_gram_{tag}{suffix}",
                "us": max(byts / HBM_BW, flops / FP32_FLOPS) * 1e6,
                "path": tag,
                "derived": (f"bound={'compute' if ai >= ridge else 'memory'}"
                            f";ai={ai:.1f};ridge={ridge:.1f};"
                            f"hbm_mb={byts/1e6:.1f};gflop={flops/1e9:.1f};"
                            f"shape=({kk},{nn},{dd},{bb});live={live}")})
    if quick:
        archs = ["qwen3-4b", "qwen3-moe-235b-a22b", "mamba2-780m"]
    else:
        from repro_torch.configs import ASSIGNED_ARCHS
        archs = list(ASSIGNED_ARCHS)
    for arch in archs:
        cfg = get_config(arch)
        bundle = get_bundle(arch)
        for shape_name, shape in SHAPES.items():
            if not bundle.supports(shape)[0]:
                continue
            costs = analytic.cell_costs(cfg, shape, 256)
            terms = {"c": costs.flops_per_chip / PEAK_FLOPS,
                     "m": costs.hbm_bytes_per_chip / HBM_BW,
                     "x": costs.coll_bytes_per_chip / NVLINK_BW}
            rows.append({
                "name": f"roofline_{arch}_{shape_name}",
                "us": max(terms.values()) * 1e6,
                "derived": (f"bound={max(terms, key=terms.get)};"
                            f"c_ms={terms['c']*1e3:.2f};"
                            f"m_ms={terms['m']*1e3:.2f};"
                            f"x_ms={terms['x']*1e3:.2f}")})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="every architecture, not three")
    args = ap.parse_args(argv)
    for r in run(quick=not args.full):
        print(f"{r['name']},{r['us']:.1f},{r['derived']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
