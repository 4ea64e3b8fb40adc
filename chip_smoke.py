#!/usr/bin/env python3
"""Drive the torch port's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the root of a checkout.  Phases, each printed as one JSON line
with its seconds:

  device   the card (nvidia-smi name and power limit), torch and CUDA
  build    nvcc builds every kernel of src/repro_torch/kernels/csrc
  data     the paper's synthetic profile at full width on the card
           (n = 300,000, d = 3,000, 100,000 test rows)
  kernels  each CUDA kernel against its plain PyTorch version at its
           path's own inputs (A = hess_sqrt(w0) and the first iteration's
           draw of the path's sketch family: b = 256 and 30 of 150 blocks
           masked for the blocks paths, the masked Gram at the nystrom
           family's A_tilde, b = 4,096 and K = 10 for distributed-avg,
           whose SJLT apply is the count-sketch kernel with s = 4 layers,
           one signed, padded (2^19, 3,000) block for the FWHT, the coded
           mat-vec at both product-code encodes (X: 1,296 workers of
           (256, 3,000); X^T: 25 of (256, 300,000)) with 5% of the workers
           erased, the normal kernel at one gaussian block (300,000 x 256),
           bit for bit, with its table's one-off build, and the draw
           kernel at the main path's and nystrom's draws, bit for bit:
           randint (150, 300,000) in [0, 256), rademacher of that shape,
           randint (150, 256) in [0, 300,000)), plus small cases
           (ragged, all masked, a non-power-of-two n, b = 4,096, the
           one-pass FWHT, and skewed codes for the segment-sum kernels:
           one bucket, half the buckets empty, out-of-range buckets, sigma
           other than +-1); times of
           kernel, plain version and a PyTorch yardstick, and the bound the
           card's peaks give.  The segment-sum apply's two phases (the sort
           by bucket, then the gather) are timed apart from a profiler
           trace of three launches, as are the masked Gram's tile and
           reduce kernels and the SRHT call's partial transform and Gram;
           the SJLT Gram's apply and Gram halves by their own calls, and
           the two-pass FWHT's local and across passes beside its
           two-pass HBM floor.  Each segment-sum kernel, the masked Gram,
           the SRHT Gram, the coded mat-vec and the two-pass FWHT are
           launched twice for the same bits, and the Grams must equal
           their transposes exactly
  newton   oversketched_newton at full width with the kernels, 3
           iterations (the oversketch family); launch counts read just
           before and after
  profile  the same call with 2 iterations under torch.profiler: device
           time by operator, the draw kernel's, and the device's idle
           share; then the sjlt family's 2 iterations the same way
  families the same loop with the sjlt, srht, nystrom, leverage and
           gaussian families, 2 iterations each, launch counts read around
           each run
  distavg  sketch_mode="distributed-avg" with debias, b = 4,096 > d, for the
           oversketch, sjlt and srht families, 2 iterations each
  check    the loop at the verify recipe's size on the card against the
           plain path on the CPU: every family in blocks mode and
           distributed-avg (b = 64 > d = 20), with the card runs' launch
           counts (the one-pass FWHT runs there, at n_pad = 1,024)

Every run on the card computes its coded gradient with the coded mat-vec
kernel: two launches per iteration, as the default fleet's coded_decode
policy waits for a peelable set and no decode falls back.

Then the kernel summary line, the nvidia-smi line, and last
{"ok": true, "device": {...}}.  Any failed check raises: the script then
exits nonzero before the last line.  Without a CUDA device, or outside a
checkout, it exits nonzero and prints no result.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# Published H100 SXM peaks (dense, no sparsity): fp32 outside the tensor
# cores, and HBM3 bandwidth.
FP32_FLOPS = 67e12
# One fp32 addition a lane a clock: half of FP32_FLOPS, which counts an FMA
# as two operations.
FP32_ADDS = 33.5e12
# The SRHT kernel's panel rows P and column strip w
# (src/repro_torch/kernels/csrc/sketch_gram_srht.cu: SP, SW).
SRHT_PANEL = 256
SRHT_STRIP = 32
HBM_BYTES_PER_S = 3.35e12
REL_TOL = 1e-4          # kernel vs plain, relative to max |plain|
ITERS = 3
PATH_ITERS = 2          # iterations of each further path
SEED = 0
BLOCK = 256             # b of the blocks paths
DISTAVG_BLOCK = 4096    # b > d = 3,000, as distributed-avg requires
CODED_ERASED = 0.05     # share of coded workers erased in the kernel check
# One 32-bit integer instruction a lane a clock on the INT32 lanes: 64 of
# the SM's 128 a clock, half of FP32_ADDS.
INT32_OPS = 16.7e12
# SASS instructions of one threefry2x32 hash (csrc/threefry.cuh) in the
# draw kernel's BITS loop, counted with cuobjdump -sass
# (scripts/count_sass.py): 68, that is 20 funnel shifts, 21 xors (LOP3),
# 10 IADD3 and 17 IMAD.IADD (the rounds' adds, the key schedule folded
# in); the loop's other 9 are the counter, the address, the store and the
# branch.  Hopper issues IMAD on the FMA pipe beside the INT32 lanes, so
# the lanes carry 51 a hash: the bound counts those at INT32_OPS (all 68
# at the issue rate, 2 x INT32_OPS, take less).
HASH_INT_OPS = 51
# The segment-sum apply's two phases, timed apart where a row has them,
# and the launches of the profiler trace they were read from.
PHASES = ("sort_ms", "gather_ms", "launches_traced")
# The two-pass FWHT's passes, timed apart.
FWHT_PASSES = ("local_pass_ms", "across_pass_ms")
# Kernels that no ported path launches, and why; every other kernel must
# be launched by some path's run.
OFF_PATH = {"fwht": "at full width (n_pad = 2^19) the fwht entry point "
                    "dispatches to fwht_two_pass; its one-pass kernel runs "
                    "where n_pad <= 4,096, as in the check phase"}


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def clocks() -> str:
    """The card's SM and memory clocks, power draw and temperature now."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw,"
         "temperature.gpu", "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()


def cuda_ms(fn, reps: int, warm: bool = True) -> float:
    """Mean device milliseconds of fn over reps runs, after one warm-up
    (skipped when the code path has just run)."""
    import torch
    if warm:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(ops: float, nbytes: float, rate: float = FP32_FLOPS) -> tuple:
    """(ms, by): the larger of ops at ``rate`` (fp32 operations, or
    INT32_OPS for integer instructions) and nbytes at HBM_BYTES_PER_S."""
    t_ops, t_bytes = ops / rate * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def timed_once(fn):
    """(fn's result, its device milliseconds): one call, for plain versions
    too slow to repeat; its code path has run before (warm)."""
    import torch
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def compare(name: str, got, want, zero_ok: bool = False) -> dict:
    """Kernel output against its plain version: max abs error, relative to
    max |plain|, and how many entries differ at all.  A plain output that
    is all zero passes only where it must be (an all-masked case)."""
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    if scale == 0 and not zero_ok:
        raise AssertionError(f"{name}: the plain version is all zero")
    rel = err / scale if scale > 0 else err
    if not math.isfinite(rel) or rel > REL_TOL:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version: max_abs_err {err}, relative {rel}")
    return {"max_abs_err": err, "rel_err": rel, "max_abs_plain": scale,
            "entries_differing": int((got != want).sum())}


def same_bits(name: str, fn, got) -> bool:
    """A second launch of a kernel must give the first one's bits."""
    import torch
    if not torch.equal(fn(), got):
        raise AssertionError(f"{name}: two launches differ")
    return True


def symmetric(name: str, g) -> bool:
    """A Gram kernel's output must equal its transpose, bit for bit."""
    import torch
    if not torch.equal(g, g.T):
        raise AssertionError(f"{name}: G is not exactly symmetric")
    return True


def gram_slices(b: int, k: int, d: int) -> int:
    """The slices the masked Gram cuts k blocks of b rows into on this
    card (kernels/oversketch_matmul.py)."""
    import torch
    from repro_torch.kernels import oversketch_matmul
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return oversketch_matmul.gram_slices(k * b, d, sms)


def dev_us(e) -> float:
    """A profiler event's own device microseconds."""
    return float(getattr(e, "self_device_time_total", 0.0) or 0.0)


# Kernel names of the apply's sort (with its memset) and its gather.
SORT_KERNELS = ("cs_hist", "cs_scan", "cs_scatter", "Memset")
# The masked Gram's three kernels (sketch_common.cuh, launch_gram).
GRAM_KERNELS = ("gram_live", "sketch::gram_kernel", "gram_reduce")


def traced_ms(fn, groups: dict, reps: int = 3) -> dict:
    """Device ms of groups of kernels, read by name from a torch.profiler
    trace of reps calls of fn: for each group, the sum over its kernels of
    each kernel's mean over the launches the trace holds, and the launches
    of the group's first kernel traced.  On the H100 machine a trace taken
    after two others in one process can miss the first launch (a single
    launch then leaves none), so each row says how many it held."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(0.25)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        time.sleep(0.25)
    us, counts = {}, {}
    names = [t for ts in groups.values() for t in ts]
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = next((t for t in names if t in e.key), None)
        if name is not None:
            us[name] = us.get(name, 0.0) + dev_us(e)
            counts[name] = counts.get(name, 0) + e.count
    out = {}
    for label, ts in groups.items():
        if any(counts.get(t, 0) == 0 for t in ts if t != "Memset"):
            raise AssertionError(f"the profiler traced none of some of "
                                 f"{label}'s kernels: {counts}")
        out[label] = sum(us[t] / counts[t] for t in ts if t in us) / 1e3
        out[label.replace("_ms", "_launches_traced")] = counts[ts[0]]
    return out


def phase_times(h, sigma, a, b, reps: int = 3) -> dict:
    """The apply's two phases apart (traced_ms): the sort by bucket (its
    memset and the histogram, scan and scatter kernels) and the gather."""
    from repro_torch.kernels import ops
    t = traced_ms(lambda: ops.count_sketch_apply(h, sigma, a, b),
                  {"gather_ms": ("cs_gather",), "sort_ms": SORT_KERNELS},
                  reps)
    return {"sort_ms": t["sort_ms"], "gather_ms": t["gather_ms"],
            "launches_traced": t["gather_launches_traced"]}


def sketch_matrix(h, sigma, live, b: int, n: int):
    """The live blocks' count sketches as one sparse (live*b, n) matrix."""
    import torch
    hl, sl = h[live].long(), sigma[live]
    rows = (torch.arange(hl.shape[0], device=h.device)[:, None] * b
            + hl).reshape(-1)
    cols = torch.arange(n, device=h.device).repeat(hl.shape[0])
    coo = torch.sparse_coo_tensor(torch.stack([rows, cols]), sl.reshape(-1),
                                  (hl.shape[0] * b, n),
                                  check_invariants=False)
    return coo.coalesce().to_sparse_csr()


def check_kernels(ops, ref, h, sigma, a, mask, b) -> dict:
    """Each kernel against its plain version at the main path's inputs."""
    import torch
    k, n = h.shape
    d = a.shape[1]
    live = mask.nonzero().squeeze(1)
    kl = int(live.numel())
    out = {}

    # count_sketch_apply: every block, no mask.
    got = ops.count_sketch_apply(h, sigma, a, b)
    a_t = ref.count_sketch_apply(h, sigma, a, b)
    row = compare("count_sketch_apply", got, a_t)
    row["bit_identical"] = same_bits(
        "count_sketch_apply", lambda: ops.count_sketch_apply(h, sigma, a, b),
        got)
    del got
    row["ms"] = cuda_ms(lambda: ops.count_sketch_apply(h, sigma, a, b), 3)
    row.update(phase_times(h, sigma, a, b))
    row["plain_ms"] = cuda_ms(lambda: ref.count_sketch_apply(h, sigma, a, b), 1)
    s_all = sketch_matrix(h, sigma, torch.arange(k, device=h.device), b, n)
    row["library_ms"] = cuda_ms(lambda: torch.sparse.mm(s_all, a), 3)
    row["library_call"] = "torch.sparse.mm(CSR sketch (K*b, n), A)"
    del s_all
    row["bound_ms"], row["bound_by"] = bound(
        2.0 * k * n * d, 4.0 * (n * d + 2 * k * n + k * b * d))
    out["count_sketch_apply"] = row

    # oversketch_gram: the plain A_tilde, 30 blocks masked.  The kernel
    # computes the upper triangle of the symmetric output: b d (d+1) per
    # live block.
    got = ops.oversketch_gram(a_t, mask)
    row = compare("oversketch_gram", got, ref.oversketch_gram(a_t, mask))
    row["ms"] = cuda_ms(lambda: ops.oversketch_gram(a_t, mask), 5)
    row["plain_ms"] = cuda_ms(lambda: ref.oversketch_gram(a_t, mask), 3)
    x_live = a_t[live].reshape(-1, d)
    row["library_ms"] = cuda_ms(lambda: torch.mm(x_live.T, x_live), 5)
    row["library_call"] = "torch.mm(A_live^T, A_live)"
    del x_live
    row["bound_ms"], row["bound_by"] = bound(
        float(kl) * b * d * (d + 1), 4.0 * (kl * b * d + d * d) + k)
    out["oversketch_gram"] = row

    # sketch_gram_count: the fused path, as the main path calls it.
    got = ops.sketch_gram_count(h, sigma, a, b, mask)
    row = compare("sketch_gram_count", got, ref.oversketch_gram(a_t, mask))
    row["bit_identical"] = same_bits(
        "sketch_gram_count",
        lambda: ops.sketch_gram_count(h, sigma, a, b, mask), got)
    del a_t
    row["ms"] = cuda_ms(lambda: ops.sketch_gram_count(h, sigma, a, b, mask), 3)
    row["plain_ms"] = cuda_ms(
        lambda: ref.sketch_gram_count(h, sigma, a, b, mask), 1)
    s_live = sketch_matrix(h, sigma, live, b, n)

    def library():
        x = torch.sparse.mm(s_live, a)
        return torch.mm(x.T, x)
    row["library_ms"] = cuda_ms(library, 3)
    row["library_call"] = "torch.sparse.mm then torch.mm"
    del s_live
    row["bound_ms"], row["bound_by"] = bound(
        float(kl) * (2.0 * n * d + b * d * (d + 1)),
        4.0 * (n * d + 2 * kl * n + d * d) + k)
    out["sketch_gram_count"] = row
    return out


def sjlt_matrix(h, sigma, live, b: int, n: int):
    """The live blocks' SJLT sketches as one sparse (live*b, n) matrix, s
    entries of +-1/sqrt(s) per column and block (repeats summed)."""
    import torch
    hl, sl = h[live].long(), sigma[live]
    kl, s, _ = hl.shape
    rows = (torch.arange(kl, device=h.device)[:, None, None] * b
            + hl).reshape(-1)
    cols = torch.arange(n, device=h.device).repeat(kl * s)
    coo = torch.sparse_coo_tensor(torch.stack([rows, cols]),
                                  sl.reshape(-1) / math.sqrt(s),
                                  (kl * b, n), check_invariants=False)
    return coo.coalesce().to_sparse_csr()


def srht_encode(rows_k, sigma_k, n: int):
    """One block's dense (n, b) SRHT encode matrix, sigma_r (-1)^popcount(
    r & rows_c) / sqrt(b), with the parity folded out of r & rows_c."""
    import torch
    v = torch.arange(n, dtype=torch.int32, device=rows_k.device)[:, None] \
        & rows_k[None, :]
    for sh in (16, 8, 4, 2, 1):
        v = v ^ (v >> sh)
    sign = 1.0 - 2.0 * (v & 1).float()
    return sign * (sigma_k[:, None] / math.sqrt(rows_k.numel()))


def srht_bound(n: int, d: int, b: int, k: int, kl: int) -> tuple:
    """The SRHT Gram's bound: (ms, by, P, additions).  Per live block the
    partial transform through panels of P rows, counted only over the
    ceil(n / P) panels that hold real rows: a length-P butterfly (log2 P
    additions an element) and one addition per sample, column and panel
    (b / P an element), at the cheapest P, each at the fp32 lane rate; the
    Gram's b d (d + 1) operations at FP32_FLOPS; against one read of A,
    the signs and the rows, and the mask, and one write of G."""
    n_pad = 1 << max(0, (n - 1).bit_length())

    def adds(p: int) -> float:
        panels = -(-n // p)
        return float(kl) * d * panels * (p * math.log2(p) + b)
    p_best = min((1 << e for e in range(1, n_pad.bit_length())), key=adds,
                 default=1)
    t_ops = (adds(p_best) / FP32_ADDS
             + float(kl) * b * d * (d + 1) / FP32_FLOPS) * 1e3
    t_bytes = (4.0 * (n * d + kl * (n + b) + d * d) + k) / HBM_BYTES_PER_S \
        * 1e3
    if t_ops >= t_bytes:
        return t_ops, "operations", p_best, adds(p_best)
    return t_bytes, "bytes", p_best, adds(p_best)


def check_family_kernels(ops, ref, a, sjlt, srht, mask, b) -> dict:
    """The fused SJLT and SRHT Grams against their plain versions at the
    main path's inputs (A, each family's first-iteration draw, the mask)."""
    import torch
    n, d = a.shape
    k = mask.numel()
    live = mask.nonzero().squeeze(1)
    kl = int(live.numel())
    out = {}

    h, sg = sjlt["h"], sjlt["sigma"]
    s = h.shape[1]
    got = ops.sketch_gram_sjlt(h, sg, a, b, mask)
    want, plain_ms = timed_once(lambda: ref.sketch_gram_sjlt(h, sg, a, b,
                                                             mask))
    row = compare("sketch_gram_sjlt", got, want)
    row["bit_identical"] = same_bits(
        "sketch_gram_sjlt", lambda: ops.sketch_gram_sjlt(h, sg, a, b, mask),
        got)
    del got, want
    row["ms"] = cuda_ms(lambda: ops.sketch_gram_sjlt(h, sg, a, b, mask), 3,
                        warm=False)
    row["plain_ms"] = plain_ms
    s_live = sjlt_matrix(h, sg, live, b, n)

    def library():
        x = torch.sparse.mm(s_live, a)
        return torch.mm(x.T, x)
    row["library_ms"] = cuda_ms(library, 3)
    row["library_call"] = "torch.sparse.mm(CSR SJLT (K_live*b, n), A) then torch.mm"
    del s_live
    row["bound_ms"], row["bound_by"] = bound(
        float(kl) * (2.0 * s * n * d + b * d * (d + 1)),
        4.0 * (n * d + 2 * kl * s * n + d * d) + k)
    out["sketch_gram_sjlt"] = row

    # The fused call's two halves apart: the layered apply of its live
    # blocks (count_sketch_apply on their (K_live, s, n) codes, the same
    # sort and gather), then the Gram of that A_tilde.
    hl, sl = h[live].contiguous(), sg[live].contiguous()
    a_t = ops.count_sketch_apply(hl, sl, a, b)
    want, plain_ms = timed_once(lambda: ref.sjlt_apply(hl, sl, a, b))
    app = compare("count_sketch_apply sjlt b=256", a_t, want)
    del want
    app["bit_identical"] = same_bits(
        "count_sketch_apply sjlt b=256",
        lambda: ops.count_sketch_apply(hl, sl, a, b), a_t)
    app["ms"] = cuda_ms(lambda: ops.count_sketch_apply(hl, sl, a, b), 3)
    app.update(phase_times(hl, sl, a, b))
    app["plain_ms"] = plain_ms
    s_live = sjlt_matrix(h, sg, live, b, n)
    app["library_ms"] = cuda_ms(lambda: torch.sparse.mm(s_live, a), 3)
    app["library_call"] = "torch.sparse.mm(CSR SJLT (K_live*b, n), A)"
    del s_live
    app["bound_ms"], app["bound_by"] = bound(
        2.0 * kl * s * n * d, 4.0 * (n * d + 2 * kl * s * n + kl * b * d))
    app["shape"] = {"K": kl, "s": s, "n": n, "d": d, "b": b}
    out["sjlt_apply"] = app
    ones = torch.ones(kl, dtype=torch.bool, device=a.device)
    gram = compare("oversketch_gram sjlt A_tilde", ops.oversketch_gram(
        a_t, ones), ref.oversketch_gram(a_t, ones))
    gram["ms"] = cuda_ms(lambda: ops.oversketch_gram(a_t, ones), 3)
    gram["plain_ms"] = cuda_ms(lambda: ref.oversketch_gram(a_t, ones), 3)
    x_live = a_t.reshape(-1, d)
    gram["library_ms"] = cuda_ms(lambda: torch.mm(x_live.T, x_live), 3)
    gram["bound_ms"], gram["bound_by"] = bound(
        float(kl) * b * d * (d + 1), 4.0 * (kl * b * d + d * d) + kl)
    gram["shape"] = {"K": kl, "b": b, "d": d}
    out["sjlt_gram"] = gram
    del a_t, x_live, hl, sl
    torch.cuda.empty_cache()

    rows, sg = srht["rows"], srht["sigma"]
    got = ops.sketch_gram_srht(rows, sg, a, mask)
    want, plain_ms = timed_once(lambda: ref.sketch_gram_srht(rows, sg, a,
                                                             mask))
    row = compare("sketch_gram_srht", got, want)
    row["bit_identical"] = same_bits(
        "sketch_gram_srht", lambda: ops.sketch_gram_srht(rows, sg, a, mask),
        got)
    row["symmetric"] = symmetric("sketch_gram_srht", got)
    del got, want
    row["ms"] = cuda_ms(lambda: ops.sketch_gram_srht(rows, sg, a, mask), 2,
                        warm=False)
    # The partial transform and the Gram apart: each kernel's mean over the
    # launches traced, times the chunks of one call.
    t = traced_ms(lambda: ops.sketch_gram_srht(rows, sg, a, mask),
                  {"transform_ms": ("srht_panel",), "gram_ms": GRAM_KERNELS},
                  reps=2)
    from repro_torch.kernels import sketch_gram
    chunks = -(-k // sketch_gram.chunk_blocks(k, b, d))
    row["transform_ms"] = t["transform_ms"] * chunks
    row["gram_ms"] = t["gram_ms"] * chunks
    row["chunks"], row["launches_traced"] = chunks, \
        t["transform_launches_traced"]
    row["plain_ms"] = plain_ms

    def library():
        x = torch.cat([srht_encode(rows[j], sg[j], n).T @ a
                       for j in live.tolist()])
        return torch.mm(x.T, x)
    row["library_ms"] = cuda_ms(library, 1)
    row["library_call"] = ("per live block torch.mm(dense encode^T, A), "
                           "then torch.mm")
    row["bound_ms"], row["bound_by"], row["bound_P"], row["adds"] = \
        srht_bound(n, d, b, k, kl)
    row["kernel_P"], row["kernel_w"] = SRHT_PANEL, SRHT_STRIP
    out["sketch_gram_srht"] = row
    return out


def fwht_pass_ms(x) -> tuple:
    """Device ms of the two-pass FWHT's local and across passes, each
    launched alone through csrc/fwht.cu's fwht_two_pass_step_launch, with
    n = n1 n2 split as fwht_two_pass splits it.  These launches are
    measurements: they do not count as the kernel's."""
    import ctypes
    import torch
    from repro_torch.kernels import srht
    step = srht.TWO_PASS_KERNEL.host_function(
        "fwht_two_pass_step_launch",
        [ctypes.c_void_p] * 2 + [ctypes.c_longlong, ctypes.c_int,
                                 ctypes.c_longlong, ctypes.c_float,
                                 ctypes.c_void_p])
    k, n, d = x.shape
    n1 = 1 << (n.bit_length() - 1) // 2
    n2 = n // n1
    out = torch.empty_like(x)
    st = torch.cuda.current_stream().cuda_stream

    def run(*args):
        err = step(*args, st)
        if err:
            raise RuntimeError(f"fwht_two_pass_step_launch: CUDA error {err}")
    local = cuda_ms(lambda: run(x.data_ptr(), out.data_ptr(), k * n1, n2,
                                d, 1.0), 3)
    across = cuda_ms(lambda: run(out.data_ptr(), out.data_ptr(), k, n1,
                                 n2 * d, math.sqrt(n)), 3)
    return local, across


def check_fwht(ops, ref, a, sigma_k) -> dict:
    """The FWHT on one signed, padded (2^19, d) block, as the distributed-
    avg SRHT path transforms it: there the fwht entry point takes the two-
    pass kernel (row fwht_two_pass; the fwht entry is checked at that n
    too).  Row fwht is the one-pass kernel, on the block's first 4,096
    rows, the most one pass takes."""
    import torch
    n, d = a.shape
    n_pad = 1 << (n - 1).bit_length()
    x = a.new_zeros((1, n_pad, d))
    torch.mul(a, sigma_k[:, None], out=x[0, :n])
    want, plain_ms = timed_once(lambda: ref.fwht(x))
    got = ops.fwht_two_pass(x)
    row = compare("fwht_two_pass", got, want)
    row["same_bits"] = same_bits("fwht_two_pass",
                                 lambda: ops.fwht_two_pass(x), got)
    del got
    row["ms"] = cuda_ms(lambda: ops.fwht_two_pass(x), 3, warm=False)
    row["plain_ms"] = plain_ms
    row["library_ms"] = None
    row["library_call"] = "none: PyTorch has no Hadamard transform"
    row["bound_ms"], row["bound_by"] = bound(
        float(n_pad) * math.log2(n_pad) * d, 8.0 * n_pad * d)
    # Two passes must each read and write the block once.
    row["floor_ms"] = 16.0 * n_pad * d / HBM_BYTES_PER_S * 1e3
    row["local_pass_ms"], row["across_pass_ms"] = fwht_pass_ms(x)
    row["clocks_after"] = clocks()
    row["fwht_entry_max_abs_err"] = compare("fwht at 2^19", ops.fwht(x),
                                            want)["max_abs_err"]
    out = {"fwht_two_pass": row}
    del want
    n1 = 4096
    x1 = x[:, :n1].contiguous()
    del x
    w1, p1 = timed_once(lambda: ref.fwht(x1))
    one = compare("fwht", ops.fwht(x1), w1)
    one["ms"] = cuda_ms(lambda: ops.fwht(x1), 5, warm=False)
    one["plain_ms"] = p1
    one["library_ms"] = None
    one["library_call"] = "none: PyTorch has no Hadamard transform"
    one["bound_ms"], one["bound_by"] = bound(
        float(n1) * math.log2(n1) * d, 8.0 * n1 * d)
    one["shape"] = [1, n1, d]
    out["fwht"] = one
    return out


def check_large_block(ops, ref, a, cs, sj, b) -> dict:
    """count_sketch_apply and sketch_gram_count at b = 4,096 (the sorted-
    gather apply) on the distributed-avg path's first draw (K = 10), and
    count_sketch_apply's layered form on the SJLT draw (K = 10, s = 4), as
    the distributed-avg SJLT path applies it; the sort timed apart from the
    gather, and each kernel launched twice for the same bits."""
    import torch
    n, d = a.shape
    out = {}
    h, sg = sj["h"], sj["sigma"]
    k, s, _ = h.shape
    want, plain_ms = timed_once(lambda: ref.sjlt_apply(h, sg, a, b))
    got = ops.count_sketch_apply(h, sg, a, b)
    row = compare("count_sketch_apply sjlt b=4096", got, want)
    del want
    row["bit_identical"] = same_bits(
        "count_sketch_apply sjlt b=4096",
        lambda: ops.count_sketch_apply(h, sg, a, b), got)
    del got
    row["ms"] = cuda_ms(lambda: ops.count_sketch_apply(h, sg, a, b), 3,
                        warm=False)
    row.update(phase_times(h, sg, a, b))
    row["plain_ms"] = plain_ms
    s_all = sjlt_matrix(h, sg, torch.arange(k, device=h.device), b, n)
    row["library_ms"] = cuda_ms(lambda: torch.sparse.mm(s_all, a), 3)
    row["library_call"] = "torch.sparse.mm(CSR SJLT (K*b, n), A)"
    del s_all
    row["bound_ms"], row["bound_by"] = bound(
        2.0 * k * s * n * d, 4.0 * (n * d + 2 * k * s * n + k * b * d))
    row["shape"] = {"K": k, "s": s, "n": n, "d": d, "b": b}
    out["count_sketch_apply_sjlt"] = row

    h, sg = cs.h, cs.sigma
    k = h.shape[0]
    mask = torch.ones(k, dtype=torch.bool, device=a.device)
    mask[k // 2] = False
    want, plain_ms = timed_once(lambda: ref.count_sketch_apply(h, sg, a, b))
    got = ops.count_sketch_apply(h, sg, a, b)
    row = compare("count_sketch_apply b=4096", got, want)
    row["bit_identical"] = same_bits(
        "count_sketch_apply b=4096",
        lambda: ops.count_sketch_apply(h, sg, a, b), got)
    del got
    row["ms"] = cuda_ms(lambda: ops.count_sketch_apply(h, sg, a, b), 3,
                        warm=False)
    row.update(phase_times(h, sg, a, b))
    row["plain_ms"] = plain_ms
    s_all = sketch_matrix(h, sg, torch.arange(k, device=h.device), b, n)
    row["library_ms"] = cuda_ms(lambda: torch.sparse.mm(s_all, a), 3)
    row["library_call"] = "torch.sparse.mm(CSR sketch (K*b, n), A)"
    del s_all
    row["bound_ms"], row["bound_by"] = bound(
        2.0 * k * n * d, 4.0 * (n * d + 2 * k * n + k * b * d))
    row["shape"] = {"K": k, "n": n, "d": d, "b": b}
    out["count_sketch_apply"] = row
    s_live = sketch_matrix(h, sg, mask.nonzero().squeeze(1), b, n)

    def library():
        x = torch.sparse.mm(s_live, a)
        return torch.mm(x.T, x)
    gwant, gplain_ms = timed_once(lambda: ref.oversketch_gram(want, mask))
    del want
    kl = k - 1
    got = ops.sketch_gram_count(h, sg, a, b, mask)
    row = compare("sketch_gram_count b=4096", got, gwant)
    row["bit_identical"] = same_bits(
        "sketch_gram_count b=4096",
        lambda: ops.sketch_gram_count(h, sg, a, b, mask), got)
    del got
    row["ms"] = cuda_ms(lambda: ops.sketch_gram_count(h, sg, a, b, mask), 3,
                        warm=False)
    row["plain_ms"] = plain_ms + gplain_ms
    row["library_ms"] = cuda_ms(library, 3)
    del s_live
    row["bound_ms"], row["bound_by"] = bound(
        float(kl) * (2.0 * n * d + b * d * (d + 1)),
        4.0 * (n * d + 2 * kl * n + d * d) + k)
    out["sketch_gram_count"] = row
    return out


def check_skewed(ops, ref, device, g) -> dict:
    """The segment-sum kernels on skewed codes, at b = 32 and b = 4,096:
    every row in one bucket, half of the buckets empty, a third of the
    codes outside [0, b) (dropped: the plain versions take them with sigma
    0), and sigma of any value (uniform in [-2, 2), an eighth of it 0: the
    kernels multiply by sigma as the plain versions do).  Layers 1-3 repeat
    layer 0's bucket on a quarter of the rows."""
    import torch
    k, n, d = 5, 3001, 45
    a = torch.randn(n, d, generator=g).to(device)
    mask = (torch.arange(k) != 2).to(device)
    errs = {}
    for b in (32, 4096):
        for kind in ("one_bucket", "half_empty", "out_of_range",
                     "sigma_values"):
            if kind == "one_bucket":
                h = torch.full((k, 4, n), b // 3, dtype=torch.int32)
            elif kind == "half_empty":
                h = 2 * torch.randint(0, b // 2, (k, 4, n), generator=g,
                                      dtype=torch.int32)
            elif kind == "out_of_range":
                h = torch.randint(-(b // 3), b + b // 3, (k, 4, n),
                                  generator=g, dtype=torch.int32)
            else:
                h = torch.randint(0, b, (k, 4, n), generator=g,
                                  dtype=torch.int32)
            h[:, 1:, : n // 4] = h[:, :1, : n // 4]
            h = h.to(device)
            if kind == "sigma_values":
                sg = torch.rand(k, 4, n, generator=g) * 4 - 2
                sg[torch.rand(k, 4, n, generator=g) < 0.125] = 0.0
            else:
                sg = torch.randint(0, 2, (k, 4, n), generator=g).float()
                sg = sg * 2 - 1
            sg = sg.to(device)
            keep = (h >= 0) & (h < b)
            hc, sc = torch.where(keep, h, 0), torch.where(keep, sg, 0.0)
            h1, s1 = h[:, 0].contiguous(), sg[:, 0].contiguous()
            label = f"b{b}_{kind}"
            errs[label] = {
                "count_sketch_apply": compare(
                    label, ops.count_sketch_apply(h1, s1, a, b),
                    ref.count_sketch_apply(hc[:, 0], sc[:, 0], a,
                                           b))["max_abs_err"],
                "count_sketch_apply_sjlt": compare(
                    label, ops.count_sketch_apply(h, sg, a, b),
                    ref.sjlt_apply(hc, sc, a, b))["max_abs_err"],
                "sketch_gram_count": compare(
                    label, ops.sketch_gram_count(h1, s1, a, b, mask),
                    ref.sketch_gram_count(hc[:, 0], sc[:, 0], a, b,
                                          mask))["max_abs_err"],
                "sketch_gram_sjlt": compare(
                    label, ops.sketch_gram_sjlt(h, sg, a, b, mask),
                    ref.sketch_gram_sjlt(hc, sc, a, b, mask))["max_abs_err"]}
    return errs


def check_small_cases(ops, ref, device) -> dict:
    """A ragged case and an all-masked case for every kernel, and the
    segment-sum kernels on skewed codes."""
    import torch
    g = torch.Generator().manual_seed(SEED)
    k, n, d, b = 10, 1001, 37, 32
    h = torch.randint(0, b, (k, n), generator=g, dtype=torch.int32).to(device)
    sigma = (torch.randint(0, 2, (k, n), generator=g).float() * 2 - 1).to(device)
    a = torch.randn(n, d, generator=g).to(device)
    errs = {}
    for label, mask in (("ragged", torch.arange(k) % 4 != 1),
                        ("all_masked", torch.zeros(k, dtype=torch.bool))):
        mask = mask.to(device)
        none_live = not bool(mask.any())
        a_t = ref.count_sketch_apply(h, sigma, a, b)
        want = ref.oversketch_gram(a_t, mask)
        errs[label] = {
            "count_sketch_apply": compare(
                "count_sketch_apply", ops.count_sketch_apply(h, sigma, a, b),
                a_t)["max_abs_err"],
            "oversketch_gram": compare(
                "oversketch_gram", ops.oversketch_gram(a_t, mask),
                want, zero_ok=none_live)["max_abs_err"],
            "sketch_gram_count": compare(
                "sketch_gram_count",
                ops.sketch_gram_count(h, sigma, a, b, mask),
                want, zero_ok=none_live)["max_abs_err"]}
        if label == "all_masked" and ops.sketch_gram_count(
                h, sigma, a, b, mask).any():
            raise AssertionError("all-masked Gram is not zero")
        # SJLT: 4 layers, the first two colliding on a quarter of the rows.
        hs = torch.randint(0, b, (k, 4, n), generator=g,
                           dtype=torch.int32).to(device)
        hs[:, 1, : n // 4] = hs[:, 0, : n // 4]
        ss = (torch.randint(0, 2, (k, 4, n), generator=g).float() * 2
              - 1).to(device)
        got = ops.sketch_gram_sjlt(hs, ss, a, b, mask)
        errs[label]["sketch_gram_sjlt"] = compare(
            "sketch_gram_sjlt", got,
            ref.sketch_gram_sjlt(hs, ss, a, b, mask),
            zero_ok=none_live)["max_abs_err"]
        # SRHT: n = 1,001 is not a power of two (n_pad = 1,024).
        rows = torch.randint(0, 1024, (k, b), generator=g,
                             dtype=torch.int32).to(device)
        got_r = ops.sketch_gram_srht(rows, sigma, a, mask)
        errs[label]["sketch_gram_srht"] = compare(
            "sketch_gram_srht", got_r,
            ref.sketch_gram_srht(rows, sigma, a, mask),
            zero_ok=none_live)["max_abs_err"]
        if label == "all_masked" and (got.any() or got_r.any()):
            raise AssertionError("all-masked SJLT/SRHT Gram is not zero")
    for n_f, d_f in ((1, 37), (64, 37), (1024, 37), (8192, 5)):
        x = torch.randn(3, n_f, d_f, generator=g).to(device)
        want = ref.fwht(x)
        errs[f"fwht_n{n_f}"] = {
            name: compare(name, getattr(ops, name)(x), want)["max_abs_err"]
            for name in ("fwht", "fwht_two_pass")}
    # b = 4,096: past one (b + 1) x 32 tile, the sorted-gather apply.
    kb, nb, db, bb = 3, 5000, 70, 4096
    hb = torch.randint(0, bb, (kb, nb), generator=g,
                       dtype=torch.int32).to(device)
    sb = (torch.randint(0, 2, (kb, nb), generator=g).float() * 2 - 1).to(device)
    ab = torch.randn(nb, db, generator=g).to(device)
    mb = (torch.arange(kb) != 1).to(device)
    a_t = ref.count_sketch_apply(hb, sb, ab, bb)
    errs["b4096"] = {
        "count_sketch_apply": compare(
            "count_sketch_apply", ops.count_sketch_apply(hb, sb, ab, bb),
            a_t)["max_abs_err"],
        "sketch_gram_count": compare(
            "sketch_gram_count", ops.sketch_gram_count(hb, sb, ab, bb, mb),
            ref.oversketch_gram(a_t, mb))["max_abs_err"]}
    # The layered (SJLT) apply at b = 4,096, two layers colliding.
    hl = torch.randint(0, bb, (kb, 4, nb), generator=g,
                       dtype=torch.int32).to(device)
    hl[:, 1, : nb // 4] = hl[:, 0, : nb // 4]
    sl = (torch.randint(0, 2, (kb, 4, nb), generator=g).float() * 2
          - 1).to(device)
    errs["b4096"]["count_sketch_apply_sjlt"] = compare(
        "count_sketch_apply sjlt", ops.count_sketch_apply(hl, sl, ab, bb),
        ref.sjlt_apply(hl, sl, ab, bb))["max_abs_err"]
    errs["skewed"] = check_skewed(ops, ref, device, g)
    return errs


def check_coded(ops, ref, data, b: int, device) -> dict:
    """The coded mat-vec at both product-code encodes of the main path's
    gradient (X times an iterate, X^T times a residual), a seeded 5% of
    the workers erased (at least one).  The library call is one cuBLAS
    gemv over every block, then the mask."""
    import numpy as np
    import torch
    from repro_torch.core import coded
    n, d = data.x.shape
    g = torch.Generator().manual_seed(SEED)
    out = {}
    for tag, rows, s in (("X", n, d), ("XT", d, n)):
        code = coded.make_code(rows, b)
        enc = coded.encode_2d(data.x if tag == "X" else data.x.T, code)
        w = code.num_workers
        enc = enc.view(w, code.block_rows, s)
        x = torch.randn(s, generator=g).to(device)
        erased = torch.zeros(w, dtype=torch.bool)
        erased[np.random.default_rng(SEED).choice(
            w, max(1, round(CODED_ERASED * w)), replace=False)] = True
        erased = erased.to(device)
        live = int((~erased).sum())
        got = ops.coded_block_matvec(enc, x, erased)
        want, plain_ms = timed_once(lambda: ref.coded_block_matvec(enc, x,
                                                                   erased))
        row = compare(f"coded_block_matvec {tag}", got, want)
        if got[erased].any():
            raise AssertionError(f"coded_block_matvec {tag}: an erased "
                                 "worker's row is not zero")
        if not torch.equal(ops.coded_block_matvec(enc, x, erased), got):
            raise AssertionError(f"coded_block_matvec {tag}: two calls "
                                 "differ")
        row["ms"] = cuda_ms(lambda: ops.coded_block_matvec(enc, x, erased),
                            10, warm=False)
        # The host's time to enqueue one call: a kernel this short can be
        # held back by it.
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            ops.coded_block_matvec(enc, x, erased)
        row["host_enqueue_ms"] = (time.perf_counter() - t0) * 1e2
        torch.cuda.synchronize()
        row["plain_ms"] = plain_ms
        flat = enc.view(-1, s)

        def library():
            return torch.where(erased[:, None], 0.0,
                               (flat @ x).view(w, code.block_rows))
        row["library_ms"] = cuda_ms(library, 10)
        row["library_call"] = "torch.mv (cuBLAS gemv) over all blocks, then torch.where"
        row["clocks_after"] = clocks()
        bw = code.block_rows
        row["bound_ms"], row["bound_by"] = bound(
            2.0 * live * bw * s, 4.0 * (live * bw * s + s + w * bw) + w)
        row["shape"] = {"W": w, "b": bw, "s": s, "erased": w - live}
        out[tag] = row
        del enc, flat, got, want
        torch.cuda.empty_cache()
    return out


def check_nystrom_gram(ops, ref, a, a_t, mask) -> dict:
    """The masked Gram at the nystrom family's A_tilde (the first
    iteration's draw), 30 of 150 blocks masked: where the unfused families'
    Hessian takes it."""
    import torch
    k, b, d = a_t.shape
    live = mask.nonzero().squeeze(1)
    kl = int(live.numel())
    got = ops.oversketch_gram(a_t, mask)
    row = compare("oversketch_gram nystrom", got, ref.oversketch_gram(a_t,
                                                                      mask))
    row["bit_identical"] = same_bits(
        "oversketch_gram nystrom", lambda: ops.oversketch_gram(a_t, mask), got)
    row["symmetric"] = symmetric("oversketch_gram nystrom", got)
    row["slices"] = gram_slices(b, k, d)
    row["ms"] = cuda_ms(lambda: ops.oversketch_gram(a_t, mask), 5)
    # The tile kernel, the fixed-order reduce of the slices' partials and
    # the live-block list apart.
    row.update(traced_ms(lambda: ops.oversketch_gram(a_t, mask), {
        "tiles_ms": ("sketch::gram_kernel",), "reduce_ms": ("gram_reduce",),
        "live_ms": ("gram_live",)}))
    row["plain_ms"] = cuda_ms(lambda: ref.oversketch_gram(a_t, mask), 3)
    x_live = a_t[live].reshape(-1, d)
    row["library_ms"] = cuda_ms(lambda: torch.mm(x_live.T, x_live), 5)
    row["library_call"] = "torch.mm(A_live^T, A_live)"
    row["bound_ms"], row["bound_by"] = bound(
        float(kl) * b * d * (d + 1), 4.0 * (kl * b * d + d * d) + k)
    row["shape"] = {"K": k, "b": b, "d": d, "masked": k - kl}
    return row


def check_normal(ops, prng, key, shape, device) -> dict:
    """The normal kernel at one gaussian block's draw against the plain
    version on the card, every bit; torch.randn of the same shape beside
    it as a yardstick of another function; the table's build once."""
    import torch
    from repro_torch.kernels import normal
    normal.table(device)
    table, build_ms = timed_once(lambda: normal.build_table(device))
    if not torch.equal(table.view(torch.int32),
                       normal.table(device).view(torch.int32)):
        raise AssertionError("normal: two builds of the table differ")
    del table
    got = ops.normal(key, shape, device)
    want, plain_ms = timed_once(lambda: prng.normal_plain(key, shape, device))
    differing = int((got.view(torch.int32) != want.view(torch.int32)).sum())
    if differing:
        raise AssertionError(f"normal: {differing} draws differ from the "
                             "plain version")
    row = {"max_abs_err": float((got - want).abs().max()),
           "entries_differing": differing, "max_abs_plain":
           float(want.abs().max())}
    del got, want
    row["ms"] = cuda_ms(lambda: ops.normal(key, shape, device), 5)
    row["plain_ms"] = plain_ms
    row["library_ms"] = None
    row["library_call"] = "none: no PyTorch call draws jax's bits"
    row["yardstick_ms"] = cuda_ms(
        lambda: torch.randn(shape, device=device), 5)
    row["yardstick"] = "torch.randn, same shape (not the same function)"
    count = math.prod(shape)
    row["bound_ms"], row["bound_by"] = bound(float(HASH_INT_OPS) * count,
                                             4.0 * count, INT32_OPS)
    row["bound_rate"] = "INT32_OPS"
    row["table_build_ms"] = build_ms
    row["shape"] = list(shape)
    return row


def check_draw(ops, prng, key, n: int, k: int, b: int, device) -> dict:
    """The draw kernel against the plain version on the card, every bit,
    at the main path's draw of one iteration (the count sketch's h in
    [0, b) and sigma, (k, n)) and nystrom's rows ((k, b) in [0, n)), with
    the keys the samplers split; torch.randint of the same shape beside
    each as a yardstick of another function.  The first case is the row;
    the others go under other_shapes."""
    import torch
    kh, ks = prng.split(key)
    cases = {
        "randint h (K, n) in [0, b)": (
            lambda: ops.randint(kh, (k, n), 0, b, device=device),
            lambda: prng.randint(kh, (k, n), 0, b, device=device),
            (k, n), b, 2),
        "rademacher sigma (K, n)": (
            lambda: ops.rademacher(ks, (k, n), device=device),
            lambda: prng.rademacher(ks, (k, n), device=device),
            (k, n), 2, 1),
        "randint nystrom rows (K, b) in [0, n)": (
            lambda: ops.randint(key, (k, b), 0, n, device=device),
            lambda: prng.randint(key, (k, b), 0, n, device=device),
            (k, b), n, 2)}
    rows = {}
    for label, (kernel, plain, shape, span, hashes) in cases.items():
        got = kernel()
        want, plain_ms = timed_once(plain)
        bits = ((got.view(torch.int32) != want.view(torch.int32))
                if got.dtype == torch.float32 else got != want)
        differing = int(bits.sum())
        if differing or got.dtype != want.dtype:
            raise AssertionError(f"draw {label}: {differing} draws differ "
                                 "from the plain version")
        row = {"max_abs_err": float((got.double() - want.double()).abs()
                                    .max()), "entries_differing": 0}
        del got, want
        row["ms"] = cuda_ms(kernel, 5)
        row["plain_ms"] = plain_ms
        row["library_ms"] = None
        row["library_call"] = "none: no PyTorch call draws jax's bits"
        row["yardstick_ms"] = cuda_ms(
            lambda: torch.randint(0, span, shape, device=device,
                                  dtype=torch.int32), 5)
        row["yardstick"] = "torch.randint, same shape (not the same function)"
        count = math.prod(shape)
        row["bound_ms"], row["bound_by"] = bound(
            float(HASH_INT_OPS) * hashes * count, 4.0 * count, INT32_OPS)
        row["bound_rate"] = "INT32_OPS"
        row["hashes"] = hashes * count
        row["shape"] = list(shape)
        row["span"] = span
        rows[label] = row
    first, *rest = rows
    return {**rows[first], "case": first,
            "other_shapes": {name: rows[name] for name in rest}}


CHECK_CASES = {   # verify recipe: b = 64 > d = 20 for distributed-avg
    "oversketch": {}, "sjlt": {"sketch_family": "sjlt"},
    "srht": {"sketch_family": "srht"},
    "distavg_oversketch": {"sketch_mode": "distributed-avg", "debias": True},
    "distavg_sjlt": {"sketch_mode": "distributed-avg", "debias": True,
                     "sketch_family": "sjlt"},
    "distavg_srht": {"sketch_mode": "distributed-avg", "debias": True,
                     "sketch_family": "srht"},
    "gaussian": {"sketch_family": "gaussian"},
    "nystrom": {"sketch_family": "nystrom"},
    "leverage": {"sketch_family": "leverage"},
}


def run_small_reference(core, ops, data_mod, prng) -> dict:
    """The verify recipe on the card (kernels) and on the CPU (plain), for
    each case of CHECK_CASES, with the card run's launch counts."""
    import numpy as np
    data = data_mod.make_logistic_dataset(prng.PRNGKey(0), 1000, 20, 200,
                                          device="cpu")
    out = {}
    for label, extra in CHECK_CASES.items():
        kw = dict(iters=4, sketch=core.OverSketchConfig(512, 64, 0.25),
                  coded_block_rows=128, gradient_policy="coded", **extra)
        ops.reset_launch_counts()
        card = core.oversketched_newton(
            core.LogisticRegression(lam=1e-4), data, np.zeros(20, np.float32),
            core.NewtonConfig(use_kernels=True, **kw), device="cuda")
        launches = {k: c for k, c in ops.launch_counts().items() if c}
        plain = core.oversketched_newton(
            core.LogisticRegression(lam=1e-4), data, np.zeros(20, np.float32),
            core.NewtonConfig(use_kernels=False, **kw), device="cpu")
        fc = np.array(card.history["fval"])
        fp = np.array(plain.history["fval"])
        if card.history["step"] != plain.history["step"] or not np.allclose(
                fc, fp, rtol=1e-4, atol=1e-6):
            raise AssertionError(f"{label}: card {fc} vs plain {fp}")
        out[label] = {"fval_card": fc.tolist(), "fval_plain": fp.tolist(),
                      "max_rel_fval_diff": float(np.max(np.abs(fc - fp)
                                                        / np.abs(fp))),
                      "launches": launches}
    return out


def sketch_configs(core, d: int, sketch_dim_mult: int) -> tuple:
    """The blocks paths' sketch (m = sketch_dim_mult x d, with d rounded up
    to whole blocks of BLOCK) and distributed-avg's (8 blocks of
    DISTAVG_BLOCK)."""
    sketch_dim = sketch_dim_mult * (-(-d // BLOCK) * BLOCK)
    return (core.OverSketchConfig(sketch_dim, BLOCK, 0.25),
            core.OverSketchConfig(8 * DISTAVG_BLOCK, DISTAVG_BLOCK, 0.25))


def path_config(core, path: str, scfg, dcfg, **kw):
    """The NewtonConfig of a named path: newton (the oversketch family, the
    main path), families_X (sketch family X on scfg) or distavg_X
    (distributed-avg with debias, family X on dcfg); kw sets the rest."""
    family = path.partition("_")[2]
    if path == "newton":
        return core.NewtonConfig(sketch=scfg, **kw)
    if path.startswith("families_"):
        return core.NewtonConfig(sketch=scfg, sketch_family=family, **kw)
    if path.startswith("distavg_"):
        return core.NewtonConfig(sketch=dcfg, sketch_family=family,
                                 sketch_mode="distributed-avg", debias=True,
                                 **kw)
    raise ValueError(f"unknown path {path!r}")


def run_path(core, ops, objective, data, w0, cfg, label: str,
             expect: dict) -> dict:
    """One full-width run of a path through the entry point, launch counts
    set to 0 just before and read just after; checks each expected count,
    that f decreases and that every value is finite."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    res = core.oversketched_newton(objective, data, w0, cfg,
                                   device=w0.device)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    seconds = time.perf_counter() - t0
    hist = res.history
    f = [objective.value(w0, data).item()] + hist["fval"]
    row = {"phase": label, "iters": cfg.iters, "launches": launches,
           "f": f, "gnorm": hist["gnorm"], "step": hist["step"],
           "sim_seconds": hist["time"], "sim_dollars": hist["cost"],
           "wall_ms": [t * 1e3 for t in hist["wall_s"]],
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "seconds": seconds}
    keys = ["fval", "gnorm", "step", "time", "cost"]
    if cfg.track_test_error:
        row["test_error"] = hist["test_error"]
        keys.append("test_error")
    emit(row)
    for name, count in expect.items():
        if launches[name] != count:
            raise AssertionError(f"{label}: {name} launched "
                                 f"{launches[name]} times, expected {count}")
    if not all(b_ < a_ for a_, b_ in zip(f, f[1:])):
        raise AssertionError(f"{label}: fval does not decrease: {f}")
    finite = all(math.isfinite(v) for k in keys for v in hist[k])
    if not finite or not bool(torch.isfinite(res.w).all()):
        raise AssertionError(f"{label}: non-finite values in the history")
    return launches


def profile_iterations(core, objective, data, w0, cfg, device,
                       top: int = 12) -> dict:
    """Device time by operator over one more run of a path (torch.profiler),
    2 iterations, the draw kernel's share, and the device's idle share of
    its wall time."""
    import dataclasses
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        core.oversketched_newton(objective, data, w0,
                                 dataclasses.replace(cfg, iters=2),
                                 device=device)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    # Device-side events only (kernels, copies, memsets): the operators
    # that launched them carry the same time again.
    events = sorted((e for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=dev_us, reverse=True)
    device_ms = sum(dev_us(e) for e in events) / 1e3
    draws = [e for e in events if "draw_kernel" in e.key]
    return {"iters": 2, "wall_ms": wall_ms,
            "device_ms": device_ms, "idle_share": 1.0 - device_ms / wall_ms,
            "draw_kernel_ms": sum(dev_us(e) for e in draws) / 1e3,
            "draw_kernel_launches": sum(e.count for e in draws),
            "top": [{"op": e.key[:90], "device_ms": dev_us(e) / 1e3,
                     "calls": e.count} for e in events[:top]]}


def main() -> int:
    t_all = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}: run it "
              "from the root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import numpy as np
    from repro_torch import core, prng, sketching
    from repro_torch import data as data_mod
    from repro_torch.configs import PROFILES, WORKER_SETUP
    from repro_torch.kernels import _build, ops, ref

    t0 = time.perf_counter()
    smi = nvidia_smi()
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    paths = _build.build()
    emit({"phase": "build", "libraries": sorted(p.name for p in paths.values()),
          "ptxas": {s: [ln.strip() for ln in log.splitlines()
                        if "registers" in ln or "spill" in ln]
                    for s, log in _build.BUILD_LOGS.items()},
          "seconds": time.perf_counter() - t0})

    # The paper's synthetic workload at full width (Sec. 5.1).
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    prof = PROFILES["synthetic"]
    data = data_mod.profile_dataset("synthetic", prng.PRNGKey(SEED),
                                    full_scale=True, device=dev)
    n, d = data.x.shape
    b = BLOCK
    scfg, dcfg = sketch_configs(
        core, d, WORKER_SETUP["synthetic"]["sketch_dim_mult"])
    torch.cuda.synchronize()
    emit({"phase": "data", "n": n, "d": d, "n_test": data.x_test.shape[0],
          "profile": [prof.n_train, prof.n_features, prof.n_test],
          "sketch_dim": scfg.sketch_dim, "block_size": b,
          "total_blocks": scfg.total_blocks,
          "label_balance": float((data.y > 0).float().mean()),
          "seconds": time.perf_counter() - t0})

    # Kernel checks at each path's own inputs: A = hess_sqrt(w0) and the
    # first iteration's draw of the path's family (key kh, as the loop
    # splits it), 30 of 150 blocks masked on the blocks paths.
    t0 = time.perf_counter()
    objective = core.LogisticRegression()
    w0 = torch.zeros(d, device=dev)
    a = objective.hess_sqrt(w0, data)
    _, _, kh, _ = prng.split(prng.PRNGKey(SEED), 4)
    draw = prng.fold_in(kh, 7)
    state = sketching.get("oversketch", scfg).sample(draw, n, device=dev)
    drop = np.random.default_rng(SEED).choice(scfg.total_blocks, 30,
                                              replace=False)
    mask = torch.ones(scfg.total_blocks, dtype=torch.bool)
    mask[torch.from_numpy(drop)] = False
    mask = mask.to(dev)
    ops.reset_launch_counts()
    rows = check_kernels(ops, ref, state.h, state.sigma, a, mask, b)
    del state
    rows.update(check_family_kernels(
        ops, ref, a, sketching.get("sjlt", scfg).sample(draw, n, device=dev),
        sketching.get("srht", scfg).sample(draw, n, device=dev), mask, b))
    srht_d = sketching.get("srht", dcfg).sample(draw, n, device=dev)
    rows.update(check_fwht(ops, ref, a, srht_d["sigma"][0]))
    del srht_d
    large = check_large_block(
        ops, ref, a, sketching.get("oversketch", dcfg).sample(draw, n,
                                                              device=dev),
        sketching.get("sjlt", dcfg).sample(draw, n, device=dev),
        DISTAVG_BLOCK)
    small = check_small_cases(ops, ref, dev)
    nystrom = sketching.get("nystrom", scfg)
    a_t = nystrom.apply(nystrom.sample(draw, n, device=dev), a)
    count_gram = rows["oversketch_gram"]
    rows["oversketch_gram"] = check_nystrom_gram(ops, ref, a, a_t, mask)
    del a, a_t
    gauss = sketching.get("gaussian", scfg).sample(draw, n, device=dev)
    rows["normal"] = check_normal(ops, prng, gauss["keys"][0], (n, b), dev)
    del gauss
    rows["draw"] = check_draw(ops, prng, draw, n, scfg.total_blocks, b, dev)
    torch.cuda.empty_cache()
    coded_rows = check_coded(ops, ref, data, b, dev)
    rows["coded_block_matvec"] = coded_rows["XT"]
    emit({"phase": "kernels", "shapes": {"K": scfg.total_blocks, "n": n,
                                         "d": d, "b": b, "masked": 30,
                                         "sjlt_s": 4, "distavg_K":
                                         dcfg.total_blocks, "distavg_b":
                                         DISTAVG_BLOCK},
          "rows": rows, "coded_X": coded_rows["X"],
          "oversketch_gram_count_sketch": count_gram, "b4096": large,
          "small_cases_max_abs_err": small,
          "tolerance_rel": REL_TOL, "seconds": time.perf_counter() - t0})

    # The main path: counts set to 0 just before, read just after.  Each
    # iteration draws its count sketch (h, then sigma) with the draw kernel.
    cfg = path_config(core, "newton", scfg, dcfg, iters=ITERS,
                      gradient_policy="coded", use_kernels=True,
                      track_test_error=True, seed=SEED)
    paths = {"newton": run_path(core, ops, objective, data, w0, cfg,
                                "newton", {"sketch_gram_count": ITERS,
                                           "coded_block_matvec": 2 * ITERS,
                                           "draw": 2 * ITERS})}

    # Where the time goes: the main path once more under torch.profiler
    # (its launches come after the counts were read), then the sjlt family.
    t0 = time.perf_counter()
    prof = profile_iterations(core, objective, data, w0, cfg, dev)
    emit({"phase": "profile", **prof, "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    prof = profile_iterations(
        core, objective, data, w0,
        path_config(core, "families_sjlt", scfg, dcfg, iters=PATH_ITERS,
                    gradient_policy="coded", use_kernels=True, seed=SEED),
        dev)
    emit({"phase": "profile_families_sjlt", **prof,
          "seconds": time.perf_counter() - t0})

    # The other sketch families and distributed-avg, each driven and
    # counted on its own.  The draw kernel launches twice an iteration where
    # the family draws codes or signs and rows (h and sigma; sigma and the
    # SRHT's rows), once on nystrom (its rows), and never on leverage (its
    # rows come from prng.choice's plain uniform on the card) or gaussian
    # (its blocks come from the normal kernel).
    base = dict(iters=PATH_ITERS, gradient_policy="coded", use_kernels=True,
                seed=SEED)
    coded_launches = {"coded_block_matvec": 2 * PATH_ITERS}
    k = scfg.total_blocks
    for fam, expect in (
            ("sjlt", {"sketch_gram_sjlt": PATH_ITERS,
                      "draw": 2 * PATH_ITERS}),
            ("srht", {"sketch_gram_srht": PATH_ITERS,
                      "draw": 2 * PATH_ITERS}),
            ("nystrom", {"oversketch_gram": PATH_ITERS, "draw": PATH_ITERS}),
            ("leverage", {"oversketch_gram": PATH_ITERS, "draw": 0}),
            ("gaussian", {"oversketch_gram": PATH_ITERS,
                          "normal": k * PATH_ITERS, "draw": 0})):
        label = f"families_{fam}"
        paths[label] = run_path(
            core, ops, objective, data, w0,
            path_config(core, label, scfg, dcfg, **base), label,
            {**expect, **coded_launches})
    k_d = dcfg.total_blocks
    for fam, expect in (("oversketch", {"count_sketch_apply": PATH_ITERS,
                                        "draw": 2 * PATH_ITERS}),
                        ("sjlt", {"count_sketch_apply": PATH_ITERS,
                                  "draw": 2 * PATH_ITERS}),
                        ("srht", {"fwht": 0,
                                  "fwht_two_pass": k_d * PATH_ITERS,
                                  "draw": 2 * PATH_ITERS})):
        label = f"distavg_{fam}"
        paths[label] = run_path(
            core, ops, objective, data, w0,
            path_config(core, label, scfg, dcfg, **base), label,
            {**expect, **coded_launches})
    del data
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    check = run_small_reference(core, ops, data_mod, prng)
    emit({"phase": "check", "cases": check,
          "seconds": time.perf_counter() - t0})
    # n_pad = 1,024 there: the fwht entry takes its one-pass kernel.
    if check["distavg_srht"]["launches"].get("fwht", 0) == 0:
        raise AssertionError("the one-pass fwht was not launched on the "
                             "check phase's distributed-avg srht run")

    # Each kernel's numbers at the shape its full-width path launches it:
    # count_sketch_apply at b = 4,096 (distributed-avg), the coded mat-vec
    # at the X^T encode, the masked Gram at nystrom's A_tilde, each with its
    # other shapes beside; fwht's one-pass kernel at its largest n, 4,096.
    rows["count_sketch_apply"], cs_b256 = large["count_sketch_apply"], \
        rows["count_sketch_apply"]
    other = {"count_sketch_apply": {
        "distavg_sjlt (layered, s = 4)": large["count_sketch_apply_sjlt"],
        "b256_K150 (no path)": cs_b256},
        "coded_block_matvec": {"X encode (W = 1,296, s = 3,000)":
                               coded_rows["X"]},
        "oversketch_gram": {"count-sketch A_tilde (no path)": count_gram},
        "sketch_gram_sjlt": {
            "apply alone (count_sketch_apply, K_live = 120, s = 4, b = 256)":
                rows["sjlt_apply"],
            "Gram alone (oversketch_gram of that A_tilde)":
                rows["sjlt_gram"]},
        "draw": rows["draw"]["other_shapes"]}
    summary = []
    for name, kern in ops.KERNELS.items():
        r = rows[name]
        by_path = {p: c[name] for p, c in paths.items() if c[name]}
        launches = sum(by_path.values())
        if launches == 0 and name not in OFF_PATH:
            raise AssertionError(f"{name} was launched on no path")
        entry = {
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{kern.source}",
            "replaces": kern.replaces, "launches": launches,
            "launches_by_path": by_path, "on_path": launches > 0,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "launches_check_phase": sum(c["launches"].get(name, 0)
                                        for c in check.values())}
        if name in OFF_PATH:
            entry["off_path"] = OFF_PATH[name]
        if name in other:
            entry["other_shapes"] = {
                k: {f: v[f] for f in ("max_abs_err", "ms", "plain_ms",
                                      "bound_ms", "bound_by", "library_ms",
                                      "yardstick_ms", *PHASES) if f in v}
                for k, v in other[name].items()}
        entry.update({f: r[f] for f in PHASES + FWHT_PASSES if f in r})
        if name in ("normal", "draw"):
            entry.update({f: r[f] for f in ("yardstick_ms", "yardstick",
                                            "bound_rate", "table_build_ms",
                                            "case")
                          if f in r})
        summary.append(entry)
    emit({"phase": "total", "seconds": time.perf_counter() - t_all})
    emit({"kernels": summary})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
