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
           masked for the blocks paths, the fused Gram also at fig6_paper's
           sketch (30 of 148 blocks masked), the masked Gram at the nystrom
           family's A_tilde, b = 4,096 and K = 10 for distributed-avg,
           whose SJLT apply is the count-sketch kernel with s = 4 layers,
           one signed, padded (2^19, 3,000) block for the FWHT, the coded
           mat-vec at both product-code encodes (X: 1,296 workers of
           (256, 3,000); X^T: 25 of (256, 300,000)) with 5% of the workers
           erased, the normal kernel at one gaussian block (300,000 x 256),
           bit for bit, with its table's one-off build, and the draw
           kernel at the main path's and nystrom's draws, bit for bit:
           randint (150, 300,000) in [0, 256), rademacher of that shape,
           randint (150, 256) in [0, 300,000), and its raw bits at sgd's
           300,000 sort keys, with sgd's batch permutation against the
           CPU's), plus small cases
           (ragged, all masked, a non-power-of-two n, b = 4,096, the
           one-pass FWHT, and skewed codes for the segment-sum kernels:
           one bucket, half the buckets empty, out-of-range buckets, sigma
           other than +-1); the fwht entry and fwht_two_pass at n = 256,
           1,024, 2,048 and 4,096 (K = 1, d = 3,000) bit for bit, timed
           from CUDA graphs, with the wide one-pass kernel at 2,048 and
           4,096; times of
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
  giant_memory, exact_newton, giant_{wait_all,gcode,ignore},
  first_order_{gd,nag,sgd}
           the baseline optimizers at full width (GIANT's memory reckoned
           and printed first): exact Newton (coded gradients, the exact
           Hessian with speculative workers) and GIANT (60 workers) with
           fig. 6's line search, 2 iterations each; gd, nag and sgd under
           the ignore policy with backtracking (fig. 11's setup), 3 each;
           launch counts read around each run: exact Newton the coded
           mat-vec twice an iteration, GIANT none, sgd the draw kernel's
           bits once a sort round (2 at n = 300,000)
  corruption_parts, corruption, corruption_blind, corruption_gnorm
           before the runs, the clean lines' parity margin (largest
           residual over magnitude) at both encodes and the corruption
           noise's draw at (36, 36, 256) and (5, 5, 256), bit for bit; then
           the main path under the registry's corruption plan (prob 0.1)
           with detection on, 3 iterations: the latch flips, each corrupted
           mat-vec's rebuild launches the coded mat-vec once more and the
           normal kernel once, each relaunch the coded mat-vec once more
           (the counts the run's own telemetry implies); then detection
           off, 2 iterations (values finite); both gnorm histories
  adaptive_mp, adaptive_stall
           growth by the MP factor from OverSketchConfig(6,144, 256, 0.25)
           (K = 30 -> 60), and by the stall ratio on the main path's sketch
           (4 iterations), each K printed
  telemetry_off, telemetry, profiler_hook
           the main path without and with obs.Telemetry(monitors=True):
           simulated time and cost bit for bit (and the newton phase's),
           the Perfetto export validated, spans and alerts counted, wall ms
           beside each other; then one iteration under the kernel profiler
           (kernels.ops.set_profiler), each kernel.<op>.us
  fig6_paper
           the paper's fig. 6 through the port's bench body
           (repro_torch.benchmarks.fig6_logistic_synthetic._fig6) at the
           synthetic profile's n = 300,000 and d = 3,000 (fig. 6's
           generator, 1,000 test rows), with the reference bench's full
           counts: OSN and exact Newton 12 iterations, GIANT under each
           policy 18; the six rows, each run's wall seconds an iteration,
           peak device memory and launches (OSN: the fused Gram once, the
           coded mat-vec and the draw kernel twice an iteration; exact
           Newton the coded mat-vec twice; GIANT none), on a card that
           holds none of the earlier phases' tensors
  tenancy  the tenancy bench's autoscaled shared-pool cell at its quick
           size (1,000 jobs at 60 a second) and the committed golden
           two-tenant trace replayed through the port's JobScheduler,
           seconds and dollars bit for bit (host only)
  softmax_data, softmax_kernels, softmax
           softmax regression at the emnist profile's widths (d = 784,
           K = 10, 40,000 test rows) with n cut from 240,000 to 180,000 to
           fit the card (the reckoning is printed): hess_sqrt A is
           (1,800,000, 7,840), 56.4 GB; fig. 9's sketch m = 47,104 in
           blocks of 256 (K = 230).  The fused Gram against its plain
           version on 8 of the path's first blocks over all of A, and
           beside the library call on 64 of them, with eigh and the pinv
           solve of that 7,840-wide Gram timed apart, and the coded
           mat-vec at the path's encodes, and one fused Gram over all 230
           blocks (184 live, as the path's k-of-n leaves them); then 2
           iterations (pinv direction, the weakly convex line search),
           launch counts read just before and after
  check    the loop at the verify recipe's size on the card against the
           plain path on the CPU: every family in blocks mode and
           distributed-avg (b = 64 > d = 20), and softmax (n = 600, d =
           12, K = 4), then each baseline optimizer at its CPU parity
           test's size (n = 1,200, d = 20: GIANT under each policy, gd,
           nag, sgd, exact Newton; time, cost and steps equal), then the
           loop under a corruption plan (detection on) and with MP growth
           (m = 64 -> 128), time, cost and sketch_dim equal; with the card
           runs' launch counts (the one-pass FWHT runs there, at n_pad =
           1,024)

  lm_init  the dense LM slice: qwen3-4b (src/repro_torch/configs/qwen3_4b.py)
           at its published width, 4,411,424,256 bf16 parameters drawn on
           the card from PRNGKey(0) through get_bundle(...).init: one
           launch of the normal kernel's bfloat16 mode per drawn leaf (9)
  lm_check the smoke-width qwen3-4b on the card against the CPU (float32:
           forward's last logits within 1e-4 of max |CPU|, the server's
           tokens equal; bfloat16: the gap, within the CPU tests' 3e-2),
           then at full width the reference's serving invariant: prefill
           of 511 tokens plus one decode against forward's last logits, 2
           sequences, max abs diff within 0.06 of max |logit|
  lm_serve BatchedServer(batch 16, max_seq 2,048) on 32 requests (prompt
           lengths as launch/serve.py draws them, 4 to 1,024 tokens), 64
           new tokens each: prefill ms a wave and decode ms a step beside
           launch/analytic.py's bound (989 TFLOP/s bf16, 3.35 TB/s),
           tokens a second, peak memory; then 3 decode steps under
           torch.profiler (kernels and device ms a step, idle share)
  lm_features, lm_head_kernels, lm_osn_head, lm_osn_head_reference
           extract_features over 8,192 synthetic documents of 64 tokens
           (4 classes, class-conditioned token ranges) in batches of 128;
           the fused Gram at the OSN head's shape (A = hess_sqrt(0) is
           (32,768, 10,240), K = 400 blocks of b = 128, 80 masked) against
           its plain version and beside torch.sparse.mm then torch.mm,
           with eigh of its Gram; the coded mat-vec at the features' two
           encodes; the draw kernel at the head's draw; the normal
           kernel's bfloat16 mode at the embedding's shape, bit for bit;
           then train_osn_head with use_kernels=True, 4 iterations (per
           iteration the fused Gram once, the coded mat-vec 2 K = 8 times,
           the draw kernel twice), and as the reference configures it
           (use_kernels=False), 2 iterations: simulated time, cost and
           steps bit for bit, fval and gnorm gaps printed (the pinv
           direction inverts eigenvalues inside the Gram's fp32 rounding:
           lm_head_kernels prints the direction's gap beside the Grams'
           and the eigenvalues by band); the probe's train accuracy
  lm_moe_init, lm_moe_init_window
           the MoE slice: qwen3-moe-30b-a3b (configs/qwen3_moe_30b_a3b.py)
           at its published width, 30,532,122,624 bf16 parameters (61.06
           GB) drawn on the card from PRNGKey(0), one bf16 normal launch
           per drawn leaf (10); 4,096 draws of the expert leaf w_gate
           (9,663,676,416 elements) around counter 2^32 and at its end
           against the plain hash of the same counters, bit for bit; the
           bf16 mode at the MoE's embedding (151,936 x 2,048), bit for bit
  lm_moe_check
           the smoke-width MoE card against CPU (as lm_check); at full
           width prefill of 512 tokens (two whole groups of 256) plus one
           decode against forward over 513, 2 sequences, within 0.06 of
           max |logit|; the dropped assignments of real tokens in forward
           (2 x 513 and 16 x 512 tokens, capacity 20 a group), with the
           first layer's top-k and capacity positions taken again on the
           CPU from the card's probabilities, equal
  lm_moe_serve, lm_moe_features, lm_moe_head_kernels, lm_moe_osn_head
           BatchedServer(16, 2,048) on 16 requests (one wave, prompts as
           lm_serve's), 64 new tokens each, beside the analytic bound, and
           3 profiled decode steps; features of 4,096 documents of 64
           tokens; the fused Gram, the coded mat-vec and the draw kernel at
           the head's new shapes (A (16,384, 8,192), K = 320, 64 masked)
           against their plain versions; train_osn_head with the kernels,
           4 iterations (launches as lm_osn_head's)
  lm_moe_235b
           qwen3-moe-235b-a22b (470.19 GB of bf16 weights, past any card):
           its parameter count and launch/analytic.py's decode bound only
  lm_families_<arch>_{init,check,serve}
           mamba2-780m, recurrentgemma-2b and whisper-large-v3 at their
           published widths, one after another: init (one bf16 normal
           launch per drawn leaf), the smoke-width card against CPU, the
           full-width serving invariant (2 x 512 tokens, gate 0.06), and
           16 requests of 32 new tokens (whisper through its bundle with
           seeded frame embeddings (16, 1,500, 1,280): the reference's
           server passes no frames), each with 3 profiled decode steps

  lm_train_check, lm_train, lm_train_restart
           the LM training path (training/trainer.py): the trainer at
           smoke width, float32, 5 steps on the card against the CPU
           (loss and grad norm within 1e-4), and the two custom backwards
           (embed_lookup's one-hot product, chunked_cross_entropy) within
           1e-5 of max |CPU|; qwen3-4b training at its published width
           from PRNGKey(0), 8 steps of 4 x 128 tokens (the 9 bf16
           `normal` launches of its init counted): the loss and grad norm
           a step, step ms, tokens a second, launch/analytic.py's bound,
           one profiled step (kernels, device ms, idle share) and one
           timed in its stages (loss and backward, norm, AdamW), the state's
           bytes and peak memory, the loss falling, and the embedding's
           gradient within 1e-2 of autograd's default on uniform tokens
           and of the float32 sum on the pipeline's Zipfian ones; then at the
           same width cut to 2 layers, 6 steps uninterrupted and 6 with a
           checkpoint at step 4 and a failure at step 5 into a temp dir:
           the steps after the restore bit for bit, save and restore
           seconds

  distributed_paths
           after the modes, the three distributed functions
           (core/sketch.py::distributed_sketched_gram, core/coded.py::
           distributed_coded_matvec, core/linesearch.py::
           distributed_f_trials) on a one-rank NCCL group at full width
           (OverSketchConfig(30720, 256, 0.25), 30 of 150 blocks masked;
           the X encode's 1,296 workers, 5% erased; six trial steps)
           against the local sketched_gram, coded_matvec and objective
           values, within 1e-4 of max |local|, with their ms and their
           launches (the count-sketch kernel once, the coded mat-vec once)
  mesh_train
           after the training path, qwen3-4b at its published width on a
           1 x 1 ("data", "model") mesh over NCCL (a file store, no
           environment variable), its init drawn by the normal kernel's
           window mode (9 launches, no whole draw: every box is the whole
           leaf on a 1 x 1 mesh), 4 steps of 4 x 128 tokens against the
           unsharded trainer's from the same key, losses and norms equal
           (largest relative gap printed), step ms, tokens a second and
           peak GiB beside the unsharded run's step ms in this run, one
           more step of each under torch.profiler (kernels, device ms,
           host ms); then at 2 layers the mesh run's checkpoint at step 2
           restored onto the unsharded trainer, whose steps 2-3 must equal
           the mesh run's bit for bit
  mesh_init_30b, normal_window, mesh_init_235b_<data>_<model>
           after mesh_train, the sharded init (Trainer.init_state's on a
           mesh: each rank's boxes, sharding.param_boxes, drawn alone by
           the normal kernel's window mode): qwen3-moe-30b-a3b at a 4 x 2
           ("data", "model") mesh, leaf by leaf, each drawn leaf whole by
           the whole draw's launch and each of the 8 ranks' boxes by the
           window mode, every box equal to its slice bit for bit (each
           rank's bytes, 8.79 GB; each mode's ms and launches); the
           window mode against its plain version at the expert leaf
           w_gate's box of rank (3, 1), (48, 64, 2,048, 192) bf16, and a
           float32 box past counter 2^32; then qwen3-moe-235b-a22b at
           4 x 8, the whole parameter shards of ranks (0, 0) and (3, 7)
           through bundle.init_local (16.19 GB each, peak printed and
           gated under a tenth of the whole model's 470.19 GB), sub-boxes
           of each expert leaf at counters past 2^32 against
           prng.normal_window on the CPU, bit for bit
  ckpt_sharded_30b
           after mesh_init, the sharded checkpoint save as each rank of
           the 4 x 2 mesh writes it: qwen3-moe-30b-a3b at its published
           widths with the depth cut 48 -> 4 layers, each of the 8 ranks'
           boxes drawn alone by bundle.init_local and written into the
           shared files by checkpoint.manager.write_part at that rank's
           coordinates, then freed (save seconds, GB written and device
           peak a rank; the peak gated at the rank's shard bytes plus its
           largest box plus 256 MiB); the files equal byte for byte to an
           unsharded CheckpointManager.save of the same tree drawn whole
           by the normal kernel; rank (3, 1)'s boxes read back
           (manager.read_box) equal to its init_local bit for bit
  kernels_bench
           at the end, kernels_bench's rows (its bench_rows format) from
           this run's own kernel timings, written through kernels_bench's
           writer to a temporary file: every kernel's ms, plain ms and
           library ms at the kernel table's shapes beside PERF.md's (no
           kernel timed twice; no gate on speed)
  dryrun_16x16, dryrun_2x16x16, dryrun_smoke_<arch>_<shape>_<mesh>
           python -m repro_torch.launch.dryrun --arch qwen3-4b --shape
           train_4k on the 16 x 16 fake mesh and with --multi-pod, and
           with --smoke the reduced cells of tests/test_torch_dryrun.py
           at 4 x 2 (qwen3-4b train_4k, the MoE's decode_32k, mamba2's
           long_500k, recurrentgemma's prefill_32k), whisper's train_4k
           and mamba2's prefill_32k at 4 x 2, and mamba2 train_4k at
           2 x 2 x 2, each a host process started after the build:
           every field present, the counted flops per chip within 1 -+
           dryrun.FLOPS_TOL (0.2) of dryrun.expected_flops_per_chip
           (launch/analytic.py's parts under the port's rules; prefill
           and decode pinned as the train step is), host seconds printed

Every Newton run on the card (exact Newton's included) computes its coded
gradient with the coded mat-vec kernel: two launches per iteration, as
the default fleet's coded_decode policy waits for a peelable set and no
decode falls back; under corruption, one more per rebuild and per
relaunch.

Then the kernel summary line, the nvidia-smi line, and last
{"ok": true, "device": {...}}.  Any failed check raises: the script then
exits nonzero before the last line.  Without a CUDA device, or outside a
checkout, it exits nonzero and prints no result.
"""
from __future__ import annotations

import json
import math
import os
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
GIANT_WORKERS = 60      # the paper's GIANT workers for the synthetic profile
FIRST_ORDER_ITERS = 3   # iterations of each first-order run
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


def check_kernels(ops, ref, h, sigma, a, mask, b) -> dict:
    """Each kernel against its plain version at the main path's inputs."""
    import torch
    from repro_torch.benchmarks.kernels_bench import sparse_rows
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
    s_all = sparse_rows(h, sigma, torch.arange(k, device=h.device), b, n)
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
    s_live = sparse_rows(h, sigma, live, b, n)

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


def drop_mask(k: int, masked: int, dev):
    """A mask over k blocks with ``masked`` of them, chosen from SEED,
    dropped."""
    import numpy as np
    import torch
    drop = np.random.default_rng(SEED).choice(k, masked, replace=False)
    mask = torch.ones(k, dtype=torch.bool)
    mask[torch.from_numpy(drop)] = False
    return mask.to(dev)


def check_gram_at(ops, ref, state, a, b, masked: int, label: str) -> dict:
    """sketch_gram_count against its plain version on another path's draw
    of the count sketch, ``masked`` of its blocks dropped."""
    k = state.h.shape[0]
    mask = drop_mask(k, masked, a.device)
    got = ops.sketch_gram_count(state.h, state.sigma, a, b, mask)
    row = compare(f"sketch_gram_count {label}", got,
                  ref.sketch_gram_count(state.h, state.sigma, a, b, mask))
    row["ms"] = cuda_ms(
        lambda: ops.sketch_gram_count(state.h, state.sigma, a, b, mask), 3)
    row.update(K=k, masked=masked)
    return row

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
    from repro_torch.benchmarks.kernels_bench import sparse_rows, srht_encode
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
    s_live = sparse_rows(h, sg, live, b, n, 1 / math.sqrt(h.shape[1]))

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
    s_live = sparse_rows(h, sg, live, b, n, 1 / math.sqrt(h.shape[1]))
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


def graph_ms(fn, reps: int = 20, replays: int = 5) -> float:
    """Mean device milliseconds of one call of fn, replayed from a CUDA
    graph of reps calls after a warm-up: the wrapper's enqueue of a call
    (tens of microseconds on the host) stays out of the timing, which at
    the one-pass FWHT's sizes it would exceed."""
    import torch
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def fwht_step():
    """One FWHT pass alone, through csrc/fwht.cu's
    fwht_two_pass_step_launch: step(x, out, batches, rows, cols, div), on
    the current stream.  These launches are measurements: they do not count
    as the kernels'."""
    import ctypes
    import torch
    from repro_torch.kernels import srht
    fn = srht.TWO_PASS_KERNEL.host_function(
        "fwht_two_pass_step_launch",
        [ctypes.c_void_p] * 2 + [ctypes.c_longlong, ctypes.c_int,
                                 ctypes.c_longlong, ctypes.c_float,
                                 ctypes.c_void_p])

    def step(x, out, batches, rows, cols, div):
        err = fn(x.data_ptr(), out.data_ptr(), batches, rows, cols, div,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"fwht_two_pass_step_launch: CUDA error {err}")
    return step


def fwht_pass_ms(x) -> tuple:
    """Device ms of the two-pass FWHT's local and across passes, each
    launched alone (fwht_step), with n = n1 n2 split as fwht_two_pass
    splits it."""
    import torch
    step = fwht_step()
    k, n, d = x.shape
    n1 = 1 << (n.bit_length() - 1) // 2
    n2 = n // n1
    out = torch.empty_like(x)
    local = cuda_ms(lambda: step(x, out, k * n1, n2, d, 1.0), 3)
    across = cuda_ms(lambda: step(out, out, k, n1, n2 * d, math.sqrt(n)), 3)
    return local, across


# The one-pass fwht's lengths checked and timed (K = 1, d = 3,000).
FWHT_NS = (256, 1024, 2048, 4096)


def check_fwht(ops, ref, a, sigma_k) -> dict:
    """The FWHT on one signed, padded (2^19, d) block, as the distributed-
    avg SRHT path transforms it: there the fwht entry point takes the two-
    pass kernel (row fwht_two_pass; the fwht entry is checked at that n
    too).  Row fwht is the entry at n = 4,096 on the block's first rows,
    the most one pass takes; row fwht_lengths the entry at each length of
    FWHT_NS.  At each length the entry and fwht_two_pass must give the
    plain butterfly's bits; the entry is timed from CUDA graphs (graph_ms)
    beside a copy of x."""
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
    lengths = {}
    for n1 in FWHT_NS:
        x1 = x[:, :n1].contiguous()
        w1, p1 = timed_once(lambda: ref.fwht(x1))
        one = compare(f"fwht n={n1}", ops.fwht(x1), w1)
        for name, fn in (("fwht", ops.fwht),
                         ("fwht_two_pass", ops.fwht_two_pass)):
            if not torch.equal(fn(x1), w1):
                raise AssertionError(f"{name} at n = {n1} is not the plain "
                                     "butterfly bit for bit")
        y1 = torch.empty_like(x1)
        one["ms"] = graph_ms(lambda: ops.fwht(x1))
        one["copy_ms"] = graph_ms(lambda: y1.copy_(x1))
        one["plain_ms"] = p1
        one["library_ms"] = None
        one["library_call"] = "none: PyTorch has no Hadamard transform"
        one["bound_ms"], one["bound_by"] = bound(
            float(n1) * math.log2(n1) * d, 8.0 * n1 * d)
        one["form"] = ("one register pass" if n1 <= 1024 else
                       "one wide pass (a cluster of CTAs a strip)")
        one["timing"] = "CUDA graph of 20 calls, 5 replays"
        one["shape"] = [1, n1, d]
        lengths[f"(1, {n1}, {d})"] = one
        del x1, w1, y1
    out["fwht"] = lengths.pop(f"(1, {FWHT_NS[-1]}, {d})")
    out["fwht_lengths"] = lengths
    return out


def check_large_block(ops, ref, a, cs, sj, b) -> dict:
    """count_sketch_apply and sketch_gram_count at b = 4,096 (the sorted-
    gather apply) on the distributed-avg path's first draw (K = 10), and
    count_sketch_apply's layered form on the SJLT draw (K = 10, s = 4), as
    the distributed-avg SJLT path applies it; the sort timed apart from the
    gather, and each kernel launched twice for the same bits."""
    import torch
    from repro_torch.benchmarks.kernels_bench import sparse_rows
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
    s_all = sparse_rows(h, sg, torch.arange(k, device=h.device), b, n,
                        1 / math.sqrt(h.shape[1]))
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
    s_all = sparse_rows(h, sg, torch.arange(k, device=h.device), b, n)
    row["library_ms"] = cuda_ms(lambda: torch.sparse.mm(s_all, a), 3)
    row["library_call"] = "torch.sparse.mm(CSR sketch (K*b, n), A)"
    del s_all
    row["bound_ms"], row["bound_by"] = bound(
        2.0 * k * n * d, 4.0 * (n * d + 2 * k * n + k * b * d))
    row["shape"] = {"K": k, "n": n, "d": d, "b": b}
    out["count_sketch_apply"] = row
    s_live = sparse_rows(h, sg, mask.nonzero().squeeze(1), b, n)

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


def check_draw(ops, prng, key, n: int, k: int, b: int, device,
               label: str = "", nystrom: bool = True) -> dict:
    """The draw kernel against the plain version on the card, every bit,
    at a path's draw of one iteration (the count sketch's h in [0, b) and
    sigma, (k, n)) and, with nystrom, nystrom's rows ((k, b) in [0, n)),
    with the keys the samplers split; torch.randint of the same shape
    beside each as a yardstick of another function.  Returns a row per
    case, its name prefixed with label."""
    import torch
    kh, ks = prng.split(key)
    cases = {
        f"{label}randint h (K, n) in [0, b)": (
            lambda: ops.randint(kh, (k, n), 0, b, device=device),
            lambda: prng.randint(kh, (k, n), 0, b, device=device),
            (k, n), b, 2),
        f"{label}rademacher sigma (K, n)": (
            lambda: ops.rademacher(ks, (k, n), device=device),
            lambda: prng.rademacher(ks, (k, n), device=device),
            (k, n), 2, 1)}
    if nystrom:
        cases[f"{label}randint nystrom rows (K, b) in [0, n)"] = (
            lambda: ops.randint(key, (k, b), 0, n, device=device),
            lambda: prng.randint(key, (k, b), 0, n, device=device),
            (k, b), n, 2)
    rows = {}
    for name, (kernel, plain, shape, span, hashes) in cases.items():
        got = kernel()
        want, plain_ms = timed_once(plain)
        bits = ((got.view(torch.int32) != want.view(torch.int32))
                if got.dtype == torch.float32 else got != want)
        differing = int(bits.sum())
        if differing or got.dtype != want.dtype:
            raise AssertionError(f"draw {name}: {differing} draws differ "
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
        rows[name] = row
    return rows


def sort_rounds(n: int) -> int:
    """Sort rounds of jax's shuffle (prng.permutation) of n elements:
    ceil(3 ln n / ln(2^32 - 1)), each one launch of the bits mode."""
    return math.ceil(3 * math.log(max(1, n)) / math.log(2 ** 32 - 1))


def check_bits(ops, prng, n: int, device) -> dict:
    """The draw kernel's raw-bits mode against prng's plain bits on the
    card, every bit, at sgd's sort keys: the n words of the first sort
    round of first_order's first batch (seed SEED); then that batch's
    permutation on the card (sort keys by the kernel) against the CPU's.
    torch.randint of the same shape beside it as a yardstick of another
    function.  These launches are measurements, not the path's."""
    import torch
    _, _, kb = prng.split(prng.PRNGKey(SEED), 3)
    _, sub = prng.split(kb)
    got = ops.bits(sub, 0, n, device=device)
    want, plain_ms = timed_once(lambda: prng._bits(sub, 0, n, device))
    differing = int(((got.long() & prng.M32) != want).sum())
    if differing or got.dtype != torch.int32:
        raise AssertionError(f"draw bits: {differing} of {n} words differ "
                             "from the plain bits")
    perm = prng.permutation(kb, n, device=device)
    if not torch.equal(perm.cpu(), prng.permutation(kb, n, device="cpu")):
        raise AssertionError("sgd's batch permutation on the card is not "
                             "the CPU's")
    row = {"max_abs_err": float(((got.long() & prng.M32) - want).abs()
                                .max()),
           "entries_differing": 0, "permutation_equal": True,
           "ms": cuda_ms(lambda: ops.bits(sub, 0, n, device=device), 20),
           "plain_ms": plain_ms, "library_ms": None,
           "library_call": "none: no PyTorch call draws jax's bits",
           "yardstick_ms": cuda_ms(lambda: torch.randint(
               -(1 << 31), (1 << 31) - 1, (n,), device=device,
               dtype=torch.int32), 20),
           "yardstick": "torch.randint, same shape (not the same function)",
           "permutation_ms": cuda_ms(
               lambda: prng.permutation(kb, n, device=device), 5),
           "sort_rounds": sort_rounds(n)}
    row["bound_ms"], row["bound_by"] = bound(float(HASH_INT_OPS) * n,
                                             4.0 * n, INT32_OPS)
    row["bound_rate"] = "INT32_OPS"
    row["hashes"] = n
    row["shape"] = [n]
    return row


def giant_bytes(n: int, d: int, workers: int) -> dict:
    """GIANT's device memory at full width, reckoned before the run: the
    padded shard stack, the shards' hess_sqrt (the same size), and the
    (workers, d, d) local Hessians and their Cholesky factors, float32."""
    per = -(-n // workers)
    stack = 4.0 * workers * per * d
    hess = 4.0 * workers * d * d
    return {"workers": workers, "rows_per_shard": per,
            "shard_stack_gb": stack / 1e9, "hess_sqrt_gb": stack / 1e9,
            "hessians_gb": hess / 1e9, "factors_gb": hess / 1e9}


def run_optimizer(ops, label: str, run, expect: dict, f0: float,
                  decreasing: bool = True) -> dict:
    """One full-width run of a baseline optimizer through its entry point,
    launch counts set to 0 just before and read just after: every kernel's
    count must be expect's (0 where it names none).  Checks that f ends
    below f0 (every step where ``decreasing``) and that every value is
    finite; prints the iterations' wall ms and the peak device memory."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    hist = run()
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    seconds = time.perf_counter() - t0
    f = [f0] + hist["fval"]
    emit({"phase": label, "iters": len(hist["fval"]), "launches": launches,
          "f": f, "gnorm": hist["gnorm"], "step": hist["step"],
          "sim_seconds": hist["time"], "sim_dollars": hist["cost"],
          "wall_ms": [t * 1e3 for t in hist["wall_s"]],
          "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
          "seconds": seconds})
    for name, count in launches.items():
        if count != expect.get(name, 0):
            raise AssertionError(f"{label}: {name} launched {count} times, "
                                 f"expected {expect.get(name, 0)}")
    if not f[-1] < f[0] or (decreasing and not all(
            b_ < a_ for a_, b_ in zip(f, f[1:]))):
        raise AssertionError(f"{label}: fval does not decrease: {f}")
    finite = all(math.isfinite(v) for k in ("fval", "gnorm", "step", "time",
                                            "cost") for v in hist[k])
    if not finite or not bool(torch.isfinite(hist["w"]).all()):
        raise AssertionError(f"{label}: non-finite values in the history")
    return launches


def check_softmax_draws(ops, prng, data, key, device) -> dict:
    """make_softmax_dataset's draws on the card, every bit against prng's
    plain draws on the card, with the keys the dataset splits: the model w
    (K, d), the features x and x_test (the normal kernel), the labels'
    Gumbel draws (rows, K) by ops.gumbel, whose uniforms on [tiny, 1) are
    the draw kernel's, against prng.gumbel, and the labels by
    ops.categorical against prng.categorical on the same logits and, one
    hot, against the dataset's y and y_test.  These launches are
    measurements: the path's counts are set to 0 after them."""
    import torch
    kx, kw, ky, kxt, kyt = prng.split(key, 5)
    k, d = data.y.shape[1], data.x.shape[1]
    rows = {}

    def bits(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t

    def hold(name, got, kernel, plain):
        want, plain_ms = timed_once(plain)
        if got.dtype != want.dtype or not torch.equal(bits(got), bits(want)):
            raise AssertionError(f"softmax data: {name} is not the plain "
                                 "draw bit for bit")
        rows[name] = {"shape": list(got.shape), "entries_differing": 0,
                      "ms": cuda_ms(kernel, 3), "plain_ms": plain_ms}

    w = ops.normal(kw, (k, d), device)
    hold("normal w", w, lambda: ops.normal(kw, (k, d), device),
         lambda: prng.normal_plain(kw, (k, d), device))
    for split, kx_, ky_, x, y in (("x", kx, ky, data.x, data.y),
                                  ("x_test", kxt, kyt, data.x_test,
                                   data.y_test)):
        m = x.shape[0]
        hold(f"normal {split}", x,
             lambda: ops.normal(kx_, (m, d), device),
             lambda: prng.normal_plain(kx_, (m, d), device))
        hold(f"gumbel of {split}'s labels",
             ops.gumbel(ky_, (m, k), device=device),
             lambda: ops.gumbel(ky_, (m, k), device=device),
             lambda: prng.gumbel(ky_, (m, k), device=device))
        logits = x @ w.T
        labels = ops.categorical(ky_, logits)
        hold(f"categorical of {split}'s labels", labels,
             lambda: ops.categorical(ky_, logits),
             lambda: prng.categorical(ky_, logits))
        if not torch.equal(prng.one_hot(labels, k), y):
            raise AssertionError(f"softmax data: the labels of {split} are "
                                 "not the categorical draws on its logits")
    return rows


# The softmax path: the emnist profile's widths (d = 784, K = 10, 40,000
# test rows) with n cut from 240,000 to SOFTMAX_N so that it fits the card
# (softmax_bytes), fig. 9's sketch rule, and its kernel check on
# SOFTMAX_CHECK_BLOCKS of the path's first draw of blocks.
SOFTMAX_N = 180_000
SOFTMAX_CHECK_BLOCKS = 8
# Blocks of the library call's sparse sketch: its COO build and coalesce
# take ~0.1 GB a block beside A's 56.4 GB, so all 230 would not fit.
SOFTMAX_LIBRARY_BLOCKS = 64


def softmax_sketch_dim(dk: int) -> int:
    """benchmarks/fig9_softmax.py's sketch rule: m = ((6 dK) // b + 1) b."""
    return ((6 * dk) // BLOCK + 1) * BLOCK


def softmax_bytes(n: int, d: int, k: int, n_test: int, blocks: int) -> dict:
    """What the softmax path holds on the card at once, at n training rows:
    A = hess_sqrt (n K, d K), the count sketch's codes h and sigma
    (blocks, n K) each, the sort's (row, sigma) pairs, the features, the
    product-code encodes of X and X^T (their padding counted), the fused
    kernel's A_tilde chunk and Gram partials, and the (d K)^2 Gram with
    eigh's matrix of vectors; in bytes."""
    from repro_torch.core import coded
    from repro_torch.kernels import oversketch_matmul, sketch_gram
    rows, dk = n * k, d * k
    cx, cxt = coded.make_code(n, BLOCK), coded.make_code(d, BLOCK)
    chunk = sketch_gram.chunk_blocks(blocks, BLOCK, dk)
    parts = {
        "A": 4.0 * rows * dk,
        "codes": 2 * 4.0 * blocks * rows,
        "sort": 8.0 * blocks * rows,
        "x": 4.0 * (n + n_test) * d,
        "encodes": 4.0 * BLOCK * (cx.num_workers * d + cxt.num_workers * n),
        "chunk": 4.0 * chunk * BLOCK * dk
        + 4.0 * 2 * oversketch_matmul.gram_tiles(dk)
        * oversketch_matmul.GRAM_TILE ** 2,
        "gram_eigh": 3 * 4.0 * dk * dk}
    parts["total"] = sum(parts.values())
    return parts


def check_softmax_kernels(ops, ref, solvers, a, h, sg, device) -> dict:
    """sketch_gram_count at the softmax path's shape: the first
    SOFTMAX_CHECK_BLOCKS of the blocks h, sg (one in eight masked) over all
    of A's n K rows at the full d K width, against the plain version and
    beside the library call; then all SOFTMAX_LIBRARY_BLOCKS of them, the
    most whose sparse sketch the card holds beside A with margin, the
    kernel beside the library call (and within 1e-4 of it); then eigh and
    the pinv solve of the first Gram, the direction solve's cuSOLVER call
    at the path's width, timed apart."""
    import torch
    from repro_torch.benchmarks.kernels_bench import sparse_rows
    n, d = a.shape

    def library_of(h_, sg_, mask_):
        s_live = sparse_rows(h_, sg_, mask_.nonzero().squeeze(1), BLOCK, n)

        def library():
            x = torch.sparse.mm(s_live, a)
            return torch.mm(x.T, x)
        return library

    def gram_bound(kb, kl):
        return count_gram_bound(n, d, BLOCK, kb, kl)

    kb = SOFTMAX_CHECK_BLOCKS
    hc, sc = h[:kb].contiguous(), sg[:kb].contiguous()
    mask = torch.arange(kb, device=device) % 8 != 4
    kl = int(mask.sum())
    got = ops.sketch_gram_count(hc, sc, a, BLOCK, mask)
    want, plain_ms = timed_once(
        lambda: ref.sketch_gram_count(hc, sc, a, BLOCK, mask))
    row = compare("sketch_gram_count softmax", got, want)
    del want
    row["bit_identical"] = same_bits(
        "sketch_gram_count softmax",
        lambda: ops.sketch_gram_count(hc, sc, a, BLOCK, mask), got)
    row["symmetric"] = symmetric("sketch_gram_count softmax", got)
    row["ms"] = cuda_ms(lambda: ops.sketch_gram_count(hc, sc, a, BLOCK,
                                                      mask), 2, warm=False)
    row["plain_ms"] = plain_ms
    row["library_ms"] = cuda_ms(library_of(hc, sc, mask), 2)
    row["library_call"] = ("torch.sparse.mm(CSR sketch (K_live*b, n), A) "
                           "then torch.mm")
    row["bound_ms"], row["bound_by"] = gram_bound(kb, kl)
    row["shape"] = {"K": kb, "masked": kb - kl, "n": n, "d": d, "b": BLOCK}

    kw = h.shape[0]
    mask_w = torch.arange(kw, device=device) % 8 != 4
    library = library_of(h, sg, mask_w)
    # The library's Gram is the sum over the live blocks; the kernel's is
    # their mean.
    wide = compare("sketch_gram_count softmax, library's blocks",
                   ops.sketch_gram_count(h, sg, a, BLOCK, mask_w),
                   library() / float(mask_w.sum()))
    wide["ms"] = cuda_ms(lambda: ops.sketch_gram_count(h, sg, a, BLOCK,
                                                       mask_w), 2)
    wide["library_ms"] = cuda_ms(library, 2)
    wide["bound_ms"], wide["bound_by"] = gram_bound(kw, int(mask_w.sum()))
    wide["shape"] = {"K": kw, "masked": kw - int(mask_w.sum())}
    row["library_blocks"] = wide
    del library

    g = torch.randn(d, generator=torch.Generator().manual_seed(SEED)).to(
        device)
    _, row["eigh_ms"] = timed_once(lambda: torch.linalg.eigh(got))
    _, row["eigh_ms_again"] = timed_once(lambda: torch.linalg.eigh(got))
    p, row["pinv_solve_ms"] = timed_once(
        lambda: solvers.psd_pinv_solve(got, g))
    if not bool(torch.isfinite(p).all()):
        raise AssertionError("softmax: the pinv solve is not finite")
    return row


def run_softmax(core, ops, ref, solvers, data_mod, prng, sketching,
                device) -> tuple:
    """The softmax path: the data at the emnist profile's widths with n
    cut to SOFTMAX_N, the kernel checks at its shapes (the data's and the
    sketch's draws bit for bit, the fused Gram on SOFTMAX_CHECK_BLOCKS
    blocks, eigh, the coded mat-vec at its encodes),
    then PATH_ITERS iterations of oversketched_newton with the kernels,
    counted from 0 just before.  Returns (launches, the kernel rows)."""
    import torch
    from repro_torch.configs import PROFILES
    t0 = time.perf_counter()
    prof = PROFILES["emnist"]
    d, k, n_test = prof.n_features, prof.n_classes, prof.n_test
    dk = d * k
    scfg = core.OverSketchConfig(softmax_sketch_dim(dk), BLOCK, 0.25)
    k_blocks = scfg.total_blocks
    card = torch.cuda.get_device_properties(0).total_memory
    full = softmax_bytes(prof.n_train, d, k, n_test, k_blocks)
    cut = softmax_bytes(SOFTMAX_N, d, k, n_test, k_blocks)
    data = data_mod.make_softmax_dataset(prng.PRNGKey(SEED), SOFTMAX_N, d, k,
                                         n_test, device=device)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    # The data's draws, and the sketch's draw of the first iteration (key
    # kh, as the loop splits it), held against the plain versions before A
    # takes the card's memory.
    data_draws = check_softmax_draws(ops, prng, data, prng.PRNGKey(SEED),
                                     device)
    _, _, kh, _ = prng.split(prng.PRNGKey(SEED), 4)
    sketch_draws = check_draw(ops, prng, prng.fold_in(kh, 7), SOFTMAX_N * k,
                              k_blocks, BLOCK, device, label="softmax ",
                              nystrom=False)
    emit({"phase": "softmax_data", "profile": "emnist",
          "published": [prof.n_train, d, n_test, k],
          "n": data.x.shape[0], "d": d, "k": k, "n_test": n_test,
          "sketch_dim": scfg.sketch_dim, "block_size": BLOCK,
          "total_blocks": k_blocks, "card_bytes": card,
          "bytes_at_published_n": full, "bytes_at_n": cut,
          "cut": f"n {prof.n_train:,} -> {SOFTMAX_N:,}: at the published n "
                 f"the path holds {full['total'] / 1e9:.1f} GB (A alone "
                 f"{full['A'] / 1e9:.1f} GB), past the card's "
                 f"{card / 1e9:.1f} GB; at {SOFTMAX_N:,} it holds "
                 f"{cut['total'] / 1e9:.1f} GB.  d, K, the test rows and "
                 "the sketch are as published.",
          "class_balance": data.y.mean(0).tolist(), "seconds": seconds,
          "draws": data_draws, "sketch_draws": sketch_draws,
          "check_seconds": time.perf_counter() - t0 - seconds})

    t0 = time.perf_counter()
    objective = core.SoftmaxRegression(k)
    w0 = torch.zeros(dk, device=device)
    a = objective.hess_sqrt(w0, data)
    state = sketching.get("oversketch", scfg).sample(prng.fold_in(kh, 7),
                                                     a.shape[0],
                                                     device=device)
    # One call over all K blocks, N live as the path's k-of-n leaves them:
    # the fused Gram's share of an iteration.
    live = torch.arange(k_blocks, device=device) >= k_blocks - scfg.num_blocks
    _, full_ms = timed_once(lambda: ops.sketch_gram_count(
        state.h, state.sigma, a, BLOCK, live))
    h = state.h[:SOFTMAX_LIBRARY_BLOCKS].contiguous()
    sg = state.sigma[:SOFTMAX_LIBRARY_BLOCKS].contiguous()
    del state
    gram = check_softmax_kernels(ops, ref, solvers, a, h, sg, device)
    gram["all_blocks_ms"] = full_ms
    gram["all_blocks_live"] = int(live.sum())
    del a, h, sg
    torch.cuda.empty_cache()
    coded_rows = check_coded(ops, ref, data, BLOCK, device)
    emit({"phase": "softmax_kernels", "sketch_gram_count": gram,
          "coded_X": coded_rows["X"], "coded_XT": coded_rows["XT"],
          "tolerance_rel": REL_TOL, "seconds": time.perf_counter() - t0})
    torch.cuda.empty_cache()

    # Each iteration: one fused Gram, K coded mat-vecs each way for the
    # gradient, and the draw kernel twice (h, then sigma).
    cfg = core.NewtonConfig(iters=PATH_ITERS, sketch=scfg, solver="pinv",
                            unit_step=False, coded_block_rows=BLOCK,
                            gradient_policy="coded", use_kernels=True,
                            track_test_error=True, seed=SEED)
    launches = run_path(core, ops, objective, data, w0, cfg, "softmax",
                        {"sketch_gram_count": PATH_ITERS,
                         "coded_block_matvec": 2 * k * PATH_ITERS,
                         "draw": 2 * PATH_ITERS})
    del data
    torch.cuda.empty_cache()
    rows = {"sketch_gram_count": gram, "coded_X": coded_rows["X"],
            "coded_XT": coded_rows["XT"], "draw": sketch_draws}
    return launches, rows


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


def card_against_plain(core, ops, objective, data, w0, kw: dict,
                       label: str, clock=None) -> dict:
    """One small run on the card (kernels) and on the CPU (plain): the same
    steps, fval within rtol 1e-4; with the card run's launch counts.  With
    ``clock`` (a SimClock factory) both runs take a fresh one, and the
    simulated time, cost and sketch_dim must be equal too."""
    import numpy as np
    extra = {} if clock is None else {"model": clock()}
    ops.reset_launch_counts()
    card = core.oversketched_newton(objective, data, w0,
                                    core.NewtonConfig(use_kernels=True, **kw),
                                    device="cuda", **extra)
    launches = {k: c for k, c in ops.launch_counts().items() if c}
    extra = {} if clock is None else {"model": clock()}
    plain = core.oversketched_newton(objective, data, w0,
                                     core.NewtonConfig(use_kernels=False,
                                                       **kw), device="cpu",
                                     **extra)
    fc = np.array(card.history["fval"])
    fp = np.array(plain.history["fval"])
    if card.history["step"] != plain.history["step"] or not np.allclose(
            fc, fp, rtol=1e-4, atol=1e-6):
        raise AssertionError(f"{label}: card {fc} vs plain {fp}")
    if clock is not None:
        for k in ("time", "cost", "sketch_dim"):
            if card.history[k] != plain.history[k]:
                raise AssertionError(f"{label}: {k} on the card "
                                     f"{card.history[k]} vs the CPU "
                                     f"{plain.history[k]}")
    return {"fval_card": fc.tolist(), "fval_plain": fp.tolist(),
            "max_rel_fval_diff": float(np.max(np.abs(fc - fp)
                                              / np.abs(fp))),
            "sketch_dim": card.history["sketch_dim"],
            "launches": launches}


# The baseline optimizers at their CPU parity tests' size (n = 1,200,
# d = 20): (entry point, its keyword arguments).
OPTIMIZER_CASES = {
    "giant_wait_all": ("giant", dict(policy="wait_all")),
    "giant_gcode": ("giant", dict(policy="gcode", schedule="sequential")),
    "giant_ignore": ("giant", dict(policy="ignore", unit_step=False)),
    "first_order_gd": ("first_order", dict(method="gd")),
    "first_order_nag": ("first_order", dict(method="nag")),
    "first_order_sgd": ("first_order", dict(method="sgd")),
    "exact_newton": ("exact_newton", dict()),
}


def optimizer_card_against_cpu(ops, optim, objective, data, w0, name: str,
                               kw: dict, label: str) -> dict:
    """One small run of a baseline optimizer on the card and one on the
    CPU: iter, step, simulated time and cost equal, fval and gnorm within
    rtol 1e-4; with the card run's launch counts."""
    import numpy as np

    def run(device):
        if name == "giant":
            return optim.giant(objective, data, w0, optim.GiantConfig(
                iters=4, num_workers=24, **kw), device=device)
        if name == "first_order":
            return optim.first_order(objective, data, w0,
                                     optim.FirstOrderConfig(iters=6, **kw),
                                     device=device)
        return optim.exact_newton(objective, data, w0, iters=4, **kw,
                                  device=device)
    ops.reset_launch_counts()
    card = run("cuda")
    launches = {k: c for k, c in ops.launch_counts().items() if c}
    cpu = run("cpu")
    for k in ("iter", "step", "time", "cost"):
        if card[k] != cpu[k]:
            raise AssertionError(f"{label}: {k} on the card {card[k]} vs "
                                 f"the CPU {cpu[k]}")
    for k in ("fval", "gnorm"):
        if not np.allclose(card[k], cpu[k], rtol=1e-4, atol=1e-6):
            raise AssertionError(f"{label}: {k} on the card {card[k]} vs "
                                 f"the CPU {cpu[k]}")
    fc, fp = np.array(card["fval"]), np.array(cpu["fval"])
    return {"fval_card": fc.tolist(), "fval_cpu": fp.tolist(),
            "max_rel_fval_diff": float(np.max(np.abs(fc - fp)
                                              / np.abs(fp))),
            "launches": launches}


def run_small_reference(core, ops, optim, data_mod, prng) -> dict:
    """The verify recipe on the card (kernels) and on the CPU (plain), for
    each case of CHECK_CASES, then softmax regression at the size of its
    CPU parity test (n = 600, d = 12, K = 4, fig. 9's sketch rule, pinv),
    then each case of OPTIMIZER_CASES."""
    import numpy as np
    data = data_mod.make_logistic_dataset(prng.PRNGKey(0), 1000, 20, 200,
                                          device="cpu")
    out = {}
    for label, extra in CHECK_CASES.items():
        kw = dict(iters=4, sketch=core.OverSketchConfig(512, 64, 0.25),
                  coded_block_rows=128, gradient_policy="coded", **extra)
        out[label] = card_against_plain(
            core, ops, core.LogisticRegression(lam=1e-4), data,
            np.zeros(20, np.float32), kw, label)
    sdata = data_mod.make_softmax_dataset(prng.PRNGKey(3), 600, 12, 4, 100,
                                          device="cpu")
    kw = dict(iters=4, sketch=core.OverSketchConfig(softmax_sketch_dim(48),
                                                    BLOCK, 0.25),
              solver="pinv", unit_step=False, coded_block_rows=BLOCK,
              gradient_policy="coded")
    out["softmax"] = card_against_plain(core, ops, core.SoftmaxRegression(4),
                                        sdata, np.zeros(48, np.float32), kw,
                                        "softmax")
    # Corruption (the registry's plan, detection on) and MP growth (m = 64
    # gives 1 - 20/64 < 0.75, so the sketch doubles once): the fleet's
    # policy follows the detector's verdicts, so time and cost agree only
    # if the card's flags and decodes are the CPU's.
    from repro_torch.runtime import get_scenario
    for label, extra, plan in (
            ("corruption", dict(sketch=core.OverSketchConfig(512, 64, 0.25)),
             get_scenario("corruption", prob=0.3)),
            ("adaptive_mp", dict(sketch=core.OverSketchConfig(64, 16, 0.25),
                                 adaptive_sketch=True, adaptive_metric="mp"),
             None)):
        kw = dict(iters=4, coded_block_rows=64, gradient_policy="coded",
                  **extra)
        out[label] = card_against_plain(
            core, ops, core.LogisticRegression(lam=1e-4), data,
            np.zeros(20, np.float32), kw, label,
            clock=lambda plan=plan: core.SimClock(core.StragglerModel(),
                                                  faults=plan))
    if out["adaptive_mp"]["sketch_dim"][-1] <= 64:
        raise AssertionError("adaptive_mp: the check run's sketch did not "
                             "grow")
    odata = data_mod.make_logistic_dataset(prng.PRNGKey(0), 1200, 20, 200,
                                           device="cpu")
    for label, (name, kw) in OPTIMIZER_CASES.items():
        out[label] = optimizer_card_against_cpu(
            ops, optim, core.LogisticRegression(lam=1e-4), odata,
            np.zeros(20, np.float32), name, kw, label)
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


# Each run_path history by its label, for phases that compare two runs.
HISTORIES = {}


def run_path(core, ops, objective, data, w0, cfg, label: str,
             expect: dict, *, clock=None, after=None,
             decreasing: bool = True) -> dict:
    """One full-width run of a path through the entry point, launch counts
    set to 0 just before and read just after; checks each expected count,
    that f decreases (unless not ``decreasing``) and that every value is
    finite.  ``clock`` is the fleet to run on (a fresh default one when
    None); ``after(history)`` returns more fields for the printed row and
    more expected counts, read from the run itself."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    res = core.oversketched_newton(
        objective, data, w0, cfg, device=w0.device,
        **({} if clock is None else {"model": clock}))
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
    if cfg.adaptive_sketch:
        row["sketch_dim"] = hist["sketch_dim"]
    HISTORIES[label] = hist
    if after is not None:
        fields, more = after(hist)
        row.update(fields)
        expect = {**expect, **more}
    emit(row)
    for name, count in expect.items():
        if launches[name] != count:
            raise AssertionError(f"{label}: {name} launched "
                                 f"{launches[name]} times, expected {count}")
    if decreasing and not all(b_ < a_ for a_, b_ in zip(f, f[1:])):
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


def check_corruption_parts(ops, prng, data, b: int, device) -> dict:
    """Before the corruption paths: the clean lines' parity margin at both
    product-code encodes (the largest residual over magnitude, against the
    detector's 1e-3; no cell may be flagged), and the corruption noise's
    draw at each grid, (g+1, g+1, b), bit for bit against the plain
    normal."""
    import torch
    from repro_torch.core import coded
    from repro_torch.kernels.coded_matvec import parity_residuals
    out = {}
    gen = torch.Generator(device=device).manual_seed(SEED)
    for tag, mat in (("X", data.x), ("XT", data.x.T)):
        code = coded.make_code(mat.shape[0], b)
        enc = coded.encode_2d(mat, code)
        v = torch.randn(mat.shape[1], device=device, generator=gen)
        prods = coded.coded_block_products(enc, v)
        del enc
        known = torch.ones(prods.shape[:2], dtype=torch.bool, device=device)
        row_res, row_mag, col_res, col_mag = parity_residuals(prods, known)
        res, mag = torch.cat([row_res, col_res]), torch.cat([row_mag, col_mag])
        # Lines of the zero padding blocks have nothing to check.
        live = mag > 0
        flagged = int(coded.detect_corrupted(prods, known, code).sum())
        if flagged:
            raise AssertionError(f"corruption: {flagged} clean cells flagged "
                                 f"at the {tag} encode")
        g1 = code.grid + 1
        key = prng.fold_in(prng.PRNGKey(SEED), 777)
        got = ops.normal(key, (g1, g1, b), device)
        want = prng.normal_plain(key, (g1, g1, b), device)
        differing = int((got.view(torch.int32)
                         != want.view(torch.int32)).sum())
        if differing:
            raise AssertionError(f"normal: {differing} draws of the "
                                 f"({g1}, {g1}, {b}) noise differ")
        out[tag] = {"grid": g1, "workers": g1 * g1,
                    "max_clean_res_over_mag": float(
                        (res[live] / mag[live]).max()),
                    "lines": int(mag.numel()),
                    "zero_lines": int((~live).sum()),
                    "detector_rtol": 1e-3,
                    "noise_shape": [g1, g1, b], "noise_bits_differing": 0}
    return out


def corruption_counts(tel, iters: int, detection: bool):
    """``run_path``'s ``after`` for a corruption run: the counters its
    telemetry holds, and the launches they imply.  Every coded mat-vec is
    one launch (the rebuild where cells were corrupted, else the decode's
    products) plus one per relaunch; the normal kernel draws the noise of
    each corrupted mat-vec once."""
    def after(hist):
        counters = tel.metrics.snapshot()["counters"]
        rates = tel.metrics.gauges["coded.block_error_rate"].series
        fields = {k.partition(".")[2]: counters.get(k, 0.0) for k in (
            "coded.corruption_injected", "coded.corruption_detected",
            "coded.decode_fallbacks", "coded.paranoid_mode")}
        fields.update(block_error_rate=rates,
                      corrupted_matvecs=sum(r > 0 for r in rates),
                      detection=detection)
        fallbacks = int(fields["decode_fallbacks"])
        return fields, {"coded_block_matvec": 2 * iters + fallbacks,
                        "normal": fields["corrupted_matvecs"]}
    return after


def run_modes(core, ops, obs, prng, objective, data, w0, scfg, b: int,
              dev) -> dict:
    """The Newton loop's modes at full width, each driven and counted on
    its own: corruption (the registry's plan, detection on, 3 iterations;
    then off, 2), MP-driven growth from OverSketchConfig(6,144, 256, 0.25)
    (K = 30, 1 - 3,000/6,144 < 0.75), stall-driven growth on the main
    path's sketch, and the main path under live telemetry against the same
    run without it, then one iteration under the kernel profiler."""
    import dataclasses
    from repro_torch.runtime import get_scenario
    paths = {}
    t0 = time.perf_counter()
    emit({"phase": "corruption_parts",
          **check_corruption_parts(ops, prng, data, b, dev),
          "seconds": time.perf_counter() - t0})
    base = path_config(core, "newton", scfg, None, iters=ITERS,
                       gradient_policy="coded", use_kernels=True, seed=SEED)
    expect = {"sketch_gram_count": ITERS, "coded_block_matvec": 2 * ITERS,
              "draw": 2 * ITERS}
    for label, iters, detection in (("corruption", ITERS, True),
                                    ("corruption_blind", PATH_ITERS, False)):
        tel = obs.Telemetry()
        clock = core.SimClock(core.StragglerModel(),
                              faults=get_scenario("corruption"),
                              telemetry=tel)
        paths[label] = run_path(
            core, ops, objective, data, w0,
            dataclasses.replace(base, iters=iters,
                                corruption_detection=detection), label,
            {"sketch_gram_count": iters, "draw": 2 * iters}, clock=clock,
            after=corruption_counts(tel, iters, detection),
            decreasing=detection)
        counters = tel.metrics.snapshot()["counters"]
        if not counters.get("coded.corruption_injected"):
            raise AssertionError(f"{label}: no corruption was injected")
        if detection and counters.get("coded.paranoid_mode") != 1.0:
            raise AssertionError(f"{label}: the paranoid latch did not flip")
    emit({"phase": "corruption_gnorm",
          "detected": HISTORIES["corruption"]["gnorm"],
          "blind": HISTORIES["corruption_blind"]["gnorm"]})

    mp_sketch = core.OverSketchConfig(6144, b, 0.25)
    cfg = dataclasses.replace(base, sketch=mp_sketch, adaptive_sketch=True,
                              adaptive_metric="mp")

    def blocks(hist):
        return {"total_blocks": [
            core.OverSketchConfig(m, b, 0.25).total_blocks
            for m in hist["sketch_dim"]]}, {}
    paths["adaptive_mp"] = run_path(core, ops, objective, data, w0, cfg,
                                    "adaptive_mp", expect, after=blocks)
    dims = HISTORIES["adaptive_mp"]["sketch_dim"]
    if not dims[-1] > dims[0] or max(dims) > 4 * mp_sketch.sketch_dim:
        raise AssertionError(f"adaptive_mp: sketch_dim {dims}")
    stall_iters = ITERS + 1     # growth after iteration 2 shows in the 4th
    paths["adaptive_stall"] = run_path(
        core, ops, objective, data, w0,
        dataclasses.replace(base, iters=stall_iters, adaptive_sketch=True),
        "adaptive_stall", {"sketch_gram_count": stall_iters,
                           "coded_block_matvec": 2 * stall_iters,
                           "draw": 2 * stall_iters}, after=blocks)

    # Live telemetry: the same run without it, then with it (monitors on).
    paths["telemetry_off"] = run_path(core, ops, objective, data, w0, base,
                                      "telemetry_off", expect)
    tel = obs.Telemetry(monitors=True)

    def spans(hist):
        kinds = {}
        for sp in tel.trace.spans:
            kinds[sp.kind] = kinds.get(sp.kind, 0) + 1
        return {"spans": len(tel.trace.spans), "spans_by_kind": kinds,
                "alerts": len(tel.health.alerts),
                "alerts_by_metric": tel.health.summary()["by_metric"],
                "wall_ms_without": [t * 1e3 for t in
                                    HISTORIES["telemetry_off"]["wall_s"]]}, {}
    paths["telemetry"] = run_path(
        core, ops, objective, data, w0, base, "telemetry", expect,
        clock=core.SimClock(core.StragglerModel(), telemetry=tel),
        after=spans)
    on, off = HISTORIES["telemetry"], HISTORIES["telemetry_off"]
    for k in ("time", "cost"):
        if on[k] != off[k] or on[k] != HISTORIES["newton"][k]:
            raise AssertionError(f"telemetry: simulated {k} moved: {on[k]} "
                                 f"vs {off[k]}")
    obs.validate_trace(obs.to_perfetto(tel.trace.spans),
                       require_phases=("hessian", "linesearch"))
    reg = obs.MetricsRegistry()
    ops.set_profiler(reg)
    try:
        t0 = time.perf_counter()
        core.oversketched_newton(objective, data, w0,
                                 dataclasses.replace(base, iters=1),
                                 device=dev)
        seconds = time.perf_counter() - t0
    finally:
        ops.set_profiler(None)
    snap = reg.snapshot()
    emit({"phase": "profiler_hook", "iters": 1,
          "calls": snap["counters"],
          "us": {k: v for k, v in snap["histograms"].items()},
          "seconds": seconds})
    if set(snap["counters"]) != {"kernel.sketch_gram_count.calls",
                                 "kernel.coded_block_matvec.calls"}:
        raise AssertionError(f"profiler_hook: {snap['counters']}")
    return paths


# Fig. 6 at the synthetic profile's width: the reference bench's "full"
# iteration counts (benchmarks/fig6_logistic_synthetic.py), OSN and exact
# Newton 12, GIANT under each policy 18.
FIG6_ITERS = 12
FIG6_GIANT_ITERS = 18


def run_fig6_paper(ops, data_mod, prng, fig6, dev) -> tuple:
    """The paper's fig. 6 comparison at the synthetic profile's n and d
    through the port's fig. 6 body, kernels on: each run's launch counts
    set to 0 just before it and read just after (OSN: the fused Gram and
    its grouped gather once, the coded mat-vec twice and the draw kernel
    twice an iteration; exact Newton the coded mat-vec twice; GIANT none),
    its iterations' wall seconds and its peak device memory.  Checks that
    every value is finite and that each run ends below f(w0).  Returns the
    phase's row and the summed launch counts."""
    import torch
    t0 = time.perf_counter()
    data = data_mod.make_logistic_dataset(
        prng.PRNGKey(0), 300_000, 3_000, n_test=1_000, cond=10.0,
        sorted_layout=True, device=dev)
    torch.cuda.synchronize()
    data_s = time.perf_counter() - t0
    f0 = fig6.LogisticRegression(lam=1e-5).value(
        torch.zeros(data.x.shape[1], device=dev), data).item()
    expect = {"osn": {"sketch_gram_count": FIG6_ITERS,
                      "cs_gather_grouped": FIG6_ITERS,
                      "coded_block_matvec": 2 * FIG6_ITERS,
                      "draw": 2 * FIG6_ITERS},
              "exact_newton_spec": {"coded_block_matvec": 2 * FIG6_ITERS}}
    runs, total = {}, dict.fromkeys(ops.launch_counts(), 0)

    def observe(name, run):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t1 = time.perf_counter()
        hist = run()
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        runs[name] = {
            "iters": len(hist["fval"]),
            "wall_s_per_iter": hist["wall_s"],
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "launches": {k: v for k, v in launches.items() if v},
            "sim_seconds": hist["time"][-1], "sim_dollars": hist["cost"][-1],
            "f": hist["fval"][-1], "gnorm": hist["gnorm"][-1],
            "seconds": time.perf_counter() - t1}
        for k, v in launches.items():
            total[k] += v
            if v != expect.get(name, {}).get(k, 0):
                raise AssertionError(f"fig6_paper {name}: {k} launched {v} "
                                     "times, expected "
                                     f"{expect.get(name, {}).get(k, 0)}")
        finite = all(math.isfinite(v) for k in ("fval", "gnorm", "time",
                                                "cost") for v in hist[k])
        if not finite or not hist["fval"][-1] < f0:
            raise AssertionError(f"fig6_paper {name}: f {f0} -> "
                                 f"{hist['fval']}, finite {finite}")
        torch.cuda.empty_cache()
        return hist

    rows = fig6._fig6(data, FIG6_ITERS, FIG6_GIANT_ITERS,
                      observe=observe)
    if [r["name"] for r in rows] != [f"fig6_{n}" for n in fig6.RUNS] + [
            "fig6_speedup_osn_vs_exact"] or not all(
                math.isfinite(r["us"]) for r in rows):
        raise AssertionError(f"fig6_paper: rows {rows}")
    n, d = data.x.shape
    del data
    torch.cuda.empty_cache()
    return ({"phase": "fig6_paper", "n": n, "d": d, "data_s": data_s,
             "f0": f0, "rows": rows, "runs": runs,
             "seconds": time.perf_counter() - t0}, total)


def run_tenancy() -> dict:
    """The multi-tenant scheduler on the host: tenancy_bench's autoscaled
    shared-pool cell at its quick size (1,000 jobs at 60 a second), then
    the committed two-tenant golden trace replayed through JobScheduler,
    its seconds and dollars bit for bit the sums of the recorded rows."""
    from repro_torch import prng, tenancy
    from repro_torch.benchmarks import tenancy_bench as tb
    from repro_torch.core.straggler import SimClock, StragglerModel
    from repro_torch.runtime import CostLedger, CostModel, TraceReplayer
    from repro_torch.scheduler import WarmPool
    t0 = time.perf_counter()
    jobs = tenancy.generate_workload(tenancy.WorkloadConfig(
        seed=tb.SEED, rate=60.0, n_jobs=1_000))
    pool = WarmPool(ttl=tb.POOL_TTL, prewarmed=0)
    res = tb._drive(jobs, pool=pool, config=tenancy.TenancyConfig(
        admission=tb.OPEN, pool_aware=True,
        autoscaler=tenancy.Autoscaler(max_provisioned=400)))
    host_s = time.perf_counter() - t0
    row = tb._row("tenancy_autoscale", host_s, res, pool=pool)
    summary = res.summary()
    if summary["completed"] != 1_000 or not summary["provisioned_gb_seconds"]:
        raise AssertionError(f"tenancy: {summary}")
    fixture = ROOT / "tests" / "fixtures" / "tenancy_trace_golden.jsonl"
    rows = [json.loads(line) for line in fixture.read_text().splitlines()
            if line.strip()][1:]
    seconds, ledger = 0.0, CostLedger()
    for r in rows:
        seconds += r.get("advance", r["elapsed"])
        ledger.add(CostLedger(gb_seconds=r["gb_seconds"],
                              invocations=r["invocations"],
                              s3_puts=r["s3_puts"], s3_gets=r["s3_gets"]))
    clock = SimClock(StragglerModel(), replay=TraceReplayer(rows))
    tenancy.JobScheduler(clock, prng.PRNGKey(99), tenancy.workload_from_trace(
        [(0.0, "matvec"), (0.1, "giant")]), tenancy.TenancyConfig()).run()
    exact = (clock.time == seconds
             and clock.dollars == ledger.dollars(CostModel()))
    if not exact:
        raise AssertionError(f"tenancy golden replay: {clock.time} s, "
                             f"{clock.dollars} $ against {seconds} s, "
                             f"{ledger.dollars(CostModel())} $")
    return {"phase": "tenancy", "row": row, "summary": summary,
            "host_s": host_s, "golden_replay": {
                "phases": len(rows), "seconds": clock.time,
                "dollars": clock.dollars, "bit_for_bit": exact},
            "seconds": time.perf_counter() - t0}


# ---------------------------------------------------------------- the LM slice
# qwen3-4b (src/repro_torch/configs/qwen3_4b.py) at its published width.
LM_ARCH = "qwen3-4b"
LM_PARAMS = 4_411_424_256
# bf16 tensor-core peak of the H100 SXM (dense), for the serving bounds.
BF16_FLOPS = 989e12
LM_CHECK_SEQ = 512        # 2 sequences: forward against prefill + decode
# The reference's DECODE_TOL (tests/test_archs.py) of 0.2 at its logit
# scale of ~3.5, as a share of max |logit|.
LM_DECODE_GATE = 0.06
LM_SMOKE_TOL = {"float32": 1e-4, "bfloat16": 3e-2}   # card vs CPU, smoke
LM_BATCH, LM_MAX_SEQ, LM_REQUESTS, LM_MAX_NEW = 16, 2048, 32, 64
LM_PROMPT_LEN = 1024      # launch/serve.py's draw: 4 to this many tokens
LM_DOCS, LM_DOC_LEN, LM_FEATURE_BATCH, LM_CLASSES = 8192, 64, 128, 4
LM_HEAD_ITERS, LM_HEAD_REF_ITERS = 4, 2
LM_HEAD_BLOCK = 128       # train_osn_head's block size
LM_CODED_ROWS = 256       # train_osn_head's coded_block_rows at 8,192 rows


def peak_gib() -> float:
    import torch
    return torch.cuda.max_memory_allocated() / 2**30


def fresh_peak() -> None:
    import torch
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def run_lm_init(ops, prng, registry, dev, arch: str = LM_ARCH,
                expect: int = LM_PARAMS, phase: str = "lm_init") -> tuple:
    """A model (qwen3-4b unless ``arch``) at full width on the card from
    PRNGKey(0): one launch of the normal kernel's bfloat16 mode per drawn
    leaf."""
    import torch
    from repro_torch.models.common import flatten
    fresh_peak()
    bundle = registry.get_bundle(arch)
    count = bundle.param_count()
    if count != expect:
        raise AssertionError(f"{arch}: {count} parameters, expected "
                             f"{expect}")
    drawn = sum(1 for _, s in flatten(bundle.specs()) if s.init == "normal")
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    params = bundle.init(prng.PRNGKey(SEED), device=dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = ops.launch_counts()
    nbytes = sum(p.numel() * p.element_size() for p in params.parameters())
    held = sum(p.numel() for p in params.parameters())
    emit({"phase": phase, "arch": arch, "params": count,
          "params_held": held, "bytes": nbytes,
          "dtype": str(bundle.cfg.compute_dtype), "seconds": seconds,
          "normal_launches": launches["normal"], "drawn_leaves": drawn,
          "launches": launches, "peak_gib": peak_gib()})
    if held != count or launches["normal"] != drawn:
        raise AssertionError(f"{phase}: {held} parameters held, "
                             f"{launches['normal']} normal launches for "
                             f"{drawn} drawn leaves")
    for name, p in params.named_parameters():
        if not bool(torch.isfinite(p).all()):
            raise AssertionError(f"{phase}: {name} is not finite")
    return bundle, params, launches


def check_normal_bf16(ops, prng, dev, arch: str = LM_ARCH) -> dict:
    """The normal kernel's bfloat16 mode at the embedding's shape (qwen3-4b
    unless ``arch``: 151,936 x 2,560, lm_init's largest leaf) against the
    plain draw on the card, every bit."""
    import torch
    from repro_torch.models import get_config
    cfg = get_config(arch)
    shape = (cfg.vocab_size, cfg.d_model)
    key = prng.PRNGKey(SEED + 1)
    got = ops.normal(key, shape, dev, dtype=torch.bfloat16)
    want, plain_ms = timed_once(lambda: prng.normal_bf16_plain(key, shape,
                                                               dev))
    differing = int((got.view(torch.int16) != want.view(torch.int16)).sum())
    if differing:
        raise AssertionError(f"normal bf16: {differing} draws differ from "
                             "the plain version")
    row = {"max_abs_err": float((got.float() - want.float()).abs().max()),
           "entries_differing": 0, "max_abs_plain":
           float(want.float().abs().max())}
    del got, want
    row["ms"] = cuda_ms(lambda: ops.normal(key, shape, dev,
                                           dtype=torch.bfloat16), 5)
    row["plain_ms"] = plain_ms
    row["library_ms"] = None
    row["library_call"] = "none: no PyTorch call draws jax's bits"
    row["yardstick_ms"] = cuda_ms(lambda: torch.randn(
        shape, device=dev, dtype=torch.bfloat16), 5)
    count = math.prod(shape)
    row["bound_ms"], row["bound_by"] = bound(float(HASH_INT_OPS) * count,
                                             2.0 * count, INT32_OPS)
    row["shape"] = list(shape)
    return row


def frame_embeds(cfg, batch: int, dev, seed: int = SEED):
    """The audio stub's frame embeddings (batch, encoder_seq, d) from a
    seed, in the compute dtype."""
    import torch
    g = torch.Generator().manual_seed(seed)
    return torch.randn((batch, cfg.encoder_seq, cfg.d_model),
                       generator=g).to(cfg.compute_dtype).to(dev)


def model_forward(cfg, params, toks, frames=None):
    """forward's logits of any family (the encoder-decoder's with its
    frames)."""
    from repro_torch.models import encdec, transformer
    if cfg.family == "encdec":
        return encdec.forward(cfg, params, toks, frames)[0]
    return transformer.forward(cfg, params, toks)[0]


def smoke_check(prng, registry, serve, arch: str, dev) -> dict:
    """The smoke-width model on the card against the CPU, float32
    (forward's last logits within 1e-4 of max |CPU|, the server's tokens
    equal) and bfloat16 (the gap, within the CPU tests' 3e-2).  The
    encoder-decoder has no server (the reference's passes no frames)."""
    import numpy as np
    import torch
    from repro_torch.configs import smoke_config
    smoke = {}
    for dtype in ("float32", "bfloat16"):
        cfg = smoke_config(arch).scaled(dtype=dtype)
        b = registry.ModelBundle(cfg)
        cpu = b.init(prng.PRNGKey(SEED), device="cpu")
        card = b.init(prng.PRNGKey(SEED), device=dev)
        rs = np.random.RandomState(SEED)
        toks = torch.from_numpy(rs.randint(1, cfg.vocab_size - 1, (2, 40)))
        frames = frame_embeds(cfg, 2, "cpu") if cfg.family == "encdec" \
            else None
        want = model_forward(cfg, cpu, toks, frames)[:, -1].float()
        got = model_forward(cfg, card, toks.to(dev), None if frames is None
                            else frames.to(dev))[:, -1].float()
        rel = float((got.cpu() - want).abs().max() / want.abs().max())
        row = {"forward_rel_err": rel, "tol": LM_SMOKE_TOL[dtype]}
        if rel > LM_SMOKE_TOL[dtype]:
            raise AssertionError(f"{arch} {dtype}: card and CPU logits "
                                 f"differ by {rel} of max |CPU|")
        if cfg.family != "encdec":
            prompts = [rs.randint(1, cfg.vocab_size - 1, rs.randint(4, 16))
                       for _ in range(10)]
            outs = [serve.BatchedServer(b, p, batch=4, max_seq=128).generate(
                prompts, max_new=12) for p in (cpu, card)]
            row["served_equal"] = outs[0] == outs[1]
            row["served_slots_differing"] = sum(a != c for a, c in
                                                zip(*outs))
            if dtype == "float32" and not row["served_equal"]:
                raise AssertionError(f"{arch}: the card served other tokens "
                                     "than the CPU at float32")
        smoke[dtype] = row
    return smoke


def serving_invariant(bundle, params, dev, seq: int) -> dict:
    """The reference's serving invariant at full width, 2 sequences:
    prefill of seq - 1 tokens plus one decode against forward's last
    logits over seq tokens; the gate is LM_DECODE_GATE of max |logit|."""
    import numpy as np
    import torch
    cfg = bundle.cfg
    rs = np.random.RandomState(SEED + 1)
    toks = torch.from_numpy(rs.randint(1, cfg.vocab_size - 1,
                                       (2, seq))).to(dev)
    frames = frame_embeds(cfg, 2, dev) if cfg.family == "encdec" else None
    full = model_forward(cfg, params, toks, frames)[:, -1].float()
    cache = bundle.init_cache(2, seq, device=dev)
    _, cache = bundle.prefill(params, toks[:, :-1], cache, frames)
    dec, cache = bundle.decode(params, cache, toks[:, -1])
    diff = float((dec.float() - full).abs().max())
    scale = float(full.abs().max())
    return {"sequences": 2, "tokens": seq, "max_abs_diff": diff,
            "max_abs_logit": scale, "gate": LM_DECODE_GATE * scale,
            "pos": cache["pos"], "finite": bool(torch.isfinite(full).all())}


def check_invariant(row: dict, label: str) -> None:
    """Raise unless ``serving_invariant``'s row is finite and in its gate
    (after the row is printed)."""
    if not row["finite"] or not row["max_abs_diff"] <= row["gate"]:
        raise AssertionError(f"{label}: decode drifts {row['max_abs_diff']} "
                             f"from forward (gate {row['gate']})")


def run_lm_check(prng, registry, serve, bundle, params, dev) -> dict:
    """The card against the CPU at smoke width (``smoke_check``), then the
    reference's serving invariant at full width: prefill of S - 1 tokens
    plus one decode against forward's last logits, 2 sequences of 512."""
    fresh_peak()
    t0 = time.perf_counter()
    smoke = smoke_check(prng, registry, serve, LM_ARCH, dev)
    row = {"phase": "lm_check", "smoke": smoke,
           "full_width": serving_invariant(bundle, params, dev,
                                           LM_CHECK_SEQ),
           "peak_gib": peak_gib(), "seconds": time.perf_counter() - t0}
    emit(row)
    check_invariant(row["full_width"], "lm_check")
    return row


class TimedBundle:
    """A bundle whose prefill and decode are timed (the device synchronized
    around each), for the server's per-wave and per-step times."""

    def __init__(self, bundle):
        self.bundle, self.cfg = bundle, bundle.cfg
        self.prefill_ms, self.prefill_len = [], []
        self.decode_ms, self.decode_ctx = [], []

    def init_cache(self, *args, **kw):
        return self.bundle.init_cache(*args, **kw)

    def _timed(self, fn, *args):
        import torch
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def prefill(self, params, tokens, cache, extra=None):
        out, ms = self._timed(self.bundle.prefill, params, tokens, cache,
                              extra)
        self.prefill_ms.append(ms)
        self.prefill_len.append(tokens.shape[1])
        return out

    def decode(self, params, cache, token):
        self.decode_ctx.append(cache["pos"] + 1)
        out, ms = self._timed(self.bundle.decode, params, cache, token)
        self.decode_ms.append(ms)
        return out


def lm_bound(analytic, registry, cfg, kind: str, seq: int) -> dict:
    """launch/analytic.py's flops and HBM bytes of one prefill wave or one
    decode step of LM_BATCH sequences at context ``seq`` on one card, and
    the bound: the larger of flops at BF16_FLOPS and bytes at
    HBM_BYTES_PER_S."""
    c = analytic.cell_costs(cfg, registry.ShapeSpec(kind, kind, seq,
                                                    LM_BATCH),
                            chips=1, mesh_model=1, mesh_data=1)
    t_f = c.flops_per_chip / BF16_FLOPS * 1e3
    t_b = c.hbm_bytes_per_chip / HBM_BYTES_PER_S * 1e3
    return {"flops": c.flops_per_chip, "bytes": c.hbm_bytes_per_chip,
            "bound_ms": max(t_f, t_b),
            "bound_by": "operations" if t_f >= t_b else "bytes"}


def generate_with_frames(bundle, params, prompts, frames, max_new: int,
                         max_seq: int):
    """The server's wave for the encoder-decoder (the reference's server
    passes no frames): prompts left-padded with 0, one prefill with the
    frames, then greedy decode steps, as ``BatchedServer.generate``."""
    import numpy as np
    import torch
    dev = frames.device
    plen = max(len(p) for p in prompts)
    toks = np.zeros((len(prompts), plen), np.int64)
    for i, p in enumerate(prompts):
        toks[i, plen - len(p):] = p
    cache = bundle.init_cache(len(prompts), max_seq, device=dev)
    logits, cache = bundle.prefill(params, torch.from_numpy(toks).to(dev),
                                   cache, frames)
    tok = logits[:, -1].argmax(dim=-1)
    out = [[] for _ in prompts]
    for _ in range(max_new):
        for o, t in zip(out, tok.tolist()):
            o.append(t)
        logits, cache = bundle.decode(params, cache, tok)
        tok = logits.argmax(dim=-1)
    return out


def run_lm_serve(serve, analytic, registry, bundle, params, dev,
                 requests: int = LM_REQUESTS, max_new: int = LM_MAX_NEW,
                 phase: str = "lm_serve") -> dict:
    """BatchedServer(batch 16, max_seq 2,048) on ``requests`` requests
    (32 for qwen3-4b), prompt lengths drawn as launch/serve.py's main
    draws them (RandomState(0), 4 to 1,024 tokens), ``max_new`` new tokens
    each; the encoder-decoder through its bundle with seeded frames."""
    import numpy as np
    fresh_peak()
    cfg = bundle.cfg
    rs = np.random.RandomState(0)
    prompts = [rs.randint(1, cfg.vocab_size - 1,
                          rs.randint(4, LM_PROMPT_LEN + 1))
               for _ in range(requests)]
    timed = TimedBundle(bundle)
    frames = None
    t0 = time.perf_counter()
    if cfg.family == "encdec":
        frames = frame_embeds(cfg, LM_BATCH, dev)
        outs = []
        for w in range(0, requests, LM_BATCH):
            outs += generate_with_frames(timed, params,
                                         prompts[w:w + LM_BATCH], frames,
                                         max_new, LM_MAX_SEQ)
    else:
        server = serve.BatchedServer(timed, params, LM_BATCH, LM_MAX_SEQ)
        outs = server.generate(prompts, max_new)
    wall = time.perf_counter() - t0
    new = sum(len(o) for o in outs)
    if len(outs) != requests or not all(
            1 <= len(o) <= max_new and all(0 <= t < cfg.vocab_size
                                           for t in o) for o in outs):
        raise AssertionError(f"{phase}: malformed outputs")
    waves = [{"prompt_len": n, "ms": ms, **lm_bound(analytic, registry,
                                                     cfg, "prefill", n)}
             for n, ms in zip(timed.prefill_len, timed.prefill_ms)]
    steps = [dict(ms=ms, ctx=c, **lm_bound(analytic, registry, cfg,
                                          "decode", c))
             for c, ms in zip(timed.decode_ctx, timed.decode_ms)]
    ms = sorted(st["ms"] for st in steps)
    bounds = sorted(st["bound_ms"] for st in steps)
    row = {"phase": phase, "arch": cfg.name, "requests": requests,
           "batch": LM_BATCH, "max_seq": LM_MAX_SEQ, "max_new": max_new,
           "prompt_lens": [len(p) for p in prompts], "new_tokens": new,
           "wall_s": wall, "tokens_per_s": new / wall, "waves": waves,
           "decode_steps": len(steps),
           "decode_ms_median": ms[len(ms) // 2], "decode_ms_max": ms[-1],
           "decode_ms_min": ms[0],
           "decode_bound_ms_median": bounds[len(bounds) // 2],
           "decode_bound_by": steps[0]["bound_by"],
           "decode_ms_first_wave": [st["ms"] for st in steps[:3]],
           "first_outputs": [o[:8] for o in outs[:2]],
           "peak_gib": peak_gib()}
    row["decode_profile"] = profile_decode(bundle, params, dev, frames=frames)
    emit(row)
    return row


def profile_decode(bundle, params, dev, steps: int = 3,
                   frames=None) -> dict:
    """torch.profiler over ``steps`` decode steps of LM_BATCH sequences
    after a 256-token prefill (with ``frames`` for the encoder-decoder):
    device kernels a step, device ms a step beside the wall ms, and the
    device's idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    cfg = bundle.cfg
    toks = torch.randint(1, cfg.vocab_size - 1, (LM_BATCH, 256),
                         generator=torch.Generator().manual_seed(SEED)
                         ).to(dev)
    cache = bundle.init_cache(LM_BATCH, 512, device=dev)
    logits, cache = bundle.prefill(params, toks, cache, frames)
    tok = logits[:, -1].argmax(dim=-1)
    logits, cache = bundle.decode(params, cache, tok)    # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            logits, cache = bundle.decode(params, cache,
                                          logits.argmax(dim=-1))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(dev_us(e) for e in events) / 1e3
    top = sorted(events, key=dev_us, reverse=True)[:8]
    return {"steps": steps, "context": cache["pos"],
            "wall_ms_per_step": wall_ms / steps,
            "device_ms_per_step": device_ms / steps,
            "idle_share": 1.0 - device_ms / wall_ms,
            "kernels_per_step": sum(e.count for e in events) / steps,
            "top": [{"op": e.key[:80], "device_ms": dev_us(e) / 1e3,
                     "calls": e.count} for e in top]}


def lm_documents(arch: str = LM_ARCH, docs: int = LM_DOCS):
    """``docs`` synthetic documents of LM_DOC_LEN tokens with
    class-conditioned token ranges (examples/osn_lm_head.py's recipe)."""
    import numpy as np
    from repro_torch.models import get_config
    vocab = get_config(arch).vocab_size
    rs = np.random.RandomState(SEED)
    labels = rs.randint(0, LM_CLASSES, docs)
    span = vocab // LM_CLASSES
    tokens = (rs.randint(1, span - 1, (docs, LM_DOC_LEN)) +
              labels[:, None] * span).astype(np.int64)
    return tokens, labels


def run_lm_features(training, bundle, params, dev, docs: int = LM_DOCS,
                    phase: str = "lm_features") -> tuple:
    """extract_features over the documents in batches of 128."""
    import torch
    fresh_peak()
    tokens, labels = lm_documents(bundle.cfg.name, docs)
    toks = torch.from_numpy(tokens).to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    feats = torch.cat([training.extract_features(
        bundle, params, toks[i:i + LM_FEATURE_BATCH])
        for i in range(0, docs, LM_FEATURE_BATCH)])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if feats.shape != (docs, bundle.cfg.d_model) or \
            not bool(torch.isfinite(feats).all()):
        raise AssertionError(f"{phase}: {tuple(feats.shape)} or not "
                             "finite")
    emit({"phase": phase, "arch": bundle.cfg.name, "documents": docs,
          "tokens_each": LM_DOC_LEN, "batch": LM_FEATURE_BATCH,
          "classes": LM_CLASSES, "shape": list(feats.shape),
          "seconds": seconds, "tokens_per_s": docs * LM_DOC_LEN / seconds,
          "feature_abs_max": float(feats.abs().max()),
          "peak_gib": peak_gib()})
    return feats, torch.from_numpy(labels).to(dev)


def count_gram_bound(n: int, d: int, b: int, kb: int, kl: int) -> tuple:
    """The fused count-sketch Gram's bound: kl live blocks of b rows each
    sketch all n rows of the (n, d) A (2 n d) and add their (d, d) Gram
    (b d (d + 1)); A read once, h and sigma once, G written once."""
    return bound(float(kl) * (2.0 * n * d + b * d * (d + 1)),
                 4.0 * (n * d + 2 * kl * n + d * d) + kb)


def pinv_sensitivity(core, objective, data, g_kernel, g_plain,
                     dk: int) -> dict:
    """How far the pinv direction (rtol 1e-6 of the largest eigenvalue,
    core/solvers.py) moves between the kernel's Gram and the plain
    version's, which differ by fp32 rounding: the first iteration's
    direction from each, their relative gap beside the Grams', and the
    kernel Gram's eigenvalues by band of lambda / lambda_max."""
    import torch
    from repro_torch.core import solvers
    grad = objective.gradient_via(torch.zeros(dk, device=g_kernel.device),
                                  data)
    p_k = solvers.psd_pinv_solve(g_kernel, grad)
    p_p = solvers.psd_pinv_solve(g_plain, grad)
    ev = torch.linalg.eigvalsh(g_kernel).abs()
    top = float(ev.max())
    bands = {}
    for lo, hi in ((0.0, 1e-6), (1e-6, 1e-5), (1e-5, 1e-4), (1e-4, 1e-2),
                   (1e-2, 1.01)):
        bands[f"[{lo:g}, {hi:g})"] = int(((ev >= lo * top) &
                                          (ev < hi * top)).sum())
    return {"gram_rel_gap": float((g_kernel - g_plain).norm()
                                  / g_plain.norm()),
            "direction_rel_gap": float((p_k - p_p).norm() / p_p.norm()),
            "eigenvalues_by_band": bands}


def check_head_kernels(ops, ref, core, prng, sketching, feats, onehot,
                       dev, label: str = "lm_osn_head") -> dict:
    """sketch_gram_count at the head's Hessian factor A = hess_sqrt(0)
    ((32,768, 10,240) on qwen3-4b's features) and the first iteration's
    draw (key kh, as the loop splits it), the path's k-of-n share of the
    blocks live (320 of 400 there, the rest masked from SEED), against its
    plain version and beside the library call; the draw kernel at that
    draw; the coded mat-vec at the features' two encodes, 5% of the
    workers erased."""
    import torch
    from repro_torch.benchmarks.kernels_bench import sparse_rows
    k = LM_CLASSES
    data = core.Dataset(x=feats, y=onehot)
    objective = core.SoftmaxRegression(num_classes=k)
    n, dk = feats.shape[0] * k, feats.shape[1] * k
    scfg = core.OverSketchConfig(max(LM_HEAD_BLOCK, LM_HEAD_BLOCK * (
        -(-4 * dk // LM_HEAD_BLOCK))), LM_HEAD_BLOCK, 0.25)
    kb, b = scfg.total_blocks, LM_HEAD_BLOCK
    a = objective.hess_sqrt(torch.zeros(dk, device=dev), data)
    _, _, kh, _ = prng.split(prng.PRNGKey(SEED), 4)
    key = prng.fold_in(kh, 7)
    draws = check_draw(ops, prng, key, n, kb, b, dev, label=label + " ",
                       nystrom=False)
    state = sketching.get("oversketch", scfg).sample(key, n, device=dev)
    mask = drop_mask(kb, kb - scfg.num_blocks, dev)
    kl = int(mask.sum())
    got = ops.sketch_gram_count(state.h, state.sigma, a, b, mask)
    want, plain_ms = timed_once(
        lambda: ref.sketch_gram_count(state.h, state.sigma, a, b, mask))
    row = compare(f"sketch_gram_count {label}", got, want)
    row["pinv"] = pinv_sensitivity(core, objective, data, got, want, dk)
    del want
    row["bit_identical"] = same_bits(
        f"sketch_gram_count {label}",
        lambda: ops.sketch_gram_count(state.h, state.sigma, a, b, mask), got)
    row["symmetric"] = symmetric(f"sketch_gram_count {label}", got)
    row["ms"] = cuda_ms(lambda: ops.sketch_gram_count(
        state.h, state.sigma, a, b, mask), 2, warm=False)
    row["plain_ms"] = plain_ms
    s_live = sparse_rows(state.h, state.sigma, mask.nonzero().squeeze(1),
                           b, n)

    def library():
        x = torch.sparse.mm(s_live, a)
        return torch.mm(x.T, x)
    row["library_ms"] = cuda_ms(library, 2)
    row["library_call"] = ("torch.sparse.mm(CSR sketch (K_live*b, n), A) "
                           "then torch.mm")
    row["bound_ms"], row["bound_by"] = count_gram_bound(n, dk, b, kb, kl)
    row["shape"] = {"K": kb, "masked": kb - kl, "n": n, "d": dk, "b": b}
    _, row["eigh_ms"] = timed_once(lambda: torch.linalg.eigh(got))
    del s_live, got, a, state
    torch.cuda.empty_cache()
    coded_rows = check_coded(ops, ref, data, LM_CODED_ROWS, dev)
    return {"sketch_gram_count": row, "coded_X": coded_rows["X"],
            "coded_XT": coded_rows["XT"], "draw": draws}


def run_osn_head(ops, training, feats, labels, onehot, label: str,
                 iters: int, use_kernels: bool, expect: dict) -> tuple:
    """train_osn_head on the features, launch counts set to 0 just before
    and read just after; each expected count checked."""
    import torch
    fresh_peak()
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    w, hist = training.train_osn_head(feats, onehot, num_classes=LM_CLASSES,
                                      iters=iters, use_kernels=use_kernels)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    seconds = time.perf_counter() - t0
    pred = (feats @ w.reshape(LM_CLASSES, -1).T).argmax(dim=1)
    acc = float((pred == labels).float().mean())
    row = {"phase": label, "iters": iters, "use_kernels": use_kernels,
           "launches": launches, "fval": hist["fval"],
           "gnorm": hist["gnorm"], "step": hist["step"],
           "sim_seconds": hist["time"], "sim_dollars": hist["cost"],
           "wall_ms": [t * 1e3 for t in hist["wall_s"]],
           "train_accuracy": acc, "peak_gib": peak_gib(),
           "seconds": seconds}
    emit(row)
    for name, count in expect.items():
        if launches[name] != count:
            raise AssertionError(f"{label}: {name} launched "
                                 f"{launches[name]} times, expected {count}")
    f = [math.log(LM_CLASSES)] + hist["fval"]
    if not all(b_ < a_ for a_, b_ in zip(f, f[1:])) or not all(
            math.isfinite(v) for k in ("fval", "gnorm", "time", "cost")
            for v in hist[k]):
        raise AssertionError(f"{label}: f does not decrease or a value is "
                             f"not finite: {f}")
    if not acc > 1.0 / LM_CLASSES:
        raise AssertionError(f"{label}: train accuracy {acc} is not above "
                             "chance")
    return launches, hist


def run_lm(ops, ref, core, prng, sketching, dev) -> tuple:
    """The LM slice: init, checks, serving and features on qwen3-4b at
    full width, then the OSN readout head with and without the fused
    kernel.  Returns (launches by run, the head's kernel rows)."""
    import torch
    from repro_torch import training
    from repro_torch.launch import analytic, serve
    from repro_torch.models import registry
    paths = {}
    bundle, params, paths["lm_init"] = run_lm_init(ops, prng, registry, dev)
    run_lm_check(prng, registry, serve, bundle, params, dev)
    run_lm_serve(serve, analytic, registry, bundle, params, dev)
    feats, labels = run_lm_features(training, bundle, params, dev)
    del params
    fresh_peak()
    t0 = time.perf_counter()
    onehot = prng.one_hot(labels, LM_CLASSES)
    rows = check_head_kernels(ops, ref, core, prng, sketching, feats, onehot,
                              dev)
    rows["normal_bf16"] = check_normal_bf16(ops, prng, dev)
    emit({"phase": "lm_head_kernels", **rows, "tolerance_rel": REL_TOL,
          "seconds": time.perf_counter() - t0})
    torch.cuda.empty_cache()
    k = LM_CLASSES
    paths["lm_osn_head"], fused = run_osn_head(
        ops, training, feats, labels, onehot, "lm_osn_head", LM_HEAD_ITERS,
        True, {"sketch_gram_count": LM_HEAD_ITERS,
               "coded_block_matvec": 2 * k * LM_HEAD_ITERS,
               "draw": 2 * LM_HEAD_ITERS, "normal": 0})
    paths["lm_osn_head_reference"], plain = run_osn_head(
        ops, training, feats, labels, onehot, "lm_osn_head_reference",
        LM_HEAD_REF_ITERS, False,
        {"sketch_gram_count": 0, "coded_block_matvec": 2 * k *
         LM_HEAD_REF_ITERS, "draw": 2 * LM_HEAD_REF_ITERS})
    # The fleet's phases must be the same: simulated time, cost and the
    # line search's steps equal.  fval and gnorm are printed: the pinv
    # direction inverts eigenvalues down to 1e-6 of the largest, inside
    # the fp32 rounding of a 10,240-wide Gram (lm_head_kernels' "pinv"),
    # so the two Grams' rounding moves the iterates apart.
    m = LM_HEAD_REF_ITERS
    agree = {"time_equal": plain["time"] == fused["time"][:m],
             "cost_equal": plain["cost"] == fused["cost"][:m],
             "steps_equal": plain["step"] == fused["step"][:m],
             "fval_rel": [abs(a - b) / abs(b) for a, b in
                          zip(plain["fval"], fused["fval"])],
             "gnorm_rel": [abs(a - b) / abs(b) for a, b in
                           zip(plain["gnorm"], fused["gnorm"])]}
    emit({"phase": "lm_osn_head_agreement", **agree})
    if not (agree["time_equal"] and agree["cost_equal"]
            and agree["steps_equal"]):
        raise AssertionError(f"lm_osn_head: the fused and the reference "
                             f"configurations disagree: {agree}")
    return paths, rows

# ------------------------------------------------- the MoE slice and families
# qwen3-moe-30b-a3b (src/repro_torch/configs/qwen3_moe_30b_a3b.py) at its
# published width: 61.06 GB of bf16 weights, the first init leaves past
# 2^32 counters (w_gate, w_up, w_down: 48 x 128 x 2,048 x 768 each).
MOE_ARCH = "qwen3-moe-30b-a3b"
MOE_PARAMS = 30_532_122_624
# Two whole groups of 256 in the prefill: the decoded token opens a group
# of its own in forward's 513 tokens, so neither run drops its
# assignments and the invariant compares like with like.
MOE_CHECK_SEQ = 513
MOE_REQUESTS = 16         # one wave of LM_BATCH
MOE_DOCS = 4096           # the head's documents: A is (16,384, 8,192)
MOE_WINDOW = 4096         # bf16 draws checked around 2^32 and at the end
MOE_235B = "qwen3-moe-235b-a22b"
MOE_235B_PARAMS = 235_093_634_560
FAMILY_ARCHS = {"mamba2-780m": 780_148_992,
                "recurrentgemma-2b": 2_894_574_080,
                "whisper-large-v3": 1_577_408_000}
FAMILY_MAX_NEW = 32


def stacked_window(layers, start: int, count: int):
    """Elements start .. start + count - 1 of a stacked (L, ...) leaf held
    as L per-layer views (``layers``)."""
    import torch
    per = layers[0].numel()
    parts, i = [], start
    while i < start + count:
        layer, off = divmod(i, per)
        take = min(per - off, start + count - i)
        parts.append(layers[layer].reshape(-1)[off:off + take])
        i += take
    return torch.cat(parts)


def check_moe_leaf_window(prng, bundle, params, dev) -> dict:
    """The init's bfloat16 draws of the expert leaf w_gate (9,663,676,416
    elements, counters past 2^32) against the plain hash of the same
    counters on the card, times the leaf's scale: MOE_WINDOW draws around
    2^32 and at the leaf's end, bit for bit."""
    import math as m
    import torch
    from repro_torch.models.common import flatten
    leaves = flatten(bundle.specs())
    names = [p for p, _ in leaves]
    i = names.index("layers/ffn/w_gate")
    spec = leaves[i][1]
    key = prng.split(prng.PRNGKey(SEED), len(leaves))[i]
    fan_in = m.prod(spec.shape[d] for d in spec.fan_in_dims)
    scale = torch.tensor(1.0 / m.sqrt(fan_in), dtype=torch.bfloat16,
                         device=dev)
    size = m.prod(spec.shape)
    layers = [layer.ffn.w_gate for layer in params.layers]
    row = {"leaf": names[i], "shape": list(spec.shape), "elements": size,
           "windows": []}
    around = min(1 << 32, size - MOE_WINDOW // 2)
    for start in (around - MOE_WINDOW // 2, size - MOE_WINDOW):
        got = stacked_window(layers, start, MOE_WINDOW)
        want = prng.normal_window(key, (size,), ((start, MOE_WINDOW),),
                                  torch.bfloat16, dev) * scale
        differing = int((got.view(torch.int16) !=
                         want.view(torch.int16)).sum())
        row["windows"].append({"start": start, "count": MOE_WINDOW,
                               "differing": differing})
        if differing:
            raise AssertionError(f"lm_moe_init: {differing} draws of "
                                 f"{names[i]} from {start} differ from the "
                                 "plain hash")
    return row


class DropCounter:
    """Wraps ``moe.route`` while a forward runs: assignments routed and
    dropped, of real tokens (a group's zero padding is routed too, and its
    zero rows are left out here).  The first layer's top-k and capacity
    positions are also taken on the CPU from the card's probabilities
    (the stable sorts and scatters of ``moe.top_k`` and
    ``moe.slot_positions``) and must be the card's exactly."""

    def __init__(self, moe):
        self.moe, self.route = moe, moe.route
        self.assignments = self.dropped = 0
        self.cpu_equal = None

    def __enter__(self):
        def counted(cfg, router, xg, cap):
            r = self.route(cfg, router, xg, cap)
            real = (xg.abs().amax(dim=-1) > 0)[..., None].expand_as(r.keep)
            self.assignments += int(real.sum())
            self.dropped += int((real & ~r.keep).sum())
            if self.cpu_equal is None:
                _, expert = self.moe.top_k(r.probs.cpu(), r.expert.shape[-1])
                pos, _ = self.moe.slot_positions(
                    expert.reshape(expert.shape[0], -1), cfg.num_experts)
                self.cpu_equal = bool(
                    (expert == r.expert.cpu()).all() and
                    (pos.view_as(expert) == r.pos.cpu()).all())
            return r
        self.moe.route = counted
        return self

    def __exit__(self, *exc):
        self.moe.route = self.route


def run_moe_check(prng, registry, serve, moe, transformer, bundle, params,
                  dev) -> dict:
    """The smoke-width MoE on the card against the CPU, then the serving
    invariant at full width (prefill 512 + decode 1 against forward 513),
    then the dropped assignments of forward over the check's 2 x 513
    tokens and over 16 x 512 (capacity 20 a group of 256)."""
    import numpy as np
    import torch
    fresh_peak()
    t0 = time.perf_counter()
    smoke = smoke_check(prng, registry, serve, MOE_ARCH, dev)
    full = serving_invariant(bundle, params, dev, MOE_CHECK_SEQ)
    drops = {}
    rs = np.random.RandomState(SEED + 2)
    for b, seq in ((2, MOE_CHECK_SEQ), (LM_BATCH, 512)):
        toks = torch.from_numpy(rs.randint(1, bundle.cfg.vocab_size - 1,
                                           (b, seq))).to(dev)
        with DropCounter(moe) as c:
            transformer.forward_hidden(bundle.cfg, params, toks)
        drops[f"{b}x{seq}"] = {"assignments": c.assignments,
                               "dropped": c.dropped,
                               "share": c.dropped / c.assignments,
                               "routing_card_equals_cpu": c.cpu_equal}
    row = {"phase": "lm_moe_check", "arch": MOE_ARCH, "smoke": smoke,
           "full_width": full, "dropped_in_forward": drops,
           "capacity": moe._capacity(256, bundle.cfg),
           "peak_gib": peak_gib(), "seconds": time.perf_counter() - t0}
    emit(row)
    check_invariant(full, "lm_moe_check")
    if not all(d["routing_card_equals_cpu"] for d in drops.values()):
        raise AssertionError("lm_moe_check: the card's top-k or capacity "
                             "positions differ from the CPU's")
    return row


def run_moe(ops, ref, core, prng, sketching, dev) -> tuple:
    """The MoE slice: qwen3-moe-30b-a3b at full width (init with the window
    past 2^32, checks, serving), the OSN head on its features, and
    qwen3-moe-235b-a22b's specs and analytic costs.  Returns (launches by
    run, the head's kernel rows)."""
    import torch
    from repro_torch import training
    from repro_torch.launch import analytic, serve
    from repro_torch.models import moe, registry, transformer
    paths = {}
    bundle, params, paths["lm_moe_init"] = run_lm_init(
        ops, prng, registry, dev, MOE_ARCH, MOE_PARAMS, "lm_moe_init")
    t0 = time.perf_counter()
    normal_row = check_normal_bf16(ops, prng, dev, MOE_ARCH)
    emit({"phase": "lm_moe_init_window",
          **check_moe_leaf_window(prng, bundle, params, dev),
          "normal_bf16": normal_row, "seconds": time.perf_counter() - t0})
    run_moe_check(prng, registry, serve, moe, transformer, bundle, params,
                  dev)
    run_lm_serve(serve, analytic, registry, bundle, params, dev,
                 MOE_REQUESTS, LM_MAX_NEW, "lm_moe_serve")
    feats, labels = run_lm_features(training, bundle, params, dev,
                                    MOE_DOCS, "lm_moe_features")
    del params
    fresh_peak()
    t0 = time.perf_counter()
    onehot = prng.one_hot(labels, LM_CLASSES)
    rows = check_head_kernels(ops, ref, core, prng, sketching, feats, onehot,
                              dev, "lm_moe_osn_head")
    rows["normal_bf16"] = normal_row
    emit({"phase": "lm_moe_head_kernels", **rows, "tolerance_rel": REL_TOL,
          "seconds": time.perf_counter() - t0})
    torch.cuda.empty_cache()
    k = LM_CLASSES
    paths["lm_moe_osn_head"], _ = run_osn_head(
        ops, training, feats, labels, onehot, "lm_moe_osn_head",
        LM_HEAD_ITERS, True,
        {"sketch_gram_count": LM_HEAD_ITERS,
         "coded_block_matvec": 2 * k * LM_HEAD_ITERS,
         "draw": 2 * LM_HEAD_ITERS, "normal": 0})
    del feats
    big = registry.get_bundle(MOE_235B)
    count = big.param_count()
    emit({"phase": "lm_moe_235b", "arch": MOE_235B, "params": count,
          "bf16_gb": count * 2 / 1e9,
          "decode_bound": lm_bound(analytic, registry, big.cfg, "decode",
                                   1024),
          "note": "470.19 GB of bf16 weights fit no card: specs and "
                  "launch/analytic.py only"})
    if count != MOE_235B_PARAMS:
        raise AssertionError(f"{MOE_235B}: {count} parameters")
    return paths, rows


def run_families(ops, prng, dev) -> dict:
    """mamba2-780m, recurrentgemma-2b and whisper-large-v3 at their
    published widths, one after the other: init, the smoke-width card
    against the CPU, the full-width serving invariant (2 x 512), and 16
    requests of FAMILY_MAX_NEW new tokens (whisper through its bundle with
    seeded frames (16, 1,500, 1,280)).  Returns the inits' launches."""
    from repro_torch.launch import analytic, serve
    from repro_torch.models import registry
    paths = {}
    for arch, expect in FAMILY_ARCHS.items():
        label = f"lm_families_{arch}"
        bundle, params, paths[label + "_init"] = run_lm_init(
            ops, prng, registry, dev, arch, expect, label + "_init")
        fresh_peak()
        t0 = time.perf_counter()
        row = {"phase": label + "_check", "arch": arch,
               "smoke": smoke_check(prng, registry, serve, arch, dev),
               "full_width": serving_invariant(bundle, params, dev,
                                               LM_CHECK_SEQ),
               "peak_gib": peak_gib(), "seconds": time.perf_counter() - t0}
        emit(row)
        check_invariant(row["full_width"], label)
        run_lm_serve(serve, analytic, registry, bundle, params, dev,
                     LM_BATCH, FAMILY_MAX_NEW, label + "_serve")
        del bundle, params
        fresh_peak()
    return paths



# ------------------------------------------------------- the LM training path
# qwen3-4b at its published width (36 layers, d 2,560, vocab 151,936):
# TrainerConfig(arch="qwen3-4b", smoke=False, steps=8, batch=4, seq=128,
# lr=1e-3), no checkpoint.  The restart at the same width with the depth
# cut to 2 layers (979.7M parameters, 7.84 GB of state a save).
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = 8, 4, 128, 1e-3
TRAIN_CHECK_STEPS = 5
TRAIN_CHECK_TOL = 1e-4      # card vs CPU, smoke width, float32
TRAIN_GRAD_TOL = 1e-5       # the two custom backwards, card vs CPU
TRAIN_EMBED_TOL = 1e-2      # full-width embed grad vs autograd's default
RESTART_LAYERS, RESTART_STEPS, RESTART_EVERY, RESTART_FAIL = 2, 6, 4, 5


class _Float32Smoke:
    """``configs.smoke_config`` at float32 while inside (the trainer reads
    it at construction)."""

    def __enter__(self):
        from repro_torch import configs
        self.base = configs.smoke_config
        configs.smoke_config = lambda name: self.base(name).scaled(
            dtype="float32")

    def __exit__(self, *exc):
        from repro_torch import configs
        configs.smoke_config = self.base


def check_train_backwards(dev) -> dict:
    """embed_lookup's one-hot backward and chunked_cross_entropy's value
    and gradients (chunk < S, an ignored label, tied head) on the card
    against the CPU, float32, within TRAIN_GRAD_TOL of max |CPU|."""
    import torch
    from repro_torch.models import common
    g = torch.Generator().manual_seed(SEED)
    vocab, d, b, s = 4096, 256, 4, 600
    toks = torch.randint(0, vocab, (b, s), generator=g)
    cot = torch.randn(b, s, d, generator=g)
    h = torch.randn(b, s, d, generator=g)
    head = torch.randn(vocab, d, generator=g) / 16
    labels = torch.randint(0, vocab, (b, s), generator=g)
    labels[:, -1] = -1
    out = {}
    for device in ("cpu", dev):
        emb = common.embed_grad(toks.to(device), cot.to(device), vocab,
                                torch.float32)
        hh = h.detach().to(device).requires_grad_(True)
        hd = head.detach().to(device).requires_grad_(True)
        loss = common.chunked_cross_entropy(hh, hd, labels.to(device),
                                            transpose_head=True, chunk=256)
        loss.backward()
        out[str(device)] = [emb.cpu(), loss.detach().cpu(), hh.grad.cpu(),
                            hd.grad.cpu()]
    cpu, card = out["cpu"], out[str(dev)]
    rows = {}
    for name, a, c in zip(("embed_grad", "ce_loss", "ce_grad_h",
                           "ce_grad_head"), cpu, card):
        rel = float((c - a).abs().max() / a.abs().max())
        rows[name] = rel
        if not rel <= TRAIN_GRAD_TOL:
            raise AssertionError(f"lm_train_check: {name} on the card "
                                 f"differs from the CPU by {rel}")
    rows["shapes"] = {"vocab": vocab, "d": d, "batch": b, "seq": s,
                      "ce_chunk": 256, "embed_chunk": 512}
    return rows


def run_lm_train_check(ops, dev) -> dict:
    """The trainer at smoke width, float32: TRAIN_CHECK_STEPS steps on the
    card against the CPU (loss and grad norm within TRAIN_CHECK_TOL), then
    the two custom backwards (``check_train_backwards``)."""
    from repro_torch.training import trainer as tr
    fresh_peak()
    t0 = time.perf_counter()
    hist, launches = {}, None
    with _Float32Smoke():
        for device in (dev, "cpu"):
            t = tr.Trainer(tr.TrainerConfig(
                arch=LM_ARCH, steps=TRAIN_CHECK_STEPS, batch=TRAIN_BATCH,
                seq=TRAIN_SEQ, lr=TRAIN_LR), device=device)
            ops.reset_launch_counts()
            _, _, hist[str(device)] = t.run(*t.init_state())
            if launches is None:
                launches = ops.launch_counts()
    card, cpu = hist[str(dev)], hist["cpu"]
    rel = {k: [abs(a[k] - c[k]) / abs(c[k]) for a, c in zip(card, cpu)]
           for k in ("loss", "grad_norm")}
    row = {"phase": "lm_train_check", "arch": LM_ARCH, "dtype": "float32",
           "steps": TRAIN_CHECK_STEPS, "batch": TRAIN_BATCH,
           "seq": TRAIN_SEQ, "card_loss": [h["loss"] for h in card],
           "cpu_loss": [h["loss"] for h in cpu],
           "loss_rel": rel["loss"], "grad_norm_rel": rel["grad_norm"],
           "tol": TRAIN_CHECK_TOL, "launches": launches,
           "backwards": check_train_backwards(dev),
           "seconds": time.perf_counter() - t0}
    emit(row)
    if max(rel["loss"] + rel["grad_norm"]) > TRAIN_CHECK_TOL:
        raise AssertionError(f"lm_train_check: card and CPU differ: {rel}")
    return launches


def train_bound(analytic, registry, cfg) -> dict:
    """launch/analytic.py's flops and HBM bytes of one train step of
    TRAIN_BATCH x TRAIN_SEQ tokens on one card (mesh 1 x 1), and the
    bound: the larger of flops at BF16_FLOPS and bytes at
    HBM_BYTES_PER_S."""
    c = analytic.cell_costs(cfg, registry.ShapeSpec(
        "train", "train", TRAIN_SEQ, TRAIN_BATCH), chips=1, mesh_model=1,
        mesh_data=1)
    t_f = c.flops_per_chip / BF16_FLOPS * 1e3
    t_b = c.hbm_bytes_per_chip / HBM_BYTES_PER_S * 1e3
    return {"flops": c.flops_per_chip, "bytes": c.hbm_bytes_per_chip,
            "flops_ms": t_f, "bytes_ms": t_b, "bound_ms": max(t_f, t_b),
            "bound_by": "operations" if t_f >= t_b else "bytes"}


def profile_train_step(trainer, params, opt, dev,
                       step: int = TRAIN_STEPS) -> tuple:
    """torch.profiler over one more train step (step ``step``'s batch, laid
    out as the trainer lays out its batches): device kernels, device ms
    beside the wall ms, the device's idle share and the operators that
    took the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    batch = trainer.place_batch(trainer.pipeline.device_batch(step))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        opt, _ = trainer.step(params, opt, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(dev_us(e) for e in events) / 1e3
    top = sorted(events, key=dev_us, reverse=True)[:10]
    return opt, {"wall_ms": wall_ms, "device_ms": device_ms,
                 "idle_share": 1.0 - device_ms / wall_ms,
                 "kernels": sum(e.count for e in events),
                 "top": [{"op": e.key[:80], "device_ms": dev_us(e) / 1e3,
                          "calls": e.count} for e in top]}


def train_stage_ms(trainer, params, opt, dev) -> tuple:
    """One more train step (step TRAIN_STEPS + 1's batch) in its stages,
    each bracketed by CUDA events and host clocks: the loss and its
    backward (``trainer.grads``), the grad norm, AdamW's update."""
    import torch
    from repro_torch.optim import adamw
    batch = trainer.pipeline.device_batch(TRAIN_STEPS + 1)
    out = {}

    def stage(name, fn):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        res = fn()
        end.record()
        torch.cuda.synchronize()
        out[name] = {"device_ms": start.elapsed_time(end),
                     "wall_ms": (time.perf_counter() - t0) * 1e3}
        return res
    _, grads = stage("loss_backward", lambda: trainer.grads(params, batch))
    gnorm = stage("grad_norm", lambda: adamw.global_norm(grads))
    _, opt = stage("adamw", lambda: adamw.apply(trainer.ocfg, grads, opt,
                                                params.tree, gnorm))
    return opt, out


def check_embed_grad(params, zipf, dev) -> dict:
    """The embedding's gradient at full width (151,936 x 2,560, bf16) of a
    lookup of TRAIN_BATCH x TRAIN_SEQ tokens with a seeded normal
    cotangent, the one-hot backward (``common.embed_grad``):
      * on uniform tokens (few repeat) against autograd's default gather
        backward (an index-put with atomic adds), within TRAIN_EMBED_TOL
        of max |default|;
      * on ``zipf`` (the pipeline's first batch: one token up to ~130
        times) against the float32 sum (``index_add_`` of the float32
        cotangent, rounded once to bf16), within TRAIN_EMBED_TOL; the
        default's gap from that sum is printed beside it (it adds in the
        parameter's bf16).
    Each backward timed on the Zipfian tokens."""
    import torch
    from repro_torch.models import common
    embed = params.embed
    vocab, d = embed.shape
    g = torch.Generator().manual_seed(SEED + 2)
    uniform = torch.randint(0, vocab, (TRAIN_BATCH, TRAIN_SEQ),
                            generator=g).to(dev)
    cot = torch.randn(TRAIN_BATCH, TRAIN_SEQ, d, generator=g).to(
        dev, embed.dtype)

    def default(toks):
        e = embed.detach().requires_grad_(True)
        e[toks].backward(cot)
        return e.grad

    def ours(toks):
        return common.embed_grad(toks, cot, vocab, embed.dtype)

    def f32_sum(toks):
        return torch.zeros(vocab, d, device=dev).index_add_(
            0, toks.reshape(-1), cot.float().reshape(-1, d)).to(embed.dtype)

    def rel(a, b):
        return float((a.float() - b.float()).abs().max() /
                     b.float().abs().max())
    row = {"uniform_vs_default": rel(ours(uniform), default(uniform)),
           "zipf_vs_f32_sum": rel(ours(zipf), f32_sum(zipf)),
           "default_zipf_vs_f32_sum": rel(default(zipf), f32_sum(zipf)),
           "distinct_tokens": {"uniform": int(uniform.unique().numel()),
                               "zipf": int(zipf.unique().numel())},
           "max_repeats_zipf": int(torch.bincount(zipf.reshape(-1)).max()),
           "tol": TRAIN_EMBED_TOL,
           "ms": cuda_ms(lambda: ours(zipf), 3),
           "default_ms": cuda_ms(lambda: default(zipf), 3)}
    for key in ("uniform_vs_default", "zipf_vs_f32_sum"):
        if not row[key] <= TRAIN_EMBED_TOL:
            raise AssertionError(f"lm_train: the embedding's gradient "
                                 f"{key} {row[key]}")
    return row


def run_lm_train(ops, dev) -> dict:
    """qwen3-4b at full width from PRNGKey(0): TRAIN_STEPS steps of
    TRAIN_BATCH x TRAIN_SEQ tokens; per step the loss, grad norm and step
    ms; tokens a second from the median of steps 1 .. 7; the analytic
    bound; one profiled step and one more timed in its stages; peak
    memory; the embedding's gradient against autograd's default.  The
    loss must fall, every number be finite."""
    import torch
    from repro_torch.launch import analytic
    from repro_torch.models import registry
    from repro_torch.training import trainer as tr
    fresh_peak()
    t0 = time.perf_counter()
    trainer = tr.Trainer(tr.TrainerConfig(
        arch=LM_ARCH, smoke=False, steps=TRAIN_STEPS, batch=TRAIN_BATCH,
        seq=TRAIN_SEQ, lr=TRAIN_LR), device=dev)
    ops.reset_launch_counts()
    params, opt = trainer.init_state()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    params, opt, hist = trainer.run(params, opt)
    launches = ops.launch_counts()
    state_bytes = {
        name: sum(t.numel() * t.element_size()
                  for _, t in common_leaves(tree))
        for name, tree in (("params", params.tree),
                           ("grads", trainer.grad_tree), ("mu", opt.mu),
                           ("nu", opt.nu))}
    peak_run = peak_gib()
    ms = sorted(h["step_time"] * 1e3 for h in hist[1:])
    median = ms[len(ms) // 2]
    opt, prof = profile_train_step(trainer, params, opt, dev)
    opt, stages = train_stage_ms(trainer, params, opt, dev)
    row = {"phase": "lm_train", "arch": LM_ARCH, "params":
           trainer.bundle.param_count(), "steps": TRAIN_STEPS,
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "lr": TRAIN_LR,
           "init_s": init_s,
           "loss": [h["loss"] for h in hist],
           "grad_norm": [h["grad_norm"] for h in hist],
           "step_ms": [h["step_time"] * 1e3 for h in hist],
           "step_ms_median_1_7": median,
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (median / 1e3),
           "bound": train_bound(analytic, registry, trainer.mcfg),
           "profile_step": prof, "stages": stages,
           "state_gb": {k: v / 1e9 for k, v in
                                               state_bytes.items()},
           "state_gb_total": sum(state_bytes.values()) / 1e9,
           "peak_gib": peak_run, "launches": launches}
    row["bound_share"] = row["bound"]["bound_ms"] / median
    row["embed_grad"] = check_embed_grad(
        params, trainer.pipeline.device_batch(0)["tokens"], dev)
    row["seconds"] = time.perf_counter() - t0
    emit(row)
    values = row["loss"] + row["grad_norm"]
    if not all(math.isfinite(v) for v in values):
        raise AssertionError(f"lm_train: a loss or norm is not finite: "
                             f"{values}")
    if not hist[-1]["loss"] < hist[0]["loss"]:
        raise AssertionError(f"lm_train: the loss did not fall: "
                             f"{row['loss']}")
    drawn = sum(1 for _, sp in common_leaves(trainer.bundle.specs())
                if sp.init == "normal")
    if launches["normal"] != drawn:
        raise AssertionError(f"lm_train: {launches['normal']} normal "
                             f"launches for {drawn} drawn leaves")
    return launches


def common_leaves(tree):
    from repro_torch.models.common import flatten
    return flatten(tree)


def run_lm_train_restart(ops, dev) -> dict:
    """qwen3-4b's width at RESTART_LAYERS layers: RESTART_STEPS steps
    uninterrupted, then again with a checkpoint every RESTART_EVERY steps
    into a temp dir (deleted after) and a failure at step RESTART_FAIL:
    the steps after the restore must have the uninterrupted run's losses
    and norms bit for bit.  The save (snapshot and write) and restore
    seconds are printed."""
    import shutil
    import tempfile
    import torch
    from repro_torch.models import registry
    from repro_torch.training import trainer as tr
    fresh_peak()
    t0 = time.perf_counter()

    def trainer(**kw):
        t = tr.Trainer(tr.TrainerConfig(
            arch=LM_ARCH, smoke=False, steps=RESTART_STEPS,
            batch=TRAIN_BATCH, seq=TRAIN_SEQ, lr=TRAIN_LR, **kw), device=dev)
        t.mcfg = t.mcfg.scaled(num_layers=RESTART_LAYERS)
        t.bundle = registry.ModelBundle(t.mcfg)
        return t
    ops.reset_launch_counts()
    plain = trainer()
    _, _, full = plain.run(*plain.init_state())
    del plain
    torch.cuda.empty_cache()
    directory = tempfile.mkdtemp(prefix="lm_train_restart-")
    times = {"snapshot_s": [], "write_s": [], "restore_s": []}
    try:
        t = trainer(ckpt_dir=directory, ckpt_every=RESTART_EVERY)
        save, async_save, restore = t.ckpt.save, t.ckpt.async_save, \
            t.restore

        def timed(fn, key):
            def run(*a, **k):
                s0 = time.perf_counter()
                out = fn(*a, **k)
                if key == "restore_s":
                    torch.cuda.synchronize()
                times[key].append(time.perf_counter() - s0)
                return out
            return run
        t.ckpt.save = timed(save, "write_s")
        t.ckpt.async_save = timed(async_save, "snapshot_s")
        t.restore = timed(restore, "restore_s")
        hist = t.run_with_restarts(fail_at=RESTART_FAIL)
        ckpt_bytes = sum(os.path.getsize(os.path.join(root, f))
                         for root, _, files in os.walk(directory)
                         for f in files)
        params = t.bundle.param_count()
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    launches = ops.launch_counts()
    after = {h["step"]: (h["loss"], h["grad_norm"]) for h in hist}
    want = {h["step"]: (h["loss"], h["grad_norm"]) for h in full}
    resumed = sorted(after)
    equal = all(after[s] == want[s] for s in resumed)
    row = {"phase": "lm_train_restart", "arch": LM_ARCH,
           "layers": RESTART_LAYERS, "params": params,
           "state_gb": params * (2 + 2 + 2 + 4) / 1e9,
           "checkpoint_gb": ckpt_bytes / 1e9, "steps": RESTART_STEPS,
           "ckpt_every": RESTART_EVERY, "fail_at": RESTART_FAIL,
           "resumed_steps": resumed,
           "uninterrupted": [want[s] for s in sorted(want)],
           "after_restore": [after[s] for s in resumed],
           "bit_for_bit": equal, **times, "launches": launches,
           "peak_gib": peak_gib(), "seconds": time.perf_counter() - t0}
    emit(row)
    if resumed != list(range(RESTART_EVERY, RESTART_STEPS)) or not equal:
        raise AssertionError("lm_train_restart: the steps after the "
                             "restore differ from the uninterrupted run")
    return launches


def run_training(ops, dev) -> dict:
    """The LM training path on a card holding no earlier model: the smoke
    check, qwen3-4b at full width, and the restart at 2 layers.  Returns
    each run's launches."""
    import torch
    paths = {"lm_train_check": run_lm_train_check(ops, dev)}
    torch.cuda.empty_cache()
    paths["lm_train"] = run_lm_train(ops, dev)
    torch.cuda.empty_cache()
    paths["lm_train_restart"] = run_lm_train_restart(ops, dev)
    torch.cuda.empty_cache()
    return paths



# ------------------------------------------------- mesh and distribution ---
MESH_STEPS, MESH_RESTORE_LAYERS, MESH_CKPT_AT = 4, 2, 2
DIST_TOL = 1e-4          # distributed vs local, relative to max |local|
# PERF.md section 6's kernel times (rows 1-8, then normal, draw)
TABLE_MS = {"sketch_gram_count": 89.15, "count_sketch_apply": 12.54,
            "oversketch_gram": 7.45, "coded_block_matvec": 2.315,
            "sketch_gram_sjlt": 339.08, "sketch_gram_srht": 155.71,
            "fwht": 0.0544, "fwht_two_pass": 9.301, "normal": 0.860,
            "normal_window": None, "draw": 0.436}


class NcclGroup:
    """A one-rank NCCL default group on an explicit file store in a
    temporary directory (no environment variable read), destroyed on
    exit."""

    def __enter__(self):
        import tempfile
        import torch
        import torch.distributed as dist
        self.tmp = tempfile.mkdtemp(prefix="nccl-store-")
        torch.cuda.set_device(0)
        dist.init_process_group(
            "nccl", store=dist.FileStore(os.path.join(self.tmp, "store"), 1),
            rank=0, world_size=1)
        return self

    def __exit__(self, *exc):
        import shutil
        import torch.distributed as dist
        dist.destroy_process_group()
        shutil.rmtree(self.tmp, ignore_errors=True)


# The dry run's reduced cells at smoke width (tests/test_torch_dryrun.py's
# CELLS at 4 x 2, the serving ones pinned since PR 26) and mamba2's train
# cell on a 2 x 2 x 2 ("pod", "data", "model") mesh: the card's torch
# checks the serving layouts and the local-shard forms there.
DRYRUN_SMOKE_CELLS = (("qwen3-4b", "train_4k", "4x2"),
                      ("qwen3-moe-30b-a3b", "decode_32k", "4x2"),
                      ("mamba2-780m", "long_500k", "4x2"),
                      ("recurrentgemma-2b", "prefill_32k", "4x2"),
                      ("mamba2-780m", "train_4k", "2x2x2"),
                      # the encoder-decoder loss's constraint on 2.11
                      ("whisper-large-v3", "train_4k", "4x2"),
                      # the SSD's state from the chunked scan
                      ("mamba2-780m", "prefill_32k", "4x2"))


def start_dryruns() -> list:
    """The dry run of qwen3-4b x train_4k on the 16 x 16 and 2 x 16 x 16
    fake meshes and of DRYRUN_SMOKE_CELLS, each a process of its own
    started now (host only): [(label, Popen, json path, start)]."""
    import tempfile
    runs = []
    env = dict(os.environ, PYTHONPATH=str(SRC))
    cells = [("16x16", [LM_ARCH, "train_4k"], []),
             ("2x16x16", [LM_ARCH, "train_4k"], ["--multi-pod"])]
    cells += [(f"smoke_{arch}_{shape}_{mesh}", [arch, shape],
               ["--smoke", "--mesh", mesh])
              for arch, shape, mesh in DRYRUN_SMOKE_CELLS]
    for label, (arch, shape), extra in cells:
        out = os.path.join(tempfile.mkdtemp(prefix="dryrun-"), "cell.json")
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--json-out", out, *extra],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env)
        runs.append((label, proc, out, time.perf_counter()))
    return runs


def finish_dryruns(runs) -> None:
    """Each dry run's cell: every field present, the counted flops per
    chip within dryrun.expected_band of dryrun.expected_flops_per_chip
    (1 -+ dryrun.FLOPS_TOL for every step); printed with its host
    seconds."""
    import shutil
    sys.path.insert(0, str(SRC))
    from repro_torch.launch import dryrun
    for label, proc, out, t0 in runs:
        stdout, stderr = proc.communicate(timeout=900)
        read_after = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"dryrun {label}: exit {proc.returncode}: "
                                 f"{stderr[-2000:]}")
        with open(out) as f:
            cell = json.load(f)[0]
        shutil.rmtree(os.path.dirname(out), ignore_errors=True)
        missing = [k for k in dryrun.FIELDS if k not in cell]
        a = cell.get("analytic", {})
        lo, hi = a.get("expected_band", (0, 0))
        row = {"phase": f"dryrun_{label}", "arch": cell["arch"],
               "shape": cell["shape"], "mesh": cell["mesh"],
               "chips": cell.get("chips"),
               "flops_per_chip": cell.get("flops_per_chip"),
               "bytes_per_chip_unfused": cell.get("bytes_per_chip"),
               "collective_bytes_per_chip":
                   cell.get("collective_bytes_per_chip"),
               "collectives": cell.get("collectives"),
               "memory": cell.get("memory"),
               "roofline_seconds": cell.get("roofline_seconds"),
               "bottleneck": cell.get("bottleneck"),
               "useful_flop_fraction": cell.get("useful_flop_fraction"),
               "analytic": a, "host_seconds_step":
                   cell.get("host_seconds"),
               "cell_seconds": cell.get("cell_seconds"),
               "read_after_s": read_after}
        emit(row)
        if missing:
            raise AssertionError(f"dryrun {label}: fields missing: "
                                 f"{missing}")
        if not lo <= a["counted_over_expected"] <= hi:
            raise AssertionError(f"dryrun {label}: counted / expected "
                                 f"flops {a['counted_over_expected']} "
                                 f"outside [{lo}, {hi}]")


def run_mesh_train(ops, dev) -> dict:
    """qwen3-4b at its published width on a 1 x 1 ("data", "model") mesh
    over NCCL: MESH_STEPS steps against the unsharded trainer's from the
    same key, which must be equal (a size-1 mesh dim splits nothing, so
    the same kernels run); step ms against the unsharded run's in this
    run, and one more step of each under torch.profiler (kernels, device
    ms, the host's share); then at MESH_RESTORE_LAYERS layers, the mesh
    trainer's checkpoint at step MESH_CKPT_AT restored onto the unsharded
    trainer, whose steps after it must equal the mesh run's bit for bit.
    Returns the full-width mesh run's launches."""
    import shutil
    import tempfile
    import torch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import registry
    from repro_torch.models.common import flatten
    from repro_torch.training import trainer as tr
    t_all = time.perf_counter()

    def cfg(arch=LM_ARCH, **kw):
        return tr.TrainerConfig(arch=arch, smoke=False, steps=MESH_STEPS,
                                batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                                lr=TRAIN_LR, **kw)

    def history(hist):
        return [(h["loss"], h["grad_norm"]) for h in hist]

    def median_ms(hist):
        ms = sorted(h["step_time"] * 1e3 for h in hist[1:])
        return ms[len(ms) // 2]
    fresh_peak()
    plain = tr.Trainer(cfg(), device=dev)
    params, opt, want = plain.run(*plain.init_state())
    # (the profiled step's AdamW state is dropped with the rest: the mesh
    # run needs the card the unsharded state holds)
    plain_prof = profile_train_step(plain, params, opt, dev, MESH_STEPS)[1]
    del plain, params, opt
    torch.cuda.empty_cache()
    mesh = make_mesh((1, 1), ("data", "model"))
    with NcclGroup():
        fresh_peak()
        t0 = time.perf_counter()
        trainer = tr.Trainer(cfg(), device=dev, mesh=mesh)
        ops.reset_launch_counts()
        params, opt = trainer.init_state()
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        params, opt, got = trainer.run(params, opt)
        launches = ops.launch_counts()
        peak = peak_gib()
        mesh_prof = profile_train_step(trainer, params, opt, dev,
                                       MESH_STEPS)[1]
        del trainer, params, opt
        torch.cuda.empty_cache()
        gap = max(abs(a - b) / abs(b) for pa, pb in zip(history(got),
                                                        history(want))
                  for a, b in zip(pa, pb))
        median = median_ms(got)

        # The restore onto another layout, at the same width cut in depth.
        short = f"{LM_ARCH}-{MESH_RESTORE_LAYERS}l"
        registry._REGISTRY[short] = lambda: registry.get_config(
            LM_ARCH).scaled(num_layers=MESH_RESTORE_LAYERS)
        directory = tempfile.mkdtemp(prefix="mesh_train-")
        try:
            t = tr.Trainer(cfg(short, ckpt_dir=directory,
                               ckpt_every=MESH_CKPT_AT), device=dev,
                           mesh=mesh)
            mesh_hist = t.run(*t.init_state())[2]
            del t
            torch.cuda.empty_cache()
            u = tr.Trainer(cfg(short, ckpt_dir=directory, ckpt_every=100),
                           device=dev)
            params, opt = u.init_state()
            s0 = time.perf_counter()
            opt = u.restore(MESH_CKPT_AT, params, opt)
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - s0
            replay = u.run(params, opt, MESH_CKPT_AT)[2]
            del u, params, opt
        finally:
            shutil.rmtree(directory, ignore_errors=True)
            registry._REGISTRY.pop(short, None)
            torch.cuda.empty_cache()
    tail = history(mesh_hist)[MESH_CKPT_AT:]
    plain_median = median_ms(want)

    def brief(prof):
        return {**{k: prof[k] for k in ("wall_ms", "device_ms",
                                        "idle_share", "kernels")},
                "host_ms": prof["wall_ms"] - prof["device_ms"],
                "top": prof["top"][:5]}
    row = {"phase": "mesh_train", "arch": LM_ARCH, "mesh": mesh.shape,
           "steps": MESH_STEPS, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "init_s": init_s, "loss": [h["loss"] for h in got],
           "grad_norm": [h["grad_norm"] for h in got],
           "unsharded": history(want), "largest_gap_rel": gap,
           "step_ms": [h["step_time"] * 1e3 for h in got],
           "step_ms_median_1_3": median,
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (median / 1e3),
           "unsharded_step_ms": [h["step_time"] * 1e3 for h in want],
           "unsharded_step_ms_median_1_3": plain_median,
           "mesh_over_unsharded": median / plain_median,
           "profiled_step": {"mesh": brief(mesh_prof),
                             "unsharded": brief(plain_prof)},
           "peak_gib": peak, "launches": launches,
           "restore": {"layers": MESH_RESTORE_LAYERS, "ckpt_at":
                       MESH_CKPT_AT, "mesh_run": history(mesh_hist),
                       "unsharded_after_restore": history(replay),
                       "bit_for_bit": history(replay) == tail,
                       "restore_s": restore_s},
           "seconds": time.perf_counter() - t_all}
    emit(row)
    drawn = sum(1 for _, spec in flatten(registry.get_bundle(
        LM_ARCH).specs()) if spec.init == "normal")
    if launches["normal_window"] != drawn or launches["normal"]:
        raise AssertionError(f"mesh_train: the sharded init launched the "
                             f"window mode {launches['normal_window']} "
                             f"times and the whole draw "
                             f"{launches['normal']} for {drawn} drawn "
                             "leaves")
    if history(got) != history(want):
        raise AssertionError(f"mesh_train: the 1 x 1 mesh's losses and "
                             f"norms differ from the unsharded trainer's "
                             f"(largest gap {gap})")
    if not row["restore"]["bit_for_bit"]:
        raise AssertionError("mesh_train: the unsharded replay after the "
                             "mesh's checkpoint differs")
    if not all(math.isfinite(v) for v in row["loss"] + row["grad_norm"]):
        raise AssertionError("mesh_train: a loss or norm is not finite")
    return launches


def run_distributed_paths(ops, core, data, dev) -> dict:
    """The three distributed functions on a one-rank NCCL group at the
    synthetic profile's full width (OverSketchConfig(30720, 256, 0.25),
    30 of 150 blocks masked; the X encode's 1,296 workers, 5% erased; six
    trial steps) against their local counterparts, within DIST_TOL of max
    |local|, each timed beside them.  Returns the distributed calls'
    launches (counted from 0 just before each, read just after)."""
    import torch
    from repro_torch import prng
    from repro_torch.core import coded, linesearch, sketch
    t_all = time.perf_counter()
    n, d = data.x.shape
    objective = core.LogisticRegression()
    w0 = torch.zeros(d, device=dev)
    a = objective.hess_sqrt(w0, data)
    cfg = core.OverSketchConfig(30720, BLOCK, 0.25)
    cs = core.sample_countsketch(prng.PRNGKey(SEED), n, cfg, device=dev)
    surv = drop_mask(cfg.total_blocks, 30, dev)
    code = core.make_code(n, BLOCK)
    enc = core.encode_2d(data.x, code)
    g1 = code.grid + 1
    enc_flat = enc.view(g1 * g1, BLOCK, d)
    erased = drop_mask(g1 * g1, int(CODED_ERASED * g1 * g1), dev).logical_not()
    vec = torch.randn(d, generator=torch.Generator(device=dev).manual_seed(
        SEED), device=dev)
    p = objective.gradient(w0, data)
    cand = torch.tensor([4.0 ** -i for i in range(6)], device=dev)
    out, launches = {}, {}
    with NcclGroup():
        cases = {
            "sketched_gram": (
                lambda: sketch.distributed_sketched_gram(a, cs, surv),
                lambda: core.sketched_gram(core.apply_sketch(cs, a), surv)),
            "coded_matvec": (
                lambda: coded.distributed_coded_matvec(
                    enc_flat, vec, erased, code, n)[0],
                lambda: core.coded_matvec(enc, vec, code, n,
                                          erased.view(g1, g1))[0]),
            "f_trials": (
                lambda: linesearch.distributed_f_trials(objective, data, w0,
                                                        p, cand),
                lambda: objective.value(w0[None] + cand[:, None] * p[None],
                                        data))}
        for name, (dist_fn, local_fn) in cases.items():
            ops.reset_launch_counts()
            got = dist_fn()
            torch.cuda.synchronize()
            launches[name] = {k: v for k, v in ops.launch_counts().items()
                              if v}
            want = local_fn()
            row = compare(f"distributed {name}", got, want)
            row["ms"] = cuda_ms(dist_fn, 3, warm=False)
            row["local_ms"] = cuda_ms(local_fn, 1, warm=False)
            row["launches"] = launches[name]
            out[name] = row
            del got, want
    del a, enc, enc_flat
    torch.cuda.empty_cache()
    emit({"phase": "distributed_paths", "world": 1, "backend": "nccl",
          "shapes": {"n": n, "d": d, "K": cfg.total_blocks, "b": BLOCK,
                     "workers": g1 * g1, "trials": 6},
          "rows": out, "tolerance_rel": DIST_TOL,
          "seconds": time.perf_counter() - t_all})
    if launches["sketched_gram"].get("count_sketch_apply") != 1:
        raise AssertionError("distributed_paths: the count-sketch kernel "
                             "did not launch once")
    if launches["coded_matvec"].get("coded_block_matvec") != 1:
        raise AssertionError("distributed_paths: the coded mat-vec kernel "
                             "did not launch once")
    total = {}
    for counts in launches.values():
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    return {name: total.get(name, 0) for name in ops.KERNELS}


MESH_30B = (4, 2)              # ("data", "model") of the 30B mesh_init
MESH_235B = (4, 8)
MESH_235B_RANKS = ((0, 0), (3, 7))
MESH_235B_PEAK_SHARE = 0.1     # a rank's peak, at most this of the whole
# The window mode's kernel row: the expert leaf w_gate's box of rank
# (data 3, model 1) at 4 x 2, (48, 64, 2,048, 192) bf16 draws.
WINDOW_LEAF = "layers/ffn/w_gate"
WINDOW_COORDS = {"data": 3, "model": 1}
# bf16 sub-boxes of each 235B expert leaf (local offsets in the rank's
# box, at its last layer: counters past 2^32), checked on the CPU.
SUB_BOX = ((-1, 1), (0, 2), (-2, 2), (0, 64))


def check_normal_window(ops, prng, dev, bundle, keys) -> dict:
    """The window mode against its plain version on the card, every bit,
    at WINDOW_LEAF's box of WINDOW_COORDS (the main path's largest
    window), with one float32 box of the 235B expert leaf past counter
    2^32 beside it; ms, plain ms, the hash's bound."""
    import torch
    from repro_torch.distributed.sharding import param_boxes
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.common import flatten
    names = [p for p, _ in flatten(bundle.specs())]
    i = names.index(WINDOW_LEAF)
    shape = flatten(bundle.specs())[i][1].shape
    box = param_boxes(bundle, make_mesh(MESH_30B, ("data", "model")),
                      WINDOW_COORDS)[WINDOW_LEAF]
    bf = torch.bfloat16
    got = ops.normal_window(keys[i], shape, box, dev, dtype=bf)
    want, plain_ms = timed_once(lambda: prng.normal_window(
        keys[i], shape, box, bf, dev))
    differing = int((got.view(torch.int16) != want.view(torch.int16)).sum())
    if differing:
        raise AssertionError(f"normal_window: {differing} draws differ from "
                             "the plain version")
    row = {"max_abs_err": float((got.float() - want.float()).abs().max()),
           "entries_differing": 0, "leaf": WINDOW_LEAF,
           "shape": list(shape), "box": [list(b) for b in box]}
    del got, want
    row["ms"] = cuda_ms(lambda: ops.normal_window(keys[i], shape, box, dev,
                                                  dtype=bf), 5)
    row["plain_ms"] = plain_ms
    row["library_ms"] = None
    row["library_call"] = "none: no PyTorch call draws jax's bits"
    count = math.prod(n for _, n in box)
    row["bound_ms"], row["bound_by"] = bound(float(HASH_INT_OPS) * count,
                                             2.0 * count, INT32_OPS)
    row["bound_rate"] = "INT32_OPS"
    big = (94, 128, 4096, 1536)
    far = ((93, 1), (112, 16), (0, 1024), (1152, 384))
    got = ops.normal_window(keys[i], big, far, dev)
    want, f32_plain_ms = timed_once(lambda: prng.normal_window(
        keys[i], big, far, torch.float32, dev))
    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        raise AssertionError("normal_window: a float32 box past 2^32 "
                             "differs from the plain version")
    count = math.prod(n for _, n in far)
    row["float32_past_2_32"] = {
        "shape": list(big), "box": [list(b) for b in far],
        "max_abs_err": float((got - want).abs().max()),
        "ms": cuda_ms(lambda: ops.normal_window(keys[i], big, far, dev), 5),
        "plain_ms": f32_plain_ms, "library_ms": None,
        "bound_ms": bound(float(HASH_INT_OPS) * count, 4.0 * count,
                          INT32_OPS)[0], "bound_by": "operations"}
    return row


def run_mesh_init(ops, prng, dev) -> tuple:
    """The sharded init (Trainer.init_state's on a mesh: each rank's
    boxes by ``sharding.param_boxes``, drawn alone by the normal kernel's
    window mode).  mesh_init_30b: qwen3-moe-30b-a3b at 4 x 2, leaf by
    leaf: each drawn leaf whole by the whole draw's launch, then each of
    the 8 ranks' boxes by the window mode, every box equal to its slice
    of the whole leaf bit for bit; each rank's bytes, each mode's ms
    (CUDA events around each launch) and launches.  mesh_init_235b:
    qwen3-moe-235b-a22b (470.19 GB, past any card) at 4 x 8, ranks
    MESH_235B_RANKS' whole parameter shards drawn on the card through
    ``bundle.init_local`` (the function init_state calls), their peak
    memory gated far below the whole model's, and SUB_BOX of each expert
    leaf against ``prng.normal_window`` on the CPU, bit for bit.
    Returns ({run: launches}, the window mode's kernel row)."""
    import torch
    from repro_torch.distributed.sharding import (local_shape, param_boxes,
                                                  resolve_pspec,
                                                  sharded_param_bytes)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import registry
    from repro_torch.models.common import flatten
    t_all = time.perf_counter()
    fresh_peak()
    bundle = registry.get_bundle(MOE_ARCH)
    mesh = make_mesh(MESH_30B, ("data", "model"))
    coords = [{"data": d, "model": m} for d in range(MESH_30B[0])
              for m in range(MESH_30B[1])]
    boxes = [param_boxes(bundle, mesh, c) for c in coords]
    leaves = flatten(bundle.specs())
    keys = prng.split(prng.PRNGKey(SEED), len(leaves))
    bf = torch.bfloat16
    rank_bytes = [0] * len(coords)
    ms = {"whole": 0.0, "window": 0.0}
    paths = {}
    ops.reset_launch_counts()
    for (path, spec), key in zip(leaves, keys):
        for r, b in enumerate(boxes):
            rank_bytes[r] += math.prod(n for _, n in b[path]) * 2
        if spec.init != "normal":
            continue
        leaf, t = timed_once(lambda: ops.normal(key, spec.shape, dev,
                                                dtype=bf))
        ms["whole"] += t
        for b in boxes:
            got, t = timed_once(lambda: ops.normal_window(
                key, spec.shape, b[path], dev, dtype=bf))
            ms["window"] += t
            want = leaf[tuple(slice(s0, s0 + n) for s0, n in b[path])]
            if not torch.equal(got.view(torch.int16), want.view(torch.int16)):
                raise AssertionError(f"mesh_init_30b: a box of {path} "
                                     "differs from the whole leaf's slice")
            del got, want
        del leaf
    paths["mesh_init_30b"] = ops.launch_counts()
    drawn = sum(1 for _, spec in leaves if spec.init == "normal")
    row = {"phase": "mesh_init_30b", "arch": MOE_ARCH, "mesh": mesh.shape,
           "ranks": len(coords), "rank_bytes": rank_bytes,
           "rank_gb": [b / 1e9 for b in rank_bytes],
           "whole_gb": bundle.param_count() * 2 / 1e9, "drawn_leaves": drawn,
           "boxes_bit_for_bit": drawn * len(coords), "ms": ms,
           "launches": {k: paths["mesh_init_30b"][k]
                        for k in ("normal", "normal_window")},
           "peak_gib": peak_gib(), "seconds": time.perf_counter() - t_all}
    emit(row)
    if paths["mesh_init_30b"]["normal"] != drawn or \
            paths["mesh_init_30b"]["normal_window"] != drawn * len(coords):
        raise AssertionError(f"mesh_init_30b: launches {row['launches']} "
                             f"for {drawn} leaves on {len(coords)} ranks")
    if any(b != sharded_param_bytes(bundle, mesh) for b in rank_bytes):
        raise AssertionError(f"mesh_init_30b: a rank's boxes hold "
                             f"{rank_bytes} bytes, the policy "
                             f"{sharded_param_bytes(bundle, mesh)}")
    t0 = time.perf_counter()
    kernel_row = check_normal_window(ops, prng, dev, bundle, keys)
    emit({"phase": "normal_window", **kernel_row,
          "seconds": time.perf_counter() - t0})
    torch.cuda.empty_cache()

    big = registry.get_bundle(MOE_235B)
    mesh = make_mesh(MESH_235B, ("data", "model"))
    leaves = flatten(big.specs())
    keys = prng.split(prng.PRNGKey(SEED), len(leaves))
    whole = big.param_count() * 2
    for d, m in MESH_235B_RANKS:
        t0 = time.perf_counter()
        fresh_peak()
        coords = {"data": d, "model": m}
        b = param_boxes(big, mesh, coords)
        ops.reset_launch_counts()
        tree = dict(flatten(big.init_local(prng.PRNGKey(SEED), b, dev)))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        label = f"mesh_init_235b_{d}_{m}"
        paths[label] = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        nbytes = sum(t.numel() * t.element_size() for t in tree.values())
        checked = []
        for i, (path, spec) in enumerate(leaves):
            want_shape = local_shape(spec.shape, resolve_pspec(
                spec.shape, spec.axes, mesh), mesh)
            if tuple(tree[path].shape) != want_shape:
                raise AssertionError(f"{label}: {path} drawn at "
                                     f"{tuple(tree[path].shape)}")
            if "expert_ffn" not in spec.axes:
                continue
            sub = tuple(((o % n) if o < 0 else o, k) for (o, k), (_, n) in
                        zip(SUB_BOX, b[path]))
            gbox = tuple((s0 + o, k) for (o, k), (s0, _) in zip(sub,
                                                                 b[path]))
            scale = torch.tensor(1.0 / math.sqrt(math.prod(
                spec.shape[j] for j in spec.fan_in_dims)), dtype=bf,
                device=dev)
            want = prng.normal_window(keys[i], spec.shape, gbox, bf,
                                      "cpu").to(dev) * scale
            got = tree[path][tuple(slice(o, o + k) for o, k in sub)]
            counter = int(prng.box_counters(spec.shape, gbox, 0, 1, "cpu"))
            same = torch.equal(got.contiguous().view(torch.int16),
                               want.view(torch.int16))
            checked.append({"leaf": path, "box": [list(x) for x in gbox],
                            "first_counter": counter, "bit_for_bit": same})
            del got, want     # a view of the leaf: it would outlive tree
            if not same or counter < 1 << 32:
                raise AssertionError(f"{label}: {path}'s box {gbox} "
                                     f"(counter {counter}) differs")
        emit({"phase": label, "arch": MOE_235B, "mesh": mesh.shape,
              "coords": coords, "bytes": nbytes, "gb": nbytes / 1e9,
              "whole_gb": whole / 1e9, "peak_gib": peak / 2**30,
              "launches": {k: paths[label][k]
                           for k in ("normal", "normal_window")},
              "sub_boxes": checked, "seconds": seconds})
        if peak > MESH_235B_PEAK_SHARE * whole or \
                paths[label]["normal_window"] != sum(
                    1 for _, spec in leaves if spec.init == "normal"):
            raise AssertionError(f"{label}: peak {peak / 2**30:.2f} GiB, "
                                 f"launches {paths[label]}")
        del tree
        torch.cuda.empty_cache()
    return paths, kernel_row


CKPT_LAYERS = 4               # qwen3-moe-30b-a3b's 48 layers cut to 4
CKPT_RANK = {"data": 3, "model": 1}   # the rank restored from the files
CKPT_SLACK = 256 * 2**20      # a writing rank's device peak, past its data


def same_bytes(a: str, b: str, chunk: int = 1 << 26) -> bool:
    """Whether files ``a`` and ``b`` hold the same bytes."""
    if os.path.getsize(a) != os.path.getsize(b):
        return False
    with open(a, "rb") as f, open(b, "rb") as g:
        while True:
            x = f.read(chunk)
            if x != g.read(chunk):
                return False
            if not x:
                return True


def run_ckpt_sharded(ops, prng, dev) -> tuple:
    """ckpt_sharded_30b: a sharded checkpoint save of qwen3-moe-30b-a3b's
    parameters (published widths, CKPT_LAYERS layers) as the 4 x 2 mesh
    of MESH_30B writes it, one rank at a time on the card: the rank's
    boxes drawn by ``bundle.init_local`` (``sharding.param_boxes`` at its
    coordinates), written by ``checkpoint.manager.write_part`` into the
    files ``create_files`` made (each box by its first replica only),
    then freed; ``publish`` last.  Gated: the files equal an unsharded
    ``CheckpointManager.save`` of the tree drawn whole byte for byte;
    rank CKPT_RANK's boxes read back by ``manager.read_box`` equal its
    ``init_local`` bit for bit; each rank's device peak while it writes
    at most its shard bytes plus its largest box plus CKPT_SLACK.
    Returns ({run: launches}, the row)."""
    import shutil
    import tempfile
    import torch
    from repro_torch.checkpoint import CheckpointManager, manager
    from repro_torch.distributed.sharding import param_boxes, resolve_pspec
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import registry
    from repro_torch.models.common import flatten
    t_all = time.perf_counter()
    short = f"{MOE_ARCH}-{CKPT_LAYERS}l"
    registry._REGISTRY[short] = lambda: registry.get_config(
        MOE_ARCH).scaled(num_layers=CKPT_LAYERS)
    root = tempfile.mkdtemp(prefix="ckpt_sharded-")
    try:
        bundle = registry.get_bundle(short)
        mesh = make_mesh(MESH_30B, ("data", "model"))
        specs = {path: resolve_pspec(s.shape, s.axes, mesh)
                 for path, s in flatten(bundle.specs())}
        # the manager's leaf order (its names sorted as a save sorts them)
        layout = [(name, tuple(t.shape), t.dtype) for name, t in
                  manager._flatten_with_names(bundle.abstract())]
        names = [name for name, _, _ in layout]
        step, key = 1, prng.PRNGKey(SEED)
        sharded = os.path.join(root, "sharded")
        tmp = os.path.join(sharded, f".tmp-{step}")
        t0 = time.perf_counter()
        records = manager.create_files(tmp, layout)
        create_s = time.perf_counter() - t0
        ranks, paths = [], {}
        ops.reset_launch_counts()
        for d in range(MESH_30B[0]):
            for m in range(MESH_30B[1]):
                coords = {"data": d, "model": m}
                base = torch.cuda.memory_allocated()
                tree = dict(flatten(bundle.init_local(
                    key, param_boxes(bundle, mesh, coords), dev)))
                torch.cuda.synchronize()
                sizes = [t.numel() * t.element_size() for t in tree.values()]
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                written = manager.write_part(
                    tmp, [(tree[n], specs[n]) for n in names], mesh, coords)
                seconds = time.perf_counter() - t0
                peak = torch.cuda.max_memory_allocated() - base
                gate = sum(sizes) + max(sizes) + CKPT_SLACK
                ranks.append({"coords": coords, "save_s": seconds,
                              "gb_written": written / 1e9,
                              "shard_gb": sum(sizes) / 1e9,
                              "largest_box_gb": max(sizes) / 1e9,
                              "write_peak_gib": peak / 2**30,
                              "gate_gib": gate / 2**30})
                del tree
                torch.cuda.empty_cache()
                if peak > gate:
                    raise AssertionError(f"ckpt_sharded_30b: rank {coords} "
                                         f"peaked at {peak / 2**30:.3f} GiB "
                                         f"writing, past {gate / 2**30:.3f}")
        t0 = time.perf_counter()
        manager.publish(sharded, step, tmp, records)
        publish_s = time.perf_counter() - t0
        paths["ckpt_sharded_30b"] = ops.launch_counts()

        # The same tree drawn whole, saved unsharded.
        ops.reset_launch_counts()
        whole = bundle.init(key, device=dev).tree
        paths["ckpt_sharded_30b_whole"] = ops.launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        CheckpointManager(os.path.join(root, "plain")).save(step, whole)
        plain_s = time.perf_counter() - t0
        del whole
        torch.cuda.empty_cache()
        ours = os.path.join(sharded, f"step-{step:08d}")
        theirs = os.path.join(root, "plain", f"step-{step:08d}")
        files = sorted(os.listdir(ours))
        t0 = time.perf_counter()
        differing = [f for f in files
                     if not same_bytes(os.path.join(ours, f),
                                       os.path.join(theirs, f))]
        if files != sorted(os.listdir(theirs)):
            differing.append("the file lists")
        compare_s = time.perf_counter() - t0

        # Rank CKPT_RANK's boxes read back against its own draw.
        boxes = param_boxes(bundle, mesh, CKPT_RANK)
        want = dict(flatten(bundle.init_local(key, boxes, dev)))
        t0 = time.perf_counter()
        unequal = []
        for rec in records:
            got = manager.read_box(os.path.join(ours, rec["file"]),
                                   rec["dtype"], boxes[rec["name"]], dev,
                                   torch.bfloat16)
            if not torch.equal(got.view(torch.int16),
                               want[rec["name"]].view(torch.int16)):
                unequal.append(rec["name"])
        restore_s = time.perf_counter() - t0
        del want
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
        registry._REGISTRY.pop(short, None)
    row = {"phase": "ckpt_sharded_30b", "arch": MOE_ARCH,
           "reduced": {"num_layers": [registry.get_config(
               MOE_ARCH).num_layers, CKPT_LAYERS]},
           "mesh": mesh.shape, "params": bundle.param_count(),
           "whole_gb": bundle.param_count() * 2 / 1e9,
           "leaves": len(records), "ranks": ranks,
           "gb_written": sum(r["gb_written"] for r in ranks),
           "create_s": create_s, "publish_s": publish_s,
           "unsharded_save_s": plain_s, "compare_s": compare_s,
           "files_byte_for_byte": not differing, "differing": differing,
           "restored_rank": CKPT_RANK, "restore_s": restore_s,
           "restored_bit_for_bit": not unequal,
           "launches": {run: {k: c[k] for k in ("normal", "normal_window")}
                        for run, c in paths.items()},
           "seconds": time.perf_counter() - t_all}
    emit(row)
    if differing or unequal:
        raise AssertionError(f"ckpt_sharded_30b: files differing "
                             f"{differing}, restored leaves unequal "
                             f"{unequal}")
    return paths, row


def write_kernels_bench(summary: list, rows: dict, shapes: dict,
                        smi: str) -> None:
    """kernels_bench's rows (``kernels_bench.bench_rows``, the bench's own
    format) from this run's kernel timings, at the shapes the bench takes
    (no kernel is timed a second time), written through
    ``kernels_bench.write`` to a temporary file and read back; each
    kernel's ms beside PERF.md section 6's.  No gate on speed."""
    import shutil
    import tempfile
    from repro_torch.benchmarks import kernels_bench
    t0 = time.perf_counter()
    bench = []
    for e in summary:
        shape = rows[e["name"]].get("shape") or shapes
        bench += kernels_bench.bench_rows(
            e["name"], shape, smi, e["plain_ms"], e["ms"], e["max_abs_err"],
            e["library_ms"])
    tmp = tempfile.mkdtemp(prefix="kernels_bench-")
    try:
        out = os.path.join(tmp, "kernels_bench.json")
        kernels_bench.write(bench, out)
        with open(out) as f:
            bench = json.load(f)["rows"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    table = {}
    for r in bench:
        entry = table.setdefault(r["kernel"], {"perf_md_ms":
                                               TABLE_MS[r["kernel"]]})
        entry[f"{r['path']}_ms"] = r["ms"]
        if r["path"] == "cuda":
            entry["max_abs_err"] = r["max_abs_err"]
        entry["device"] = r["device"]
    emit({"phase": "kernels_bench", "kernels": table,
          "seconds": time.perf_counter() - t0})


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
    from repro_torch import core, optim, prng, sketching
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
    # The dry runs are host work in processes of their own: started now,
    # read at the end.
    dryruns = start_dryruns()

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
    mask = drop_mask(scfg.total_blocks, 30, dev)
    ops.reset_launch_counts()
    rows = check_kernels(ops, ref, state.h, state.sigma, a, mask, b)
    del state
    # The fig6_paper phase's sketch: fig. 6's rule, ((10 d) // 256 + 1)
    # 256 rows (K = 148 at d = 3,000).
    fig6_cfg = core.OverSketchConfig(((10 * d) // b + 1) * b, b, 0.25)
    rows["sketch_gram_count"]["fig6_paper"] = check_gram_at(
        ops, ref, sketching.get("oversketch", fig6_cfg).sample(
            draw, n, device=dev), a, b, 30, "fig6_paper")
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
    draws = check_draw(ops, prng, draw, n, scfg.total_blocks, b, dev)
    draws["bits, sgd's sort keys (n) (first_order sgd)"] = check_bits(
        ops, prng, n, dev)
    first = next(iter(draws))
    rows["draw"] = {**draws.pop(first), "case": first, "other_shapes": draws}
    torch.cuda.empty_cache()
    coded_rows = check_coded(ops, ref, data, b, dev)
    rows["coded_block_matvec"] = coded_rows["XT"]
    kernel_shapes = {"K": scfg.total_blocks, "n": n, "d": d, "b": b,
                     "masked": 30, "sjlt_s": 4,
                     "distavg_K": dcfg.total_blocks,
                     "distavg_b": DISTAVG_BLOCK}
    emit({"phase": "kernels", "shapes": kernel_shapes, "rows": rows,
          "coded_X": coded_rows["X"],
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

    # The baseline optimizers at full width, each driven and counted on its
    # own: exact Newton and GIANT with fig. 6's line search (GIANT's unit
    # step diverges on the profile's sorted, non-iid shards), the
    # first-order methods in fig. 11's setup (ignore, backtracking).  Exact
    # Newton launches the coded mat-vec twice an iteration and nothing else,
    # GIANT no kernel, sgd the draw kernel's bits once a sort round.
    f0 = objective.value(w0, data).item()
    emit({"phase": "giant_memory", **giant_bytes(n, d, GIANT_WORKERS)})
    paths["exact_newton"] = run_optimizer(
        ops, "exact_newton", lambda: optim.exact_newton(
            objective, data, w0, iters=PATH_ITERS, unit_step=False,
            seed=SEED, device=dev),
        {"coded_block_matvec": 2 * PATH_ITERS}, f0)
    for policy in ("wait_all", "gcode", "ignore"):
        label = f"giant_{policy}"
        paths[label] = run_optimizer(
            ops, label, lambda: optim.giant(
                objective, data, w0, optim.GiantConfig(
                    iters=PATH_ITERS, num_workers=GIANT_WORKERS,
                    policy=policy, unit_step=False, seed=SEED),
                device=dev), {}, f0)
        torch.cuda.empty_cache()
    for method in ("gd", "nag", "sgd"):
        label = f"first_order_{method}"
        paths[label] = run_optimizer(
            ops, label, lambda: optim.first_order(
                objective, data, w0, optim.FirstOrderConfig(
                    iters=FIRST_ORDER_ITERS, method=method, policy="ignore",
                    num_workers=GIANT_WORKERS, backtracking=True,
                    seed=SEED), device=dev),
            {"draw": sort_rounds(n) * FIRST_ORDER_ITERS}
            if method == "sgd" else {}, f0, decreasing=method != "nag")
    # Corruption, adaptive growth and live telemetry on the main path.
    from repro_torch import obs
    paths.update(run_modes(core, ops, obs, prng, objective, data, w0, scfg,
                           b, dev))
    # The three distributed paths on a one-rank NCCL group.
    paths["distributed_paths"] = run_distributed_paths(ops, core, data, dev)
    del data
    torch.cuda.empty_cache()

    # The paper's fig. 6 at the synthetic profile's width, on a card that
    # holds nothing else of the smoke's, then the multi-tenant scheduler.
    from repro_torch.benchmarks import fig6_logistic_synthetic as fig6
    row, paths["fig6_paper"] = run_fig6_paper(ops, data_mod, prng, fig6,
                                              dev)
    emit(row)
    emit(run_tenancy())

    # Softmax regression at the emnist profile's widths (n cut to fit).
    from repro_torch.core import solvers
    paths["softmax"], softmax_rows = run_softmax(
        core, ops, ref, solvers, data_mod, prng, sketching, dev)

    t0 = time.perf_counter()
    check = run_small_reference(core, ops, optim, data_mod, prng)
    emit({"phase": "check", "cases": check,
          "seconds": time.perf_counter() - t0})
    # n_pad = 1,024 there: the fwht entry takes its one-pass kernel.
    if check["distavg_srht"]["launches"].get("fwht", 0) == 0:
        raise AssertionError("the one-pass fwht was not launched on the "
                             "check phase's distributed-avg srht run")

    # The dense LM slice, on a card that holds nothing of the earlier
    # phases: qwen3-4b at full width, then the OSN readout head.
    torch.cuda.empty_cache()
    lm_paths, lm_rows = run_lm(ops, ref, core, prng, sketching, dev)
    paths.update(lm_paths)

    # The MoE slice at full width, then the SSM, hybrid and
    # encoder-decoder families, each on a card holding no earlier model.
    torch.cuda.empty_cache()
    moe_paths, moe_rows = run_moe(ops, ref, core, prng, sketching, dev)
    paths.update(moe_paths)
    paths.update(run_families(ops, prng, dev))

    # The LM training path: the trainer at smoke width on the card against
    # the CPU, qwen3-4b training at full width, and its restart.
    paths.update(run_training(ops, dev))

    # Mesh training on a 1 x 1 mesh over NCCL, its checkpoint restored
    # onto the unsharded trainer; the dry runs' cells.
    paths["mesh_train"] = run_mesh_train(ops, dev)
    torch.cuda.empty_cache()
    # The sharded init at the MoE configs' widths: every 4 x 2 rank's
    # boxes of qwen3-moe-30b-a3b against its whole leaves, two 4 x 8
    # ranks' shards of qwen3-moe-235b-a22b.
    init_paths, rows["normal_window"] = run_mesh_init(ops, prng, dev)
    paths.update(init_paths)
    torch.cuda.empty_cache()
    # The sharded checkpoint save, every 4 x 2 rank's part on the card.
    paths.update(run_ckpt_sharded(ops, prng, dev)[0])
    finish_dryruns(dryruns)

    # Each kernel's numbers at the shape its full-width path launches it:
    # count_sketch_apply at b = 4,096 (distributed-avg), the coded mat-vec
    # at the X^T encode, the masked Gram at nystrom's A_tilde, each with its
    # other shapes beside; fwht's one-pass kernel at its largest n, 4,096.
    rows["count_sketch_apply"], cs_b256 = large["count_sketch_apply"], \
        rows["count_sketch_apply"]
    sm_x, sm_xt = softmax_rows["coded_X"], softmax_rows["coded_XT"]
    other = {"count_sketch_apply": {
        "distavg_sjlt (layered, s = 4)": large["count_sketch_apply_sjlt"],
        "b256_K150 (no path)": cs_b256},
        "sketch_gram_count": {
            f"softmax ({SOFTMAX_CHECK_BLOCKS} of its blocks, n K = "
            f"{softmax_rows['sketch_gram_count']['shape']['n']:,}, d K = "
            f"{softmax_rows['sketch_gram_count']['shape']['d']:,})":
                softmax_rows["sketch_gram_count"],
            "lm_osn_head (K = {K}, {masked} masked, n K = {n:,}, d K = "
            "{d:,}, b = {b})".format(**lm_rows["sketch_gram_count"]["shape"]):
                lm_rows["sketch_gram_count"],
            "lm_moe_osn_head (K = {K}, {masked} masked, n K = {n:,}, d K = "
            "{d:,}, b = {b})".format(**moe_rows["sketch_gram_count"]["shape"]):
                moe_rows["sketch_gram_count"]},
        "coded_block_matvec": {
            "X encode (W = 1,296, s = 3,000)": coded_rows["X"],
            f"softmax X encode (W = {sm_x['shape']['W']:,}, s = "
            f"{sm_x['shape']['s']:,})": sm_x,
            f"softmax X^T encode (W = {sm_xt['shape']['W']:,}, s = "
            f"{sm_xt['shape']['s']:,})": sm_xt,
            **{f"{head} {tag} encode (W = {r['shape']['W']:,}, b = "
               f"{r['shape']['b']}, s = {r['shape']['s']:,})": r
               for head, rs_ in (("lm_osn_head", lm_rows),
                                 ("lm_moe_osn_head", moe_rows))
               for tag, r in (("X", rs_["coded_X"]),
                              ("X^T", rs_["coded_XT"]))}},
        "normal": {"bf16 mode, lm_init's embed (151,936 x 2,560)":
                   lm_rows["normal_bf16"],
                   "bf16 mode, lm_moe_init's embed (151,936 x 2,048)":
                   moe_rows["normal_bf16"]},
        "normal_window": {
            "float32, qwen3-moe-235b-a22b's w_gate past counter 2^32":
                rows["normal_window"]["float32_past_2_32"]},
        "fwht": rows["fwht_lengths"],
        "oversketch_gram": {"count-sketch A_tilde (no path)": count_gram},
        "sketch_gram_sjlt": {
            "apply alone (count_sketch_apply, K_live = 120, s = 4, b = 256)":
                rows["sjlt_apply"],
            "Gram alone (oversketch_gram of that A_tilde)":
                rows["sjlt_gram"]},
        "draw": {**rows["draw"]["other_shapes"], **softmax_rows["draw"],
                 **lm_rows["draw"], **moe_rows["draw"]}}
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
                                      "yardstick_ms", "copy_ms", *PHASES,
                                      "library_blocks", "eigh_ms")
                    if f in v}
                for k, v in other[name].items()}
        entry.update({f: r[f] for f in PHASES + FWHT_PASSES + ("copy_ms",)
                      if f in r})
        if name in ("normal", "normal_window", "draw"):
            entry.update({f: r[f] for f in ("yardstick_ms", "yardstick",
                                            "bound_rate", "table_build_ms",
                                            "case")
                          if f in r})
        summary.append(entry)
    write_kernels_bench(summary, rows, kernel_shapes, smi)
    emit({"phase": "total", "seconds": time.perf_counter() - t_all})
    emit({"kernels": summary})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
