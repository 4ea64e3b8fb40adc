#!/usr/bin/env python3
"""Drive the torch port's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the root of a checkout.  Phases, each printed as one JSON line
with its seconds:

  device   the card (nvidia-smi name and power limit), torch and CUDA
  build    nvcc builds every kernel of src/repro_torch/kernels/csrc
  data     the paper's synthetic profile at full width on the card
           (n = 300,000, d = 3,000, 100,000 test rows)
  kernels  each CUDA kernel against its plain PyTorch version at the main
           path's own inputs (A = hess_sqrt(w0), the first iteration's
           sketch, 30 of 150 blocks masked), plus a ragged and an
           all-masked case; times of kernel, plain version and a one-call
           PyTorch yardstick, and the bound the card's peaks give
  newton   oversketched_newton at full width with the kernels, 3 iterations;
           launch counts read just before and after
  profile  the same call with 2 iterations under torch.profiler: device
           time by operator and the device's idle share
  check    the same loop at the verify recipe's size on the card against
           the plain path on the CPU

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
HBM_BYTES_PER_S = 3.35e12
REL_TOL = 1e-4          # kernel vs plain, relative to max |plain|
ITERS = 3
SEED = 0


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn over reps runs, after one warm-up."""
    import torch
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


def bound(ops: float, nbytes: float) -> tuple:
    t_ops, t_bytes = ops / FP32_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def compare(name: str, got, want) -> dict:
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    rel = err / scale if scale > 0 else err
    if not math.isfinite(rel) or rel > REL_TOL:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version: max_abs_err {err}, relative {rel}")
    return {"max_abs_err": err, "rel_err": rel}


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
    del got
    row["ms"] = cuda_ms(lambda: ops.count_sketch_apply(h, sigma, a, b), 3)
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


def check_small_cases(ops, ref, device) -> dict:
    """A ragged case and an all-masked case for every kernel."""
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
        a_t = ref.count_sketch_apply(h, sigma, a, b)
        want = ref.oversketch_gram(a_t, mask)
        errs[label] = {
            "count_sketch_apply": compare(
                "count_sketch_apply", ops.count_sketch_apply(h, sigma, a, b),
                a_t)["max_abs_err"],
            "oversketch_gram": compare(
                "oversketch_gram", ops.oversketch_gram(a_t, mask),
                want)["max_abs_err"],
            "sketch_gram_count": compare(
                "sketch_gram_count",
                ops.sketch_gram_count(h, sigma, a, b, mask),
                want)["max_abs_err"]}
        if label == "all_masked" and ops.sketch_gram_count(
                h, sigma, a, b, mask).any():
            raise AssertionError("all-masked Gram is not zero")
    return errs


def run_small_reference(core, data_mod, prng) -> dict:
    """The verify recipe on the card (kernels) and on the CPU (plain)."""
    import numpy as np
    data = data_mod.make_logistic_dataset(prng.PRNGKey(0), 1000, 20, 200,
                                          device="cpu")
    kw = dict(iters=4, sketch=core.OverSketchConfig(512, 64, 0.25),
              coded_block_rows=128, gradient_policy="coded")
    card = core.oversketched_newton(
        core.LogisticRegression(lam=1e-4), data, np.zeros(20, np.float32),
        core.NewtonConfig(use_kernels=True, **kw), device="cuda")
    plain = core.oversketched_newton(
        core.LogisticRegression(lam=1e-4), data, np.zeros(20, np.float32),
        core.NewtonConfig(use_kernels=False, **kw), device="cpu")
    fc, fp = np.array(card.history["fval"]), np.array(plain.history["fval"])
    if card.history["step"] != plain.history["step"] or not np.allclose(
            fc, fp, rtol=1e-4, atol=1e-6):
        raise AssertionError(f"card {fc} vs plain {fp}")
    return {"fval_card": fc.tolist(), "fval_plain": fp.tolist(),
            "max_rel_fval_diff": float(np.max(np.abs(fc - fp) / np.abs(fp)))}


def profile_iterations(core, objective, data, w0, cfg, device,
                       top: int = 12) -> dict:
    """Device time by operator over one more run of the main path
    (torch.profiler), and the device's idle share of its wall time."""
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

    def dev_us(e):
        return float(getattr(e, "self_device_time_total", 0.0) or 0.0)
    # Device-side events only (kernels, copies, memsets): the operators
    # that launched them carry the same time again.
    events = sorted((e for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=dev_us, reverse=True)
    device_ms = sum(dev_us(e) for e in events) / 1e3
    return {"iters": 2, "wall_ms": wall_ms, "device_ms": device_ms,
            "idle_share": 1.0 - device_ms / wall_ms,
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
    b = 256
    # m = sketch_dim_mult x d, with d rounded up to whole blocks.
    sketch_dim = WORKER_SETUP["synthetic"]["sketch_dim_mult"] * (-(-d // b) * b)
    scfg = core.OverSketchConfig(sketch_dim, b, 0.25)
    torch.cuda.synchronize()
    emit({"phase": "data", "n": n, "d": d, "n_test": data.x_test.shape[0],
          "profile": [prof.n_train, prof.n_features, prof.n_test],
          "sketch_dim": sketch_dim, "block_size": b,
          "total_blocks": scfg.total_blocks,
          "label_balance": float((data.y > 0).float().mean()),
          "seconds": time.perf_counter() - t0})

    # Kernel checks at the main path's own inputs: A = hess_sqrt(w0) and
    # the first iteration's sketch draw, 30 of 150 blocks masked.
    t0 = time.perf_counter()
    objective = core.LogisticRegression()
    w0 = torch.zeros(d, device=dev)
    a = objective.hess_sqrt(w0, data)
    _, _, kh, _ = prng.split(prng.PRNGKey(SEED), 4)
    state = sketching.get("oversketch", scfg).sample(prng.fold_in(kh, 7), n,
                                                     device=dev)
    drop = np.random.default_rng(SEED).choice(scfg.total_blocks, 30,
                                              replace=False)
    mask = torch.ones(scfg.total_blocks, dtype=torch.bool)
    mask[torch.from_numpy(drop)] = False
    mask = mask.to(dev)
    ops.reset_launch_counts()
    rows = check_kernels(ops, ref, state.h, state.sigma, a, mask, b)
    small = check_small_cases(ops, ref, dev)
    del a, state
    emit({"phase": "kernels", "shapes": {"K": scfg.total_blocks, "n": n,
                                         "d": d, "b": b, "masked": 30},
          "rows": rows, "small_cases_max_abs_err": small,
          "tolerance_rel": REL_TOL, "seconds": time.perf_counter() - t0})

    # The main path: counts set to 0 just before, read just after.
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg = core.NewtonConfig(iters=ITERS, sketch=scfg, gradient_policy="coded",
                            use_kernels=True, track_test_error=True,
                            seed=SEED)
    ops.reset_launch_counts()
    res = core.oversketched_newton(objective, data, w0, cfg, device=dev)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    seconds = time.perf_counter() - t0
    hist = res.history
    for i in range(ITERS):
        emit({"phase": "newton_iter", "iter": hist["iter"][i],
              "fval": hist["fval"][i], "gnorm": hist["gnorm"][i],
              "step": hist["step"][i], "sim_seconds": hist["time"][i],
              "sim_dollars": hist["cost"][i],
              "test_error": hist["test_error"][i],
              "wall_ms": hist["wall_s"][i] * 1e3})
    f = [objective.value(w0, data).item()] + hist["fval"]
    finite = all(math.isfinite(v) for k in ("fval", "gnorm", "step", "time",
                                            "cost", "test_error")
                 for v in hist[k]) and bool(torch.isfinite(res.w).all())
    emit({"phase": "newton", "iters": ITERS, "launches": launches,
          "f0": f[0], "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
          "seconds": seconds})
    if launches["sketch_gram_count"] != ITERS:
        raise AssertionError(f"sketch_gram_count launched "
                             f"{launches['sketch_gram_count']} times in "
                             f"{ITERS} iterations")
    if not all(b_ < a_ for a_, b_ in zip(f, f[1:])):
        raise AssertionError(f"fval does not decrease: {f}")
    if not finite:
        raise AssertionError("non-finite values in the Newton history")
    del res

    # Where the time goes: the main path once more under torch.profiler
    # (its launches come after the counts were read).
    t0 = time.perf_counter()
    prof = profile_iterations(core, objective, data, w0, cfg, dev)
    emit({"phase": "profile", **prof, "seconds": time.perf_counter() - t0})
    del data

    t0 = time.perf_counter()
    check = run_small_reference(core, data_mod, prng)
    emit({"phase": "check", **check, "seconds": time.perf_counter() - t0})

    summary = []
    for name, kern in ops.KERNELS.items():
        r = rows[name]
        summary.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{kern.source}",
            "replaces": kern.replaces, "launches": launches[name],
            "on_main_path": launches[name] > 0,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    emit({"phase": "total", "seconds": time.perf_counter() - t_all})
    emit({"kernels": summary})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
