"""Kernel microbenchmarks of the port (the counterpart of
``benchmarks/kernels_bench.py``): every CUDA kernel of ``kernels/`` (the
eight that replace a Pallas kernel, then ``normal``, its window mode
``normal_window`` and ``draw``) timed
against its plain PyTorch version and, where PyTorch has one, the
library call that computes the same function, at the shapes of the
kernel table in PERF.md (the synthetic profile: n = 300,000, d = 3,000,
b = 256, K = 150 with 30 blocks masked; distributed-avg's b = 4,096,
K = 10; one padded (2^19, 3,000) FWHT block; the X^T product-code
encode; the window mode at qwen3-moe-30b-a3b's expert leaf's shard at
a 4 x 2 mesh, bfloat16).

  python -m repro_torch.benchmarks.kernels_bench [--out FILE] [--device cpu]

Every row carries a ``path`` field naming what ran (``cuda``: the
kernel, with its max abs error against the plain version; ``plain``;
``library``: the PyTorch call, named in ``call``), its milliseconds
(CUDA events over ``REPS`` launches after a warm-up, the plain version's
from its one call; the host clock on the CPU) and the device's name and
power limit as ``nvidia-smi`` gives them (``bench_rows``: the one row
format; ``chip_smoke.py`` writes it from the timings of its own kernel
phases).  On the CPU only the plain versions run, at small shapes.  The
JSON goes to ``--out`` (default ``artifacts/kernels_bench.json``,
git-ignored); it never writes the JAX package's ``BENCH_kernels.json``.  Not a module of
``benchmarks.run``: it runs on its own.
"""
from __future__ import annotations

import argparse
import json
import math
import pathlib
import subprocess
import time
from typing import Callable, Dict, List, Optional

import torch

REPO_ROOT = pathlib.Path(__file__).resolve().parents[3]
DEFAULT_OUT = REPO_ROOT / "artifacts" / "kernels_bench.json"

REPS = 3                 # timed launches a kernel and library call
FULL = dict(n=300_000, d=3_000, b=256, k=150, masked=30, s=4,
            b_avg=4_096, k_avg=10, n_fwht=4_096, n_pad=1 << 19, w_xt=25,
            leaf=(48, 128, 2048, 768),
            box=((0, 48), (64, 64), (0, 2048), (576, 192)))
SMALL = dict(n=500, d=16, b=16, k=8, masked=2, s=4, b_avg=32, k_avg=2,
             n_fwht=64, n_pad=1 << 9, w_xt=9, leaf=(4, 8, 16, 12),
             box=((0, 4), (4, 4), (0, 16), (3, 3)))


# Each kernel's row of PERF.md's kernel table (None: the port's own draws)
# and the PyTorch call that computes the same function (None: there is
# none).
KERNELS = {
    "sketch_gram_count": (1, "torch.sparse.mm then torch.mm"),
    "count_sketch_apply": (2, "torch.sparse.mm"),
    "oversketch_gram": (3, "torch.mm(A_live^T, A_live)"),
    "coded_block_matvec": (4, "torch.mv then torch.where"),
    "sketch_gram_sjlt": (5, "torch.sparse.mm then torch.mm"),
    "sketch_gram_srht": (6, "per live block torch.mm(dense encode^T, A), "
                            "then torch.mm"),
    "fwht": (7, None),
    "fwht_two_pass": (8, None),
    "normal": (None, None),
    "normal_window": (None, None),
    "draw": (None, None),
}


def device_label(device: torch.device) -> str:
    """``name, power limit`` of the card (``nvidia-smi``), or the CPU."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else torch.cuda.get_device_name(device)


def time_ms(fn: Callable, device: torch.device, reps: int = REPS,
            warm: bool = True) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` calls after one warm-up
    (none with ``warm=False``): CUDA events on the card, the host clock
    on the CPU."""
    if warm:
        fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def sparse_rows(h, sigma, live, b: int, n: int, scale: float = 1.0):
    """The live blocks' codes as one CSR (K_live b, n) matrix, each entry
    sigma * ``scale``: the count sketch (h (K, n)) or the SJLT's s layers
    (h (K, s, n), ``scale`` 1 / sqrt(s)) summed."""
    hl, sl = h[live].long(), sigma[live] * scale
    if hl.dim() == 2:
        hl, sl = hl[:, None], sl[:, None]
    kl, s, _ = hl.shape
    rows = (torch.arange(kl, device=h.device)[:, None, None] * b + hl)
    cols = torch.arange(n, device=h.device).expand(kl, s, n)
    coo = torch.sparse_coo_tensor(
        torch.stack([rows.reshape(-1), cols.reshape(-1)]), sl.reshape(-1),
        (kl * b, n), check_invariants=False)
    return coo.coalesce().to_sparse_csr()


def srht_encode(rows_k, sigma_k, n: int):
    """One block's dense (n, b) SRHT encode, sigma_r (-1)^popcount(r &
    rows_c) / sqrt(b)."""
    v = torch.arange(n, dtype=torch.int32, device=rows_k.device)[:, None] \
        & rows_k[None, :]
    for sh in (16, 8, 4, 2, 1):
        v = v ^ (v >> sh)
    return (1.0 - 2.0 * (v & 1).float()) * (sigma_k[:, None] /
                                           math.sqrt(rows_k.numel()))


def cases(device: torch.device, sz: Dict[str, int]) -> List[dict]:
    """Each kernel's inputs (from seed 0) and its three callables: the
    kernel's entry point, its plain version and the library call (None
    where ``KERNELS`` names none)."""
    from repro_torch import prng
    from repro_torch.kernels import ops, ref
    g = torch.Generator(device=device).manual_seed(0)
    n, d, b, k, s = sz["n"], sz["d"], sz["b"], sz["k"], sz["s"]

    def randint(hi, shape):
        return torch.randint(0, hi, shape, generator=g, device=device,
                             dtype=torch.int32)

    def signs(shape):
        return randint(2, shape).float() * 2 - 1
    a = torch.randn((n, d), generator=g, device=device) / math.sqrt(n)
    h, sg = randint(b, (k, n)), signs((k, n))
    mask = torch.ones(k, dtype=torch.bool, device=device)
    mask[torch.randperm(k, generator=g, device=device)[:sz["masked"]]] = \
        False
    live = mask.nonzero().squeeze(1)
    hj, sj = randint(b, (k, s, n)), signs((k, s, n))
    n_pad = sz["n_pad"]
    rows = randint(n_pad, (k, b))
    ha, sa = randint(sz["b_avg"], (sz["k_avg"], n)), \
        signs((sz["k_avg"], n))
    a_t = ref.count_sketch_apply(h, sg, a, b)
    x_fwht = torch.randn((1, sz["n_fwht"], d), generator=g, device=device)
    x_pad = torch.randn((1, n_pad, d), generator=g, device=device)
    enc = torch.randn((sz["w_xt"], b, n), generator=g, device=device)
    vec = torch.randn((n,), generator=g, device=device)
    erased = torch.zeros(sz["w_xt"], dtype=torch.bool, device=device)
    erased[1] = True
    key = prng.PRNGKey(0)

    def gram_of(x):
        return x.T @ x

    out = [
        dict(name="sketch_gram_count",
             shape=dict(K=k, n=n, d=d, b=b, masked=sz["masked"]),
             kernel=lambda: ops.sketch_gram_count(h, sg, a, b, mask),
             plain=lambda: ref.sketch_gram_count(h, sg, a, b, mask),
             library=lambda m=sparse_rows(h, sg, live, b, n):
             gram_of(torch.sparse.mm(m, a))),
        dict(name="count_sketch_apply",
             shape=dict(K=sz["k_avg"], n=n, d=d, b=sz["b_avg"]),
             kernel=lambda: ops.count_sketch_apply(ha, sa, a, sz["b_avg"]),
             plain=lambda: ref.count_sketch_apply(ha, sa, a, sz["b_avg"]),
             library=lambda m=sparse_rows(
                 ha, sa, torch.arange(sz["k_avg"], device=device),
                 sz["b_avg"], n): torch.sparse.mm(m, a)),
        dict(name="oversketch_gram",
             shape=dict(K=k, b=b, d=d, masked=sz["masked"]),
             kernel=lambda: ops.oversketch_gram(a_t, mask),
             plain=lambda: ref.oversketch_gram(a_t, mask),
             library=lambda x=a_t[live].reshape(-1, d): gram_of(x)),
        dict(name="coded_block_matvec",
             shape=dict(W=sz["w_xt"], b=b, s=n, erased=1),
             kernel=lambda: ops.coded_block_matvec(enc, vec, erased),
             plain=lambda: ref.coded_block_matvec(enc, vec, erased),
             library=lambda: torch.where(
                 erased[:, None], 0.0,
                 torch.mv(enc.view(-1, n), vec).view(-1, b))),
        dict(name="sketch_gram_sjlt",
             shape=dict(K=k, s=s, n=n, d=d, b=b, masked=sz["masked"]),
             kernel=lambda: ops.sketch_gram_sjlt(hj, sj, a, b, mask),
             plain=lambda: ref.sketch_gram_sjlt(hj, sj, a, b, mask),
             library=lambda m=sparse_rows(hj, sj, live, b, n,
                                          1 / math.sqrt(s)):
             gram_of(torch.sparse.mm(m, a))),
        dict(name="sketch_gram_srht",
             shape=dict(K=k, n=n, n_pad=n_pad, d=d, b=b,
                        masked=sz["masked"]),
             kernel=lambda: ops.sketch_gram_srht(rows, sg, a, mask),
             plain=lambda: ref.sketch_gram_srht(rows, sg, a, mask),
             library=lambda: gram_of(torch.cat([
                 srht_encode(rows[j], sg[j], n).T @ a
                 for j in live.tolist()]))),
        dict(name="fwht", shape=dict(K=1, n=sz["n_fwht"], d=d),
             kernel=lambda: ops.fwht(x_fwht), plain=lambda: ref.fwht(x_fwht),
             library=None),
        dict(name="fwht_two_pass", shape=dict(K=1, n=n_pad, d=d),
             kernel=lambda: ops.fwht_two_pass(x_pad),
             plain=lambda: ref.fwht(x_pad), library=None),
        dict(name="normal", shape=dict(n=n, b=b),
             kernel=lambda: ops.normal(key, (n, b), device),
             plain=lambda: ref.normal(key, (n, b), device),
             library=None),
        dict(name="normal_window",
             shape=dict(leaf=list(sz["leaf"]), box=[list(x)
                                                    for x in sz["box"]],
                        dtype="bfloat16"),
             kernel=lambda: ops.normal_window(key, sz["leaf"], sz["box"],
                                              device, dtype=torch.bfloat16),
             plain=lambda: ref.normal_window(key, sz["leaf"], sz["box"],
                                             device, torch.bfloat16),
             library=None),
        dict(name="draw", shape=dict(K=k, n=n, span=b),
             kernel=lambda: ops.randint(key, (k, n), 0, b, device=device),
             plain=lambda: ref.randint(key, (k, n), 0, b, device),
             library=None),
    ]
    return out


def bench_rows(name: str, shape: dict, device: str, plain_ms: float,
               ms: Optional[float] = None,
               max_abs_err: Optional[float] = None,
               library_ms: Optional[float] = None) -> List[dict]:
    """Kernel ``name``'s rows at ``shape`` on ``device`` (its name and
    power limit): the kernel's (when it ran), the plain version's, the
    library call's (when ``KERNELS`` names one and it ran)."""
    row, call = KERNELS[name]
    base = {"kernel": name, "table_row": row, "shape": shape,
            "device": device}
    rows = []
    if ms is not None:
        rows.append({**base, "name": f"kernel_{name}", "path": "cuda",
                     "max_abs_err": max_abs_err, "ms": ms})
    rows.append({**base, "name": f"kernel_{name}_plain", "path": "plain",
                 "ms": plain_ms})
    if library_ms is not None and call is not None:
        rows.append({**base, "name": f"kernel_{name}_library",
                     "path": "library", "call": call, "ms": library_ms})
    return rows


def run(device=None) -> List[dict]:
    """The rows: on a CUDA device the kernel, plain and library paths of
    every case at the table's shapes; on the CPU the plain paths at small
    ones."""
    from repro_torch import resolve_device
    device = resolve_device(device)
    on_card = device.type == "cuda"
    label = device_label(device)
    rows = []
    for case in cases(device, FULL if on_card else SMALL):
        # The plain version once (the slowest take seconds): its output
        # is what the kernel's is held against.
        holder = []
        plain_ms = time_ms(lambda: holder.append(case["plain"]()), device,
                           1, warm=False)
        ms = err = lib_ms = None
        if on_card:
            got = case["kernel"]()
            err = float((got.float() - holder[0].float()).abs().max())
            del got
            ms = time_ms(case["kernel"], device)
        del holder
        if on_card and case["library"] is not None:
            lib_ms = time_ms(case["library"], device)
        rows += bench_rows(case["name"], case["shape"], label, plain_ms, ms,
                           err, lib_ms)
        if on_card:
            torch.cuda.empty_cache()
    return rows


def out_path(out) -> pathlib.Path:
    """``out`` as a path, refused if it is the JAX package's
    ``BENCH_*.json``."""
    out = pathlib.Path(out)
    if out.name.startswith("BENCH_") and out.parent.resolve() == REPO_ROOT:
        raise SystemExit("kernels_bench never writes the JAX package's "
                         "BENCH_*.json")
    return out


def write(rows: List[dict], out) -> None:
    """The rows as ``{"rows": [...]}`` JSON at ``out`` (its directory
    made)."""
    out = out_path(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"rows": rows}, indent=1))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=str, default=str(DEFAULT_OUT))
    ap.add_argument("--device", type=str, default=None,
                    help="cpu, or the CUDA device when not given")
    args = ap.parse_args(argv)
    out_path(args.out)           # refused before the run, not after
    rows = run(args.device)
    write(rows, args.out)
    for r in rows:
        print(f"{r['name']},{r['ms'] * 1e3:.1f},path={r['path']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
