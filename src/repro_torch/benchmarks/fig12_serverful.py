"""Fig. 12: serverless OverSketched Newton vs serverful (EC2/MPI-style)
GIANT; port of ``benchmarks/fig12_serverful.py``.  The serverful clock has
much lower invocation overhead and faster communication but far fewer,
fixed workers; OSN exploits the serverless scale for a better global
second-order update — the paper's (surprising) result is OSN winning by
>= 30%."""
from __future__ import annotations

import torch

from repro_torch import prng
from repro_torch.benchmarks.common import best_f, time_to_target
from repro_torch.core import (LogisticRegression, NewtonConfig,
                              OverSketchConfig, oversketched_newton)
from repro_torch.core.straggler import SimClock, StragglerModel
from repro_torch.data import make_logistic_dataset
from repro_torch.optim import GiantConfig, giant
from repro_torch.runtime import CostModel

# serverless: high invoke overhead, heavy tail, thousands of workers
SERVERLESS = StragglerModel(invoke_overhead=0.10, comm_per_unit=0.05,
                            p_tail=0.02)
# serverful MPI: negligible overhead, fast interconnect, mild noise, but
# capped at 60 fixed t2.medium workers (1 burstable vCPU — about half a
# Lambda 3GB worker's throughput) holding 1/60th of the data each
SERVERFUL = StragglerModel(invoke_overhead=0.005, comm_per_unit=0.01,
                           p_tail=0.005, tail_hi=0.5, flops_per_second=1e6)
# EC2-style meters for the fixed cluster: t2.medium-ish per-GB-second rate,
# reserved billing (all 60 nodes bill phase wall-clock, idle included), no
# per-invocation or per-S3-op charges (MPI interconnect).
EC2_METERS = CostModel(memory_gb=4.0, billing="reserved",
                       usd_per_gb_second=3.22e-6, usd_per_invocation=0.0,
                       usd_per_s3_put=0.0, usd_per_s3_get=0.0)


def _fig12(data, osn_iters: int, giant_iters: int):
    """OSN on the serverless clock for ``osn_iters`` iterations against
    GIANT (60 workers, wait-all) on the serverful one for
    ``giant_iters``."""
    d = data.x.shape[1]
    dev = data.x.device
    obj = LogisticRegression(lam=1e-5)
    w0 = torch.zeros(d, device=dev)

    sk = OverSketchConfig(((10 * d) // 256 + 1) * 256, 256, 0.25)
    osn = oversketched_newton(
        obj, data, w0, NewtonConfig(iters=osn_iters, sketch=sk,
                                    unit_step=False,
                                    coded_block_rows=max(32, d // 7),
                                    use_kernels=True),
        model=SERVERLESS, device=dev).history
    g_mpi = giant(obj, data, w0,
                  GiantConfig(iters=giant_iters, num_workers=60,
                              policy="wait_all", unit_step=False),
                  model=SimClock(SERVERFUL, cost=EC2_METERS), device=dev)

    target = best_f(osn, g_mpi)
    rows = []
    for name, h in [("osn_serverless", osn), ("giant_serverful_mpi", g_mpi)]:
        t = time_to_target(h, target)
        rows.append({
            "name": f"fig12_{name}",
            "us": (t if t != float("inf") else h["time"][-1]) * 1e6,
            "derived": (f"t_to_target={t:.2f};final_f={h['fval'][-1]:.5f};"
                        f"usd={h['cost'][-1]:.4f}"),
        })
    return rows


def run(quick: bool = True, device=None):
    n, d = (40_000, 400) if quick else (80_000, 1000)
    data = make_logistic_dataset(prng.PRNGKey(6), n, d, cond=10.0,
                                 sorted_layout=True, device=device)
    return _fig12(data, 8 if quick else 12, 14 if quick else 20)
