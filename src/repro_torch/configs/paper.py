"""The paper's own experimental workloads (Sec. 5 datasets) as dataset
profiles: a copy of ``repro/configs/paper.py``.  ``n_train``,
``n_features`` and ``n_test`` are the paper's sizes; the ``bench_*`` sizes
are the reference's CPU-scaled ones.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DatasetProfile:
    name: str
    n_train: int
    n_features: int
    n_test: int
    n_classes: int = 2          # 2 => logistic (+-1), >2 => softmax
    bench_n: int = 4000
    bench_d: int = 200
    bench_test: int = 1000


PROFILES = {
    "synthetic": DatasetProfile("synthetic", 300_000, 3000, 100_000,
                                bench_n=12_000, bench_d=400),
    "epsilon": DatasetProfile("epsilon", 400_000, 2000, 100_000,
                              bench_n=12_000, bench_d=400),
    "webpage": DatasetProfile("webpage", 48_000, 300, 15_000,
                              bench_n=8000, bench_d=300),
    "a9a": DatasetProfile("a9a", 32_000, 123, 16_000,
                          bench_n=8000, bench_d=123),
    "emnist": DatasetProfile("emnist", 240_000, 784, 40_000, n_classes=10,
                             bench_n=2400, bench_d=98),
}

# Paper worker/sketch setups per experiment (Sec. 5.1-5.2).
WORKER_SETUP = {
    "synthetic": dict(giant_workers=60, mv_workers=60, exact_hessian=3600,
                      sketch_workers=600, sketch_dim_mult=10),
    "epsilon": dict(giant_workers=100, mv_workers=100, exact_hessian=10_000,
                    sketch_workers=1500, sketch_dim_mult=15),
    "webpage": dict(giant_workers=30, mv_workers=30, exact_hessian=900,
                    sketch_workers=300, sketch_dim_mult=10),
    "a9a": dict(giant_workers=30, mv_workers=30, exact_hessian=900,
                sketch_workers=300, sketch_dim_mult=10),
    "emnist": dict(giant_workers=60, mv_workers=60, exact_hessian=3600,
                   sketch_workers=360, sketch_dim_mult=6),
}
