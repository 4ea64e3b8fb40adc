"""Gradient coding (Tandon et al., 2017): replication-based straggler
mitigation for the gradient phase (paper Fig. 5b baseline); port of
``repro/optim/gradient_coding.py``, numpy and clock calls only.

Each worker holds r data shards (its own and r - 1 neighbours') and sends
a fixed linear combination of its shard gradients; the master recovers the
exact full gradient from any W - (r - 1) workers.  Every worker reads and
processes r shards, so per-worker work and communication scale by r.  The
decode is a deterministic linear combination, so the simulation charges
the clock and uses the exact gradient; ``decode_weights`` computes the
cyclic scheme's combination weights for the tests.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core import straggler


def assignment(num_workers: int, redundancy: int) -> np.ndarray:
    """Cyclic shard placement: worker i holds shards i, i+1, ..., i+r-1."""
    return np.stack([(np.arange(num_workers) + j) % num_workers
                     for j in range(redundancy)], axis=1)


def decode_weights(finished: np.ndarray, num_workers: int,
                   redundancy: int) -> Optional[np.ndarray]:
    """Per-worker weights a_w with sum_w a_w (sum of w's shard gradients)
    = sum of all shard gradients, i.e. A^T a = 1 restricted to the
    finished workers; None when the erasure pattern is unrecoverable."""
    asn = assignment(num_workers, redundancy)
    b = np.zeros((num_workers, num_workers))
    for w in range(num_workers):
        b[w, asn[w]] = 1.0
    rows = np.where(finished)[0]
    if len(rows) == 0:
        return None
    bf = b[rows]                                  # (F, W_shards)
    target = np.ones(num_workers)
    sol = np.linalg.lstsq(bf.T, target, rcond=None)[0]
    if not np.allclose(bf.T @ sol, target, atol=1e-6):
        return None
    weights = np.zeros(num_workers)
    weights[rows] = sol
    return weights


def gradient_coding_phase(clock: Optional[straggler.SimClock],
                          key: torch.Tensor, num_workers: int,
                          redundancy: int,
                          flops_per_worker: Optional[float] = None) -> None:
    """Charge the clock for one gradient-coded round: any W - (r - 1)
    workers suffice, but each does r-fold work and r-fold communication."""
    if clock is None:
        return
    k = max(1, num_workers - (redundancy - 1))
    if flops_per_worker is not None:
        clock.phase(key, num_workers, policy="k_of_n", k=k,
                    flops_per_worker=flops_per_worker * redundancy,
                    comm_units=float(redundancy))
    else:
        clock.phase(key, num_workers, policy="k_of_n", k=k,
                    work_per_worker=float(redundancy),
                    comm_units=float(redundancy))
