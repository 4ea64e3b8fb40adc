"""Per-phase Lambda memory sizing; copy of ``repro/scheduler/sizing.py``
(the parts the Newton loop uses).

``lambda_memory_gb`` maps a working-set byte count to a billable Lambda
size: bytes x headroom, rounded up to the 64 MB allocation granularity and
clamped to the platform bounds.
"""
from __future__ import annotations

import math

LAMBDA_MIN_GB = 0.125      # 128 MB platform floor
LAMBDA_MAX_GB = 10.0       # platform ceiling
LAMBDA_STEP_GB = 0.0625    # 64 MB allocation granularity

FLOAT32_BYTES = 4


def lambda_memory_gb(working_set_bytes: float, headroom: float = 2.0,
                     floor: float = LAMBDA_MIN_GB,
                     ceil: float = LAMBDA_MAX_GB) -> float:
    """Billable Lambda size (GB) for a declared per-worker working set."""
    if working_set_bytes < 0:
        raise ValueError("working_set_bytes must be >= 0")
    gb = working_set_bytes * headroom / 2.0 ** 30
    stepped = math.ceil(gb / LAMBDA_STEP_GB) * LAMBDA_STEP_GB
    return float(min(ceil, max(floor, stepped)))


def matvec_worker_bytes(block_rows: int, cols: int,
                        dtype_bytes: int = FLOAT32_BYTES) -> float:
    """Coded-matvec worker: one encoded block, the input and the output."""
    return float(dtype_bytes) * (block_rows * cols + cols + block_rows)


def sketch_worker_bytes(block_size: int, d: int,
                        dtype_bytes: int = FLOAT32_BYTES) -> float:
    """Hessian-sketch worker: one (block_size x d) block plus its Gram tile."""
    return float(dtype_bytes) * (block_size * d + d * d)


def distavg_worker_bytes(block_size: int, d: int,
                         dtype_bytes: int = FLOAT32_BYTES) -> float:
    """Distributed-averaging worker: sketch block, local d x d system and
    its factorization workspace."""
    return float(dtype_bytes) * (block_size * d + 2 * d * d + 2 * d)
