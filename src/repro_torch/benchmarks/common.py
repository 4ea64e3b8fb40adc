"""Shared benchmark harness utilities; port of ``benchmarks/common.py``."""
from __future__ import annotations

import time
from typing import Callable, Dict, List

import torch


def _block(out) -> None:
    """Wait for the card when ``out`` holds a CUDA tensor (tensors nested
    in tuples, lists and dicts included); host results need no wait."""
    stack = [out]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                torch.cuda.synchronize(x.device)
                return
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)


def time_fn(fn: Callable, *args, iters: int = 5, warmup: int = 2) -> float:
    """Median wall-clock microseconds per call (after warmup)."""
    for _ in range(warmup):
        _block(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        _block(fn(*args))
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2] * 1e6


def time_to_target(history: Dict[str, List[float]], f_target: float) -> float:
    """Simulated seconds until fval <= target (inf if never)."""
    for f, t in zip(history["fval"], history["time"]):
        if f <= f_target:
            return t
    return float("inf")


def best_f(*histories, rel: float = 0.01) -> float:
    """A common reachable target: rel-relative above the best final value
    (1% default — the accuracy regime the paper's figures compare at)."""
    best = min(h["fval"][-1] for h in histories)
    return best * (1.0 + rel) + 1e-6


def row(name: str, us: float, derived: str) -> str:
    return f"{name},{us:.1f},{derived}"


def json_row(name: str, us: float, **payload) -> Dict[str, object]:
    """One JSON-ready benchmark row; payload keys land in ``derived`` as
    ``k=v`` pairs (CSV-safe, no commas), e.g. one row per sketch family in
    the fig7 sweep."""
    def fmt(v):
        return f"{v:.4g}" if isinstance(v, float) else str(v)
    return {"name": name, "us": us,
            "derived": ";".join(f"{k}={fmt(v)}" for k, v in payload.items())}

