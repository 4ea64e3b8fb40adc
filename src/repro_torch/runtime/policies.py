"""Termination/recovery policy registry for the fleet engine (a copy of
``repro/runtime/policies.py``, which is numpy only).

A policy decides, given the per-worker completion times of one distributed
phase, (a) when the master stops waiting, (b) which workers' results it has
at that point, and (c) what extra attempts it launched along the way (for
billing).  Policies are plain functions registered under a string key —
mirroring ``repro_torch.sketching.registry`` — so "how does this phase terminate"
is a config axis (``SimClock.phase(policy=...)``), not an if-chain:

  wait_all      wait for every worker (uncoded baseline);
  k_of_n        proceed when any k of n finish (coded / sketched semantics);
  speculative   watch ``watch_fraction`` finish, then relaunch the detected
                stragglers (paper Sec. 5.3) — relaunches bill extra attempts;
  hedged        duplicate every request still outstanding at the
                ``hedge_quantile`` arrival time (Dean & Barroso tail-at-scale
                hedging) — cheaper detection than speculative, more
                duplicates;
  coded_decode  stream results in arrival order and stop at the first
                decodable prefix (paper Alg. 1 step 8); the caller supplies
                the decodability predicate via ``ctx.decodable``.

All policies are deterministic functions of (times, ctx): any randomness
(relaunch durations) is drawn through ``ctx.sample_relaunch``, which threads
the phase's actual per-worker work — the historical ``SimClock`` bug of
relaunching stragglers with unit work cannot recur here.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class PhaseContext:
    """Everything a policy may consult beyond the completion times."""

    k: Optional[int] = None                 # k_of_n / coded_decode floor
    watch_fraction: float = 0.9             # speculative watch deadline
    hedge_quantile: float = 0.8             # hedged duplicate launch point
    decodable: Optional[Callable[[np.ndarray], bool]] = None
    # Fresh relaunch durations with the phase's true work (cold starts
    # included per the fleet config); () -> (n,) float array.
    sample_relaunch: Optional[Callable[[], np.ndarray]] = None


@dataclasses.dataclass
class PhaseOutcome:
    elapsed: float                          # master wait, pre-comm
    mask: np.ndarray                        # which workers' results arrived
    extra_attempts: List[Tuple[float, float]]  # (launch, end) relaunches
    # How many extra attempts actually completed and wrote output (a
    # duplicate cancelled because the original won does not PUT).
    extra_successes: int = 0


Policy = Callable[[np.ndarray, PhaseContext], PhaseOutcome]

_POLICIES: Dict[str, Policy] = {}


def register_policy(name: str) -> Callable[[Policy], Policy]:
    def deco(fn: Policy) -> Policy:
        if name in _POLICIES and _POLICIES[name] is not fn:
            raise ValueError(f"policy {name!r} already registered")
        _POLICIES[name] = fn
        return fn
    return deco


def get_policy(name: str) -> Policy:
    try:
        return _POLICIES[name]
    except KeyError:
        raise ValueError(
            f"unknown policy {name!r}; available: {available_policies()}"
        ) from None


def available_policies() -> list:
    return sorted(_POLICIES)


@register_policy("wait_all")
def wait_all(times: np.ndarray, ctx: PhaseContext) -> PhaseOutcome:
    return PhaseOutcome(float(times.max()),
                        np.ones(times.shape, dtype=bool), [])


@register_policy("k_of_n")
def k_of_n(times: np.ndarray, ctx: PhaseContext) -> PhaseOutcome:
    if ctx.k is None:
        raise ValueError("k_of_n policy needs k")
    deadline = float(np.sort(times)[ctx.k - 1])
    return PhaseOutcome(deadline, times <= deadline, [])


def _relaunch_outstanding(times: np.ndarray, deadline: float,
                          ctx: PhaseContext) -> PhaseOutcome:
    """Shared speculative/hedged core: duplicate every worker still
    outstanding at ``deadline``; each copy finishes at min(original,
    deadline + relaunch) — relaunch is inf if the duplicate died.  The
    losing copy is cancelled when the winner returns (billed until then,
    but only winners count as extra successes / PUT output)."""
    effective = times.copy()
    relaunch = ctx.sample_relaunch()
    extra = []
    wins = 0
    for w in np.where(times > deadline)[0]:
        finish = deadline + float(relaunch[w])
        effective[w] = min(float(times[w]), finish)
        extra.append((deadline, effective[w]))
        wins += finish < float(times[w])
    return PhaseOutcome(float(effective.max()),
                        np.ones(times.shape[0], dtype=bool), extra, wins)


@register_policy("speculative")
def speculative(times: np.ndarray, ctx: PhaseContext) -> PhaseOutcome:
    # Deadline over the FINITE arrivals only: an exhausted worker (time
    # inf, fail_open=False) never arrives, so the watcher's order
    # statistic must not wait on it — with every time finite this is
    # exactly the historical np.sort(times)[k-1].
    k = max(1, int(np.floor(ctx.watch_fraction * times.shape[0])))
    finite = times[np.isfinite(times)]
    if finite.size == 0:
        deadline = 0.0
    else:
        deadline = float(np.sort(finite)[min(k, finite.size) - 1])
    return _relaunch_outstanding(times, deadline, ctx)


@register_policy("hedged")
def hedged(times: np.ndarray, ctx: PhaseContext) -> PhaseOutcome:
    """Duplicate every request still outstanding at the hedge deadline."""
    finite = times[np.isfinite(times)]
    if finite.size == 0:
        deadline = 0.0
    else:
        # Quantile of the finite arrivals (identical to the historical
        # all-times quantile when nothing exhausted).
        deadline = float(np.quantile(finite, ctx.hedge_quantile))
    return _relaunch_outstanding(times, deadline, ctx)


@register_policy("coded_decode")
def coded_decode(times: np.ndarray, ctx: PhaseContext) -> PhaseOutcome:
    """Stop at the first arrival-order prefix that decodes.

    With no predicate this degenerates to k_of_n (any k results suffice);
    with one, it reproduces the faithful streaming master of Alg. 1.
    """
    n = times.shape[0]
    order = np.argsort(times, kind="stable")
    k_min = ctx.k if ctx.k is not None else 1
    for k in range(max(1, k_min), n + 1):
        if not np.isfinite(times[order[k - 1]]):
            # The prefix has run out of arrivals (exhausted workers sort
            # last): no decodable set exists — fall through to the
            # wait-all outcome, whose inf elapsed surfaces the exhaustion.
            break
        mask = np.zeros(n, dtype=bool)
        mask[order[:k]] = True
        if ctx.decodable is None or ctx.decodable(mask):
            return PhaseOutcome(float(times[order[k - 1]]), mask, [])
    return PhaseOutcome(float(times.max()), np.ones(n, dtype=bool), [])
