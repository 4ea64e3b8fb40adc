"""Straggler model + simulation clock; port of ``repro/core/straggler.py``.

Calibrated to the paper's Fig. 1 (3600 AWS Lambda workers): per-worker job
time ``t_w = base * lognormal(0, body_sigma) * (1 + straggler * tail)``
with P[straggler] = p_tail and tail ~ U[tail_lo, tail_hi].  ``SimClock``
is a facade over the ``runtime`` fleet engine that turns each phase into
simulated seconds and dollars.  Both stay on the host.  The
order-statistic helpers (``wait_all_time``, ``k_of_n_time``,
``k_of_n_mask``, ``speculative_time``) work on a sampled time tensor
directly.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import prng
from repro_torch.kernels import ops as kops


@dataclasses.dataclass(frozen=True)
class StragglerModel:
    base_time: float = 1.0
    body_sigma: float = 0.08
    p_tail: float = 0.02
    tail_lo: float = 0.3
    tail_hi: float = 1.5
    invoke_overhead: float = 0.1
    comm_per_unit: float = 0.05
    flops_per_second: float = 2e6

    def sample_times(self, key: torch.Tensor, num_workers: int,
                     work_per_worker: float = 1.0,
                     flops_per_worker: Optional[float] = None) -> torch.Tensor:
        """Per-worker completion times of one phase, float32 on the CPU as
        the reference computes them (the fleet engine widens them to
        float64 only afterwards).  Work is abstract seconds or a flop count
        converted through ``flops_per_second``."""
        if flops_per_worker is not None:
            work_per_worker = flops_per_worker / self.flops_per_second
        k1, k2, k3 = prng.split(key, 3)
        body = prng.exp_f32(self.body_sigma * kops.normal(
            k1, (num_workers,), device="cpu"))
        is_tail = prng.bernoulli(k2, self.p_tail, (num_workers,),
                                 device="cpu")
        tail = prng.uniform(k3, (num_workers,), self.tail_lo, self.tail_hi,
                            device="cpu")
        slow = 1.0 + is_tail * tail
        return (self.invoke_overhead
                + self.base_time * work_per_worker * body * slow)


# The production termination policies live in the ``runtime.policies``
# registry (what SimClock.phase dispatches through); these helpers are the
# order-statistic forms for a sampled time tensor.  ``speculative_time``
# delegates to the registry, so there is one implementation.

def wait_all_time(times: torch.Tensor) -> torch.Tensor:
    """Policy: wait for every worker (uncoded baseline)."""
    return times.max()


def k_of_n_time(times: torch.Tensor, k: int) -> torch.Tensor:
    """Policy: proceed when any k of n workers finish (coded / sketched)."""
    return torch.sort(times).values[k - 1]


def k_of_n_mask(times: torch.Tensor, k: int) -> torch.Tensor:
    """Which workers finished by the k-of-n deadline (ties kept, >= k)."""
    return times <= k_of_n_time(times, k)


def speculative_time(times: torch.Tensor, key: torch.Tensor,
                     model: StragglerModel, watch_fraction: float = 0.9,
                     work_per_worker: float = 1.0,
                     flops_per_worker: Optional[float] = None
                     ) -> torch.Tensor:
    """Policy: speculative execution (paper Sec. 5.3).  Wait for
    ``watch_fraction`` of the workers, relaunch the stragglers (redoing the
    phase's actual work) and take min(original finish, deadline + relaunch
    finish) per straggler.  A float32 scalar, as the reference returns."""
    from repro_torch.runtime import policies   # runtime imports us
    n = times.shape[0]
    ctx = policies.PhaseContext(
        watch_fraction=watch_fraction,
        sample_relaunch=lambda: model.sample_times(
            key, n, work_per_worker,
            flops_per_worker).numpy().astype(np.float64))
    out = policies.get_policy("speculative")(
        times.cpu().numpy().astype(np.float64), ctx)
    return torch.tensor(out.elapsed, dtype=torch.float32)


class SimClock:
    """Simulated wall time and dollars across distributed phases: a thin
    facade over ``runtime.FleetEngine`` with the reference's
    ``phase()``/``time``/``dollars`` surface."""

    def __init__(self, model: StragglerModel, time: float = 0.0, *,
                 fleet=None, cost=None, recorder=None, replay=None,
                 pool=None, telemetry=None, faults=None):
        from repro_torch.runtime import FleetEngine   # runtime imports us
        self.engine = FleetEngine(model, fleet=fleet, cost=cost,
                                  recorder=recorder, replay=replay,
                                  pool=pool, telemetry=telemetry,
                                  faults=faults)
        if time:
            self.engine.seconds += float(time)

    @property
    def model(self) -> StragglerModel:
        return self.engine.model

    @property
    def time(self) -> float:
        return self.engine.seconds

    @property
    def dollars(self) -> float:
        return self.engine.dollars

    @property
    def ledger(self):
        return self.engine.ledger

    @property
    def telemetry(self):
        """The attached ``obs.Telemetry`` (or the no-op ``obs.NULL``)."""
        return self.engine.telemetry

    @property
    def last_corruption(self):
        """Per-worker corruption flags of the most recent phase (None
        unless a fault plan with a ``CorruptionSpec`` is attached or a
        replayed row carries them)."""
        return self.engine.last_corruption

    def charge(self, elapsed: float, phase_name=None) -> None:
        """Add externally computed phase time (no workers billed)."""
        self.engine.charge(elapsed, phase_name=phase_name)

    def phase(self, key: torch.Tensor, num_workers: int, *,
              work_per_worker: float = 1.0,
              flops_per_worker: Optional[float] = None,
              policy: str = "wait_all", k: Optional[int] = None,
              comm_units: float = 0.0, decodable=None,
              not_before: Optional[float] = None,
              memory_gb: Optional[float] = None,
              working_set_gb: Optional[float] = None,
              phase_name: Optional[str] = None,
              phase_deps: Tuple[str, ...] = ()) -> Tuple[float, torch.Tensor]:
        """Simulate one phase; returns (elapsed, finished mask as a CPU bool
        tensor).  See ``FleetEngine.run_phase``."""
        elapsed, mask = self.engine.run_phase(
            key, num_workers, work_per_worker=work_per_worker,
            flops_per_worker=flops_per_worker, policy=policy, k=k,
            comm_units=comm_units, decodable=decodable,
            not_before=not_before, memory_gb=memory_gb,
            working_set_gb=working_set_gb,
            phase_name=phase_name, phase_deps=phase_deps)
        return elapsed, torch.from_numpy(mask)
