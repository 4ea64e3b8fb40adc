"""Serverless runtime: the discrete-event fleet engine, its cost model and
its termination-policy registry (host-side numpy, as in the reference)."""
from repro_torch.runtime.cost import CostLedger, CostModel, bill_phase
from repro_torch.runtime.engine import FleetConfig, FleetEngine
from repro_torch.runtime.faults import PhaseExhaustedError
from repro_torch.runtime.policies import (PhaseContext, PhaseOutcome,
                                          available_policies, get_policy,
                                          register_policy)

__all__ = [
    "CostLedger", "CostModel", "bill_phase", "FleetConfig", "FleetEngine",
    "PhaseExhaustedError", "PhaseContext", "PhaseOutcome",
    "available_policies", "get_policy", "register_policy",
]
