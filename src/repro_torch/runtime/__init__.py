"""Serverless runtime: the discrete-event fleet engine, its cost model, its
termination-policy registry, the fault plane and trace record/replay
(host-side numpy, as in the reference)."""
from repro_torch.runtime.cost import CostLedger, CostModel, bill_phase
from repro_torch.runtime.engine import FleetConfig, FleetEngine
from repro_torch.runtime.faults import (BurstSpec, CorruptionSpec, FaultPlan,
                                        OomSpec, PhaseExhaustedError,
                                        PoolDeathSpec, S3Spec, ThrottleSpec,
                                        available_scenarios, get_scenario,
                                        register_scenario)
from repro_torch.runtime.policies import (PhaseContext, PhaseOutcome,
                                          available_policies, get_policy,
                                          register_policy)
from repro_torch.runtime.trace import (TraceRecorder, TraceReplayer,
                                       calibrate_faults_from_trace,
                                       calibrate_fleet_from_trace,
                                       calibrate_from_times,
                                       calibrate_from_trace, load_trace)

__all__ = [
    "CostLedger", "CostModel", "bill_phase",
    "FleetConfig", "FleetEngine",
    "BurstSpec", "CorruptionSpec", "FaultPlan", "OomSpec",
    "PhaseExhaustedError", "PoolDeathSpec", "S3Spec", "ThrottleSpec",
    "available_scenarios", "get_scenario", "register_scenario",
    "PhaseContext", "PhaseOutcome", "available_policies", "get_policy",
    "register_policy",
    "TraceRecorder", "TraceReplayer", "calibrate_faults_from_trace",
    "calibrate_fleet_from_trace",
    "calibrate_from_times", "calibrate_from_trace", "load_trace",
]
