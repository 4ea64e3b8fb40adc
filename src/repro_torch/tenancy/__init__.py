"""Multi-tenant fleet plane: workloads, shared-pool job scheduling, SLOs;
port of ``repro/tenancy/``.

Below this package every run simulates ONE optimizer at a time; here the
*platform* is simulated: seeded Poisson or trace-driven arrivals of
heterogeneous Newton/GIANT jobs (``workload``), and a job-level scheduler
sharing one ``scheduler.WarmPool`` and one ``CostLedger`` across every
concurrent run, with SLO-aware admission and an arrival-rate autoscaler
for the billable provisioned-concurrency reserve (``scheduler``).
Deterministic end to end: same seed + same arrival trace => bit-identical
warm/cold assignment, seconds, dollars.  Host-only: no tensor reaches a
device.
"""
from repro_torch.tenancy.scheduler import (AdmissionPolicy, Autoscaler,
                                           FleetResult, JobRecord,
                                           JobScheduler, TenancyConfig)
from repro_torch.tenancy.workload import (DEFAULT_MIX, Job, JobTemplate,
                                          WorkloadConfig,
                                          available_templates,
                                          generate_workload, get_template,
                                          register, workload_from_trace)

__all__ = [
    "AdmissionPolicy", "Autoscaler", "FleetResult", "JobRecord",
    "JobScheduler", "TenancyConfig",
    "DEFAULT_MIX", "Job", "JobTemplate", "WorkloadConfig",
    "available_templates", "generate_workload", "get_template",
    "register", "workload_from_trace",
]
