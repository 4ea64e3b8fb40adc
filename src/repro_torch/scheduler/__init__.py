"""Phase-DAG scheduler: the layer between the optimizers and the fleet
engine (``DagRun``, ``run_dag``, ``PhaseSpec``, per-phase Lambda sizing and
the ``WarmPool``)."""
from repro_torch.scheduler.dag import DagResult, DagRun, PhaseResult, run_dag
from repro_torch.scheduler.pool import WarmPool
from repro_torch.scheduler.sizing import (LAMBDA_MAX_GB, LAMBDA_MIN_GB,
                                          LAMBDA_STEP_GB,
                                          distavg_worker_bytes,
                                          lambda_memory_gb,
                                          matvec_worker_bytes,
                                          sketch_worker_bytes)
from repro_torch.scheduler.spec import (PhaseSpec, canonical_order,
                                        validate_dag)

__all__ = [
    "DagResult", "DagRun", "PhaseResult", "run_dag", "WarmPool",
    "LAMBDA_MAX_GB", "LAMBDA_MIN_GB", "LAMBDA_STEP_GB",
    "distavg_worker_bytes", "lambda_memory_gb", "matvec_worker_bytes",
    "sketch_worker_bytes", "PhaseSpec", "canonical_order", "validate_dag",
]
