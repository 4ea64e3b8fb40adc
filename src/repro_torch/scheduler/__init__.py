"""Phase-DAG scheduler: the layer between the Newton loop and the fleet
engine (``DagRun``, ``PhaseSpec``, per-phase Lambda sizing)."""
from repro_torch.scheduler.dag import DagRun, PhaseResult
from repro_torch.scheduler.sizing import (distavg_worker_bytes,
                                          lambda_memory_gb,
                                          matvec_worker_bytes,
                                          sketch_worker_bytes)
from repro_torch.scheduler.spec import PhaseSpec

__all__ = ["DagRun", "PhaseResult", "PhaseSpec", "distavg_worker_bytes",
           "lambda_memory_gb", "matvec_worker_bytes", "sketch_worker_bytes"]
