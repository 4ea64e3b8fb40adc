"""The paper's workload profiles (copied from ``repro.configs.paper``)."""
from repro_torch.configs.paper import PROFILES, WORKER_SETUP, DatasetProfile

__all__ = ["PROFILES", "WORKER_SETUP", "DatasetProfile"]
