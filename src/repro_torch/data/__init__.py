"""Synthetic datasets (the paper's Sec. 5.1 generative model)."""
from repro_torch.data.synthetic import make_logistic_dataset, profile_dataset

__all__ = ["make_logistic_dataset", "profile_dataset"]
