"""Synthetic datasets (the paper's Sec. 5.1 generative models)."""
from repro_torch.data.synthetic import (make_logistic_dataset,
                                        make_softmax_dataset, profile_dataset)

__all__ = ["make_logistic_dataset", "make_softmax_dataset", "profile_dataset"]
