"""Synthetic datasets (the paper's Sec. 5.1 generative models) and the LM
training's token pipeline (``pipeline.TokenPipeline``)."""
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.data.synthetic import (make_logistic_dataset,
                                        make_softmax_dataset, profile_dataset)

__all__ = ["TokenPipeline", "make_logistic_dataset", "make_softmax_dataset",
           "profile_dataset"]
