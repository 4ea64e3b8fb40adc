"""Training on the port: the LM trainer (``trainer.Trainer``) and the OSN
readout head."""
from repro_torch.training.osn_head import extract_features, train_osn_head
from repro_torch.training.trainer import (SimulatedFailure, Trainer,
                                          TrainerConfig)

__all__ = ["extract_features", "train_osn_head", "Trainer", "TrainerConfig",
           "SimulatedFailure"]
