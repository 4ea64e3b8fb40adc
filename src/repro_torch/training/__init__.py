"""Training on the port: the OSN readout head (the trainer is not ported
yet, ROADMAP Queue 1 item 13)."""
from repro_torch.training.osn_head import extract_features, train_osn_head

__all__ = ["extract_features", "train_osn_head"]
