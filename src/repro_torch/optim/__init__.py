"""Baseline optimizers of the paper's comparisons (Sec. 5): GIANT, exact
Newton, the first-order methods and gradient coding.  The reference's LM
AdamW path waits for ROADMAP Queue 1 item 13."""
from repro_torch.optim.exact_newton import exact_newton
from repro_torch.optim.first_order import FirstOrderConfig, first_order
from repro_torch.optim.giant import GiantConfig, giant
from repro_torch.optim.gradient_coding import (assignment, decode_weights,
                                               gradient_coding_phase)

__all__ = ["FirstOrderConfig", "first_order", "GiantConfig", "giant",
           "exact_newton", "assignment", "decode_weights",
           "gradient_coding_phase"]
