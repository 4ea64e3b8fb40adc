"""OverSketched Newton as a framework feature: train a softmax readout head
(linear probe) on frozen backbone features with the paper's algorithm, its
Sec. 4.2 workload at LM scale (the counterpart of
``repro/training/osn_head.py``).

The probe objective is (weakly) convex, so Thms 3.1/3.3 apply, and the
Hessian square root has the matrix-product structure OverSketch
accelerates.  On the card, ``use_kernels=True`` builds each Hessian with
the fused count sketch -> Gram kernel; the coded gradient takes the coded
mat-vec kernel either way.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import (Dataset, NewtonConfig, OverSketchConfig,
                              SoftmaxRegression, oversketched_newton)
from repro_torch.core.straggler import StragglerModel
from repro_torch.models import transformer
from repro_torch.models.registry import ModelBundle


def extract_features(bundle: ModelBundle, params, tokens: torch.Tensor,
                     extra=None) -> torch.Tensor:
    """Frozen-backbone features: mean-pooled final hidden states (B, d),
    the mean in float32 rounded to the compute dtype (as jnp.mean of a
    bfloat16 array), then float32.  No final norm."""
    h, _ = transformer.forward_hidden(bundle.cfg, params, tokens, extra)
    return (h.float().sum(dim=1) / h.shape[1]).to(h.dtype).float()


def train_osn_head(features: torch.Tensor, labels_onehot: torch.Tensor, *,
                   num_classes: int, sketch_dim: Optional[int] = None,
                   block_size: int = 128, iters: int = 8,
                   model: Optional[StragglerModel] = StragglerModel(),
                   seed: int = 0, use_kernels: bool = False
                   ) -> Tuple[torch.Tensor, dict]:
    """Fit W (K, d) on (B, d) features with OverSketched Newton, on the
    features' device.

    Returns (w_flat, history).  Weakly-convex path (unregularized softmax):
    Newton-MR update + Eq. (6) line search, per the paper.  ``use_kernels``
    (the port's; the reference leaves it False) routes the Hessian through
    the fused sketch kernel.
    """
    b, d = features.shape
    k = num_classes
    sketch_dim = sketch_dim or max(block_size,
                                   block_size * (-(-4 * d * k // block_size)))
    obj = SoftmaxRegression(num_classes=k)
    data = Dataset(x=features, y=labels_onehot)
    cfg = NewtonConfig(
        iters=iters, solver="pinv",
        sketch=OverSketchConfig(sketch_dim, block_size, 0.25),
        coded_block_rows=min(256, max(32, b // 8)), seed=seed,
        use_kernels=use_kernels)
    res = oversketched_newton(
        obj, data, torch.zeros(k * d, device=features.device), cfg,
        model=model, device=features.device)
    return res.w, res.history
