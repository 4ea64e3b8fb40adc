"""AdamW for the LM training path (the counterpart of
``repro/optim/adamw.py``): decoupled weight decay, global-norm clipping
and a linear-warmup cosine schedule, formula for formula, on parameter
trees in the reference's layout (``model.tree``: nested dicts, stacked
layers).  Not ``torch.optim.AdamW``, whose decay order, bias correction
and rounding differ.

The reference's types are kept: the first moment in the parameter's
dtype, the second in float32, the step an int32 counter.  jax computes
``m * mu_hat_scale`` (a bfloat16 moment times a float32 0-d array) in
float32, and the update ``p - lr (u + wd p)`` in float32 cast once to the
parameter's dtype; a Python scalar times a bfloat16 array stays bfloat16
(the scalar rounded to bfloat16 first).  Here each promotion is written
out.  The schedule and the bias corrections are float32 on the host (the
cosine is XLA's CPU float32 cos, ``prng.cos_f32``).

``apply`` updates the parameters and both moments in place (through the
stacked leaves, so a model's per-layer parameter views see the update)
and returns them with the new state; the gradients are not modified.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import prng
from repro_torch.models.common import flatten, unflatten

Pytree = Any
F32 = torch.float32
# Elements a pass of the update touches at once (leaves larger than this
# are updated in slices along their first axis, bounding the float32
# temporaries; the arithmetic is elementwise, so slicing changes no bit).
SLICE_ELEMENTS = 1 << 27


class AdamWState(NamedTuple):
    step: torch.Tensor        # int32 0-d, on the host
    mu: Pytree
    nu: Pytree


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=F32)


def init(params: Pytree) -> AdamWState:
    """First moment in the param dtype (bf16-safe); second moment in f32:
    bf16 cannot represent small squared-gradient magnitudes."""
    leaves = flatten(params)
    mu = unflatten([(path, torch.zeros_like(p, requires_grad=False))
                    for path, p in leaves])
    nu = unflatten([(path, torch.zeros(p.shape, dtype=F32, device=p.device))
                    for path, p in leaves])
    return AdamWState(step=torch.zeros((), dtype=torch.int32), mu=mu, nu=nu)


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (int32), float32: linear warmup, then
    cosine decay to ``min_lr_frac`` of ``lr``."""
    step = torch.as_tensor(step, dtype=torch.int32).cpu()
    warm = torch.minimum(_f32(1.0), (step + 1).to(F32) /
                         float(max(cfg.warmup_steps, 1)))
    prog = torch.clamp((step - cfg.warmup_steps).to(F32) /
                       float(max(cfg.total_steps - cfg.warmup_steps, 1)),
                       0.0, 1.0)
    cos = _f32(cfg.min_lr_frac) + _f32((1 - cfg.min_lr_frac) * 0.5) * (
        1 + prng.cos_f32(_f32(np.pi) * prog))
    return _f32(cfg.lr) * warm * cos


def global_norm(tree: Pytree) -> torch.Tensor:
    """sqrt of the sum over the leaves, in the reference's order (sorted
    keys), of each leaf's float32 sum of squares."""
    return torch.sqrt(sum(g.float().square().sum()
                          for _, g in flatten(tree)))


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root, as XLA's and the card's
    (the CPU's vectorized float32 sqrt can miss it by an ulp; through
    float64 the one rounding to float32 is exact)."""
    if x.device.type == "cpu":
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def _slices(t: torch.Tensor) -> list:
    """Slices of t's first axis of at most SLICE_ELEMENTS elements each
    (the whole of a small or 0-d leaf)."""
    if t.dim() == 0 or t.numel() <= SLICE_ELEMENTS:
        return [...]
    rows = max(1, SLICE_ELEMENTS // max(t[0].numel(), 1))
    return [slice(i, i + rows) for i in range(0, t.shape[0], rows)]


@torch.no_grad()
def apply(cfg: AdamWConfig, grads: Pytree, state: AdamWState,
          params: Pytree, gnorm: Optional[torch.Tensor] = None
          ) -> Tuple[Pytree, AdamWState]:
    """One AdamW step: the gradients clipped to global norm
    ``clip_norm`` (the scale rounded to the gradients' dtype), the moments
    and the parameters updated in place.  ``gnorm``: the gradients'
    ``global_norm`` where the caller has it already."""
    leaves = flatten(grads)
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.minimum(torch.ones_like(gnorm), cfg.clip_norm /
                          torch.maximum(gnorm, torch.full_like(gnorm, 1e-9)))
    scale = scale.to(leaves[0][1].dtype)

    step = state.step + 1
    stepf = step.to(F32)
    scalars = {"scale": scale,
               "mu_hat": 1.0 / (1 - torch.pow(_f32(cfg.b1), stepf)),
               "nu_hat": 1.0 / (1 - torch.pow(_f32(cfg.b2), stepf)),
               "lr": schedule(cfg, state.step), "b1": cfg.b1,
               "c1": 1 - cfg.b1, "b2": cfg.b2, "c2": 1 - cfg.b2,
               "eps": cfg.eps, "wd": cfg.weight_decay}
    consts = {}

    def c(name, dtype, device):
        """A scalar as a 0-d tensor in ``dtype`` on ``device`` (a Python
        scalar meets a bfloat16 array in bfloat16)."""
        key = (name, dtype, device)
        if key not in consts:
            consts[key] = torch.as_tensor(scalars[name]).to(device=device,
                                                            dtype=dtype)
        return consts[key]

    mus, nus = dict(flatten(state.mu)), dict(flatten(state.nu))
    for (path, g), (_, p) in zip(leaves, flatten(params)):
        m, v = mus[path], nus[path]
        dev, dt = p.device, p.dtype
        for sl in _slices(p):
            gs = g[sl] * c("scale", g.dtype, dev)
            m[sl] = c("b1", m.dtype, dev) * m[sl] + c("c1", m.dtype, dev) * gs
            v[sl] = (c("b2", F32, dev) * v[sl] +
                     c("c2", F32, dev) * gs.float().square())
            u = (m[sl].float() * c("mu_hat", F32, dev)) / (
                _sqrt(v[sl] * c("nu_hat", F32, dev)) + c("eps", F32, dev))
            decay = (p[sl] * c("wd", dt, dev)).float()
            p[sl] = (p[sl].float() - c("lr", F32, dev) * (u + decay)).to(dt)
    return params, AdamWState(step=step, mu=state.mu, nu=state.nu)
