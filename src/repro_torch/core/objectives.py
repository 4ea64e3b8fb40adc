"""Logistic regression with the (gradient-as-matvec, Hessian-square-root)
structure that OverSketched Newton exploits; port of
``repro/core/objectives.py`` (``Dataset`` and ``LogisticRegression``).

  f(w) = (1/n) sum log(1 + exp(-y_i x_i.w)) + (lam/2)||w||^2,  y in {-1, +1}

``value`` also takes a batch of points ``w`` of shape (c, d) and returns
(c,) values: the line search evaluates all its candidate steps at once
where the reference vmaps.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F


class Dataset(NamedTuple):
    x: torch.Tensor                      # (n, d) features
    y: torch.Tensor                      # (n,) labels +-1
    x_test: Optional[torch.Tensor] = None
    y_test: Optional[torch.Tensor] = None


MatVec = Callable[[str, torch.Tensor], torch.Tensor]


def _plain_mv(data: Dataset) -> MatVec:
    def mv(tag: str, v: torch.Tensor) -> torch.Tensor:
        if tag == "X":
            return data.x @ v
        if tag == "XT":
            return data.x.T @ v
        raise ValueError(tag)
    return mv


@dataclasses.dataclass(frozen=True)
class LogisticRegression:
    lam: float = 1e-5
    strongly_convex: bool = True
    name: str = "logistic"

    @property
    def hess_reg(self) -> float:
        return self.lam

    def value(self, w: torch.Tensor, data: Dataset) -> torch.Tensor:
        """f at w (d,) -> scalar, or at a batch w (c, d) -> (c,)."""
        z = data.x @ w if w.dim() == 1 else (data.x @ w.T).T
        margins = data.y * z
        reg = 0.5 * self.lam * (w * w).sum(-1)
        return F.softplus(-margins).mean(-1) + reg

    def gradient_via(self, w: torch.Tensor, data: Dataset,
                     mv: Optional[MatVec] = None) -> torch.Tensor:
        mv = mv or _plain_mv(data)
        n = data.x.shape[0]
        alpha = mv("X", w)                                   # (n,)
        beta = -data.y * torch.sigmoid(-data.y * alpha)      # -y/(1+e^{y a})
        return mv("XT", beta) / n + self.lam * w

    def gradient(self, w: torch.Tensor, data: Dataset) -> torch.Tensor:
        return self.gradient_via(w, data)

    def hess_sqrt(self, w: torch.Tensor, data: Dataset) -> torch.Tensor:
        """A = sqrt(Lam/n) X, Lam_ii = sig(y a)(1 - sig(y a))."""
        n = data.x.shape[0]
        s = torch.sigmoid(data.y * (data.x @ w))
        return torch.sqrt(s * (1.0 - s) / n)[:, None] * data.x

    def error(self, w: torch.Tensor, x: torch.Tensor,
              y: torch.Tensor) -> torch.Tensor:
        return (torch.sign(x @ w) != y).float().mean()
