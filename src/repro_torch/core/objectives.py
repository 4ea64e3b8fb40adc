"""Convex objectives with the (gradient-as-matvec, Hessian-square-root)
structure that OverSketched Newton exploits (paper Sec. 4); port of
``repro/core/objectives.py``.

Conventions (row-major, mean-normalized):
  features X: (n, d) with samples as rows;  logistic labels y in {-1, +1}.
  logistic:  f(w) = (1/n) sum log(1 + exp(-y_i x_i.w)) + (lam/2)||w||^2
  softmax:   W (K, d) class-major, flat dim K*d, mean-normalized NLL,
             unregularized => weakly convex (paper Sec. 4.2).
  ridge:     f(w) = (1/2n)||Xw - y||^2 + (lam/2)||w||^2
  lp_ipm:    f(x) = tau c.x - sum_i log(b_i - a_i.x)   (interior point stage)
  lasso_dual_ipm: the Lasso dual's barrier stage, over z in R^n.

Every objective provides ``value``, ``gradient``, ``hess_sqrt`` (A with
grad^2 f = A^T A + hess_reg I) and ``gradient_via(w, data, mv)``, whose
large matvecs go through ``mv(tag, v)``, tag "X" or "XT": the hook the
coded, straggler-resilient path plugs into (paper Alg. 1).  Each vector
handed to the hook is contiguous.

``value`` also takes a batch of points ``w`` of shape (c, dim) and returns
(c,) values: the line search evaluates all its candidate steps at once
where the reference vmaps.  ``LinearProgramIPM.value`` is +inf (its
barrier -inf) outside the interior, candidate by candidate.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F


class Dataset(NamedTuple):
    x: torch.Tensor                      # (n, d) features
    y: torch.Tensor                      # (n,) labels +-1, or (n, K) one-hot
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


def _rows(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w for one point w (d,) -> (n,), or for a batch (c, d) -> (c, n)."""
    return x @ w if w.dim() == 1 else (x @ w.T).T


def _sq_norm(w: torch.Tensor) -> torch.Tensor:
    return (w * w).sum(-1)


def _masked_mean(loss: torch.Tensor, row_ok: torch.Tensor) -> torch.Tensor:
    """Mean of the per-row loss over the surviving rows (at least one)."""
    ok = row_ok.to(loss.dtype)
    return (loss * ok).sum(-1) / ok.sum().clamp_min(1.0)


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
        margins = data.y * _rows(data.x, w)
        return F.softplus(-margins).mean(-1) + 0.5 * self.lam * _sq_norm(w)

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

    def masked_value(self, w: torch.Tensor, data: Dataset,
                     row_ok: torch.Tensor) -> torch.Tensor:
        """Mean loss over surviving rows only (ignore-stragglers scheme)."""
        loss = F.softplus(-data.y * _rows(data.x, w))
        return _masked_mean(loss, row_ok) + 0.5 * self.lam * _sq_norm(w)

    def error(self, w: torch.Tensor, x: torch.Tensor,
              y: torch.Tensor) -> torch.Tensor:
        return (torch.sign(x @ w) != y).float().mean()


@dataclasses.dataclass(frozen=True)
class SoftmaxRegression:
    """Unregularized multinomial logistic regression, weakly convex.

    Parameters are a flat vector w of length K*d (class-major), matching the
    paper's dK-dimensional Hessian treatment (Sec. 4.2).
    """
    num_classes: int
    lam: float = 0.0
    strongly_convex: bool = False
    name: str = "softmax"

    @property
    def hess_reg(self) -> float:
        return self.lam

    def _logits(self, w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """x W^T: (n, K) for w (K d,), (c, n, K) for a batch (c, K d)."""
        wk = w.reshape(*w.shape[:-1], self.num_classes, x.shape[1])
        return x @ wk.transpose(-1, -2)

    @staticmethod
    def _nll(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return torch.logsumexp(logits, dim=-1) - (logits * y).sum(-1)

    def value(self, w: torch.Tensor, data: Dataset) -> torch.Tensor:
        nll = self._nll(self._logits(w, data.x), data.y)
        return nll.mean(-1) + 0.5 * self.lam * _sq_norm(w)

    def gradient_via(self, w: torch.Tensor, data: Dataset,
                     mv: Optional[MatVec] = None) -> torch.Tensor:
        mv = mv or _plain_mv(data)
        n, d = data.x.shape
        k = self.num_classes
        # alpha: (n, K) by K matvecs through the hook, then K back.
        wk = w.reshape(k, d)
        alpha = torch.stack([mv("X", wk[c]) for c in range(k)], dim=1)
        p = torch.softmax(alpha, dim=1)
        beta = ((p - data.y) / n).T.contiguous()             # (K, n)
        g = torch.stack([mv("XT", beta[c]) for c in range(k)], dim=0)
        return g.reshape(-1) + self.lam * w

    def gradient(self, w: torch.Tensor, data: Dataset) -> torch.Tensor:
        p = torch.softmax(self._logits(w, data.x), dim=1)
        g = (p - data.y).T @ data.x / data.x.shape[0]        # (K, d)
        return g.reshape(-1) + self.lam * w

    def hess_sqrt(self, w: torch.Tensor, data: Dataset) -> torch.Tensor:
        """A (n K, d K) with A^T A = Hessian, class-major: the row (n, c)
        and column (i, j) hold M_n[i, c] x_n[j] / sqrt(n), where
        B_n = diag(p_n) - p_n p_n^T = M_n M_n^T with
        M_n = diag(sqrt(p_n)) - p_n sqrt(p_n)^T.  Written by one broadcast
        product into the (n, K, K, d) output and divided in place: no
        permuted copy of A, which at full width is most of the card."""
        n, d = data.x.shape
        k = self.num_classes
        p = torch.softmax(self._logits(w, data.x), dim=1)    # (n, K)
        sq = torch.sqrt(p)
        eye = torch.eye(k, dtype=p.dtype, device=p.device)
        m = eye[None] * sq[:, None, :] - p[..., None] * sq[:, None, :]
        a = torch.empty((n, k, k, d), dtype=p.dtype, device=p.device)
        torch.mul(m.transpose(1, 2)[..., None], data.x[:, None, None, :],
                  out=a)
        a /= math.sqrt(n)
        return a.view(n * k, k * d)

    def masked_value(self, w: torch.Tensor, data: Dataset,
                     row_ok: torch.Tensor) -> torch.Tensor:
        nll = self._nll(self._logits(w, data.x), data.y)
        return _masked_mean(nll, row_ok) + 0.5 * self.lam * _sq_norm(w)

    def error(self, w: torch.Tensor, x: torch.Tensor,
              y: torch.Tensor) -> torch.Tensor:
        pred = torch.argmax(self._logits(w, x), dim=1)
        return (pred != torch.argmax(y, dim=1)).float().mean()


@dataclasses.dataclass(frozen=True)
class RidgeRegression:
    lam: float = 1e-5
    strongly_convex: bool = True
    name: str = "ridge"

    @property
    def hess_reg(self) -> float:
        return self.lam

    def value(self, w: torch.Tensor, data: Dataset) -> torch.Tensor:
        r = _rows(data.x, w) - data.y
        return 0.5 * (r * r).mean(-1) + 0.5 * self.lam * _sq_norm(w)

    def gradient_via(self, w: torch.Tensor, data: Dataset,
                     mv: Optional[MatVec] = None) -> torch.Tensor:
        mv = mv or _plain_mv(data)
        n = data.x.shape[0]
        beta = mv("X", w) - data.y
        return mv("XT", beta) / n + self.lam * w

    def gradient(self, w: torch.Tensor, data: Dataset) -> torch.Tensor:
        return self.gradient_via(w, data)

    def hess_sqrt(self, w: torch.Tensor, data: Dataset) -> torch.Tensor:
        return data.x / math.sqrt(data.x.shape[0])

    def masked_value(self, w: torch.Tensor, data: Dataset,
                     row_ok: torch.Tensor) -> torch.Tensor:
        r = _rows(data.x, w) - data.y
        return 0.5 * _masked_mean(r * r, row_ok) \
            + 0.5 * self.lam * _sq_norm(w)

    def error(self, w: torch.Tensor, x: torch.Tensor,
              y: torch.Tensor) -> torch.Tensor:
        r = x @ w - y
        return (r * r).mean()


@dataclasses.dataclass(frozen=True)
class LinearProgramIPM:
    """One interior-point stage of  min c.x  s.t.  Ax <= b  (paper Sec. 4.3).

    data.x = A (n, m), data.y = b (n,); c (a float32 tensor, on the device
    the stage runs on) and tau are parameters here.  Strongly convex on
    the interior when A has full column rank.
    """
    c: torch.Tensor
    tau: float = 10.0
    strongly_convex: bool = True
    name: str = "lp_ipm"

    def __post_init__(self):
        object.__setattr__(self, "c", torch.as_tensor(self.c,
                                                      dtype=torch.float32))

    @property
    def hess_reg(self) -> float:
        return 0.0

    def _tau_c(self, w: torch.Tensor) -> torch.Tensor:
        return self.tau * self.c.to(w.device)

    def value(self, w: torch.Tensor, data: Dataset) -> torch.Tensor:
        slack = data.y - _rows(data.x, w)
        barrier = torch.where(slack > 0, torch.log(slack.clamp_min(1e-30)),
                              -torch.inf)
        return w @ self._tau_c(w) - barrier.sum(-1)

    def gradient_via(self, w: torch.Tensor, data: Dataset,
                     mv: Optional[MatVec] = None) -> torch.Tensor:
        mv = mv or _plain_mv(data)
        alpha = mv("X", w)
        beta = 1.0 / (data.y - alpha)
        return self._tau_c(w) + mv("XT", beta)

    def gradient(self, w: torch.Tensor, data: Dataset) -> torch.Tensor:
        return self.gradient_via(w, data)

    def hess_sqrt(self, w: torch.Tensor, data: Dataset) -> torch.Tensor:
        slack = data.y - data.x @ w
        return data.x / torch.abs(slack)[:, None]


@dataclasses.dataclass(frozen=True)
class LassoDualIPM:
    """Interior-point stage of the Lasso dual (paper Sec. 4.3):
    min_z tau/2 ||y - z||^2 - sum_j log(lam - x_j.z) - sum_j log(lam + x_j.z).

    data.x: (n, d) measurement matrix (columns x_j are the dual constraints);
    data.y: (n,) measurements; optimizes over z in R^n.  The Hessian square
    root is (d, n): the sketch runs over d rows, and ``gradient_via`` calls
    "XT" before "X".
    """
    lam: float = 1.0
    tau: float = 10.0
    strongly_convex: bool = True
    name: str = "lasso_dual_ipm"

    @property
    def hess_reg(self) -> float:
        return self.tau

    def value(self, z: torch.Tensor, data: Dataset) -> torch.Tensor:
        alpha = z @ data.x                                   # (d,) or (c, d)
        lo, hi = self.lam - alpha, self.lam + alpha
        ok = (lo > 0) & (hi > 0)
        bar = torch.where(ok, torch.log(lo.clamp_min(1e-30))
                          + torch.log(hi.clamp_min(1e-30)), -torch.inf)
        r = data.y - z
        return 0.5 * self.tau * (r * r).sum(-1) - bar.sum(-1)

    def gradient_via(self, z: torch.Tensor, data: Dataset,
                     mv: Optional[MatVec] = None) -> torch.Tensor:
        mv = mv or _plain_mv(data)
        alpha = mv("XT", z)
        beta = 1.0 / (self.lam - alpha)
        gamma = 1.0 / (self.lam + alpha)
        return self.tau * (z - data.y) + mv("X", beta - gamma)

    def gradient(self, z: torch.Tensor, data: Dataset) -> torch.Tensor:
        return self.gradient_via(z, data)

    def hess_sqrt(self, z: torch.Tensor, data: Dataset) -> torch.Tensor:
        """grad^2 f = tau I + X Lam X^T; A = sqrt(Lam) X^T, (d, n)."""
        alpha = data.x.T @ z
        lam_diag = 1.0 / (self.lam - alpha) ** 2 \
            + 1.0 / (self.lam + alpha) ** 2
        return (torch.sqrt(lam_diag)[:, None] * data.x.T).contiguous()
