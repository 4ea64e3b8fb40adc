"""The benchmark's problem generators: the paper's synthetic logistic and
softmax recipes (arXiv:1903.08857 Sec. 5.1, as ``repro_torch.data.synthetic``
writes them) in plain PyTorch, drawn on the device from the run's seed with
a ``torch.Generator`` in a few large calls.

* logistic: features uniform on [-1, 1]^d, column j scaled by the geometric
  spectrum 1 .. 1/cond; labels +-1 from a random ground-truth logistic model
  (w, b standard normal); rows optionally stored sorted by the true margin
  (the non-iid storage layout).
* softmax: standard normal features; labels drawn from the categorical
  distributions softmax(x W^T) of a random (K, d) model (Gumbel-max), one-hot.

The program under test receives only the tensors made here.  The same seed
gives the same bytes; the sizes never depend on the seed.
"""
from __future__ import annotations

import hashlib
from typing import Tuple

import torch

ROWS = 1 << 15      # rows a block when a pass over x works in float64


def derive(seed: int, *tags) -> int:
    """A 63-bit seed for one purpose of a run (data, a call, the warm-up)."""
    text = "/".join(str(t) for t in (int(seed),) + tags)
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8],
                          "little") >> 1


def _gen(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(derive(seed, "data"))
    return g


def logistic(cfg: dict, seed: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x (n, d) float32, y (n,) float32 in {-1, +1})."""
    n, d = int(cfg["n"]), int(cfg["d"])
    g = _gen(seed, device)
    w = torch.randn(d, generator=g, device=device)
    b = torch.randn((), generator=g, device=device)
    scales = torch.logspace(0.0, -torch.log10(torch.tensor(
        max(float(cfg["cond"]), 1.0))).item(), d, dtype=torch.float64,
        device=device).to(torch.float32)
    x = torch.rand((n, d), generator=g, device=device)
    x.mul_(2.0).sub_(1.0).mul_(scales)
    margin = x @ w
    u = torch.rand(n, generator=g, device=device)
    y = torch.where(u < torch.sigmoid(margin + b), 1.0, -1.0)
    if cfg.get("sorted_layout", False):
        order = torch.argsort(margin, stable=True)
        x, y = x[order], y[order]
    return x, y


def softmax(cfg: dict, seed: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x (n, d) float32, y (n, K) float32 one-hot)."""
    n, d, k = int(cfg["n"]), int(cfg["d"]), int(cfg["classes"])
    g = _gen(seed, device)
    w = torch.randn((k, d), generator=g, device=device)
    x = torch.randn((n, d), generator=g, device=device)
    u = torch.rand((n, k), generator=g, device=device)
    tiny = torch.finfo(torch.float32).tiny
    gumbel = -torch.log(-torch.log(u.clamp_min_(tiny)))
    labels = torch.argmax(x @ w.T + gumbel, dim=1)
    y = torch.nn.functional.one_hot(labels, k).to(torch.float32)
    return x, y


GENERATORS = {"logistic": logistic, "softmax": softmax}


def make(cfg: dict, seed: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The configuration's problem for ``seed`` on ``device``."""
    return GENERATORS[cfg["objective"]](cfg, seed, device)


def fingerprint(x: torch.Tensor, y: torch.Tensor) -> Tuple[float, ...]:
    """Float64 sums of the inputs and of their squares: read before the
    window and after it, they show that nothing wrote into the inputs."""
    sums = torch.zeros(4, dtype=torch.float64, device=x.device)
    for i in range(0, x.shape[0], ROWS):
        xb = x[i:i + ROWS].double()
        yb = y[i:i + ROWS].double()
        sums += torch.stack([xb.sum(), (xb * xb).sum(), yb.sum(),
                             (yb * yb).sum()])
    return tuple(sums.tolist())
