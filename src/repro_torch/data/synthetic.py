"""Synthetic logistic datasets matching the paper's generative model
(Sec. 5.1), port of ``repro/data/synthetic.py``: features uniform on
[-1, 1]^d, labels from a random ground-truth logistic model.

Draws come from ``repro_torch.prng``, so a key gives the reference's
features bit for bit; the ground-truth weights come from ``normal`` and
the column spectrum from ``logspace``, both within float32 rounding of
the reference, so a label whose probability sits on its uniform draw can
flip.  Large draws are made in chunks on ``device``.
"""
from __future__ import annotations

import math

import torch

from repro_torch import prng, resolve_device
from repro_torch.configs.paper import PROFILES, DatasetProfile
from repro_torch.core.objectives import Dataset


def _geomspace(start: float, stop: float, num: int, device) -> torch.Tensor:
    return torch.logspace(math.log10(start), math.log10(stop), num,
                          dtype=torch.float32, device=device)


def make_logistic_dataset(key: torch.Tensor, n: int, d: int,
                          n_test: int = 0, cond: float = 1.0,
                          sorted_layout: bool = False,
                          device=None) -> Dataset:
    """``cond > 1`` scales feature columns by a geometric spectrum;
    ``sorted_layout`` stores rows sorted by margin (the non-iid storage
    layout).  Runs on CUDA unless ``device`` says otherwise."""
    device = resolve_device(device)
    kx, kw, kb, ky, kxt, kyt = prng.split(key, 6)
    w = prng.normal(kw, (d,), device=device)
    b = prng.normal(kb, (), device=device)
    scales = _geomspace(1.0, 1.0 / max(cond, 1.0), d, device)

    def sample(kx_, ky_, m):
        x = prng.uniform(kx_, (m, d), -1.0, 1.0, device=device)
        x *= scales
        p = torch.sigmoid(x @ w + b)
        u = prng.uniform(ky_, (m,), device=device)
        y = torch.where(u < p, 1.0, -1.0)
        return x, y

    x, y = sample(kx, ky, n)
    if sorted_layout:
        order = torch.argsort(x @ w, stable=True)
        x, y = x[order], y[order]
    if n_test:
        xt, yt = sample(kxt, kyt, n_test)
        return Dataset(x=x, y=y, x_test=xt, y_test=yt)
    return Dataset(x=x, y=y)


def profile_dataset(name: str, key: torch.Tensor, *, full_scale: bool = False,
                    device=None) -> Dataset:
    """Dataset for a logistic paper profile at bench (default) or full
    scale; the softmax profiles wait for the softmax objective."""
    prof: DatasetProfile = PROFILES[name]
    if prof.n_classes > 2:
        raise NotImplementedError(
            f"profile {name!r} is a softmax workload; SoftmaxRegression is "
            "still to be ported (ROADMAP Queue 1 item 2)")
    n = prof.n_train if full_scale else prof.bench_n
    d = prof.n_features if full_scale else prof.bench_d
    nt = prof.n_test if full_scale else prof.bench_test
    return make_logistic_dataset(key, n, d, nt, cond=10.0,
                                 sorted_layout=True, device=device)
