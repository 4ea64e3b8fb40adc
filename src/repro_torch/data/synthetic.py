"""Synthetic datasets matching the paper's generative models (Sec. 5.1),
port of ``repro/data/synthetic.py``: logistic features uniform on
[-1, 1]^d with labels from a random ground-truth logistic model; softmax
features standard normal with labels from a random linear model (the
EMNIST stand-in).

Draws come from the port's draw entry points (``kernels.ops.uniform``,
``normal`` and ``categorical``: the draw and normal kernels on the card,
``prng`` on the CPU), so a key gives the reference's features and
ground-truth weights bit for bit, and the column spectrum is
``jnp.geomspace``'s bit for bit.  The labels come from a matrix product
(a sigmoid compared with a uniform draw; an argmax of logits plus Gumbel
draws), and torch sums and rounds that product in another order than XLA,
so a label whose probability sits on its draw, or whose two largest
scores nearly tie, can still flip.
"""
from __future__ import annotations

import ctypes
import ctypes.util

import numpy as np
import torch

from repro_torch import prng, resolve_device
from repro_torch.configs.paper import PROFILES, DatasetProfile
from repro_torch.core.objectives import Dataset
from repro_torch.kernels import ops as kops


def _powf():
    """glibc's float32 ``powf``, the power XLA's CPU backend calls."""
    fn = ctypes.CDLL(ctypes.util.find_library("m")).powf
    fn.argtypes = [ctypes.c_float, ctypes.c_float]
    fn.restype = ctypes.c_float
    return fn


# log10(e) in float32, the factor XLA multiplies a log by for log10.
_LOG10_E = float(np.float32(0.434294492))


def _geomspace(start: float, stop: float, num: int, device) -> torch.Tensor:
    """``jnp.geomspace`` bit for bit, as XLA's CPU backend fuses it:
    10 ** lin, with lo = log(start) * log10(e) and, for i < num - 1,
    lin[i] = lo * (1 - i c) + i * (log(stop) * k), where c = f32(1 / (num -
    1)) and XLA folds log10(e) * c into one float32 constant k; the last
    entry is log(stop) * log10(e).  ``log`` is XLA's float32 log
    (``prng.log_f32``) and the power glibc's ``powf``, both on the host."""
    f32 = torch.float32
    ln = prng.log_f32(torch.tensor([start, stop], dtype=f32))
    lo, hi = ln * _LOG10_E
    if num == 1:
        lin = lo[None]
    else:
        c = float(np.float32(1.0 / (num - 1)))
        k = float(np.float32(_LOG10_E) * np.float32(c))
        i = torch.arange(num - 1, dtype=f32)
        lin = torch.cat([lo * (1.0 - i * c) + i * (ln[1] * k), hi[None]])
    powf = _powf()
    return torch.tensor([powf(10.0, v) for v in lin.tolist()], dtype=f32,
                        device=device)


def make_logistic_dataset(key: torch.Tensor, n: int, d: int,
                          n_test: int = 0, cond: float = 1.0,
                          sorted_layout: bool = False,
                          device=None) -> Dataset:
    """``cond > 1`` scales feature columns by a geometric spectrum;
    ``sorted_layout`` stores rows sorted by margin (the non-iid storage
    layout).  Runs on CUDA unless ``device`` says otherwise."""
    device = resolve_device(device)
    kx, kw, kb, ky, kxt, kyt = prng.split(key, 6)
    w = kops.normal(kw, (d,), device=device)
    b = kops.normal(kb, (), device=device)
    scales = _geomspace(1.0, 1.0 / max(cond, 1.0), d, device)

    def sample(kx_, ky_, m):
        x = kops.uniform(kx_, (m, d), -1.0, 1.0, device=device)
        x *= scales
        p = torch.sigmoid(x @ w + b)
        u = kops.uniform(ky_, (m,), device=device)
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


def make_softmax_dataset(key: torch.Tensor, n: int, d: int, k: int,
                         n_test: int = 0, device=None) -> Dataset:
    """Standard normal features and one-hot labels (n, k) drawn from the
    categorical distributions softmax(x w^T) of a random (k, d) model.
    Runs on CUDA unless ``device`` says otherwise."""
    device = resolve_device(device)
    kx, kw, ky, kxt, kyt = prng.split(key, 5)
    w = kops.normal(kw, (k, d), device=device)

    def sample(kx_, ky_, m):
        x = kops.normal(kx_, (m, d), device=device)
        y = prng.one_hot(kops.categorical(ky_, x @ w.T), k)
        return x, y

    x, y = sample(kx, ky, n)
    if n_test:
        xt, yt = sample(kxt, kyt, n_test)
        return Dataset(x=x, y=y, x_test=xt, y_test=yt)
    return Dataset(x=x, y=y)


def profile_dataset(name: str, key: torch.Tensor, *, full_scale: bool = False,
                    device=None) -> Dataset:
    """Dataset for a paper profile at bench (default) or full scale: the
    softmax generator for a profile of more than two classes, else the
    logistic one."""
    prof: DatasetProfile = PROFILES[name]
    n = prof.n_train if full_scale else prof.bench_n
    d = prof.n_features if full_scale else prof.bench_d
    nt = prof.n_test if full_scale else prof.bench_test
    if prof.n_classes > 2:
        return make_softmax_dataset(key, n, d, prof.n_classes, nt,
                                    device=device)
    # Real-dataset stand-ins use the realistic non-iid storage layout and
    # mild ill-conditioning.
    return make_logistic_dataset(key, n, d, nt, cond=10.0,
                                 sorted_layout=True, device=device)
