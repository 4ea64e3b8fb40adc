"""Carry the JAX package's inputs across to the port.

The JAX package's arrays cross over as numpy (``np.asarray`` of a jax
array), so nothing here imports jax or ``repro``:

  dataset(x, y, x_test, y_test, device)  -> core.objectives.Dataset
  vector(w0, device)                     -> float32 tensor
  key(raw)                               -> a prng key from uint32[2]
  params(cfg, tree, device)              -> a model's modules

With the same inputs and the same key both packages compute on identical
data and draw identical sketches, masks and fleet timelines.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.objectives import Dataset


def vector(a, device=None) -> torch.Tensor:
    """A float32 numpy array (or anything np.asarray takes) as a tensor on
    ``device`` (the CUDA device when none is given)."""
    device = resolve_device(device)
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)


def dataset(x, y, x_test=None, y_test=None, device=None) -> Dataset:
    device = resolve_device(device)

    def opt(a) -> Optional[torch.Tensor]:
        return None if a is None else vector(a, device)
    return Dataset(x=vector(x, device), y=vector(y, device),
                   x_test=opt(x_test), y_test=opt(y_test))


def key(raw) -> torch.Tensor:
    """A raw threefry key, the two uint32 words of
    ``jax.random.key_data(k)``, as a port key."""
    words = np.asarray(raw, dtype=np.uint32).reshape(2)
    return torch.tensor(words.astype(np.int64))


def tensor(a, device=None) -> torch.Tensor:
    """A numpy array of any dtype as a tensor of the same dtype, bit for bit
    (a jax bfloat16 array arrives as an ``ml_dtypes`` bfloat16 array, which
    ``torch.from_numpy`` refuses: it crosses as its 16-bit patterns)."""
    device = resolve_device(device)
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(a.view(np.int16)))
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def params(cfg, tree, device=None):
    """The JAX package's parameter tree of a model (nested dicts of arrays,
    as numpy) as the port's modules for ``cfg``'s family on ``device``."""
    from repro_torch.models import registry

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return tensor(node, device)
    return registry.build(cfg, walk(tree))
