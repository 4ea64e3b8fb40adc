"""OverSketch: straggler-resilient Count-Sketch randomized products; port of
``repro/core/sketch.py``.

The paper's Eq. (4) sketch is ``S = (1/sqrt(N)) [S_1, ..., S_{N+e}]`` with
each ``S_i in R^{n x b}`` an independent Count-Sketch.  The sketched Gram
``H_hat = (1/N) sum_i (S_i^T A)^T (S_i^T A)`` tolerates up to ``e``
straggling blocks: any surviving subset gives an unbiased estimate after
rescaling by the survivor count.  S is never materialized: a block is a
bucket vector ``h`` and a sign vector ``sigma``, and ``S_i^T A`` is a
signed segment-sum (``index_add_``) of A's rows into b buckets.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

from repro_torch import prng, resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref


@dataclasses.dataclass(frozen=True)
class OverSketchConfig:
    """sketch_dim m = N*b (excluding over-provision), block_size b, and
    straggler_tolerance zeta: e = ceil(zeta * N) extra blocks."""

    sketch_dim: int
    block_size: int
    straggler_tolerance: float = 0.25

    def __post_init__(self):
        if self.sketch_dim % self.block_size != 0:
            raise ValueError(
                f"sketch_dim {self.sketch_dim} must be divisible by "
                f"block_size {self.block_size}")

    @property
    def num_blocks(self) -> int:
        return self.sketch_dim // self.block_size

    @property
    def num_redundant(self) -> int:
        return int(math.ceil(self.straggler_tolerance * self.num_blocks))

    @property
    def total_blocks(self) -> int:
        return self.num_blocks + self.num_redundant


@dataclasses.dataclass
class CountSketch:
    """(N+e) independent Count-Sketch blocks over n rows: h int32 (K, n)
    buckets in [0, b), sigma float32 (K, n) Rademacher signs."""

    h: torch.Tensor
    sigma: torch.Tensor
    block_size: int

    @property
    def total_blocks(self) -> int:
        return self.h.shape[0]


def sample_countsketch(key: torch.Tensor, num_rows: int,
                       cfg: OverSketchConfig, device=None) -> CountSketch:
    """Draw an independent realization of the Eq. (4) sketch on ``device``
    (the CUDA device when none is given)."""
    device = resolve_device(device)
    kh, ks = prng.split(key)
    shape = (cfg.total_blocks, num_rows)
    h = kops.randint(kh, shape, 0, cfg.block_size, device=device)
    sigma = kops.rademacher(ks, shape, device=device)
    return CountSketch(h=h, sigma=sigma, block_size=cfg.block_size)


def apply_block(h: torch.Tensor, sigma: torch.Tensor, block_size: int,
                a: torch.Tensor) -> torch.Tensor:
    """S_i^T A for one block: (n,), (n,), (n, d) -> (b, d)."""
    return kref.count_sketch_apply(h[None], sigma[None], a, block_size)[0]


def apply_sketch(cs: CountSketch, a: torch.Tensor) -> torch.Tensor:
    """All blocks: A (n, d) -> A_tilde (total_blocks, b, d), unscaled (the
    1/sqrt(N) of Eq. (4) is the survivor-count division of the Gram)."""
    return kref.count_sketch_apply(cs.h, cs.sigma, a, cs.block_size)


def apply_sketch_chunked(cs: CountSketch,
                         a_fn: Callable[[int], torch.Tensor],
                         num_chunks: int, chunk_rows: int,
                         d: int) -> torch.Tensor:
    """Streaming S^T A for a tall A that should not be materialized:
    ``a_fn(c)`` returns chunk c of A (``chunk_rows`` rows, global rows
    ``c * chunk_rows`` on).  Plain, as ``apply_sketch`` is; the chunk's
    columns of ``h`` and ``sigma`` are copied contiguous, and a start past
    the end is clamped back as ``lax.dynamic_slice`` clamps it."""
    n = cs.h.shape[1]
    acc = torch.zeros((cs.total_blocks, cs.block_size, d),
                      dtype=torch.float32, device=cs.h.device)
    for c in range(num_chunks):
        rows = a_fn(c)
        start = min(max(c * chunk_rows, 0), n - chunk_rows)
        h_c = cs.h[:, start:start + chunk_rows].contiguous()
        s_c = cs.sigma[:, start:start + chunk_rows].contiguous()
        acc = acc + kref.count_sketch_apply(h_c, s_c, rows, cs.block_size)
    return acc


def sketched_gram(a_tilde: torch.Tensor,
                  survivors: Optional[torch.Tensor] = None, *,
                  use_kernels: bool = False) -> torch.Tensor:
    """H_hat = (1/N_avail) sum_{i in survivors} A_tilde_i^T A_tilde_i;
    ``use_kernels`` routes it through the masked-Gram kernel."""
    if survivors is None:
        survivors = torch.ones(a_tilde.shape[0], dtype=torch.bool,
                               device=a_tilde.device)
    if use_kernels:
        return kops.oversketch_gram(a_tilde, survivors)
    return kref.oversketch_gram(a_tilde, survivors)


def oversketched_gram(key: torch.Tensor, a: torch.Tensor,
                      cfg: OverSketchConfig,
                      survivors: Optional[torch.Tensor] = None, *,
                      use_kernels: bool = False) -> torch.Tensor:
    """One-shot H_hat ~= A^T A with straggler resiliency; ``use_kernels``
    takes the fused sketch -> Gram kernel (A_tilde a chunk at a time)."""
    cs = sample_countsketch(key, a.shape[0], cfg, device=a.device)
    if survivors is None:
        survivors = torch.ones(cs.total_blocks, dtype=torch.bool,
                               device=a.device)
    if use_kernels:
        return kops.sketch_gram_count(cs.h, cs.sigma, a, cfg.block_size,
                                      survivors)
    return sketched_gram(apply_sketch(cs, a), survivors)
