"""Plain PyTorch versions of the kernels (the correctness ground truth).

Mirrors ``repro/kernels/ref.py``.  The kernel wrappers use these for CPU
tensors; the tests and ``chip_smoke.py`` hold the CUDA kernels against
them.  Nothing on the card's main path calls them.
"""
from __future__ import annotations

import torch


def count_sketch_apply(h: torch.Tensor, sigma: torch.Tensor, a: torch.Tensor,
                       block_size: int) -> torch.Tensor:
    """S^T A for all sketch blocks: (K, n) int32 buckets in [0, block_size),
    (K, n) signs, (n, d) -> (K, block_size, d), one index_add_ per block."""
    k = h.shape[0]
    out = a.new_zeros((k, block_size, a.shape[1]))
    for i in range(k):
        out[i].index_add_(0, h[i].long(), a * sigma[i, :, None].to(a.dtype))
    return out


def oversketch_gram(a_tilde: torch.Tensor,
                    survivors: torch.Tensor) -> torch.Tensor:
    """H_hat = (1/max(sum m, 1)) sum_k m_k A_tilde_k^T A_tilde_k:
    (K, b, d), (K,) bool -> (d, d)."""
    k, b, d = a_tilde.shape
    m = survivors.to(a_tilde.dtype)
    x = a_tilde.reshape(k * b, d)
    gram = (x * m.repeat_interleave(b)[:, None]).T @ x
    return gram / m.sum().clamp_min(1.0)


def sketch_gram_count(h: torch.Tensor, sigma: torch.Tensor, a: torch.Tensor,
                      block_size: int, survivors: torch.Tensor) -> torch.Tensor:
    """Unfused apply + Gram: the fused count-sketch kernel's plain version."""
    return oversketch_gram(count_sketch_apply(h, sigma, a, block_size),
                           survivors)
