"""Plain PyTorch versions of the kernels (the correctness ground truth).

Mirrors ``repro/kernels/ref.py``.  The kernel wrappers use these for CPU
tensors; the tests and ``chip_smoke.py`` hold the CUDA kernels against
them.  Nothing on the card's main path calls them.
"""
from __future__ import annotations

import torch


# Elements of A's signed rows made at once by the plain apply: a run of
# rows at a time, so that its scratch stays at 1 GiB where A itself fills
# most of the card (the softmax Hessian factor at full width).
APPLY_CHUNK_ELEMENTS = 1 << 28


def count_sketch_apply(h: torch.Tensor, sigma: torch.Tensor, a: torch.Tensor,
                       block_size: int) -> torch.Tensor:
    """S^T A for all sketch blocks: (K, n) int32 buckets in [0, block_size),
    (K, n) signs, (n, d) -> (K, block_size, d), index_add_ per block over
    runs of rows in order (on the CPU the same sums as one index_add_)."""
    k, n = h.shape
    out = a.new_zeros((k, block_size, a.shape[1]))
    step = max(1, APPLY_CHUNK_ELEMENTS // max(a.shape[1], 1))
    for i in range(k):
        for r0 in range(0, n, step):
            rows = slice(r0, r0 + step)
            out[i].index_add_(0, h[i, rows].long(),
                              a[rows] * sigma[i, rows, None].to(a.dtype))
    return out


def sjlt_apply(h: torch.Tensor, sigma: torch.Tensor, a: torch.Tensor,
               block_size: int) -> torch.Tensor:
    """SJLT (OSNAP) apply: s signed segment-sum layers per block, summed,
    / sqrt(s): (K, s, n) int32, (K, s, n) signs, (n, d) -> (K, b, d)."""
    k, s, n = h.shape
    out = count_sketch_apply(h.reshape(k * s, n), sigma.reshape(k * s, n), a,
                             block_size)
    out = out.reshape(k, s, block_size, a.shape[1]).sum(dim=1)
    return out / torch.sqrt(torch.tensor(float(s), dtype=out.dtype))


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


def fwht(x: torch.Tensor) -> torch.Tensor:
    """Orthonormal Walsh-Hadamard transform along axis 1 of (K, n, d): the
    radix-2 butterfly in natural (Sylvester) order; n a power of two."""
    k, n, d = x.shape
    if n & (n - 1):
        raise ValueError(f"fwht length {n} must be a power of two")
    y, h = x, 1
    while h < n:
        y = y.reshape(k, n // (2 * h), 2, h, d)
        y = torch.stack([y[:, :, 0] + y[:, :, 1], y[:, :, 0] - y[:, :, 1]],
                        dim=2)
        h *= 2
    return y.reshape(k, n, d) / torch.sqrt(torch.tensor(float(n),
                                                        dtype=y.dtype))


def srht_apply(rows: torch.Tensor, sigma: torch.Tensor,
               a: torch.Tensor) -> torch.Tensor:
    """Blocked SRHT apply, unfused: sign, zero-pad to n_pad = next power of
    two, orthonormal FWHT, gather the b sampled rows, scale by
    sqrt(n_pad / b).  (K, b) int32 rows in [0, n_pad), (K, n) signs,
    (n, d) -> (K, b, d), one block at a time."""
    n, d = a.shape
    n_pad = 1 << max(0, (n - 1).bit_length())
    k, b = rows.shape
    scale = torch.sqrt(torch.tensor(n_pad / b, dtype=torch.float32))
    out = a.new_empty((k, b, d))
    for i in range(k):
        x = a.new_zeros((1, n_pad, d))
        torch.mul(a, sigma[i, :, None], out=x[0, :n])
        out[i] = fwht(x)[0][rows[i].long()] * scale
    return out


def sketch_gram_sjlt(h: torch.Tensor, sigma: torch.Tensor, a: torch.Tensor,
                     block_size: int, survivors: torch.Tensor) -> torch.Tensor:
    """Unfused apply + Gram: the fused SJLT kernel's plain version."""
    return oversketch_gram(sjlt_apply(h, sigma, a, block_size), survivors)


def sketch_gram_srht(rows: torch.Tensor, sigma: torch.Tensor,
                     a: torch.Tensor, survivors: torch.Tensor) -> torch.Tensor:
    """Unfused apply + Gram: the fused SRHT kernel's plain version."""
    return oversketch_gram(srht_apply(rows, sigma, a), survivors)


def coded_block_matvec(enc: torch.Tensor, x: torch.Tensor,
                       erased: torch.Tensor) -> torch.Tensor:
    """Per-worker coded block products with the erasure mask: (W, b, s),
    (s,), (W,) bool -> (W, b), 0 where erased."""
    return torch.einsum("wbs,s->wb", enc, x).masked_fill(erased[:, None], 0.0)


def normal(key: torch.Tensor, shape, device) -> torch.Tensor:
    """The normal kernel's plain version: ``prng.normal_plain`` on any
    device (the kernels bench times it on the card)."""
    from repro_torch import prng
    return prng.normal_plain(key, shape, device)


def normal_window(key: torch.Tensor, shape, box, device,
                  dtype=torch.float32) -> torch.Tensor:
    """The normal kernel's window mode's plain version:
    ``prng.normal_window`` on any device."""
    from repro_torch import prng
    return prng.normal_window(key, shape, box, dtype, device)


def randint(key: torch.Tensor, shape, minval: int, maxval: int,
            device) -> torch.Tensor:
    """The draw kernel's plain randint: ``prng.randint`` on any device."""
    from repro_torch import prng
    return prng.randint(key, shape, minval, maxval, device=device)
