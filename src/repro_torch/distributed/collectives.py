"""Straggler-resilient collectives: the paper's k-of-n termination rule
(Alg. 2 step 4) as reductions over a ``torch.distributed`` process group
(the counterpart of ``repro/distributed/collectives.py``, where the ranks
are the shards of a mesh axis).

Every rank contributes ``live * value``; the reduction divides by the
count of live ranks instead of the world size, so losing contributions
re-weights the mean instead of corrupting it.  The trainer's resilient
data-parallel gradients reduce through them.  ``group`` is an explicit
process group (gloo on the CPU, NCCL on the card); None means the
default group, or a single rank when no group was initialized (every
collective is then the identity on its one contribution).
"""
from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.distributed as dist

Pytree = Any


def _world(group) -> int:
    if group is None and not dist.is_initialized():
        return 1
    return dist.get_world_size(group)


def _all_reduce(t: torch.Tensor, op, group) -> torch.Tensor:
    if _world(group) > 1:
        dist.all_reduce(t, op=op, group=group)
    return t


def _map(fn, tree: Pytree) -> Pytree:
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k]) for k in sorted(tree)}
    return fn(tree)


def resilient_psum(tree: Pytree, live: torch.Tensor, group=None) -> Pytree:
    """Mean over the live ranks of ``group``.

    tree: this rank's contribution (already a *mean* over its local data),
    a tensor or a nested dict of tensors.  live: a 0-d {0, 1} tensor,
    whether this rank's result arrived in time.
    """
    livef = torch.as_tensor(live).float()
    n_live = _all_reduce(livef.clone(), dist.ReduceOp.SUM, group)
    scale = 1.0 / torch.clamp(n_live, min=1.0)

    def red(x):
        contrib = x * livef.to(device=x.device, dtype=x.dtype)
        _all_reduce(contrib, dist.ReduceOp.SUM, group)
        return contrib * scale.to(device=x.device, dtype=x.dtype)

    return _map(red, tree)


def masked_allgather_mean(x: torch.Tensor, live: torch.Tensor, group=None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """All-gather with survivor accounting; returns (stacked (n, ...)
    contributions times their live flags, the live mask (n,))."""
    live = torch.as_tensor(live).to(x.device)
    xs_local = x * live.to(x.dtype)
    n = _world(group)
    if n == 1:
        return xs_local[None], live[None]
    xs = [torch.empty_like(xs_local) for _ in range(n)]
    masks = [torch.empty_like(live) for _ in range(n)]
    dist.all_gather(xs, xs_local.contiguous(), group=group)
    dist.all_gather(masks, live.contiguous(), group=group)
    return torch.stack(xs), torch.stack(masks)


def compressed_resilient_psum(tree: Pytree, live: torch.Tensor,
                              group=None) -> Pytree:
    """``resilient_psum`` with an int8 wire format: per leaf one max
    all-reduce agrees on a symmetric scale, the int8 payload is summed in
    int32 (<= 127 x ranks fits), then dequantized and divided by the live
    count.  The quantization noise is zero-mean and bounded by scale/127
    an element."""
    livef = torch.as_tensor(live).float()
    n_live = _all_reduce(livef.clone(), dist.ReduceOp.SUM, group)
    rescale = 1.0 / torch.clamp(n_live, min=1.0)

    def red(x):
        xf = x.float() * livef.to(x.device)
        scale = _all_reduce(xf.abs().max(), dist.ReduceOp.MAX, group)
        scale = torch.clamp(scale, min=1e-20)
        q = torch.clamp(torch.round(xf / scale * 127.0), -127, 127).to(
            torch.int8)
        total = _all_reduce(q.to(torch.int32), dist.ReduceOp.SUM, group)
        return (total.float() * (scale / 127.0) *
                rescale.to(x.device)).to(x.dtype)

    return _map(red, tree)
