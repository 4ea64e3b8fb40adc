"""Mixture-of-Experts layer (Qwen3-MoE style: top-k softmax routing over the
experts, SwiGLU experts, renormalized gates), the counterpart of
``repro/models/moe.py``.

The reference's semantics: tokens are grouped by sequence chunks of
``moe_group_size`` per batch row (the last chunk right-padded with zero
tokens, which are routed too); the router's logits are a product in the
compute dtype taken to float32; each token keeps the top k of their
softmax (on a tie the lower expert first, as ``jax.lax.top_k``), with
the gates renormalized; an assignment's place in its expert is the count
of earlier (token, slot) assignments to that expert in its group, and
assignments at or past the capacity are dropped; the gates are rounded to
the compute dtype before they weight the experts' outputs.  The auxiliary
loss is the Switch load-balance term averaged over the groups.

The reference dispatches with dense one-hot einsums (a (B, g, k, E, C)
tensor a group).  Here the dispatch is by index: every group of every
batch row at once, each kept assignment's token gathered into its
expert's slot of an (E, rows x C, d) buffer (empty slots zero, as the
einsum leaves them), one batched product per expert weight, and each
token's output gathered back from its slots.  It keeps and drops the same
assignments; the outputs differ from the einsums' only in summation
order.  Plain PyTorch: the reference has no Pallas kernel here.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import shard_ops
from repro_torch.models import common
from repro_torch.models.common import ModelConfig, Spec


def moe_specs(cfg: ModelConfig, stacked: int = 0) -> Dict[str, Spec]:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    lead = (stacked,) if stacked else ()
    lax_ = ("layers",) if stacked else ()
    return {
        "router": Spec(lead + (d, e), lax_ + ("embed", "experts"),
                       fan_in_dims=(len(lead),)),
        "w_gate": Spec(lead + (e, d, f),
                       lax_ + ("experts", "embed", "expert_ffn"),
                       fan_in_dims=(len(lead) + 1,)),
        "w_up": Spec(lead + (e, d, f),
                     lax_ + ("experts", "embed", "expert_ffn"),
                     fan_in_dims=(len(lead) + 1,)),
        "w_down": Spec(lead + (e, f, d),
                       lax_ + ("experts", "expert_ffn", "embed"),
                       fan_in_dims=(len(lead) + 1,)),
    }


def _capacity(group: int, cfg: ModelConfig) -> int:
    cap = int(group * cfg.experts_per_token * cfg.moe_capacity_factor /
              cfg.num_experts)
    return max(cap, cfg.experts_per_token)


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest along the last axis and their indices, ties in index
    order (``jax.lax.top_k``'s; ``torch.topk`` promises no order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def slot_positions(expert: torch.Tensor, num_experts: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """expert (R, n) ids of each row's assignments in order -> (position of
    each among the row's earlier assignments to the same expert (R, n),
    assignments per expert (R, E)): the reference's cumulative one-hot
    count, by a stable sort."""
    r, n = expert.shape
    counts = torch.zeros((r, num_experts), dtype=torch.int64,
                         device=expert.device)
    counts.scatter_add_(1, expert, torch.ones_like(expert))
    order = torch.sort(expert, dim=1, stable=True).indices
    first = (counts.cumsum(1) - counts).gather(1, expert.gather(1, order))
    rank = torch.arange(n, device=expert.device) - first
    return torch.empty_like(expert).scatter_(1, order, rank), counts


class Routing(NamedTuple):
    """One layer's routing of rows of a group each: the float32 softmax
    probs (R, g, E), the renormalized gates and experts (R, g, k), each
    assignment's position in its expert (R, g, k), whether it is kept
    (position < capacity), and the assignments per expert (R, E)."""
    probs: torch.Tensor
    gate: torch.Tensor
    expert: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    counts: torch.Tensor


def route(cfg: ModelConfig, router: torch.Tensor, xg: torch.Tensor,
          cap: int) -> Routing:
    """Top-k routing of xg (R, g, d) with the (d, E) router, capacity
    ``cap`` per expert and row."""
    rows, g, _ = xg.shape
    k = cfg.experts_per_token
    probs = torch.softmax((xg @ router).float(), dim=-1)      # (R, g, E)
    gate, expert = top_k(probs, k)                            # (R, g, k)
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    pos, counts = slot_positions(expert.reshape(rows, g * k),
                                 cfg.num_experts)
    pos = pos.reshape(rows, g, k)
    return Routing(probs, gate, expert, pos, pos < cap, counts)


def moe_ffn(cfg: ModelConfig, p, x: torch.Tensor,
            group_size: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (y (B, S, d), aux_loss scalar).  ``p`` holds one
    layer's router (d, E) and w_gate, w_up (E, d, f), w_down (E, f, d).
    On a mesh (x a DTensor) the routing, dispatch and combine run on each
    rank's own batch rows (``distributed.shard_ops.moe_ffn``)."""
    b, s, d = x.shape
    g = min(group_size or cfg.moe_group_size, s)
    n_groups = -(-s // g)
    cap = _capacity(g, cfg)
    k, e = cfg.experts_per_token, cfg.num_experts

    def experts(xe):
        """The expert products, one batched product a weight."""
        hidden = common.silu(torch.bmm(xe, p.w_gate)) * torch.bmm(xe, p.w_up)
        return torch.bmm(hidden, p.w_down)

    def body(x, router, experts):
        """Routing, dispatch and combine of x (b, S, d) -> (y, probs,
        counts)."""
        b_rows = x.shape[0]
        pad = n_groups * g - s
        if pad:
            x = F.pad(x, (0, 0, 0, pad))
        rows = b_rows * n_groups
        xg = x.reshape(rows, g, d)
        r = route(cfg, router, xg, cap)

        # --- dispatch: slot (e, r, c) of an (E, R, C) buffer ------------
        row = torch.arange(rows, device=x.device)[:, None, None]
        slot = (r.expert * rows + row) * cap + r.pos.clamp(max=cap - 1)
        n_slots = e * rows * cap
        token = (row * g + torch.arange(g, device=x.device)[None, :, None]
                 ).expand(rows, g, k)
        src = torch.full((n_slots + 1,), rows * g, dtype=torch.int64,
                         device=x.device)       # rows * g: the zero token
        src[torch.where(r.keep, slot, n_slots).reshape(-1)] = \
            token.reshape(-1)
        xz = torch.cat([xg.reshape(rows * g, d), xg.new_zeros((1, d))])
        xe = xz[src[:n_slots]].view(e, rows * cap, d)
        ye = experts(xe).reshape(n_slots, d)

        # --- combine: each token's kept slots weighted by its gates -----
        w = (r.gate * r.keep).to(x.dtype).float().reshape(rows * g, k)
        flat = slot.reshape(rows * g, k)
        y = ye[flat[:, 0]].float() * w[:, :1]
        for j in range(1, k):
            y = y + ye[flat[:, j]].float() * w[:, j:j + 1]
        y = y.to(x.dtype).view(b_rows, n_groups * g, d)[:, :s]
        return y, r.probs, r.counts

    if shard_ops.is_sharded(x):
        y, probs, counts = shard_ops.moe_ffn(body, experts, x, p.router)
    else:
        y, probs, counts = body(x, p.router, experts)

    # --- load-balance auxiliary loss (Switch style), per group ----------
    prob_mean = probs.view(b, n_groups, g, e).mean(dim=(0, 2))  # (G, E)
    density = counts.view(b, n_groups, e).sum(0).float() / (b * g)
    aux = (e * (prob_mean * density).mean(-1) * k).sum() / n_groups
    return y, aux
