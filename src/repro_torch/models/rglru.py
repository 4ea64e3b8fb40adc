"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427), the
counterpart of ``repro/models/rglru.py``.

Gated linear recurrence:
    r_t = sigmoid(W_r u_t + b_r)           (recurrence gate)
    i_t = sigmoid(W_i u_t + b_i)           (input gate)
    log a_t = -c * softplus(Lambda) * r_t  (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)

The full sequence evaluates the recurrence with ``associative_scan``, the
odd-even recursion of ``jax.lax.associative_scan`` op for op, so the
float32 combines come in the reference's order (log depth: a few dozen
tensor ops, not one a token); decode is the O(1) step.  The block wraps
the recurrence with the Griffin structure: conv1d(4) front, GeLU (tanh)
gate branch, output projection.  Plain PyTorch: the reference has no
Pallas kernel here.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.distributed import shard_ops
from repro_torch.models import common
from repro_torch.models.common import ModelConfig, Spec

_C = 8.0


def rglru_specs(cfg: ModelConfig, stacked: int = 0) -> Dict[str, Spec]:
    d, r = cfg.d_model, cfg.rnn_width
    lead = (stacked,) if stacked else ()
    lax_ = ("layers",) if stacked else ()
    return {
        "w_x": Spec(lead + (d, r), lax_ + ("embed", "rnn"),
                    fan_in_dims=(len(lead),)),
        "w_gate": Spec(lead + (d, r), lax_ + ("embed", "rnn"),
                       fan_in_dims=(len(lead),)),
        "conv_w": Spec(lead + (4, r), lax_ + ("conv", "rnn")),
        "conv_b": Spec(lead + (r,), lax_ + ("rnn",), init="zeros"),
        "w_r": Spec(lead + (r, r), lax_ + ("rnn", "rnn"),
                    fan_in_dims=(len(lead),)),
        "b_r": Spec(lead + (r,), lax_ + ("rnn",), init="zeros"),
        "w_i": Spec(lead + (r, r), lax_ + ("rnn", "rnn"),
                    fan_in_dims=(len(lead),)),
        "b_i": Spec(lead + (r,), lax_ + ("rnn",), init="zeros"),
        "lam": Spec(lead + (r,), lax_ + ("rnn",), init="ones"),
        "w_out": Spec(lead + (r, d), lax_ + ("rnn", "embed"),
                      fan_in_dims=(len(lead),)),
    }


def _gates(p, u: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    r_gate = torch.sigmoid(shard_ops.split_matmul(u, p.w_r) + p.b_r).float()
    i_gate = torch.sigmoid(shard_ops.split_matmul(u, p.w_i) + p.b_i)
    log_a = -_C * common.softplus(p.lam.float()) * r_gate
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-9))
    return a, beta.to(u.dtype) * (i_gate * u)


def _combine(left, right):
    """(a2, b2) o (a1, b1) = (a1 a2, a2 b1 + b2)."""
    return left[0] * right[0], right[0] * left[1] + right[1]


def associative_scan(elems, axis: int = 1):
    """``jax.lax.associative_scan(_combine, elems, axis)``: pairs combined,
    the halves scanned recursively, the even elements filled in, the two
    interleaved."""
    n = elems[0].shape[axis]
    if n < 2:
        return elems

    def sl(x, start, stop=None, step=1):
        return x[(slice(None),) * axis + (slice(start, stop, step),)]
    reduced = _combine([sl(e, 0, -1, 2) for e in elems],
                       [sl(e, 1, None, 2) for e in elems])
    odd = associative_scan(reduced, axis)
    if n % 2 == 0:
        even = _combine([sl(e, 0, -1) for e in odd],
                        [sl(e, 2, None, 2) for e in elems])
    else:
        even = _combine(odd, [sl(e, 2, None, 2) for e in elems])
    even = [torch.cat([sl(e, 0, 1), r], dim=axis)
            for e, r in zip(elems, even)]
    out = []
    for e, o in zip(even, odd):
        shape = list(e.shape)
        shape[axis] = n
        x = e.new_empty(shape)
        x[(slice(None),) * axis + (slice(0, None, 2),)] = e
        x[(slice(None),) * axis + (slice(1, None, 2),)] = o
        out.append(x)
    return out


def rglru_sequence(cfg: ModelConfig, p, x_in: torch.Tensor):
    """The block over a sequence: (y (B, S, d), the float32 states h
    (B, S, R), the conv's raw input x W_x (B, S, R))."""
    gate_branch = common.gelu(x_in @ p.w_gate)
    u_raw = x_in @ p.w_x
    u = common.causal_conv(u_raw, p.conv_w, p.conv_b)
    a, b = _gates(p, u)                       # (B,S,R) each
    _, h = associative_scan((a, b.float()), axis=1)
    return (h.to(x_in.dtype) * gate_branch) @ p.w_out, h, u_raw


def rglru_forward(cfg: ModelConfig, p, x_in: torch.Tensor) -> torch.Tensor:
    """Full-sequence Griffin recurrent block.  (B, S, d) -> (B, S, d)."""
    return rglru_sequence(cfg, p, x_in)[0]


def rglru_init_state(cfg: ModelConfig, batch: int, dtype,
                     device=None) -> Dict[str, torch.Tensor]:
    r = cfg.rnn_width
    return {"h": torch.zeros((batch, r), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, 3, r), dtype=dtype, device=device)}


def rglru_decode_step(cfg: ModelConfig, p, state: Dict[str, torch.Tensor],
                      x_tok: torch.Tensor) -> torch.Tensor:
    """One-token update: x_tok (B, d) -> y (B, d); ``state`` is updated in
    place."""
    gate_branch = common.gelu(x_tok @ p.w_gate)
    u_raw = x_tok @ p.w_x                                 # (B, R)
    hist = torch.cat([state["conv"], u_raw[:, None, :]], dim=1)
    u = (hist * p.conv_w).sum(dim=1) + p.conv_b
    a, b = _gates(p, u)
    h = a * state["h"] + b.float()
    state["h"].copy_(h)
    state["conv"].copy_(hist[:, 1:])
    return (h.to(x_tok.dtype) * gate_branch) @ p.w_out
