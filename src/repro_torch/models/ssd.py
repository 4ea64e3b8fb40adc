"""Mamba-2 SSD (state-space duality, arXiv:2405.21060) layer, the
counterpart of ``repro/models/ssd.py``.

The full sequence runs the chunked SSD algorithm: within a chunk the
contribution is a masked quadratic form (the "attention-like" dual);
across chunks a short linear recurrence carries the (H, P, N) state.
A prefill keeps the scan's carry after the prompt as the decode's state.
Decode is the O(1) recurrent update.  The numerics are the reference's:
the within-chunk prefix sum of dt * A in XLA's float32 order
(``prng.cumsum_f32``), the decays and the dual's weights in float32, the
products in the compute dtype.  Plain PyTorch: the reference has no
Pallas kernel here.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch import prng
from repro_torch.distributed import shard_ops
from repro_torch.models import common
from repro_torch.models.common import ModelConfig, Spec


def ssd_specs(cfg: ModelConfig, stacked: int = 0) -> Dict[str, Spec]:
    d = cfg.d_model
    din = cfg.ssm_inner
    h = cfg.ssm_heads
    n = cfg.ssm_state
    conv_dim = din + 2 * n                      # x, B, C share the conv
    lead = (stacked,) if stacked else ()
    lax_ = ("layers",) if stacked else ()
    return {
        # fused input projection: [z (din), x (din), B (n), C (n), dt (h)]
        "w_in": Spec(lead + (d, 2 * din + 2 * n + h),
                     lax_ + ("embed", "rnn"), fan_in_dims=(len(lead),)),
        "conv_w": Spec(lead + (cfg.ssm_conv, conv_dim),
                       lax_ + ("conv", "rnn")),
        "conv_b": Spec(lead + (conv_dim,), lax_ + ("rnn",), init="zeros"),
        "a_log": Spec(lead + (h,), lax_ + ("heads",), init="zeros"),
        "dt_bias": Spec(lead + (h,), lax_ + ("heads",), init="zeros"),
        "d_skip": Spec(lead + (h,), lax_ + ("heads",), init="ones"),
        "norm": Spec(lead + (din,), lax_ + ("rnn",), init="zeros"),
        "w_out": Spec(lead + (din, d), lax_ + ("rnn", "embed"),
                      fan_in_dims=(len(lead),)),
    }


def _split_proj(cfg: ModelConfig, proj: torch.Tensor):
    din, n = cfg.ssm_inner, cfg.ssm_state
    z = proj[..., :din]
    x = proj[..., din:2 * din]
    b_mat = proj[..., 2 * din:2 * din + n]
    c_mat = proj[..., 2 * din + n:2 * din + 2 * n]
    dt = proj[..., 2 * din + 2 * n:]
    return z, x, b_mat, c_mat, dt


def _conv_inputs(cfg: ModelConfig, p, x_in: torch.Tensor):
    """The projection's z and dt, the conv's raw input (x, B, C), and the
    conv's output after silu."""
    z, xr, b_mat, c_mat, dt = _split_proj(cfg, x_in @ p.w_in)
    conv_in = torch.cat([xr, b_mat, c_mat], dim=-1)
    return z, dt, conv_in, common.silu(common.causal_conv(conv_in, p.conv_w,
                                                          p.conv_b))


def _dt_a(p, dt: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(softplus(dt + dt_bias), A = -exp(a_log)) in float32."""
    return common.softplus(dt.float() + p.dt_bias.float()), -torch.exp(
        p.a_log.float())


def _gated_out(p, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Gated RMSNorm then the output projection (mamba2's block)."""
    return common.rms_norm(y * common.silu(z), p.norm) @ p.w_out


def _chunked_scan(xh: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                  b_mat: torch.Tensor, c_mat: torch.Tensor,
                  d_skip: torch.Tensor, q: int, valid: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The SSD's chunked dual over chunks of ``q``: xh (B,S,H,P), dt
    (B,S,H) and a (H,) from ``_dt_a``, b_mat and c_mat (B,S,N) -> (y
    (B,S,H,P), the skip term included; the state (B,H,P,N) after the
    first ``valid`` positions, all S when None).  The positions from
    ``valid`` on (a right padding) take dt = 0, so they neither decay
    nor feed the state; no earlier position's y depends on them.
    Independent across batch rows and heads (``shard_ops.ssd_scan`` runs
    it on their local shards)."""
    bsz, s, h, hp = xh.shape
    n = b_mat.shape[-1]
    nc = s // q
    if valid is not None and valid < s:
        pad = torch.arange(s, device=dt.device)[None, :, None] >= valid
        dt = dt.masked_fill(pad, 0.0)
    da = dt * a

    xc = xh.reshape(bsz, nc, q, h, hp)
    bc = b_mat.reshape(bsz, nc, q, n)
    cc = c_mat.reshape(bsz, nc, q, n)
    dtc = dt.reshape(bsz, nc, q, h)
    cum = prng.cumsum_f32(da.reshape(bsz, nc, q, h).transpose(2, 3)
                          ).transpose(2, 3)                        # (B,Nc,Q,H)

    # intra-chunk (dual/quadratic) term
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]            # (B,Nc,Q,Q,H)
    idx = torch.arange(q, device=xh.device)
    causal = (idx[:, None] >= idx[None, :])[None, None, :, :, None]
    l_mat = torch.where(causal, torch.exp(seg), 0.0)
    cb = torch.einsum("bcin,bcjn->bcij", cc, bc)                   # (B,Nc,Q,Q)
    w_ij = cb[..., None] * l_mat * dtc[:, :, None, :, :]           # f32
    y_diag = torch.einsum("bcijh,bcjhp->bcihp", w_ij.to(xc.dtype), xc)

    # chunk states: S_c = sum_j exp(cum_last - cum_j) dt_j B_j x_j^T
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)              # (B,Nc,Q,H)
    sb = (decay_to_end * dtc)[..., None] * bc[:, :, :, None, :]    # (B,Nc,Q,H,N)
    states = torch.einsum("bcqhn,bcqhp->bchpn", sb.to(xc.dtype), xc)

    # inter-chunk recurrence
    chunk_decay = torch.exp(cum[:, :, -1, :]).to(xc.dtype)         # (B,Nc,H)
    hprev = torch.zeros((bsz, h, hp, n), dtype=xc.dtype, device=xc.device)
    before = []
    for c in range(nc):
        before.append(hprev)
        hprev = hprev * chunk_decay[:, c, :, None, None] + states[:, c]
    h_before = torch.stack(before, dim=1)                          # (B,Nc,H,P,N)

    # inter-chunk contribution: C_i exp(cum_i) h_{c-1}
    y_off = torch.einsum("bcqn,bchpn->bcqhp", cc.to(xc.dtype), h_before)
    y_off = y_off * torch.exp(cum)[..., None].to(xc.dtype)

    y = (y_diag + y_off).reshape(bsz, s, h, hp)
    return y + xh * d_skip[None, None, :, None].to(xh.dtype), hprev


def ssd_forward(cfg: ModelConfig, p, x_in: torch.Tensor,
                state: Optional[Dict[str, torch.Tensor]] = None
                ) -> torch.Tensor:
    """Full-sequence SSD.  x_in (B, S, d) -> (B, S, d).  ``p`` holds one
    layer's w_in, conv_w, conv_b, a_log, dt_bias, d_skip, norm, w_out.
    With ``state`` (a prefill's, from ``ssd_init_state``), the state
    after the prompt is written into it in place: the conv's last K - 1
    raw inputs and the scan's final carry.  The reference recomputes that
    carry token by token from the cache's state (``_ssd_final_state``);
    from a fresh cache's zeros both give the same state."""
    bsz, s_orig, _ = x_in.shape
    din, n, h, hp = cfg.ssm_inner, cfg.ssm_state, cfg.ssm_heads, \
        cfg.ssm_head_dim
    q = min(cfg.ssm_chunk, s_orig)
    s_pad = (-s_orig) % q
    if s_pad:   # causal => zero right-padding never affects real positions
        x_in = shard_ops.pad(x_in, (0, 0, 0, s_pad))
    s = s_orig + s_pad

    z, dt, conv_in, conv_out = _conv_inputs(cfg, p, x_in)
    xr, b_mat, c_mat = (conv_out[..., :din], conv_out[..., din:din + n],
                        conv_out[..., din + n:])
    xh = xr.reshape(bsz, s, h, hp)
    dt, a = _dt_a(p, dt)                                           # (B,S,H)
    if shard_ops.is_sharded(xh):
        y, last = shard_ops.ssd_scan(_chunked_scan, xh, dt, a, b_mat, c_mat,
                                     p.d_skip, q, s_orig)
    else:
        y, last = _chunked_scan(xh, dt, a, b_mat, c_mat, p.d_skip, q, s_orig)
    if state is not None:
        tail = conv_in[:, :s_orig][:, -(cfg.ssm_conv - 1):]
        state["conv"].copy_(shard_ops.like(tail, state["conv"]))
        state["ssm"].copy_(shard_ops.like(last, state["ssm"]))
    y = y.reshape(bsz, s, din)
    if s_pad:
        y = y[:, :s_orig]
        z = z[:, :s_orig]
    return _gated_out(p, y, z)


def ssd_init_state(cfg: ModelConfig, batch: int, dtype,
                   device=None) -> Dict[str, torch.Tensor]:
    din, n, h, hp = cfg.ssm_inner, cfg.ssm_state, cfg.ssm_heads, \
        cfg.ssm_head_dim
    return {
        "ssm": torch.zeros((batch, h, hp, n), dtype=dtype, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, din + 2 * n),
                            dtype=dtype, device=device),
    }


def ssd_decode_step(cfg: ModelConfig, p, state: Dict[str, torch.Tensor],
                    x_tok: torch.Tensor) -> torch.Tensor:
    """One-token recurrent update: x_tok (B, d) -> y (B, d); ``state`` is
    updated in place."""
    din, n, h, hp = cfg.ssm_inner, cfg.ssm_state, cfg.ssm_heads, \
        cfg.ssm_head_dim
    z, xr, b_mat, c_mat, dt = _split_proj(cfg, (x_tok @ p.w_in)[:, None, :])
    conv_in = torch.cat([xr, b_mat, c_mat], dim=-1)                # (B,1,C)
    hist = torch.cat([state["conv"], conv_in], dim=1)              # (B,K,C)
    conv_out = common.silu((hist * p.conv_w).sum(dim=1) + p.conv_b)
    state["conv"].copy_(hist[:, 1:])
    xr = conv_out[:, :din].reshape(-1, h, hp)
    b_t = conv_out[:, din:din + n]
    c_t = conv_out[:, din + n:]

    dt, a = _dt_a(p, dt[:, 0])                                     # (B,H)
    decay = torch.exp(dt * a)
    db = dt[..., None] * b_t[:, None, :]                           # (B,H,N)
    upd = xr[..., None] * db[:, :, None, :]                        # (B,H,P,N)
    ssm = state["ssm"]
    ssm = ssm * decay[..., None, None].to(ssm.dtype) + upd.to(ssm.dtype)
    state["ssm"].copy_(ssm)
    if shard_ops.is_sharded(ssm):
        y = shard_ops.ssd_readout(ssm, c_t.to(ssm.dtype))
    else:
        y = torch.einsum("bhpn,bn->bhp", ssm, c_t.to(ssm.dtype))
    y = y + xr * p.d_skip[None, :, None].to(xr.dtype)
    # a split head_dim gathered first: some torch releases (2.11) refuse
    # to flatten it into din
    y = shard_ops.whole_last_dim(y)
    return _gated_out(p, y.reshape(-1, din), z[:, 0])
