"""Grouped-query attention with RoPE, sliding windows, qk-norm, QKV bias,
logit softcap and KV caches (the counterpart of
``repro/models/attention.py``).

Full-sequence attention is the reference's online softmax over key/value
chunks of ``attn_chunk`` columns: scores rounded to the compute dtype and
then taken to float32, the running max and sum in float32, the
accumulator in the compute dtype.  The reference pads the keys to a whole
number of chunks and masks the pad; here the last chunk is cut short
instead, which drops only columns whose weight is exactly zero.  Plain
PyTorch: the reference has no Pallas kernel here.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.distributed import shard_ops
from repro_torch.models import common
from repro_torch.models.common import ModelConfig, Spec

NEG_INF = -1e30


# ------------------------------------------------------------------ specs ----
def attn_specs(cfg: ModelConfig, stacked: int = 0, *,
               cross: bool = False) -> Dict[str, Spec]:
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
        cfg.resolved_head_dim
    lead: Tuple[int, ...] = (stacked,) if stacked else ()
    lax_: Tuple[Optional[str], ...] = ("layers",) if stacked else ()
    sp = {
        "wq": Spec(lead + (d, h, hd), lax_ + ("embed", "heads", "head_dim"),
                   fan_in_dims=(len(lead),)),
        "wk": Spec(lead + (d, kv, hd), lax_ + ("embed", "kv_heads",
                                               "head_dim"),
                   fan_in_dims=(len(lead),)),
        "wv": Spec(lead + (d, kv, hd), lax_ + ("embed", "kv_heads",
                                               "head_dim"),
                   fan_in_dims=(len(lead),)),
        "wo": Spec(lead + (h, hd, d), lax_ + ("heads", "head_dim", "embed"),
                   fan_in_dims=(len(lead), len(lead) + 1)),
    }
    if cfg.qkv_bias and not cross:
        sp["bq"] = Spec(lead + (h, hd), lax_ + ("heads", "head_dim"),
                        init="zeros")
        sp["bk"] = Spec(lead + (kv, hd), lax_ + ("kv_heads", "head_dim"),
                        init="zeros")
        sp["bv"] = Spec(lead + (kv, hd), lax_ + ("kv_heads", "head_dim"),
                        init="zeros")
    if cfg.qk_norm and not cross:
        sp["q_norm"] = Spec(lead + (hd,), lax_ + ("head_dim",), init="zeros")
        sp["k_norm"] = Spec(lead + (hd,), lax_ + ("head_dim",), init="zeros")
    return sp


# ------------------------------------------------------------- projections ---
def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum('btd,dhk->bthk') as one matmul.  A weight split along
    head_dim (the policy's fallback where the heads do not divide) is
    flattened head_dim first: DTensor flattens dims only with the split on
    the leading one."""
    d, h, k = w.shape
    if shard_ops.split_on(w, 2):
        y = x @ w.transpose(1, 2).reshape(d, k * h)
        return y.unflatten(-1, (k, h)).transpose(-1, -2)
    return (x @ w.reshape(d, h * k)).unflatten(-1, (h, k))


def project_qkv(cfg: ModelConfig, p: common.Params, xq: torch.Tensor,
                xkv: Optional[torch.Tensor] = None):
    """xq (B,S,d) [, xkv (B,T,d) for cross-attention] -> q,k,v.  ``p``
    holds one layer's attention parameters under the reference's names: wq
    (d, H, hd), wk and wv (d, KV, hd), wo (H, hd, d); bq, bk, bv with QKV
    bias; q_norm and k_norm (hd,) with qk-norm."""
    xkv = xq if xkv is None else xkv
    q = _proj(xq, p.wq)
    k = _proj(xkv, p.wk)
    v = _proj(xkv, p.wv)
    if hasattr(p, "bq"):
        q = q + p.bq
        k = k + p.bk
        v = v + p.bv
    if hasattr(p, "q_norm"):
        q = common.rms_norm(q, p.q_norm)
        k = common.rms_norm(k, p.k_norm)
    return q, k, v


def out_proj(p: common.Params, attn: torch.Tensor) -> torch.Tensor:
    """einsum('bshk,hkd->bsd')."""
    h, k, d = p.wo.shape
    if shard_ops.split_on(p.wo, 1) or shard_ops.split_on(attn, 3):
        # as in _proj
        return attn.transpose(-1, -2).flatten(-2) @ \
            p.wo.transpose(0, 1).reshape(k * h, d)
    return attn.flatten(-2) @ p.wo.reshape(h * k, d)


# --------------------------------------------------- chunked online softmax --
def _chunk_scores(q, k, scale, softcap):
    """q (B,Sq,KV,G,hd), k (B,Ck,KV,hd) -> scores (B,KV,G,Sq,Ck) in f32:
    the product in q's dtype, then float32."""
    s = torch.einsum("bskgh,bckh->bkgsc", q, k).float() * scale
    return common.softcap(s, softcap)


def _window_ok(q_pos, k_pos, window) -> torch.Tensor:
    if window <= 0:
        return torch.ones((), dtype=torch.bool, device=q_pos.device)
    return q_pos[:, None] - k_pos[None, :] < max(window, 1)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, window, softcap: float = 0.0,
                      q_offset: int = 0, kv_len: Optional[int] = None,
                      chunk: int = 512, repeat_kv: bool = False
                      ) -> torch.Tensor:
    """Online-softmax attention over KV chunks (flash structure).

    q: (B, Sq, H, hd); k, v: (B, Skv, KV, hd); GQA via H = KV * G.
    window: an int, 0/None => unlimited.  q_offset: the absolute position
    of q[0].  kv_len: optional valid-length bound.  Returns (B, Sq, H, hd).
    """
    b, sq, h, hd = q.shape
    if shard_ops.is_sharded(q):
        return shard_ops.attention(chunked_attention, q, k, v,
                                   causal=causal, window=window,
                                   softcap=softcap, q_offset=q_offset,
                                   kv_len=kv_len, chunk=chunk)
    if repeat_kv and k.shape[2] != h:
        rep = h // k.shape[2]
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    skv, kv_heads = k.shape[1], k.shape[2]
    g = h // kv_heads
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(b, sq, kv_heads, g, hd)
    dev = q.device
    q_pos = q_offset + torch.arange(sq, device=dev)
    window = int(window or 0)

    m_run = torch.full((b, kv_heads, g, sq), NEG_INF, dtype=torch.float32,
                       device=dev)
    l_run = torch.zeros((b, kv_heads, g, sq), dtype=torch.float32,
                        device=dev)
    acc = torch.zeros((b, kv_heads, g, sq, hd), dtype=q.dtype, device=dev)
    for start in range(0, skv, chunk):
        k_blk = k[:, start:start + chunk]
        v_blk = v[:, start:start + chunk]
        c = k_blk.shape[1]
        scores = _chunk_scores(qg, k_blk, scale, softcap)   # (B,KV,G,Sq,C)
        k_pos = start + torch.arange(c, device=dev)
        mask = torch.ones((sq, c), dtype=torch.bool, device=dev)
        if causal:
            mask &= q_pos[:, None] >= k_pos[None, :]
        mask &= _window_ok(q_pos, k_pos, window)
        if kv_len is not None:
            mask &= k_pos[None, :] < kv_len
        scores = torch.where(mask, scores, NEG_INF)
        m_new = torch.maximum(m_run, scores.amax(dim=-1))
        alpha = torch.exp(m_run - m_new)
        prob = torch.exp(scores - m_new[..., None])
        l_run = l_run * alpha + prob.sum(dim=-1)
        pv = torch.einsum("bkgsc,bckh->bkgsh", prob.to(v_blk.dtype), v_blk)
        acc = acc * alpha[..., None].to(acc.dtype) + pv
        m_run = m_new
    out = acc / torch.clamp(l_run[..., None], min=1e-30).to(acc.dtype)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd)


# ------------------------------------------------------------------ decode ---
def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: int, *, window=None,
                     softcap: float = 0.0) -> torch.Tensor:
    """One-token attention against a preallocated cache.

    q: (B, 1, H, hd); k_cache/v_cache: (B, S_max, KV, hd); pos: the index
    of the *current* token (cache valid through pos inclusive).  Only the
    first pos + 1 slots are read: the reference's mask gives the rest a
    weight of exactly zero.  DTensors go through
    ``shard_ops.decode_attention`` (local shards).
    """
    if shard_ops.is_sharded(q):
        return shard_ops.decode_attention(
            lambda q_, k_, v_: decode_attention(q_, k_, v_, pos,
                                                window=window,
                                                softcap=softcap),
            q, k_cache, v_cache, pos + 1, pos=pos, window=int(window or 0),
            softcap=softcap)
    b, _, h, hd = q.shape
    kv_heads = k_cache.shape[2]
    g = h // kv_heads
    scale = 1.0 / math.sqrt(hd)
    k_cache = k_cache[:, :pos + 1]
    v_cache = v_cache[:, :pos + 1]
    qg = q.reshape(b, kv_heads, g, hd)
    scores = torch.einsum("bkgh,bskh->bkgs", qg, k_cache).float() * scale
    scores = common.softcap(scores, softcap)
    window = int(window or 0)
    if window > 0:
        k_pos = torch.arange(pos + 1, device=q.device)
        scores = torch.where(pos - k_pos < window, scores, NEG_INF)
    prob = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskh->bkgh", prob.to(v_cache.dtype), v_cache)
    return out.reshape(b, 1, h, hd)


def update_cache(k_cache: torch.Tensor, v_cache: torch.Tensor,
                 k_new: torch.Tensor, v_new: torch.Tensor, pos: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write S_new tokens at position ``pos``, in place."""
    s = k_new.shape[1]
    k_cache[:, pos:pos + s] = k_new.to(k_cache.dtype)
    v_cache[:, pos:pos + s] = v_new.to(v_cache.dtype)
    return k_cache, v_cache
