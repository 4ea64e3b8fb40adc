"""Decoder-only LM, the dense family (the counterpart of the uniform dense
layout of ``repro/models/transformer.py``).

The reference scans one body over stacked (L, ...) parameters; here each
layer is its own ``nn.Module`` (``DecoderLayer``) with the reference's
parameter names, and the layers run in a plain loop, which is the
reference's ``forward`` with ``remat=False``.  Per-layer scalars (sliding
window, rope theta) come from ``layer_schedule`` as in the reference.
Caches are dicts of tensors updated in place, with ``pos`` a Python int.

Both cache layouts are here: the uniform one (every layer caches the full
context) and, where ``windowed_decode_cache`` is set on a local:global
pattern (gemma3), local layers in ring buffers of ``window_size`` slots.
The MoE, hybrid (RG-LRU), SSM and encoder-decoder families are not ported
yet; ``registry.ModelBundle`` refuses them.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import attention as attn
from repro_torch.models import common
from repro_torch.models.common import ModelConfig, Params, Spec

Pytree = Any


# ------------------------------------------------------------------ specs ----
def mlp_specs(cfg: ModelConfig, stacked: int = 0) -> Dict[str, Spec]:
    d, f = cfg.d_model, cfg.d_ff
    lead = (stacked,) if stacked else ()
    lax_ = ("layers",) if stacked else ()
    if cfg.mlp_type == "swiglu":
        return {
            "w_gate": Spec(lead + (d, f), lax_ + ("embed", "ffn"),
                           fan_in_dims=(len(lead),)),
            "w_up": Spec(lead + (d, f), lax_ + ("embed", "ffn"),
                         fan_in_dims=(len(lead),)),
            "w_down": Spec(lead + (f, d), lax_ + ("ffn", "embed"),
                           fan_in_dims=(len(lead),)),
        }
    return {   # gelu MLP with biases (whisper style)
        "w_up": Spec(lead + (d, f), lax_ + ("embed", "ffn"),
                     fan_in_dims=(len(lead),)),
        "b_up": Spec(lead + (f,), lax_ + ("ffn",), init="zeros"),
        "w_down": Spec(lead + (f, d), lax_ + ("ffn", "embed"),
                       fan_in_dims=(len(lead),)),
        "b_down": Spec(lead + (d,), lax_ + ("embed",), init="zeros"),
    }


def mlp_forward(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    if cfg.mlp_type == "swiglu":
        g = x @ p.w_gate
        return (g * torch.sigmoid(g) * (x @ p.w_up)) @ p.w_down
    return F.gelu(x @ p.w_up + p.b_up, approximate="tanh") @ p.w_down + \
        p.b_down


def _uniform_layer_specs(cfg: ModelConfig) -> Dict[str, Any]:
    n = cfg.num_layers
    return {
        "ln1": common.norm_spec(cfg, cfg.d_model, stacked=n),
        "ln2": common.norm_spec(cfg, cfg.d_model, stacked=n),
        "attn": attn.attn_specs(cfg, stacked=n),
        "ffn": mlp_specs(cfg, stacked=n),
    }


def decoder_specs(cfg: ModelConfig) -> Dict[str, Any]:
    """The dense family's spec tree (``registry.ModelBundle`` refuses the
    other families)."""
    sp: Dict[str, Any] = {
        "embed": Spec((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                      fan_in_dims=(1,)),
        "final_norm": common.norm_spec(cfg, cfg.d_model),
    }
    if not cfg.tie_embeddings:
        sp["lm_head"] = Spec((cfg.d_model, cfg.vocab_size),
                             ("embed", "vocab"), fan_in_dims=(0,))
    sp["layers"] = _uniform_layer_specs(cfg)
    return sp


# ---------------------------------------------------------------- modules ----
class DecoderLayer(nn.Module):
    """One layer: ln1, attn, ln2, ffn (the reference's ``layers/*`` leaves
    at one index of their leading axis)."""

    def __init__(self, tree: Dict[str, Dict[str, torch.Tensor]]):
        super().__init__()
        self.ln1 = Params(tree["ln1"])
        self.attn = Params(tree["attn"])
        self.ln2 = Params(tree["ln2"])
        self.ffn = Params(tree["ffn"])


class DecoderLM(nn.Module):
    """The dense decoder's parameters: embed, final_norm, lm_head (untied
    configs), and one ``DecoderLayer`` per layer, from a parameter tree in
    the reference's layout (each layer's parameters are views of the
    stacked (L, ...) leaves)."""

    def __init__(self, cfg: ModelConfig, tree: Pytree):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Parameter(tree["embed"], requires_grad=False)
        self.final_norm = Params(tree["final_norm"])
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(tree["lm_head"], requires_grad=False)
        layers = tree["layers"]
        self.layers = nn.ModuleList(
            DecoderLayer({g: {n: t[i] for n, t in leaves.items()}
                          for g, leaves in layers.items()})
            for i in range(cfg.num_layers))


# --------------------------------------------------------- layer schedules ---
def layer_schedule(cfg: ModelConfig) -> Tuple[np.ndarray, np.ndarray]:
    """Per-layer (window, rope_theta) for uniform attention stacks.
    window 0 => unlimited (global)."""
    n = cfg.num_layers
    windows = np.zeros(n, np.int32)
    thetas = np.full(n, cfg.rope_theta, np.float32)
    if cfg.local_global_pattern and cfg.window_size:
        pat = cfg.local_global_pattern + 1
        for i in range(n):
            if (i + 1) % pat != 0:            # local layer
                windows[i] = cfg.window_size
            else:                             # global layer
                thetas[i] = cfg.global_rope_theta or cfg.rope_theta
    elif cfg.window_size and not cfg.local_global_pattern:
        windows[:] = cfg.window_size
    return windows, thetas


# ------------------------------------------------------------- embeddings ----
def embed_tokens(cfg: ModelConfig, params: DecoderLM, tokens: torch.Tensor,
                 extra_embeds: Optional[torch.Tensor]) -> torch.Tensor:
    h = common.embed_lookup(params.embed, tokens).to(cfg.compute_dtype)
    if extra_embeds is not None:   # VLM / audio stub: prepend frontier embeds
        h = torch.cat([extra_embeds.to(h.dtype), h], dim=1)
    if cfg.pos_embed == "sinusoidal":
        pe = common.sinusoidal_positions(h.shape[1], cfg.d_model, h.dtype,
                                         h.device)
        h = h + pe[None]
    return h


def lm_logits(cfg: ModelConfig, params: DecoderLM,
              h: torch.Tensor) -> torch.Tensor:
    h = common.apply_norm(cfg, h, params.final_norm)
    if cfg.tie_embeddings:
        return h @ params.embed.T
    return h @ params.lm_head


# -------------------------------------------------------------- full pass ----
def _attend(cfg: ModelConfig, lp: DecoderLayer, h: torch.Tensor,
            positions: torch.Tensor, window: int, theta: float):
    """ln1 and the projections: (x's q, k, v) with rope applied."""
    x = common.apply_norm(cfg, h, lp.ln1)
    q, k, v = attn.project_qkv(cfg, lp.attn, x)
    if cfg.pos_embed == "rope":
        q = common.rope(q, positions, theta)
        k = common.rope(k, positions, theta)
    return q, k, v


def _finish(cfg: ModelConfig, lp: DecoderLayer, h: torch.Tensor,
            o: torch.Tensor) -> torch.Tensor:
    """The attention output's projection and residual, then the MLP."""
    h = h + attn.out_proj(lp.attn, o)
    x = common.apply_norm(cfg, h, lp.ln2)
    return h + mlp_forward(cfg, lp.ffn, x)


def _full_attention(cfg, q, k, v, window):
    return attn.chunked_attention(q, k, v, causal=True, window=window,
                                  softcap=cfg.logit_softcap,
                                  chunk=cfg.attn_chunk,
                                  repeat_kv=cfg.repeat_kv)


def _uniform_block(cfg: ModelConfig, lp: DecoderLayer, h: torch.Tensor,
                   positions: torch.Tensor, window: int,
                   theta: float) -> torch.Tensor:
    q, k, v = _attend(cfg, lp, h, positions, window, theta)
    return _finish(cfg, lp, h, _full_attention(cfg, q, k, v, window))


def forward_hidden(cfg: ModelConfig, params: DecoderLM, tokens: torch.Tensor,
                   extra_embeds: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence pass -> (hidden (B,S,d), moe_aux scalar): the
    reference's with ``remat=False`` (rematerialization, its training
    switch, changes no value)."""
    h = embed_tokens(cfg, params, tokens, extra_embeds)
    positions = torch.arange(h.shape[1], device=h.device)
    windows, thetas = layer_schedule(cfg)
    for lp, w, th in zip(params.layers, windows, thetas):
        h = _uniform_block(cfg, lp, h, positions, int(w), float(th))
    return h, torch.zeros((), dtype=torch.float32, device=h.device)


def forward(cfg: ModelConfig, params: DecoderLM, tokens: torch.Tensor,
            extra_embeds: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence pass -> (logits (B,S,V), moe_aux scalar)."""
    h, aux = forward_hidden(cfg, params, tokens, extra_embeds)
    return lm_logits(cfg, params, h), aux


# ------------------------------------------------------------------ caches ---
def _pattern_counts(cfg: ModelConfig):
    """(n_global, n_local) for local:global patterned stacks."""
    windows, _ = layer_schedule(cfg)
    n_local = int((windows > 0).sum())
    return cfg.num_layers - n_local, n_local


def _windowed(cfg: ModelConfig) -> bool:
    return bool(cfg.windowed_decode_cache and cfg.window_size)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None,
               device=None) -> Pytree:
    dtype = dtype or cfg.compute_dtype
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)
    if _windowed(cfg):
        n_g, n_l = _pattern_counts(cfg)
        win = min(cfg.window_size, max_seq)
        return {"kg": zeros(max(n_g, 1), batch, max_seq, kv, hd),
                "vg": zeros(max(n_g, 1), batch, max_seq, kv, hd),
                "kl": zeros(max(n_l, 1), batch, win, kv, hd),
                "vl": zeros(max(n_l, 1), batch, win, kv, hd),
                "pos": 0}
    return {"k": zeros(cfg.num_layers, batch, max_seq, kv, hd),
            "v": zeros(cfg.num_layers, batch, max_seq, kv, hd),
            "pos": 0}


def _slots(cfg: ModelConfig) -> List[Tuple[bool, int]]:
    """(local, index in its stack) of each layer of the windowed layout."""
    windows, _ = layer_schedule(cfg)
    out, n_l, n_g = [], 0, 0
    for w in windows:
        out.append((True, n_l) if w > 0 else (False, n_g))
        n_l, n_g = n_l + (w > 0), n_g + (w <= 0)
    return out


# ------------------------------------------------------------------ prefill --
def prefill(cfg: ModelConfig, params: DecoderLM, tokens: torch.Tensor,
            cache: Pytree, extra_embeds: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Pytree]:
    """Process the prompt, fill the cache (in place), return last-position
    logits (B, 1, V)."""
    h = embed_tokens(cfg, params, tokens, extra_embeds)
    s = h.shape[1]
    positions = torch.arange(s, device=h.device)
    windows, thetas = layer_schedule(cfg)
    windowed = "kg" in cache
    slots = _slots(cfg) if windowed else None
    for i, (lp, w, th) in enumerate(zip(params.layers, windows, thetas)):
        q, k, v = _attend(cfg, lp, h, positions, int(w), float(th))
        if not windowed:
            attn.update_cache(cache["k"][i], cache["v"][i], k, v, 0)
        elif slots[i][0]:
            _write_ring(cache["kl"][slots[i][1]], k, s)
            _write_ring(cache["vl"][slots[i][1]], v, s)
        else:
            attn.update_cache(cache["kg"][slots[i][1]],
                              cache["vg"][slots[i][1]], k, v, 0)
        h = _finish(cfg, lp, h, _full_attention(cfg, q, k, v, int(w)))
    cache["pos"] = s
    return lm_logits(cfg, params, h[:, -1:]), cache


def _write_ring(buf: torch.Tensor, x: torch.Tensor, s: int) -> None:
    """The last ``win`` tokens of x (B, S, KV, hd) into the ring buffer
    buf (B, win, KV, hd): token t at slot t % win, zeros past S."""
    win = buf.shape[1]
    tail = x[:, -win:].to(buf.dtype)
    if tail.shape[1] < win:
        buf.zero_()
        buf[:, :tail.shape[1]] = tail
    else:
        buf.copy_(torch.roll(tail, s % win, dims=1))


# --------------------------------------------------------------- decode ------
def decode_step(cfg: ModelConfig, params: DecoderLM, cache: Pytree,
                token: torch.Tensor) -> Tuple[torch.Tensor, Pytree]:
    """One decode step for the whole batch.  token (B,) -> logits (B, V);
    the cache is updated in place."""
    pos = int(cache["pos"])
    h = common.embed_lookup(params.embed, token[:, None]).to(
        cfg.compute_dtype)                                   # (B, 1, d)
    positions = torch.tensor([pos], device=h.device)
    windows, thetas = layer_schedule(cfg)
    windowed = "kg" in cache
    slots = _slots(cfg) if windowed else None
    for i, (lp, w, th) in enumerate(zip(params.layers, windows, thetas)):
        q, k, v = _attend(cfg, lp, h, positions, int(w), float(th))
        if windowed and slots[i][0]:
            kc, vc = cache["kl"][slots[i][1]], cache["vl"][slots[i][1]]
            win = kc.shape[1]
            attn.update_cache(kc, vc, k, v, pos % win)
            o = _ring_decode_attn(q, kc, vc, min(pos + 1, win),
                                  softcap=cfg.logit_softcap)
        else:
            if windowed:
                kc, vc = cache["kg"][slots[i][1]], cache["vg"][slots[i][1]]
                w = 0
            else:
                kc, vc = cache["k"][i], cache["v"][i]
            attn.update_cache(kc, vc, k, v, pos)
            o = attn.decode_attention(q, kc, vc, pos, window=int(w),
                                      softcap=cfg.logit_softcap)
        h = _finish(cfg, lp, h, o)
    cache["pos"] = pos + 1
    return lm_logits(cfg, params, h)[:, 0], cache


def _ring_decode_attn(q, kc, vc, valid_len: int, softcap: float = 0.0):
    """Decode attention over a ring-buffer window cache (positions are
    unordered in the buffer; all valid slots attend: the window is kept by
    eviction).  Only the ``valid_len`` filled slots are read."""
    b, _, hh, hd = q.shape
    kv = kc.shape[2]
    g = hh // kv
    kc, vc = kc[:, :valid_len], vc[:, :valid_len]
    qg = q.reshape(b, kv, g, hd)
    scores = torch.einsum("bkgh,bskh->bkgs", qg, kc).float()
    scores = common.softcap(scores / hd ** 0.5, softcap)
    prob = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskh->bkgh", prob.to(vc.dtype), vc)
    return out.reshape(b, 1, hh, hd)
