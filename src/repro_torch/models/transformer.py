"""Decoder-only LM covering the dense, MoE, hybrid (RG-LRU), SSM (SSD) and
VLM-backbone families (the counterpart of ``repro/models/transformer.py``).

The reference scans one body over stacked (L, ...) parameters; here each
layer is its own ``nn.Module`` (``common.Layer``) with the reference's
parameter names, and the layers run in a plain loop, which is the
reference's ``forward`` with ``remat=False``;
``forward_hidden(remat=True)`` (the training loss's) rematerializes them
as the reference does, in groups of ~sqrt(L) layers with
``torch.utils.checkpoint`` at both levels.  Per-layer scalars (sliding
window, rope theta) come from ``layer_schedule`` as in the reference.
Caches are dicts of tensors updated in place, with ``pos`` a Python int.

The uniform stack (``DecoderLM``) serves the dense, MoE and SSM families;
the hybrid's recurrent and attention layers are stacked apart in the
reference's tree, so it has its own layout (``HybridLM``) and runs the
reference's (rec, rec, attn) groups, then the trailing recurrent layers.
Cache layouts: the uniform one (every layer caches the full context);
where ``windowed_decode_cache`` is set on a dense or MoE local:global
pattern (gemma3), local layers in ring buffers of ``window_size`` slots;
the SSM's per-layer conv and ssm states; the hybrid's recurrent states
beside its attention layers' ring buffers.  The MoE layers' auxiliary
load-balance loss is returned by ``forward_hidden``, not kept in a
module-level store as the reference keeps it.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn
from repro_torch.models import common, moe, rglru, ssd
from repro_torch.models.common import ModelConfig, Params, Spec

Pytree = Any
MOE_AUX_WEIGHT = 0.01


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
        return (common.silu(x @ p.w_gate) * (x @ p.w_up)) @ p.w_down
    return common.gelu(x @ p.w_up + p.b_up) @ p.w_down + p.b_down


def _uniform_layer_specs(cfg: ModelConfig) -> Dict[str, Any]:
    n = cfg.num_layers
    sp: Dict[str, Any] = {
        "ln1": common.norm_spec(cfg, cfg.d_model, stacked=n),
        "ln2": common.norm_spec(cfg, cfg.d_model, stacked=n),
    }
    if cfg.family == "ssm":
        sp.pop("ln2")
        sp["mix"] = ssd.ssd_specs(cfg, stacked=n)
    else:
        sp["attn"] = attn.attn_specs(cfg, stacked=n)
        if cfg.family == "moe":
            sp["ffn"] = moe.moe_specs(cfg, stacked=n)
        else:
            sp["ffn"] = mlp_specs(cfg, stacked=n)
    return sp


REC_GROUPS = ("rec", "rec_ln", "rec_mlp", "rec_mlp_ln")
ATTN_GROUPS = ("attn", "attn_ln", "attn_mlp", "attn_mlp_ln")


def _hybrid_counts(cfg: ModelConfig) -> Tuple[int, int]:
    """(recurrent layers, attention layers) of the hybrid stack."""
    n_attn = cfg.num_layers // cfg.attn_every
    return cfg.num_layers - n_attn, n_attn


def _hybrid_layer_specs(cfg: ModelConfig) -> Dict[str, Any]:
    """RecurrentGemma: pattern (rec, rec, attn); every layer has an MLP."""
    n_rec, n_attn = _hybrid_counts(cfg)
    return {
        "rec": rglru.rglru_specs(cfg, stacked=n_rec),
        "rec_ln": common.norm_spec(cfg, cfg.d_model, stacked=n_rec),
        "rec_mlp": mlp_specs(cfg, stacked=n_rec),
        "rec_mlp_ln": common.norm_spec(cfg, cfg.d_model, stacked=n_rec),
        "attn": attn.attn_specs(cfg, stacked=n_attn),
        "attn_ln": common.norm_spec(cfg, cfg.d_model, stacked=n_attn),
        "attn_mlp": mlp_specs(cfg, stacked=n_attn),
        "attn_mlp_ln": common.norm_spec(cfg, cfg.d_model, stacked=n_attn),
    }


def decoder_specs(cfg: ModelConfig) -> Dict[str, Any]:
    """The decoder families' spec tree (the encoder-decoder's is
    ``encdec.encdec_specs``)."""
    sp: Dict[str, Any] = {
        "embed": Spec((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                      fan_in_dims=(1,)),
        "final_norm": common.norm_spec(cfg, cfg.d_model),
    }
    if not cfg.tie_embeddings:
        sp["lm_head"] = Spec((cfg.d_model, cfg.vocab_size),
                             ("embed", "vocab"), fan_in_dims=(0,))
    if cfg.family == "hybrid":
        sp["layers"] = _hybrid_layer_specs(cfg)
    else:
        sp["layers"] = _uniform_layer_specs(cfg)
    return sp


# ---------------------------------------------------------------- modules ----
class _LM(nn.Module):
    """embed, final_norm and, for untied configs, lm_head."""

    def __init__(self, cfg: ModelConfig, tree: Pytree):
        super().__init__()
        self.cfg = cfg
        self.tree = tree          # the reference's leaves, stacked layers
        self.embed = nn.Parameter(tree["embed"], requires_grad=False)
        self.final_norm = Params(tree["final_norm"])
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(tree["lm_head"], requires_grad=False)


class DecoderLM(_LM):
    """The uniform stack (dense, MoE, SSM): one ``common.Layer`` per layer
    (ln1, attn, ln2, ffn; or ln1, mix), from a parameter tree in the
    reference's layout (each layer's parameters are views of the stacked
    (L, ...) leaves)."""

    def __init__(self, cfg: ModelConfig, tree: Pytree):
        super().__init__(cfg, tree)
        self.layers = common.stack_layers(tree["layers"], cfg.num_layers)


class HybridLM(_LM):
    """RecurrentGemma: the recurrent layers (rec, rec_ln, rec_mlp,
    rec_mlp_ln) and the attention layers (attn, attn_ln, attn_mlp,
    attn_mlp_ln), each stacked apart as in the reference's tree."""

    def __init__(self, cfg: ModelConfig, tree: Pytree):
        super().__init__(cfg, tree)
        n_rec, n_attn = _hybrid_counts(cfg)
        layers = tree["layers"]
        self.rec_layers = common.stack_layers(
            {g: layers[g] for g in REC_GROUPS}, n_rec)
        self.attn_layers = common.stack_layers(
            {g: layers[g] for g in ATTN_GROUPS}, n_attn)


def build(cfg: ModelConfig, tree: Pytree) -> _LM:
    """The decoder's modules for ``cfg`` from a tree in the reference's
    layout."""
    return (HybridLM if cfg.family == "hybrid" else DecoderLM)(cfg, tree)


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
def embed_tokens(cfg: ModelConfig, params: _LM, tokens: torch.Tensor,
                 extra_embeds: Optional[torch.Tensor]) -> torch.Tensor:
    h = common.embed_lookup(params.embed, tokens).to(cfg.compute_dtype)
    if extra_embeds is not None:   # VLM / audio stub: prepend frontier embeds
        h = torch.cat([extra_embeds.to(h.dtype), h], dim=1)
    if cfg.pos_embed == "sinusoidal":
        pe = common.sinusoidal_positions(h.shape[1], cfg.d_model, h.dtype,
                                         h.device)
        h = h + pe[None]
    return h


def lm_logits(cfg: ModelConfig, params: _LM,
              h: torch.Tensor) -> torch.Tensor:
    h = common.apply_norm(cfg, h, params.final_norm)
    if cfg.tie_embeddings:
        return h @ params.embed.T
    return h @ params.lm_head


# -------------------------------------------------------------- full pass ----
def _attend(cfg: ModelConfig, p, ln, h: torch.Tensor,
            positions: torch.Tensor, theta: float):
    """The norm ``ln`` and the projections of attention ``p``: (x's q, k,
    v) with rope applied."""
    x = common.apply_norm(cfg, h, ln)
    q, k, v = attn.project_qkv(cfg, p, x)
    if cfg.pos_embed == "rope":
        q = common.rope(q, positions, theta)
        k = common.rope(k, positions, theta)
    return q, k, v


def _ffn(cfg: ModelConfig, p, x: torch.Tensor):
    """The feed-forward block -> (y, the MoE's aux loss or None)."""
    if cfg.family == "moe":
        return moe.moe_ffn(cfg, p, x)
    return mlp_forward(cfg, p, x), None


def _finish(cfg: ModelConfig, lp, h: torch.Tensor, o: torch.Tensor):
    """The attention output's projection and residual, then the MLP or the
    MoE -> (h, aux or None)."""
    h = h + attn.out_proj(lp.attn, o)
    y, aux = _ffn(cfg, lp.ffn, common.apply_norm(cfg, h, lp.ln2))
    return h + y, aux


def _full_attention(cfg, q, k, v, window):
    return attn.chunked_attention(q, k, v, causal=True, window=window,
                                  softcap=cfg.logit_softcap,
                                  chunk=cfg.attn_chunk,
                                  repeat_kv=cfg.repeat_kv)


def _uniform_block(cfg: ModelConfig, lp, h: torch.Tensor,
                   positions: torch.Tensor, window: int, theta: float):
    """One layer of the uniform stack -> (h, aux or None)."""
    if cfg.family == "ssm":
        return h + ssd.ssd_forward(cfg, lp.mix, common.apply_norm(
            cfg, h, lp.ln1)), None
    q, k, v = _attend(cfg, lp.attn, lp.ln1, h, positions, theta)
    return _finish(cfg, lp, h, _full_attention(cfg, q, k, v, window))


def forward_hidden(cfg: ModelConfig, params: _LM, tokens: torch.Tensor,
                   extra_embeds: Optional[torch.Tensor] = None, *,
                   remat: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence pass -> (hidden (B,S,d), moe_aux scalar: the MoE
    layers' aux losses summed, 0 for the other families).  With
    ``remat``, the reference's training form: the layers rematerialized
    in the backward (``_two_level``; the hybrid's groups once); it
    changes no value."""
    h = embed_tokens(cfg, params, tokens, extra_embeds)
    positions = torch.arange(h.shape[1], device=h.device)
    aux_total = torch.zeros((), dtype=torch.float32, device=h.device)
    if cfg.family == "hybrid":
        return _hybrid_forward(cfg, params, h, positions,
                               remat=remat), aux_total
    windows, thetas = layer_schedule(cfg)
    if remat:
        def body(i, hc):
            out, aux = _uniform_block(cfg, params.layers[i], hc, positions,
                                      int(windows[i]), float(thetas[i]))
            return out, aux_total if aux is None else aux
        return _two_level(body, h, cfg.num_layers)
    for lp, w, th in zip(params.layers, windows, thetas):
        h, aux = _uniform_block(cfg, lp, h, positions, int(w), float(th))
        if aux is not None:
            aux_total = aux_total + aux
    return h, aux_total


def _two_level(body, h: torch.Tensor, num_layers: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """sqrt(L) rematerialization, the reference's ``_two_level_scan``:
    groups of k = ceil(sqrt(L)) layers, each group checkpointed and each
    layer in it checkpointed again, then the L - (L // k) k remaining
    layers one checkpoint each.  ``body(i, h)`` runs layer i -> (h, aux);
    the auxes are summed per group, then over the groups, as the
    reference's scans sum them."""
    k = max(1, int(math.ceil(math.sqrt(num_layers))))
    g = num_layers // k

    def layer(i, hc):
        return checkpoint(body, i, hc, use_reentrant=False)

    def group(start, hc):
        auxes = []
        for i in range(start, start + k):
            hc, aux = layer(i, hc)
            auxes.append(aux)
        return hc, torch.stack(auxes).sum()

    aux_total = torch.zeros((), dtype=torch.float32, device=h.device)
    if g > 0:
        auxes = []
        for j in range(g):
            h, aux = checkpoint(group, j * k, h, use_reentrant=False)
            auxes.append(aux)
        aux_total = aux_total + torch.stack(auxes).sum()
    if num_layers > g * k:
        auxes = []
        for i in range(g * k, num_layers):
            h, aux = layer(i, h)
            auxes.append(aux)
        aux_total = aux_total + torch.stack(auxes).sum()
    return h, aux_total


def forward(cfg: ModelConfig, params: _LM, tokens: torch.Tensor,
            extra_embeds: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence pass -> (logits (B,S,V), moe_aux scalar)."""
    h, aux = forward_hidden(cfg, params, tokens, extra_embeds)
    return lm_logits(cfg, params, h), aux


def loss_fn(cfg: ModelConfig, params: _LM, batch: Dict[str, torch.Tensor]
            ) -> torch.Tensor:
    """Train loss; the vocab projection is fused chunk by chunk
    (``common.chunked_cross_entropy``), so the (B,S,V) logits never live
    whole; plus ``MOE_AUX_WEIGHT`` times the MoE's aux loss."""
    h, aux = forward_hidden(cfg, params, batch["tokens"],
                            batch.get("patch_embeds"), remat=True)
    h = common.apply_norm(cfg, h, params.final_norm)
    if cfg.tie_embeddings:
        ce = common.chunked_cross_entropy(h, params.embed, batch["labels"],
                                          transpose_head=True,
                                          chunk=cfg.ce_chunk)
    else:
        ce = common.chunked_cross_entropy(h, params.lm_head,
                                          batch["labels"],
                                          chunk=cfg.ce_chunk)
    return ce + MOE_AUX_WEIGHT * aux


# ------------------------------------------------------------------- hybrid --
def _hybrid_slots(cfg: ModelConfig) -> List[Tuple[bool, int]]:
    """(attention, index in its stack) of each hybrid layer in order: the
    (rec, ..., attn) groups, then the trailing recurrent layers."""
    _, n_attn = _hybrid_counts(cfg)
    out, ri, ai = [], 0, 0
    for i in range(cfg.num_layers):
        if (i + 1) % cfg.attn_every == 0 and ai < n_attn:
            out.append((True, ai))
            ai += 1
        else:
            out.append((False, ri))
            ri += 1
    return out


def _rec_mlp(cfg: ModelConfig, lp, h: torch.Tensor) -> torch.Tensor:
    return h + mlp_forward(cfg, lp.rec_mlp,
                           common.apply_norm(cfg, h, lp.rec_mlp_ln))


def _attn_finish(cfg: ModelConfig, lp, h: torch.Tensor,
                 o: torch.Tensor) -> torch.Tensor:
    h = h + attn.out_proj(lp.attn, o)
    return h + mlp_forward(cfg, lp.attn_mlp,
                           common.apply_norm(cfg, h, lp.attn_mlp_ln))


def _hybrid_forward(cfg: ModelConfig, params: HybridLM, h: torch.Tensor,
                    positions: torch.Tensor, cache: Optional[Pytree] = None,
                    remat: bool = False) -> torch.Tensor:
    """The hybrid stack over a sequence; with ``cache``, the prefill: each
    recurrent layer's final state and each attention layer's last
    ``window`` keys and values written into it.  With ``remat``, the
    reference's training form: each (rec, ..., attn) group, and each
    trailing recurrent layer, one checkpoint."""
    slots = _hybrid_slots(cfg)
    if remat:
        per = cfg.attn_every
        n_attn = _hybrid_counts(cfg)[1]
        units = [slots[i * per:(i + 1) * per] for i in range(n_attn)]
        units += [[slot] for slot in slots[n_attn * per:]]
        for unit in units:
            h = checkpoint(_hybrid_layers, cfg, params, h, positions, unit,
                           use_reentrant=False)
        return h
    return _hybrid_layers(cfg, params, h, positions, slots, cache)


def _hybrid_layers(cfg: ModelConfig, params: HybridLM, h: torch.Tensor,
                   positions: torch.Tensor, slots, cache=None
                   ) -> torch.Tensor:
    """The hybrid layers of ``slots`` ((attention, index) pairs) in
    order."""
    s = h.shape[1]
    for is_attn, j in slots:
        if is_attn:
            lp = params.attn_layers[j]
            q, k, v = _attend(cfg, lp.attn, lp.attn_ln, h, positions,
                              cfg.rope_theta)
            if cache is not None:
                _write_ring(cache["k"][j], k, s)
                _write_ring(cache["v"][j], v, s)
            h = _attn_finish(cfg, lp, h, attn.chunked_attention(
                q, k, v, causal=True, window=cfg.window_size,
                chunk=cfg.attn_chunk, repeat_kv=cfg.repeat_kv))
        else:
            lp = params.rec_layers[j]
            x = common.apply_norm(cfg, h, lp.rec_ln)
            y, hseq, u_raw = rglru.rglru_sequence(cfg, lp.rec, x)
            if cache is not None:
                cache["rec"]["h"][j].copy_(hseq[:, -1])
                cache["rec"]["conv"][j].copy_(u_raw[:, -3:])
            h = _rec_mlp(cfg, lp, h + y)
    return h


def _hybrid_decode(cfg: ModelConfig, params: HybridLM, cache: Pytree,
                   h: torch.Tensor) -> torch.Tensor:
    pos = int(cache["pos"])
    positions = torch.tensor([pos], device=h.device)
    for is_attn, j in _hybrid_slots(cfg):
        if is_attn:
            lp = params.attn_layers[j]
            q, k, v = _attend(cfg, lp.attn, lp.attn_ln, h, positions,
                              cfg.rope_theta)
            kc, vc = cache["k"][j], cache["v"][j]
            win = kc.shape[1]
            attn.update_cache(kc, vc, k, v, pos % win)
            h = _attn_finish(cfg, lp, h, _ring_decode_attn(
                q, kc, vc, min(pos + 1, win)))
        else:
            lp = params.rec_layers[j]
            x = common.apply_norm(cfg, h, lp.rec_ln)
            state = {"h": cache["rec"]["h"][j],
                     "conv": cache["rec"]["conv"][j]}
            y = rglru.rglru_decode_step(cfg, lp.rec, state, x[:, 0])
            h = _rec_mlp(cfg, lp, h + y[:, None])
    return h


# ------------------------------------------------------------------ caches ---
def _pattern_counts(cfg: ModelConfig):
    """(n_global, n_local) for local:global patterned stacks."""
    windows, _ = layer_schedule(cfg)
    n_local = int((windows > 0).sum())
    return cfg.num_layers - n_local, n_local


def _windowed(cfg: ModelConfig) -> bool:
    return bool(cfg.windowed_decode_cache and cfg.window_size and
                cfg.family in ("dense", "moe"))


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
    if cfg.family == "ssm":
        per = ssd.ssd_init_state(cfg, batch, dtype, device)
        return {"layers": {name: t.expand((cfg.num_layers,) + t.shape)
                           .contiguous() for name, t in per.items()},
                "pos": 0}
    if cfg.family == "hybrid":
        n_rec, n_attn = _hybrid_counts(cfg)
        rec = rglru.rglru_init_state(cfg, batch, dtype, device)
        win = min(cfg.window_size or max_seq, max_seq)
        return {"rec": {name: t.expand((n_rec,) + t.shape).contiguous()
                        for name, t in rec.items()},
                "k": zeros(n_attn, batch, win, kv, hd),
                "v": zeros(n_attn, batch, win, kv, hd),
                "pos": 0}
    return {"k": zeros(cfg.num_layers, batch, max_seq, kv, hd),
            "v": zeros(cfg.num_layers, batch, max_seq, kv, hd),
            "pos": 0}


def _ssd_state(cache: Pytree, i: int) -> Dict[str, torch.Tensor]:
    """Layer i's SSD state: views of the cache's stacked leaves."""
    return {name: t[i] for name, t in cache["layers"].items()}


def _slots(cfg: ModelConfig) -> List[Tuple[bool, int]]:
    """(local, index in its stack) of each layer of the windowed layout."""
    windows, _ = layer_schedule(cfg)
    out, n_l, n_g = [], 0, 0
    for w in windows:
        out.append((True, n_l) if w > 0 else (False, n_g))
        n_l, n_g = n_l + (w > 0), n_g + (w <= 0)
    return out


# ------------------------------------------------------------------ prefill --
def prefill(cfg: ModelConfig, params: _LM, tokens: torch.Tensor,
            cache: Pytree, extra_embeds: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Pytree]:
    """Process the prompt, fill the cache (in place), return last-position
    logits (B, 1, V)."""
    h = embed_tokens(cfg, params, tokens, extra_embeds)
    s = h.shape[1]
    positions = torch.arange(s, device=h.device)
    if cfg.family == "hybrid":
        h = _hybrid_forward(cfg, params, h, positions, cache)
    elif cfg.family == "ssm":
        # The chunked form for the outputs, then each layer's final state
        # by the reference's per-token recurrence.
        for i, lp in enumerate(params.layers):
            x = common.apply_norm(cfg, h, lp.ln1)
            y = ssd.ssd_forward(cfg, lp.mix, x)
            ssd.ssd_final_state(cfg, lp.mix, x, _ssd_state(cache, i))
            h = h + y
    else:
        windows, thetas = layer_schedule(cfg)
        windowed = "kg" in cache
        slots = _slots(cfg) if windowed else None
        for i, (lp, w, th) in enumerate(zip(params.layers, windows,
                                            thetas)):
            q, k, v = _attend(cfg, lp.attn, lp.ln1, h, positions, float(th))
            if not windowed:
                attn.update_cache(cache["k"][i], cache["v"][i], k, v, 0)
            elif slots[i][0]:
                _write_ring(cache["kl"][slots[i][1]], k, s)
                _write_ring(cache["vl"][slots[i][1]], v, s)
            else:
                attn.update_cache(cache["kg"][slots[i][1]],
                                  cache["vg"][slots[i][1]], k, v, 0)
            h = _finish(cfg, lp, h, _full_attention(cfg, q, k, v,
                                                    int(w)))[0]
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
def decode_step(cfg: ModelConfig, params: _LM, cache: Pytree,
                token: torch.Tensor) -> Tuple[torch.Tensor, Pytree]:
    """One decode step for the whole batch.  token (B,) -> logits (B, V);
    the cache is updated in place."""
    pos = int(cache["pos"])
    h = common.embed_lookup(params.embed, token[:, None]).to(
        cfg.compute_dtype)                                   # (B, 1, d)
    if cfg.family == "hybrid":
        h = _hybrid_decode(cfg, params, cache, h)
    elif cfg.family == "ssm":
        for i, lp in enumerate(params.layers):
            x = common.apply_norm(cfg, h, lp.ln1)
            h = h + ssd.ssd_decode_step(cfg, lp.mix, _ssd_state(cache, i),
                                        x[:, 0])[:, None]
    else:
        h = _attention_decode(cfg, params, cache, h, pos)
    cache["pos"] = pos + 1
    return lm_logits(cfg, params, h)[:, 0], cache


def _attention_decode(cfg: ModelConfig, params: DecoderLM, cache: Pytree,
                      h: torch.Tensor, pos: int) -> torch.Tensor:
    """The uniform attention stack's decode (both cache layouts)."""
    positions = torch.tensor([pos], device=h.device)
    windows, thetas = layer_schedule(cfg)
    windowed = "kg" in cache
    slots = _slots(cfg) if windowed else None
    for i, (lp, w, th) in enumerate(zip(params.layers, windows, thetas)):
        q, k, v = _attend(cfg, lp.attn, lp.ln1, h, positions, float(th))
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
        h = _finish(cfg, lp, h, o)[0]
    return h


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
