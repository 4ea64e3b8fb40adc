"""Encoder-decoder transformer (Whisper-large-v3 backbone), the counterpart
of ``repro/models/encdec.py``.

The conv/mel frontend is a stub, as in the reference: the encoder takes
precomputed frame embeddings (B, T_enc, d).  Encoder: bidirectional
self-attention layers (layernorm, gelu MLP) over sinusoidal positions.
Decoder: learned positions (``pos_dec``), causal self-attention, then
cross-attention to the encoder memory.  Serving: prefill caches both the
self-attention K/V and the (static) cross-attention K/V of the memory,
updated in place, with ``pos`` a Python int.  Plain PyTorch: the
reference has no Pallas kernel here.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.distributed import shard_ops
from repro_torch.models import attention as attn
from repro_torch.models import common
from repro_torch.models.common import ModelConfig, Params, Spec
from repro_torch.models.transformer import _identity, _two_level

Pytree = Any


def encdec_specs(cfg: ModelConfig) -> Dict[str, Any]:
    ne, nd = cfg.encoder_layers, cfg.num_layers
    return {
        "embed": Spec((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                      fan_in_dims=(1,)),
        "pos_dec": Spec((cfg.max_seq, cfg.d_model), (None, "embed"),
                        fan_in_dims=(1,)),
        "enc": {
            "attn": attn.attn_specs(cfg, stacked=ne),
            "ln1": common.norm_spec(cfg, cfg.d_model, stacked=ne),
            "ffn": _gelu_mlp_specs(cfg, ne),
            "ln2": common.norm_spec(cfg, cfg.d_model, stacked=ne),
        },
        "enc_norm": common.norm_spec(cfg, cfg.d_model),
        "dec": {
            "self_attn": attn.attn_specs(cfg, stacked=nd),
            "ln1": common.norm_spec(cfg, cfg.d_model, stacked=nd),
            "cross_attn": attn.attn_specs(cfg, stacked=nd, cross=True),
            "ln_x": common.norm_spec(cfg, cfg.d_model, stacked=nd),
            "ffn": _gelu_mlp_specs(cfg, nd),
            "ln2": common.norm_spec(cfg, cfg.d_model, stacked=nd),
        },
        "final_norm": common.norm_spec(cfg, cfg.d_model),
    }


def _gelu_mlp_specs(cfg: ModelConfig, stacked: int) -> Dict[str, Spec]:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "w_up": Spec((stacked, d, f), ("layers", "embed", "ffn"),
                     fan_in_dims=(1,)),
        "b_up": Spec((stacked, f), ("layers", "ffn"), init="zeros"),
        "w_down": Spec((stacked, f, d), ("layers", "ffn", "embed"),
                       fan_in_dims=(1,)),
        "b_down": Spec((stacked, d), ("layers", "embed"), init="zeros"),
    }


def _gelu_mlp(p, x: torch.Tensor) -> torch.Tensor:
    return common.gelu(x @ p.w_up + p.b_up) @ p.w_down + p.b_down


# ---------------------------------------------------------------- modules ----
class EncDecLM(nn.Module):
    """Whisper's parameters: embed (tied head), pos_dec, an encoder layer
    (attn, ln1, ffn, ln2) per ``enc`` index, enc_norm, a decoder layer
    (self_attn, ln1, cross_attn, ln_x, ffn, ln2) per ``dec`` index and
    final_norm, from a parameter tree in the reference's layout."""

    def __init__(self, cfg: ModelConfig, tree: Pytree):
        super().__init__()
        self.cfg = cfg
        self.tree = tree          # the reference's leaves, stacked layers
        self.embed = nn.Parameter(tree["embed"], requires_grad=False)
        self.pos_dec = nn.Parameter(tree["pos_dec"], requires_grad=False)
        self.enc = common.stack_layers(tree["enc"], cfg.encoder_layers)
        self.enc_norm = Params(tree["enc_norm"])
        self.dec = common.stack_layers(tree["dec"], cfg.num_layers)
        self.final_norm = Params(tree["final_norm"])


# ---------------------------------------------------------------- passes -----
def encode(cfg: ModelConfig, params: EncDecLM, frame_embeds: torch.Tensor,
           remat: bool = False, constrain=_identity) -> torch.Tensor:
    """(B, T_enc, d) precomputed frontend embeddings -> encoder memory.
    With ``remat``, the layers rematerialized in the backward as the
    reference's training pass does (``transformer._two_level``).
    ``constrain``: the sharding hook, applied as ``_decoder_layer``
    applies it (the memory, which every decoder layer projects, as
    "inner")."""
    h = frame_embeds.to(cfg.compute_dtype)
    h = constrain(h + common.sinusoidal_positions(
        h.shape[1], cfg.d_model, h.dtype, h.device)[None], "carry")
    zero = torch.zeros((), dtype=torch.float32, device=h.device)

    def body(i, h):
        lp = params.enc[i]
        x = constrain(common.apply_norm(cfg, h, lp.ln1), "inner")
        q, k, v = attn.project_qkv(cfg, lp.attn, x)
        o = attn.chunked_attention(q, k, v, causal=False, window=None,
                                   chunk=cfg.attn_chunk)
        h = h + shard_ops.like(attn.out_proj(lp.attn, o), h)
        x = constrain(common.apply_norm(cfg, h, lp.ln2), "inner")
        return constrain(h + shard_ops.like(_gelu_mlp(lp.ffn, x), h),
                         "carry"), zero
    h = _layers(body, h, cfg.encoder_layers, remat)
    return constrain(common.apply_norm(cfg, h, params.enc_norm), "inner")


def _layers(body, h: torch.Tensor, n: int, remat: bool) -> torch.Tensor:
    """body(i, h) -> (h, aux) over layers 0 .. n - 1: in a loop, or with
    ``remat`` by ``transformer._two_level``."""
    if remat:
        return _two_level(body, h, n)[0]
    for i in range(n):
        h = body(i, h)[0]
    return h


def _decoder_layer(cfg: ModelConfig, lp, h: torch.Tensor,
                   memory: torch.Tensor, constrain=_identity
                   ) -> torch.Tensor:
    """One decoder layer over the full sequence, no cache: causal
    self-attention, cross-attention to ``memory``, the gelu MLP.
    ``constrain``: the sharding hook on each norm's output ("inner") and
    the layer's output ("carry"), as ``transformer.forward_hidden``
    applies it."""
    x = constrain(common.apply_norm(cfg, h, lp.ln1), "inner")
    q, k, v = attn.project_qkv(cfg, lp.self_attn, x)
    o = attn.chunked_attention(q, k, v, causal=True, window=None,
                               chunk=cfg.attn_chunk)
    h = h + shard_ops.like(attn.out_proj(lp.self_attn, o), h)
    x = constrain(common.apply_norm(cfg, h, lp.ln_x), "inner")
    qx, mk, mv = attn.project_qkv(cfg, lp.cross_attn, x, memory)
    ox = attn.chunked_attention(qx, mk, mv, causal=False, window=None)
    h = h + shard_ops.like(attn.out_proj(lp.cross_attn, ox), h)
    x = constrain(common.apply_norm(cfg, h, lp.ln2), "inner")
    return constrain(h + shard_ops.like(_gelu_mlp(lp.ffn, x), h), "carry")


def _decoder_pass(cfg: ModelConfig, params: EncDecLM, h: torch.Tensor,
                  memory: Optional[torch.Tensor], cache: Optional[Pytree] = None,
                  pos: Optional[int] = None, remat: bool = False,
                  constrain=None) -> torch.Tensor:
    """The decoder stack: the full sequence when ``cache`` is None (with
    ``remat``, rematerialized as ``encode``), a cache-filling prefill from
    ``memory`` when ``pos`` is None, else one token's decode step at
    ``pos`` against the cached memory K/V.  The cache is written in
    place.  ``constrain``: the sharding hook, applied to the residual
    stream ("carry") and each norm's output ("inner"), as
    ``transformer.forward_hidden`` applies it."""
    decoding = cache is not None and pos is not None and h.shape[1] == 1
    constrain = constrain or _identity
    h = constrain(h, "carry")
    if cache is None:
        zero = torch.zeros((), dtype=torch.float32, device=h.device)
        return _layers(lambda i, hc: (_decoder_layer(
            cfg, params.dec[i], hc, memory, constrain), zero), h,
            cfg.num_layers, remat)
    for i, lp in enumerate(params.dec):
        x = constrain(common.apply_norm(cfg, h, lp.ln1), "inner")
        q, k, v = attn.project_qkv(cfg, lp.self_attn, x)
        if decoding:
            attn.update_cache(cache["k"][i], cache["v"][i], k, v, pos)
            o = attn.decode_attention(q, cache["k"][i], cache["v"][i], pos)
        else:
            attn.update_cache(cache["k"][i], cache["v"][i], k, v, 0)
            o = attn.chunked_attention(q, k, v, causal=True, window=None,
                                       chunk=cfg.attn_chunk)
        h = h + attn.out_proj(lp.self_attn, o)
        # cross attention (memory K/V cached at prefill)
        x = constrain(common.apply_norm(cfg, h, lp.ln_x), "inner")
        if decoding:
            qx = attn._proj(x, lp.cross_attn.wq)
            mk, mv = cache["mk"][i], cache["mv"][i]
        else:
            qx, mk, mv = attn.project_qkv(cfg, lp.cross_attn, x, memory)
            cache["mk"][i].copy_(mk)
            cache["mv"][i].copy_(mv)
            mk, mv = cache["mk"][i], cache["mv"][i]
        ox = attn.chunked_attention(qx, mk, mv, causal=False, window=None)
        h = h + attn.out_proj(lp.cross_attn, ox)
        x = constrain(common.apply_norm(cfg, h, lp.ln2), "inner")
        h = constrain(h + _gelu_mlp(lp.ffn, x), "carry")
    return h


def _embed_dec(cfg: ModelConfig, params: EncDecLM, tokens: torch.Tensor,
               start: int) -> torch.Tensor:
    """Token embeddings plus the learned positions from ``start``."""
    s = tokens.shape[1]
    h = common.embed_lookup(params.embed, tokens).to(cfg.compute_dtype)
    return h + params.pos_dec[start:start + s].to(h.dtype)[None]


def _logits(cfg: ModelConfig, params: EncDecLM,
            h: torch.Tensor) -> torch.Tensor:
    return common.apply_norm(cfg, h, params.final_norm) @ params.embed.T


def forward(cfg: ModelConfig, params: EncDecLM, tokens: torch.Tensor,
            frame_embeds: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full pass -> (logits (B,S,V), aux = 0)."""
    memory = encode(cfg, params, frame_embeds)
    h = _decoder_pass(cfg, params, _embed_dec(cfg, params, tokens, 0),
                      memory)
    return _logits(cfg, params, h), torch.zeros((), dtype=torch.float32,
                                                device=h.device)


def loss_fn(cfg: ModelConfig, params: EncDecLM,
            batch: Dict[str, torch.Tensor], constrain=None) -> torch.Tensor:
    """Train loss: the encoder over ``frame_embeds``, the decoder over the
    tokens, the tied head fused chunk by chunk
    (``common.chunked_cross_entropy``).  ``constrain``: the sharding hook
    of ``distributed.activation_constraint``, applied through both
    stacks as ``transformer.loss_fn`` applies it (the vocab-parallel
    embedding's partial sums are reduced before the first layer).  The
    reference's loss takes no hook: XLA propagates its layouts."""
    constrain = constrain or _identity
    memory = encode(cfg, params, batch["frame_embeds"], remat=True,
                    constrain=constrain)
    h = _decoder_pass(cfg, params, _embed_dec(cfg, params, batch["tokens"],
                                              0), memory, remat=True,
                      constrain=constrain)
    h = constrain(common.apply_norm(cfg, h, params.final_norm), "inner")
    return common.chunked_cross_entropy(h, params.embed, batch["labels"],
                                        transpose_head=True,
                                        chunk=cfg.ce_chunk)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None,
               device=None) -> Pytree:
    dtype = dtype or cfg.compute_dtype
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    nd, t_enc = cfg.num_layers, cfg.encoder_seq

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)
    return {"k": zeros(nd, batch, max_seq, kv, hd),
            "v": zeros(nd, batch, max_seq, kv, hd),
            "mk": zeros(nd, batch, t_enc, kv, hd),
            "mv": zeros(nd, batch, t_enc, kv, hd),
            "pos": 0}


def prefill(cfg: ModelConfig, params: EncDecLM, tokens: torch.Tensor,
            cache: Pytree, frame_embeds: torch.Tensor, constrain=None
            ) -> Tuple[torch.Tensor, Pytree]:
    """Encode the frames, process the prompt, fill the cache (in place),
    return last-position logits (B, 1, V).  ``constrain``: the sharding
    hook of ``_decoder_pass`` (the encoder takes the frames' layout)."""
    constrain = constrain or _identity
    memory = encode(cfg, params, frame_embeds)
    h = _decoder_pass(cfg, params, _embed_dec(cfg, params, tokens, 0),
                      memory, cache, constrain=constrain)
    cache["pos"] = tokens.shape[1]
    return _logits(cfg, params, constrain(h, "inner")[:, -1:]), cache


def decode_step(cfg: ModelConfig, params: EncDecLM, cache: Pytree,
                token: torch.Tensor, constrain=None
                ) -> Tuple[torch.Tensor, Pytree]:
    """One decode step for the whole batch.  token (B,) -> logits (B, V);
    the cache is updated in place.  ``constrain`` as in ``prefill``."""
    pos = int(cache["pos"])
    h = _embed_dec(cfg, params, token[:, None], pos)
    h = _decoder_pass(cfg, params, h, None, cache, pos, constrain=constrain)
    cache["pos"] = pos + 1
    return _logits(cfg, params, h)[:, 0], cache
