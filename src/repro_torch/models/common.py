"""Model substrate shared pieces (the counterpart of
``repro/models/common.py``): the architecture config, parameter spec trees
(shape + logical axes, materialized on demand), norms, embeddings and
activation helpers.

The numerics are the reference's: norms and rotary embeddings compute in
float32 and cast back to the activation's dtype, and ``materialize`` draws
every leaf with the reference's key and layout, so a float32 or bfloat16
init is the reference's bit for bit (the draws through
``kernels.ops.normal``: the normal kernel on the card).

Logical axis names (the reference maps them to mesh axes):
  embed, heads, kv_heads, head_dim, ffn, vocab, experts, layers, rnn, state,
  conv, classes
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import prng, resolve_device
from repro_torch.kernels import ops

Pytree = Any


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | hybrid | ssm | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int = 0
    num_kv_heads: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    head_dim: int = 0              # 0 => d_model // num_heads
    # attention flavour
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    global_rope_theta: float = 0.0   # gemma3 uses a larger theta globally
    window_size: int = 0             # sliding-window size for local layers
    local_global_pattern: int = 0    # N => N local layers per 1 global
    logit_softcap: float = 0.0
    # norm / mlp flavour
    norm_type: str = "rmsnorm"       # rmsnorm | layernorm
    mlp_type: str = "swiglu"         # swiglu | gelu
    pos_embed: str = "rope"          # rope | sinusoidal | learned
    tie_embeddings: bool = False
    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25
    moe_group_size: int = 256
    # SSM (mamba2 / SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 128
    ssm_conv: int = 4
    # recurrent (RG-LRU)
    rnn_width: int = 0
    attn_every: int = 0              # hybrid: 1 attention per `attn_every`
    # encoder-decoder
    encoder_layers: int = 0
    encoder_seq: int = 0
    # multimodal stub frontends
    frontend: Optional[str] = None   # audio_stub | patch_stub
    num_patches: int = 0
    max_seq: int = 131_072
    dtype: str = "bfloat16"
    # perf knobs
    attn_chunk: int = 512            # KV chunk for online-softmax attention
    ce_chunk: int = 1024             # sequence chunk for fused CE loss
    repeat_kv: bool = True           # repeat GQA KV to full heads
    windowed_decode_cache: bool = False  # local layers: ring-buffer KV cache
    #   bounded by window_size instead of the full context

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    @property
    def ssm_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_inner // self.ssm_head_dim

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    def scaled(self, **overrides) -> "ModelConfig":
        """A reduced copy for smoke tests."""
        return dataclasses.replace(self, **overrides)


@dataclasses.dataclass(frozen=True)
class Spec:
    """Declarative parameter: shape + logical axes + init recipe."""
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"            # normal | zeros | ones
    fan_in_dims: Tuple[int, ...] = ()   # dims whose product scales init

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


class Params(nn.Module):
    """A group of parameter tensors under their reference names (a norm's
    ``scale``, an attention's ``wq``, an MLP's ``w_gate``, ...)."""

    def __init__(self, leaves: Dict[str, torch.Tensor]):
        super().__init__()
        for name, t in leaves.items():
            self.register_parameter(name, nn.Parameter(t,
                                                       requires_grad=False))


class Layer(nn.Module):
    """One layer's parameter groups (``ln1``, ``attn``, ``ffn``, ...), each
    a ``Params`` under the reference's group name."""

    def __init__(self, groups: Dict[str, Dict[str, torch.Tensor]]):
        super().__init__()
        for name, leaves in groups.items():
            setattr(self, name, Params(leaves))


def stack_layers(groups: Dict[str, Dict[str, torch.Tensor]],
                 n: int) -> nn.ModuleList:
    """n ``Layer``s from the reference's stacked (n, ...) leaves: layer i
    holds the views of every leaf at index i."""
    return nn.ModuleList(
        Layer({g: {name: t[i] for name, t in leaves.items()}
               for g, leaves in groups.items()})
        for i in range(n))


def flatten(tree: Pytree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) pairs in ``jax.tree.flatten``'s order: dict keys
    sorted at every level; paths joined with '/'."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(flatten(tree[k], f"{prefix}{k}/"))
        return out
    return [(prefix[:-1], tree)]


def unflatten(pairs) -> Dict[str, Any]:
    """The nested dict of '/'-joined (path, leaf) pairs."""
    out: Dict[str, Any] = {}
    for path, leaf in pairs:
        node = out
        *heads, last = path.split("/")
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = leaf
    return out


def materialize(specs: Pytree, key: torch.Tensor, dtype: torch.dtype,
                device=None) -> Pytree:
    """Real parameters from a spec tree, as the reference draws them: one
    key per leaf (``prng.split`` in flatten order), normal leaves scaled
    by 1/sqrt(fan_in) in the leaf's dtype."""
    device = resolve_device(device)
    leaves = flatten(specs)
    keys = prng.split(key, len(leaves))
    out = []
    for (path, spec), k in zip(leaves, keys):
        if spec.init == "zeros":
            leaf = torch.zeros(spec.shape, dtype=dtype, device=device)
        elif spec.init == "ones":
            leaf = torch.ones(spec.shape, dtype=dtype, device=device)
        else:
            fan_in = 1
            for dim in spec.fan_in_dims:
                fan_in *= spec.shape[dim]
            scale = torch.tensor(1.0 / math.sqrt(max(fan_in, 1)),
                                 dtype=dtype, device=device)
            leaf = ops.normal(k, spec.shape, device, dtype=dtype)
            leaf.mul_(scale)
        out.append((path, leaf))
    return unflatten(out)


def param_count(specs: Pytree) -> int:
    return sum(math.prod(s.shape) for _, s in flatten(specs))


# ----------------------------------------------------------------- layers ----
def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + eps)
    return (out * scale.float() + bias.float()).to(x.dtype)


def apply_norm(cfg: ModelConfig, x: torch.Tensor, p) -> torch.Tensor:
    """``p`` is a norm module (``scale``, and ``bias`` for layernorm)."""
    if cfg.norm_type == "layernorm":
        return layer_norm(x, p.scale, p.bias)
    return rms_norm(x, p.scale)


def norm_spec(cfg: ModelConfig, dim: int, stacked: int = 0) -> Dict[str, Spec]:
    shape = (stacked, dim) if stacked else (dim,)
    axes = (("layers", "embed") if stacked else ("embed",))
    out = {"scale": Spec(shape, axes, init="zeros" if cfg.norm_type ==
                         "rmsnorm" else "ones")}
    if cfg.norm_type == "layernorm":
        out["bias"] = Spec(shape, axes, init="zeros")
    return out


def embed_lookup(embed: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Token embedding: a plain gather (the reference's forward; its
    sharding-aware backward comes with training)."""
    return embed[tokens.long()]


def sinusoidal_positions(num: int, dim: int, dtype=torch.float32,
                         device=None) -> torch.Tensor:
    pos = torch.arange(num, device=device)[:, None]
    div = torch.exp(torch.arange(0, dim, 2, device=device) *
                    (-math.log(10_000.0) / dim))
    pe = torch.zeros(num, dim, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe.to(dtype)


@functools.lru_cache(maxsize=None)
def rope_freq(hd: int, theta: float, device: torch.device) -> torch.Tensor:
    """exp(arange(hd / 2) (-2 / hd) log(theta)) in float32, with XLA's
    float32 log and exp (``prng.log_f32``, ``prng.exp_f32``); made once
    per (hd, theta, device)."""
    log_theta = prng.log_f32(torch.tensor(theta, dtype=torch.float32))
    f = torch.arange(0, hd // 2, dtype=torch.float32) * (-2.0 / hd)
    return prng.exp_f32(f * log_theta).to(device)


def rope(x: torch.Tensor, positions: torch.Tensor, theta) -> torch.Tensor:
    """Rotary embedding.  x: (batch, seq, heads, head_dim); positions:
    (seq,) or (batch, seq)."""
    hd = x.shape[-1]
    freq = rope_freq(hd, float(theta), x.device)
    if positions.dim() == 1:
        ang = positions[:, None].float() * freq[None, :]
        ang = ang[None, :, None, :]              # (1, seq, 1, hd/2)
    else:
        ang = positions[..., None].float() * freq
        ang = ang[:, :, None, :]                 # (batch, seq, 1, hd/2)
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.silu: x sigmoid(x)."""
    return x * torch.sigmoid(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.gelu's default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus: logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def causal_conv(x: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, x (B, S, C), w (K, C): the taps summed in the
    reference's order (``sum`` of the shifted products), then the bias."""
    k, s = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, k - 1, 0))
    out = pad[:, 0:s] * w[0]
    for i in range(1, k):
        out = out + pad[:, i:i + s] * w[i]
    return out + b


def softcap(logits: torch.Tensor, cap: float) -> torch.Tensor:
    if cap <= 0:
        return logits
    return cap * torch.tanh(logits / cap)
