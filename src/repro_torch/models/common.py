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
from torch.utils.checkpoint import checkpoint

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


class _EmbedLookup(torch.autograd.Function):
    """The reference's ``custom_vjp``: a gather forward, and a backward of
    chunked one-hot products accumulated in a float32 (V, d) buffer, then
    cast to the parameter's dtype (not autograd's default index-put with
    atomic adds, whose sums land in no fixed order on the card)."""

    @staticmethod
    def forward(ctx, embed, tokens, grad_chunk):
        ctx.save_for_backward(tokens)
        ctx.vocab, ctx.dtype, ctx.grad_chunk = (embed.shape[0], embed.dtype,
                                                grad_chunk)
        return embed[tokens.long()]

    @staticmethod
    def backward(ctx, g):
        tokens, = ctx.saved_tensors
        return (embed_grad(tokens, g, ctx.vocab, ctx.dtype, ctx.grad_chunk),
                None, None)


def embed_grad(tokens: torch.Tensor, g: torch.Tensor, vocab: int,
               dtype: torch.dtype, grad_chunk: int = 512) -> torch.Tensor:
    """d(embed) of a lookup of ``tokens`` (B, S) with cotangent g (B, S, d):
    per sequence chunk of ``grad_chunk`` (the last right-padded with token
    0 and a zero cotangent), the one-hot (B, cs, V) in g's dtype times g,
    a product in g's dtype, added into a float32 (V, d) buffer; then the
    buffer in ``dtype``."""
    b, s = tokens.shape
    cs = min(grad_chunk, s)
    n_chunks = -(-s // cs)
    pad = n_chunks * cs - s
    tokens = tokens.long()
    if pad:
        tokens = F.pad(tokens, (0, pad))
        g = F.pad(g, (0, 0, 0, pad))
    acc = torch.zeros((vocab, g.shape[-1]), dtype=torch.float32,
                      device=g.device)
    for i in range(n_chunks):
        tk = tokens[:, i * cs:(i + 1) * cs].reshape(-1)
        gk = g[:, i * cs:(i + 1) * cs].reshape(-1, g.shape[-1])
        onehot = torch.zeros((tk.shape[0], vocab), dtype=g.dtype,
                             device=g.device)
        onehot.scatter_(1, tk[:, None], 1)
        acc += onehot.T @ gk
    return acc.to(dtype)


def embed_lookup(embed: torch.Tensor, tokens: torch.Tensor,
                 grad_chunk: int = 512) -> torch.Tensor:
    """Token embedding: a plain gather forward; under autograd, the
    reference's chunked one-hot backward (``embed_grad``)."""
    return _EmbedLookup.apply(embed, tokens, grad_chunk)


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


# ------------------------------------------------------------------ losses ---
def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       ignore_id: int = -1) -> torch.Tensor:
    """Mean token NLL.  logits (B, S, V) any float dtype; labels (B, S)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long().clamp_min(0)[..., None])[..., 0]
    mask = (labels != ignore_id).float()
    return (((lse - gold) * mask).sum() /
            torch.clamp(mask.sum(), min=1.0))


def dynamic_slice(x: torch.Tensor, start: int, size: int,
                  dim: int) -> torch.Tensor:
    """``jax.lax.dynamic_slice_in_dim``: ``size`` entries from ``start``,
    the start clamped so the slice stays inside x."""
    n = x.shape[dim]
    if size > n:
        raise ValueError(f"slice of {size} from a dimension of {n}")
    start = min(max(start, 0), n - size)
    return x.narrow(dim, start, size)


def _ce_chunk(h_blk: torch.Tensor, head: torch.Tensor, l_blk: torch.Tensor,
              transpose_head: bool, ignore_id: int):
    """One chunk's (NLL sum, unmasked count), both float32 0-d."""
    logits = (h_blk @ (head.T if transpose_head else head)).float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, l_blk.long().clamp_min(0)[..., None])[..., 0]
    mask = (l_blk != ignore_id).float()
    return ((lse - gold) * mask).sum(), mask.sum()


def chunked_cross_entropy(h: torch.Tensor, head: torch.Tensor,
                          labels: torch.Tensor, *,
                          transpose_head: bool = False, chunk: int = 1024,
                          ignore_id: int = -1) -> torch.Tensor:
    """Mean token NLL with the vocab projection fused per sequence chunk,
    the reference's loop: h (B, S, d) right-padded to whole chunks of
    ``chunk`` (labels padded with ``ignore_id``), each chunk's logits in
    float32, each chunk rematerialized in the backward
    (``torch.utils.checkpoint``, the reference's ``jax.checkpoint``), so
    the (B, S, V) logits never live whole.

    head (d, V), or (V, d) with ``transpose_head`` (tied).
    """
    s = h.shape[1]
    n_chunks = -(-s // chunk)
    pad = n_chunks * chunk - s
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=ignore_id)
    nll_sum = torch.zeros((), dtype=torch.float32, device=h.device)
    count = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(n_chunks):
        part, n = checkpoint(_ce_chunk, dynamic_slice(h, i * chunk, chunk, 1),
                             head, dynamic_slice(labels, i * chunk, chunk, 1),
                             transpose_head, ignore_id, use_reentrant=False)
        nll_sum = nll_sum + part
        count = count + n
    return nll_sum / torch.clamp(count, min=1.0)


# --------------------------------------------------- training's parameters ---
def abstract(specs: Pytree, dtype: torch.dtype) -> Pytree:
    """Meta tensors (``device="meta"``) of each spec's shape in ``dtype``:
    the dry run's stand-in for the parameters, with no allocation."""
    return unflatten([(path, torch.empty(s.shape, dtype=dtype,
                                         device="meta"))
                      for path, s in flatten(specs)])


def spec_axes(specs: Pytree) -> Pytree:
    """Tree of logical-axis tuples, aligned with the param tree."""
    return unflatten([(path, s.axes) for path, s in flatten(specs)])


def leaf_views(model: nn.Module) -> List[Tuple[str, Optional[int],
                                               nn.Parameter]]:
    """(leaf path, layer index or None, parameter) of every parameter of
    a model built from a tree in the reference's layout: each parameter is
    its tree leaf (``model.tree``), or the view of one layer of a stacked
    (L, ...) leaf.  Found by storage."""
    leaves = {leaf.untyped_storage().data_ptr(): (path, leaf)
              for path, leaf in flatten(model.tree)}
    views = []
    for p in model.parameters():
        path, leaf = leaves[p.untyped_storage().data_ptr()]
        if p.shape == leaf.shape:
            views.append((path, None, p))
        else:
            step = leaf[0].numel()
            views.append((path, (p.storage_offset() - leaf.storage_offset())
                          // step, p))
    return views


def zero_grads(model: nn.Module, grads: Optional[Pytree] = None) -> Pytree:
    """A gradient tree in the reference's layout for ``model.tree`` (new
    zeros, or ``grads`` zeroed), with every parameter's ``.grad`` set to its
    view: a backward pass then adds each layer's gradient in place into
    its slot of the stacked leaf."""
    if grads is None:
        grads = unflatten([(path, torch.zeros_like(leaf))
                           for path, leaf in flatten(model.tree)])
    else:
        for _, g in flatten(grads):
            g.zero_()
    by_path = dict(flatten(grads))
    for path, i, p in leaf_views(model):
        g = by_path[path]
        p.grad = g if i is None else g[i]
    return grads
