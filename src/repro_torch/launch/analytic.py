"""Analytic cost model: flops, HBM bytes and collective bytes of one step
of a cell from the architecture config alone (the counterpart of
``repro/launch/analytic.py``, copied; the roofline, the dry run and the
serving phases divide by it).  The parameter bytes per chip are the
sharding policy's count over the given mesh, else the production mesh
of ``chips`` (``distributed.sharding.sharded_param_bytes``), as the
reference's dry run computes them.

Conventions:
  * flops count multiply-adds as 2 ops; attention counts QK^T + PV.
  * train multiplier: fwd + bwd(2x) + sqrt-L remat recompute (~1x) = 4x fwd.
  * per-chip = global / chips for flops (both batch and TP split work);
    HBM bytes and collective bytes are modeled per chip directly.
  * collective model (per chip): Megatron-SP pattern per layer =
    all-gather(h_full) + reduce-scatter(h_full) per matmul block pair, plus
    the DP gradient all-reduce (2x param bytes, ring), plus MoE
    dispatch/return gathers.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

from repro_torch.distributed.sharding import sharded_param_bytes
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.common import ModelConfig
from repro_torch.models.registry import ModelBundle, ShapeSpec

BF16 = 2
F32 = 4

# Roofline denominators: the H100 SXM's data-sheet figures, per card.
PEAK_FLOPS = 989e12          # dense bf16 FLOP/s
HBM_BW = 3.35e12             # HBM3 bytes/s
NVLINK_BW = 450e9            # NVLink bytes/s each way (a lower bound on a
                             # collective's time: one card has no link to
                             # measure, and a 16-wide axis spans two hosts)


@dataclasses.dataclass
class CellCosts:
    flops_per_chip: float
    hbm_bytes_per_chip: float
    coll_bytes_per_chip: float
    detail: Dict[str, float]


def _attn_flops_per_token(cfg: ModelConfig, s_eff: float) -> float:
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
        cfg.resolved_head_dim
    proj = 2 * d * (h + 2 * kv) * hd + 2 * h * hd * d
    attn = 4 * h * hd * s_eff            # QK^T + PV
    return proj + attn


def _mlp_flops_per_token(cfg: ModelConfig) -> float:
    mats = 3 if cfg.mlp_type == "swiglu" else 2
    return 2 * mats * cfg.d_model * cfg.d_ff


def _moe_flops_per_token(cfg: ModelConfig) -> float:
    d, f, e, k = cfg.d_model, cfg.d_ff, cfg.num_experts, cfg.experts_per_token
    router = 2 * d * e
    experts = k * 3 * 2 * d * f
    dispatch = 4 * k * cfg.moe_capacity_factor * d      # dispatch+combine
    return router + experts + dispatch


def _ssd_flops_per_token(cfg: ModelConfig) -> float:
    d, din, n = cfg.d_model, cfg.ssm_inner, cfg.ssm_state
    h, p, q = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_chunk
    proj = 2 * d * (2 * din + 2 * n + h) + 2 * din * d
    conv = 2 * cfg.ssm_conv * (din + 2 * n)
    # intra-chunk dual form: CB^T (Q*N) + (w .* L) x (Q*H*P) per token
    intra = 2 * q * n + 2 * q * h * p / max(h, 1) * h   # = 2qN + 2qHP
    states = 4 * n * h * p                              # build + apply state
    return proj + conv + intra + states


def _rglru_flops_per_token(cfg: ModelConfig) -> float:
    d, r = cfg.d_model, cfg.rnn_width
    return 2 * d * r * 2 + 2 * r * r * 2 + 10 * r + 2 * r * d


def _layer_mix(cfg: ModelConfig):
    """(n_global_attn, n_local_attn, n_mix) layer counts by kind."""
    n = cfg.num_layers
    if cfg.family == "ssm":
        return 0, 0, n
    if cfg.family == "hybrid":
        n_attn = n // cfg.attn_every
        return 0, n_attn, n - n_attn
    if cfg.local_global_pattern:
        pat = cfg.local_global_pattern + 1
        n_global = n // pat
        return n_global, n - n_global, 0
    return n, 0, 0


def cell_costs(cfg: ModelConfig, shape: ShapeSpec, chips: int,
               mesh_model: int = 16, mesh_data: int = 16,
               mesh=None) -> CellCosts:
    if mesh is not None:
        mesh_model = mesh.shape.get("model", 1)
        mesh_data = mesh.shape.get("data", 1)
        chips = 1
        for v in mesh.shape.values():
            chips *= v
    b, s = shape.global_batch, shape.seq_len
    n_g, n_l, n_m = _layer_mix(cfg)
    d = cfg.d_model

    # ----------------------------------------------------- flops per token --
    def fwd_flops_per_token(s_ctx: float) -> float:
        # causal: mean attended length = s/2 (global), ~window (local)
        f = 0.0
        f += n_g * _attn_flops_per_token(cfg, s_ctx / 2.0)
        f += n_l * _attn_flops_per_token(
            cfg, min(cfg.window_size or s_ctx, s_ctx / 2.0))
        if cfg.family == "ssm":
            f += n_m * _ssd_flops_per_token(cfg)
        elif cfg.family == "hybrid":
            f += n_m * _rglru_flops_per_token(cfg)
            f += cfg.num_layers * _mlp_flops_per_token(cfg)
        elif cfg.family == "moe":
            f += (n_g + n_l) * _moe_flops_per_token(cfg)
        else:
            f += (n_g + n_l) * _mlp_flops_per_token(cfg)
        if cfg.family == "encdec":
            # encoder (bidirectional, full S_enc) amortized per decoder token
            enc = cfg.encoder_layers * (
                _attn_flops_per_token(cfg, cfg.encoder_seq) +
                _mlp_flops_per_token(cfg)) * cfg.encoder_seq / max(s, 1)
            cross = cfg.num_layers * 4 * cfg.num_heads * \
                cfg.resolved_head_dim * cfg.encoder_seq
            f += enc + cross
        return f

    logits_flops = 2 * d * cfg.vocab_size

    if shape.kind == "train":
        tokens = b * s
        total = 4.0 * tokens * (fwd_flops_per_token(s) + logits_flops)
    elif shape.kind == "prefill":
        tokens = b * s
        total = tokens * fwd_flops_per_token(s) + b * logits_flops
    else:  # decode: context length = s
        tokens = b
        total = tokens * (fwd_flops_per_token_decode(cfg, s, n_g, n_l, n_m)
                          + logits_flops)
    flops_per_chip = total / chips

    # -------------------------------------------------- HBM bytes per chip --
    m = mesh if mesh is not None else \
        make_production_mesh(multi_pod=(chips == 512))
    param_bytes_chip = sharded_param_bytes(ModelBundle(cfg), m)

    if shape.kind == "train":
        # fwd+bwd read params twice, opt reads/writes moments + params
        opt_bytes = param_bytes_chip * (1 + 2 + 2)   # mu bf16, nu f32 r/w
        act = (b / mesh_data / (2 if chips == 512 else 1)) * s * d * BF16
        act_traffic = act * cfg.num_layers * 6 / max(mesh_model, 1)
        hbm = 3 * param_bytes_chip + opt_bytes + act_traffic
    elif shape.kind == "prefill":
        cache_bytes = _cache_bytes_per_chip(cfg, b, s, chips)
        act = (b * s * d * BF16) / chips
        hbm = param_bytes_chip + cache_bytes + act * cfg.num_layers * 4
    else:
        cache_bytes = _cache_bytes_per_chip(cfg, b, s, chips)
        hbm = param_bytes_chip + cache_bytes
    # ----------------------------------------------- collective bytes/chip --
    if shape.kind == "train":
        h_local = (b / mesh_data / (2 if chips == 512 else 1)) * s * d * BF16
        per_layer = 2 * 2 * h_local            # AG + RS per block pair
        coll = per_layer * cfg.num_layers * 3   # fwd + 2x bwd
        coll += 2 * param_bytes_chip            # DP/pod grad all-reduce
        if cfg.family == "moe":
            coll += cfg.num_layers * 3 * 2 * h_local  # dispatch gathers
    elif shape.kind == "prefill":
        h_local = (b * s / chips) * d * BF16
        coll = 2 * 2 * h_local * cfg.num_layers
    else:
        coll = 2 * b * d * BF16 * cfg.num_layers / max(mesh_data, 1) + \
            b * cfg.vocab_size * F32 / max(chips, 1)
    return CellCosts(flops_per_chip=flops_per_chip,
                     hbm_bytes_per_chip=hbm,
                     coll_bytes_per_chip=coll,
                     detail={"param_bytes_per_chip": param_bytes_chip,
                             "tokens": tokens})


def fwd_flops_per_token_decode(cfg: ModelConfig, s_ctx: int,
                               n_g: int, n_l: int, n_m: int) -> float:
    """Decode reads the whole cache: attention cost is linear in context."""
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
        cfg.resolved_head_dim
    proj = 2 * d * (h + 2 * kv) * hd + 2 * h * hd * d
    f = (n_g + n_l) * proj
    f += n_g * 4 * h * hd * s_ctx
    f += n_l * 4 * h * hd * min(cfg.window_size or s_ctx, s_ctx)
    if cfg.family == "ssm":
        f += n_m * _ssd_flops_per_token(cfg)
    elif cfg.family == "hybrid":
        f += n_m * _rglru_flops_per_token(cfg)
        f += cfg.num_layers * _mlp_flops_per_token(cfg)
    elif cfg.family == "moe":
        f += (n_g + n_l) * _moe_flops_per_token(cfg)
    else:
        f += (n_g + n_l) * _mlp_flops_per_token(cfg)
    if cfg.family == "encdec":
        f += cfg.num_layers * 4 * h * hd * cfg.encoder_seq   # cross attn
    return f


def _cache_bytes_per_chip(cfg: ModelConfig, b: int, s: int,
                          chips: int) -> float:
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    if cfg.family == "ssm":
        per = cfg.num_layers * b * (cfg.ssm_heads * cfg.ssm_head_dim *
                                    cfg.ssm_state + 3 *
                                    (cfg.ssm_inner + 2 * cfg.ssm_state))
        return per * BF16 / min(chips, 16)
    if cfg.family == "hybrid":
        n_attn = cfg.num_layers // cfg.attn_every
        win = min(cfg.window_size or s, s)
        kv_b = 2 * n_attn * b * win * kv * hd
        rec = (cfg.num_layers - n_attn) * b * cfg.rnn_width * (F32 + 3 * BF16)
        return (kv_b * BF16 + rec) / min(chips, 256)
    n_layers = cfg.num_layers
    if cfg.windowed_decode_cache and cfg.window_size and \
            cfg.local_global_pattern:
        pat = cfg.local_global_pattern + 1
        n_g = n_layers // pat
        n_l = n_layers - n_g
        win = min(cfg.window_size, s)
        total = 2 * b * kv * hd * (n_g * s + n_l * win) * BF16
        return total / min(chips, 256)
    total = 2 * n_layers * b * s * kv * hd * BF16
    if cfg.family == "encdec":
        total += 2 * n_layers * b * cfg.encoder_seq * kv * hd * BF16
    return total / min(chips, 256)
