"""Multi-pod dry run (the counterpart of ``repro/launch/dryrun.py``): build
the step of every (architecture x input-shape x mesh) cell without
allocating, run it, and report what one chip does.

A cell's parameters, optimizer state, batch and cache are DTensors whose
local shards are ``meta`` tensors (shapes only), laid out by the sharding
policy on a ``DeviceMesh`` over torch's fake process group of 256 or 512
ranks in this one process (the counterpart of the reference's 512 forced
host devices); its collectives move nothing.  The train step (loss,
backward, ZeRO-1 AdamW), the prefill or the decode runs eagerly, op by
op, under ``CostRecorder``, which sees the ops each rank runs on its
local shards:

  * flops per chip: ``torch.utils.flop_counter``'s formulas on the local
    ops (a DTensor op counted once, at its local shape), held against
    ``expected_flops_per_chip`` (``expected_band``);
  * bytes per chip: the inputs and outputs of every local op that is not
    a view, unfused (no op's output is assumed to stay on chip): an upper
    bound, so the memory term that names the bottleneck is the analytic
    model's HBM bytes, the unfused one beside it;
  * collective bytes by kind: the result bytes of every functional
    collective (``_c10d_functional.*``), per chip (``collective_bytes``);
  * memory: the arguments' local bytes, the outputs' (those updated in
    place are aliases), and the peak of the local tensors the step
    creates and holds at once (temp).

The roofline denominators are the H100 SXM's data-sheet figures
(``launch.analytic``), no measurement: 989e12 dense bf16 FLOP/s,
3.35e12 B/s of HBM, and 450e9 B/s each way of NVLink for the collective
term.  One card has no link to measure, and a 16-wide mesh axis spans
two 8-card hosts whose link is slower than NVLink, so the collective
term is a lower bound.  The analytic model's terms
(``launch.analytic.cell_costs``) stand beside the counted ones.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] --json-out out.json
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k --smoke --mesh 4x2

Importing this module creates no process group and sets no environment
variable: ``fake_group`` (called by ``main`` and ``run_cell``) does, in
the process that runs the cells.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import weakref
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.distributed.sharding import (activation_constraint,
                                              batch_shardings,
                                              cache_shardings, from_local,
                                              local_shape,
                                              opt_state_shardings,
                                              param_shardings,
                                              sharded_param_bytes)
from repro_torch.launch.analytic import HBM_BW, NVLINK_BW, PEAK_FLOPS
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import common
from repro_torch.models.registry import SHAPES, ModelBundle, get_bundle
from repro_torch.optim import adamw

__all__ = ["CostRecorder", "collective_bytes", "sharded_param_bytes",
           "active_param_count", "lower_cell", "analyze", "run_cell",
           "fake_group", "expected_flops_per_chip", "expected_band",
           "FLOPS_TOL", "use_smoke_config", "main",
           "FIELDS"]

# What ``run_cell`` reports for every cell that ran (host_seconds: the
# step under the recorder; cell_seconds: the cell, its build included).
FIELDS = ("chips", "flops_per_chip", "bytes_per_chip",
          "collective_bytes_per_chip", "collectives", "memory",
          "roofline_seconds", "bottleneck", "model_flops_per_chip",
          "useful_flop_fraction", "analytic", "host_seconds",
          "cell_seconds")

_COLLECTIVES = {"all_gather_into_tensor": "all-gather",
                "all_gather_into_tensor_coalesced": "all-gather",
                "reduce_scatter_tensor": "reduce-scatter",
                "reduce_scatter_tensor_coalesced": "reduce-scatter",
                "all_reduce": "all-reduce",
                "all_reduce_coalesced": "all-reduce",
                "all_to_all_single": "all-to-all",
                "broadcast": "broadcast"}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


class CostRecorder(TorchDispatchMode):
    """Counts what the local ops of a DTensor program do.

    An op on DTensors is passed on (``NotImplemented``) to DTensor, which
    runs it as local ops on the shards; those come back here and are
    counted.  DTensor's shape propagation runs the op at its global shape
    on fake tensors: those calls are not counted."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flops = flop_registry
        self.flops = 0.0
        self.flops_by_op: Dict[str, float] = {}
        self.bytes = 0.0
        self.collectives: list = []      # (op name, result bytes)
        self.live = 0                    # bytes of storages made and held
        self.peak = 0
        self._refs: Dict[int, list] = {}

    def _track(self, out) -> None:
        """Hold each new storage's bytes until its last tensor dies."""
        for t in _tensors(out):
            key = t.untyped_storage()._cdata
            if key in self._refs:
                self._refs[key][0] += 1
            else:
                size = t.untyped_storage().nbytes()
                self._refs[key] = [1, size]
                self.live += size
                self.peak = max(self.peak, self.live)
            weakref.finalize(t, self._release, key)

    def _release(self, key: int) -> None:
        rec = self._refs.get(key)
        if rec is None:
            return
        rec[0] -= 1
        if rec[0] == 0:
            self.live -= rec[1]
            del self._refs[key]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        ins = _tensors((args, kwargs))
        if any(isinstance(t, FakeTensor) for t in ins + _tensors(out)):
            return out                   # DTensor's shape propagation
        name = func.__name__.split(".")[0]
        if func.namespace == "_c10d_functional":
            if name in _COLLECTIVES:
                self.collectives.append(
                    (name, sum(_nbytes(t) for t in _tensors(out))))
            return out
        packet = func._overloadpacket
        if packet in self._flops:
            f = float(self._flops[packet](*args, **kwargs, out_val=out))
            self.flops += f
            self.flops_by_op[name] = self.flops_by_op.get(name, 0.0) + f
        if not func.is_view:
            self.bytes += sum(_nbytes(t) for t in ins + _tensors(out))
            self._track(out)
        return out


def collective_bytes(records) -> Dict[str, float]:
    """Per-chip result bytes of each collective kind (the reference's
    names: all-gather, reduce-scatter, all-reduce, all-to-all) from a
    ``CostRecorder``'s (op name, bytes) records."""
    out: Dict[str, float] = {}
    for name, size in records:
        kind = _COLLECTIVES[name]
        out[kind] = out.get(kind, 0.0) + float(size)
    return out


def active_param_count(bundle: ModelBundle) -> int:
    """Active (per-token) params: an MoE counts k/E of its expert
    weights."""
    cfg = bundle.cfg
    total = 0
    for _, s in common.flatten(bundle.specs()):
        n = math.prod(s.shape)
        if "experts" in s.axes and cfg.num_experts:
            n = int(n * cfg.experts_per_token / cfg.num_experts)
        total += n
    return total


# A step's counted flops per chip keep within this share of
# ``expected_flops_per_chip`` (``expected_band``): the reduced cells count
# 0.989-1.031 of it, qwen3-4b x train_4k at 16 x 16 0.965 on torch 2.11.
FLOPS_TOL = 0.2


def _train_layer_passes(n: int) -> float:
    """Forward passes of a layer per train step, averaged over ``n``
    layers under ``transformer._two_level``'s remat: the forward, the
    backward's two, the layer's own recompute, and the group's recompute,
    which stops after the group's last layer input (k - 1 of its k
    layers); the L - (L // k) k layers outside the groups are
    checkpointed once."""
    if n == 0:
        return 0.0
    k = math.ceil(math.sqrt(n))
    grouped = (n // k) * k
    return (grouped * (4 + (k - 1) / k) + (n - grouped) * 4) / n


def expected_band() -> Tuple[float, float]:
    """(low, high) of counted / ``expected_flops_per_chip``: 1 -+
    FLOPS_TOL for every step.  A train step's layouts are pinned (the
    batch's, the parameters', the activation constraint between layers),
    and a prefill's and a decode's the same way (the constraint threaded
    through ``bundle.prefill``/``decode``, decode attention on local
    shards), so no product runs whole on every rank of "model"."""
    return 1 - FLOPS_TOL, 1 + FLOPS_TOL


def expected_flops_per_chip(cfg, shape, mesh) -> float:
    """The flops one chip's step should count, built from the analytic
    model's parts (``launch.analytic``) with the port's own rules:

      * attention: every query attends every key of its sequence, masked,
        none skipped (the analytic model counts S/2, or the window); a
        decode reads the cache's filled slots (the ring's window, or all
        S); where the heads do not split over "model" (the policy's
        head_dim fallback), attention runs whole on each of its ranks;
      * train: a layer runs ``_train_layer_passes`` forward passes where
        the model counts 4, the hybrid's checkpointed units 4; the
        chunked logits 4 (forward, recompute, backward's two) and the
        one-hot embedding backward one more logits' worth;
      * prefill and decode: one forward, the logits of one token a row;
      * replication: a batch that does not split over the batch axes runs
        whole on each of their ranks;
      * MoE: each expert computes its capacity's slots, E C / g a token
        (C at group g = the sequence, 1 in a decode), and the router;
      * the SSM's and RG-LRU's matrix products as the model counts them
        (their convolution and elementwise terms are not products); an
        SSM decode's state terms at the split the cache policy gives the
        state (``_state_split``);
    Elementwise work is no product and counted by neither."""
    from repro_torch.launch import analytic as A
    b, s = shape.global_batch, shape.seq_len
    decode = shape.kind == "decode"
    n_g, n_l, n_m = A._layer_mix(cfg)
    d, h, kv = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    hd = cfg.resolved_head_dim
    model_n = mesh.shape.get("model", 1)
    whole_attn = model_n if h % model_n else 1
    proj = 2 * d * (h + 2 * kv) * hd + 2 * h * hd * d

    def scores(keys):
        return 4 * h * hd * keys * whole_attn

    keys_l = s
    ring = (cfg.family == "hybrid" or (cfg.windowed_decode_cache and
                                       cfg.window_size and
                                       cfg.local_global_pattern))
    if decode and ring:
        keys_l = min(cfg.window_size, s)
    attn_layers = (n_g + n_l) * proj + n_g * scores(s) + n_l * scores(keys_l)
    state_terms = 0.0
    if cfg.family == "ssm":
        q, n, hh, p = cfg.ssm_chunk, cfg.ssm_state, cfg.ssm_heads, \
            cfg.ssm_head_dim
        din = cfg.ssm_inner
        mix = 2 * d * (2 * din + 2 * n + hh)
        if decode:
            # The state's product and the output projection of its heads
            # run on the state's layout, which the cache policy may split
            # over "data" too (a batch-1 state's heads over ("data",
            # "model")): counted apart, at that layout's split.
            state_terms = b * n_m * (2 * hh * p * n + 2 * din * d) / \
                _state_split(cfg, b, mesh)
        else:
            mix += 2 * din * d + 2 * q * n + 2 * q * hh * p + \
                4 * n * hh * p
        layers = n_m * mix
    elif cfg.family == "hybrid":
        r = cfg.rnn_width
        layers = attn_layers + n_m * (2 * d * r * 2 + 2 * r * r * 2 +
                                      2 * r * d) + \
            cfg.num_layers * A._mlp_flops_per_token(cfg)
    elif cfg.family == "moe":
        g = min(cfg.moe_group_size, 1 if decode else s)
        e = cfg.num_experts
        cap = max(int(g * cfg.experts_per_token * cfg.moe_capacity_factor /
                      e), cfg.experts_per_token)
        layers = attn_layers + (n_g + n_l) * (
            2 * d * e + e * cap / g * 3 * 2 * d * cfg.d_ff)
    else:
        layers = attn_layers + (n_g + n_l) * A._mlp_flops_per_token(cfg)
    if cfg.family == "encdec":
        t = cfg.encoder_seq
        enc = cfg.encoder_layers * (proj + 4 * h * hd * t * whole_attn +
                                    A._mlp_flops_per_token(cfg))
        cross_q_o = 2 * d * h * hd * 2
        cross_kv = 2 * d * 2 * kv * hd
        layers += cfg.num_layers * (cross_q_o + scores(t))
        if not decode:
            layers += (cfg.num_layers * cross_kv + enc) * t / s
    logits = 2 * d * cfg.vocab_size
    if shape.kind == "train":
        passes = 4.0 if cfg.family == "hybrid" else \
            _train_layer_passes(cfg.num_layers)
        total = b * s * (passes * layers + 5 * logits)
        if cfg.family == "encdec":
            total += b * t * (_train_layer_passes(cfg.encoder_layers) - 1) \
                * enc
    elif shape.kind == "prefill":
        total = b * s * layers + b * logits
    else:
        total = b * (layers + logits)
    batch_n = math.prod(mesh.shape.get(a, 1) for a in ("pod", "data"))
    if b % batch_n:
        total *= batch_n
    return total / mesh.size + state_terms


def _state_split(cfg, batch: int, mesh) -> int:
    """The ranks over which ``sharding.cache_shardings`` splits an SSM
    decode's state (L, B, H, P, N)."""
    from repro_torch.models import ssd
    st = ssd.ssd_init_state(cfg, batch, cfg.compute_dtype, "meta")["ssm"]
    spec = cache_shardings(cfg, {"ssm": st.expand((cfg.num_layers,) +
                                                  st.shape)}, mesh,
                           long_context=batch == 1)["ssm"].spec
    return math.prod(mesh.shape[a] for e in spec if e is not None
                     for a in (e if isinstance(e, tuple) else (e,)))


# ------------------------------------------------------------ fake state ----
def fake_group(world: int) -> None:
    """Join torch's fake process group of ``world`` ranks (this process is
    rank 0; its collectives move nothing), leaving any other group."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _meta(shape, dtype, sharding, dm):
    """A DTensor of ``shape`` laid out by ``sharding`` whose local shard is
    a meta tensor."""
    local = torch.empty(local_shape(shape, sharding.spec, sharding.mesh),
                        dtype=dtype, device="meta")
    return from_local(local, sharding, dm, shape)


def _meta_tree(like: Any, shardings: Any, dm, dtype=None):
    """``_meta`` of each leaf of ``like`` by its sharding; a 0-d or int
    leaf as it is."""
    sh = dict(common.flatten(shardings))
    out = []
    for path, leaf in common.flatten(like):
        if not isinstance(leaf, torch.Tensor) or leaf.dim() == 0:
            out.append((path, leaf))
        else:
            out.append((path, _meta(leaf.shape, dtype or leaf.dtype,
                                    sh[path], dm)))
    return common.unflatten(out)


class Lowered:
    """One cell's step, ready to run: ``fn()`` runs it once; ``args`` are
    its inputs' trees and ``outputs(result)`` its outputs', both of
    DTensors.  Every step updates its inputs in place (the parameters and
    moments, or the cache), so its outputs alias them."""

    def __init__(self, fn: Callable[[], Any], args: Any,
                 outputs: Callable[[Any], Any]):
        self.fn, self.args, self.outputs = fn, args, outputs


def _local_bytes(tree) -> float:
    total = 0.0
    for t in _tensors(tree):
        total += _nbytes(getattr(t, "_local_tensor", t))
    return total


# --------------------------------------------------------------- lowering ----
def lower_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
               mesh=None, seq_shard: bool = True
               ) -> Tuple[Optional[Lowered], Dict[str, Any]]:
    """The step of one cell on ``mesh`` (the production mesh by default)
    over the fake group of the mesh's size, or (None, why) for a cell the
    architecture does not support."""
    bundle = get_bundle(arch)
    shape = SHAPES[shape_name]
    ok, why = bundle.supports(shape)
    if not ok:
        return None, {"arch": arch, "shape": shape_name, "skipped": why}
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    fake_group(mesh.size)
    dm = mesh.device_mesh("cpu")
    p_shard = param_shardings(bundle, mesh)
    params_abs = bundle.abstract()
    info: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                            "mesh": dict(mesh.shape),
                            "params": bundle.param_count(),
                            "active_params": active_param_count(bundle)}
    from repro_torch.models.registry import build
    tree = _meta_tree(params_abs, p_shard, dm)
    model = build(bundle.cfg, tree)
    ins = bundle.input_specs(shape)
    b_shard = batch_shardings(bundle, mesh, ins)
    batch = {k: _meta(v.shape, v.dtype, b_shard[k], dm)
             for k, v in ins.items()}

    if shape.kind == "train":
        from repro_torch.training.trainer import zero1_apply
        opt_shard = opt_state_shardings(p_shard, params_abs)
        opt = adamw.AdamWState(
            step=torch.zeros((), dtype=torch.int32),
            mu=_meta_tree(params_abs, opt_shard.mu, dm),
            nu=_meta_tree(params_abs, opt_shard.nu, dm, torch.float32))
        ocfg = adamw.AdamWConfig()
        constrain = activation_constraint(mesh, seq_shard)
        model.requires_grad_(True)

        def train_step():
            with _replicated():
                grads = common.zero_grads(model)
                loss = bundle.loss(model, batch, constrain)
                loss.backward()
                gnorm = adamw.global_norm(grads).full_tensor()
            state = zero1_apply(ocfg, grads, opt, model.tree, gnorm)
            return loss.detach(), state

        lowered = Lowered(train_step, (tree, opt, batch),
                          lambda out: (tree, out[1], out[0]))
        tokens = shape.global_batch * shape.seq_len
        info["model_flops"] = 6 * info["active_params"] * tokens
    else:
        b, s = shape.global_batch, shape.seq_len
        cache_like = bundle.init_cache(b, s, device="meta")
        c_shard = cache_shardings(bundle.cfg, cache_like, mesh,
                                  long_context=b == 1)
        cache = _meta_tree(cache_like, c_shard, dm)
        constrain = activation_constraint(mesh, seq_shard)

        if shape.kind == "prefill":
            extra = batch.get("patch_embeds", batch.get("frame_embeds"))

            def step():
                with _replicated():
                    return bundle.prefill(model, batch["tokens"], cache,
                                          extra, constrain)
            tokens = b * s
            info["model_flops"] = 2 * info["active_params"] * tokens
        else:
            # one new token against a full cache: the port's decode reads
            # the cache up to its Python-int position
            cache["pos"] = s - 1

            def step():
                with _replicated():
                    return bundle.decode(model, cache, batch["token"],
                                         constrain)
            info["model_flops"] = 2 * info["active_params"] * b
        lowered = Lowered(step, (tree, cache, batch), lambda out: out)
    return lowered, info


def _replicated():
    """DTensor's implicit replication of the plain tensors a step makes
    (positions, masks, constants)."""
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def analyze(lowered: Lowered, info: Dict[str, Any]) -> Dict[str, Any]:
    """Run the cell's step once under ``CostRecorder`` and fill in the
    per-chip terms, memory and the analytic model beside them."""
    import time
    chips = math.prod(info["mesh"].values())
    rec = CostRecorder()
    t0 = time.perf_counter()
    with rec:
        out = lowered.fn()
    host = time.perf_counter() - t0
    coll = collective_bytes(rec.collectives)
    coll_total = sum(coll.values())
    args_b = _local_bytes(lowered.args)
    out_b = _local_bytes(lowered.outputs(out))
    from repro_torch.launch import analytic
    from repro_torch.models.registry import get_config
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh(tuple(info["mesh"].values()), tuple(info["mesh"]))
    cfg, shape = get_config(info["arch"]), SHAPES[info["shape"]]
    costs = analytic.cell_costs(cfg, shape, chips, mesh=mesh)
    expected = expected_flops_per_chip(cfg, shape, mesh)
    a_terms = {"compute": costs.flops_per_chip / PEAK_FLOPS,
               "memory": costs.hbm_bytes_per_chip / HBM_BW,
               "collective": costs.coll_bytes_per_chip / NVLINK_BW}
    # The counted bytes are every eager op's inputs and outputs, unfused:
    # an upper bound, ~1,000x the HBM traffic of a fused step, which would
    # name memory the bottleneck of every cell.  The memory term that
    # names it is the analytic model's HBM bytes; the unfused one stands
    # beside it, labelled.
    terms = {"compute": rec.flops / PEAK_FLOPS,
             "memory": a_terms["memory"],
             "collective": coll_total / NVLINK_BW}
    info.update({
        "chips": chips,
        "flops_per_chip": rec.flops,
        "flops_by_op": rec.flops_by_op,
        "bytes_per_chip": rec.bytes,
        "collective_bytes_per_chip": coll_total,
        "collectives": coll,
        "memory": {"argument_bytes": args_b, "output_bytes": out_b,
                   "temp_bytes": float(rec.peak),
                   "alias_bytes": out_b},
        "roofline_seconds": {**terms, "memory_unfused_upper_bound":
                             rec.bytes / HBM_BW},
        "bottleneck": max(terms, key=terms.get),
        "model_flops_per_chip": info["model_flops"] / chips,
        "useful_flop_fraction": (info["model_flops"] / chips / rec.flops
                                 if rec.flops else 0.0),
        "host_seconds": host,
    })
    info["analytic"] = {
        "flops_per_chip": costs.flops_per_chip,
        "hbm_bytes_per_chip": costs.hbm_bytes_per_chip,
        "coll_bytes_per_chip": costs.coll_bytes_per_chip,
        "roofline_seconds": a_terms,
        "bottleneck": max(a_terms, key=a_terms.get),
        "mfu_bound": (info["model_flops"] / chips / PEAK_FLOPS) /
                     max(a_terms.values()),
        "flops_ratio": rec.flops / costs.flops_per_chip,
        "expected_flops_per_chip": expected,
        "counted_over_expected": rec.flops / expected,
        "expected_band": expected_band(),
    }
    return info


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             mesh=None, seq_shard: bool = True,
             verbose: bool = True) -> Dict[str, Any]:
    import time
    t0 = time.perf_counter()
    lowered, info = lower_cell(arch, shape_name, multi_pod=multi_pod,
                               mesh=mesh, seq_shard=seq_shard)
    if lowered is None:
        if verbose:
            print(f"[skip] {arch} x {shape_name}: {info['skipped']}")
        return info
    info = analyze(lowered, info)
    info["cell_seconds"] = time.perf_counter() - t0
    if verbose:
        t = info["roofline_seconds"]
        print(f"[ok] {arch} x {shape_name} mesh={info['mesh']} "
              f"flops/chip={info['flops_per_chip']:.3e} "
              f"bytes/chip={info['bytes_per_chip']:.3e} (unfused) "
              f"coll/chip={info['collective_bytes_per_chip']:.3e} "
              f"terms(ms)=[c {1e3*t['compute']:.2f} | m {1e3*t['memory']:.2f}"
              f" (analytic; unfused <= "
              f"{1e3*t['memory_unfused_upper_bound']:.0f})"
              f" | x {1e3*t['collective']:.2f}] bound={info['bottleneck']} "
              f"useful={info['useful_flop_fraction']:.3f} "
              f"host={info['host_seconds']:.1f}s")
        m = info["memory"]
        print(f"     memory/chip: args={m['argument_bytes']/1e9:.2f}GB "
              f"temps={m['temp_bytes']/1e9:.2f}GB "
              f"outputs={m['output_bytes']/1e9:.2f}GB "
              f"aliased={m['alias_bytes']/1e9:.2f}GB")
        a = info["analytic"]
        t = a["roofline_seconds"]
        print(f"     analytic: flops/chip={a['flops_per_chip']:.3e} "
              f"terms(ms)=[c {1e3*t['compute']:.2f} | m "
              f"{1e3*t['memory']:.2f} | x {1e3*t['collective']:.2f}] "
              f"bound={a['bottleneck']} mfu_bound={a['mfu_bound']:.3f} "
              f"counted/analytic flops={a['flops_ratio']:.3f}, "
              f"counted/expected {a['counted_over_expected']:.3f}")
    return info


def use_smoke_config(arch: str, shape_name: str) -> None:
    """Register ``arch``'s smoke config under its name, its max_seq raised
    to cover the cell (a reduced cell, as the reference's tests cut it)."""
    from repro_torch.configs import smoke_config
    from repro_torch.models.registry import _REGISTRY
    cfg = smoke_config(arch).scaled(
        max_seq=600_000 if shape_name == "long_500k" else 40_000)
    _REGISTRY[arch] = lambda cfg=cfg: cfg


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None,
                    choices=list(SHAPES) + [None])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--no-seq-shard", action="store_true")
    ap.add_argument("--json-out", type=str, default=None)
    ap.add_argument("--mesh", type=str, default=None,
                    help='a reduced mesh, "4x2" => ("data","model"), in '
                         "place of the production one")
    ap.add_argument("--smoke", action="store_true",
                    help="each architecture's smoke config under its name "
                         "(max_seq raised to the cell's), as the reduced-"
                         "mesh tests run it")
    args = ap.parse_args(argv)

    from repro_torch.configs import ASSIGNED_ARCHS
    if args.all:
        cells = [(arch, shape) for arch in ASSIGNED_ARCHS for shape in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells = [(args.arch, args.shape)]

    mesh = None
    if args.mesh:
        from repro_torch.launch.train import parse_mesh
        mesh = parse_mesh(args.mesh)
    results = []
    for arch, shape in cells:
        try:
            if args.smoke:
                use_smoke_config(arch, shape)
            results.append(run_cell(arch, shape, multi_pod=args.multi_pod,
                                    mesh=mesh,
                                    seq_shard=not args.no_seq_shard))
        except Exception as e:   # a failing cell is a bug: surface it
            import traceback
            traceback.print_exc()
            print(f"[FAIL] {arch} x {shape}: {type(e).__name__}: {e}",
                  file=sys.stderr)
            results.append({"arch": arch, "shape": shape,
                            "error": f"{type(e).__name__}: {e}"})
    if dist.is_initialized():
        dist.destroy_process_group()
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(results, f, indent=1, default=str)
    failed = [r for r in results if "error" in r]
    print(f"\n{len(results) - len(failed)}/{len(results)} cells passed")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
