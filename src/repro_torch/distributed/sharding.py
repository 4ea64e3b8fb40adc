"""Sharding policy: logical parameter/activation axes -> mesh axes (the
counterpart of ``repro/distributed/sharding.py``, rule for rule).

Baseline layout:
  params:  tensor parallelism on "model" (heads / ffn / experts / vocab /
           rnn; head_dim where the heads do not divide) and the per-expert
           ffn dim on "data"; replicated across "pod".
  train activations: batch over ("pod","data"), sequence over "model"
           between layers (sequence parallelism).
  decode caches: batch over ("pod","data") when divisible; kv_heads over
           "model" when divisible, else cache seq over "model";
           long-context (batch=1): cache seq over ("data","model").
  optimizer moments: the parameter's layout plus ZeRO-1 over "data".

A spec is a tuple with one entry per tensor dim, normalized as
``PartitionSpec`` normalizes it (trailing Nones dropped, a one-name tuple
the name): None, a mesh axis name, or a tuple of names (major first).
Rules are applied with divisibility checks and the constraint that a
mesh axis appears at most once per spec.  The policy
is arithmetic on a ``launch.mesh.Mesh`` (or anything with an ordered
``shape`` mapping); ``placements`` turns a spec into DTensor placements
on a ``DeviceMesh`` and ``distribute`` lays a tensor out by it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

Pytree = Any
Spec = Tuple[Any, ...]

# logical axis -> candidate mesh axes (first that divides wins).  The
# parameter layout is pure 2-D tensor parallelism: every large matmul dim
# that the computation can consume sharded (heads/ffn/vocab/experts/rnn on
# "model"; the per-expert ffn dim also on "data").
PARAM_RULES: Dict[Optional[str], Tuple[str, ...]] = {
    "embed": (),
    "vocab": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    # Fallback TP axis: when num_heads does not divide by the model axis
    # (llava 56, qwen2 28, whisper 20 on a 16-wide axis) the head_dim
    # (128/256/64, always divisible) carries the sharding.
    "head_dim": ("model",),
    "ffn": ("model",),
    "expert_ffn": ("data",),
    "experts": ("model",),
    "rnn": ("model",),
    "layers": (),
    "conv": (),
    "state": (),
    "classes": (),
    None: (),
}


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the counterpart of ``jax.sharding.NamedSharding``)."""
    mesh: Any
    spec: Spec


def _mesh_size(mesh, axis: str) -> int:
    return mesh.shape[axis] if axis in mesh.shape else 0


def _trim(entries: List[Any]) -> Spec:
    """A spec as ``PartitionSpec`` normalizes it: a one-axis tuple is the
    axis name, trailing Nones are dropped."""
    entries = [e[0] if isinstance(e, tuple) and len(e) == 1 else e
               for e in entries]
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def resolve_pspec(shape: Sequence[int], axes: Sequence[Optional[str]],
                  mesh, rules: Dict[Optional[str], Tuple[str, ...]]
                  = PARAM_RULES) -> Spec:
    """Logical axes -> spec, honouring divisibility and the
    one-mesh-axis-per-spec constraint (first dim that claims an axis keeps
    it; later dims fall back to replication)."""
    used = set()
    entries = []
    for dim, logical in zip(shape, axes):
        choice = None
        for cand in rules.get(logical, ()):  # first candidate that fits
            size = _mesh_size(mesh, cand)
            if size and dim % size == 0 and cand not in used:
                choice = cand
                used.add(cand)
                break
        entries.append(choice)
    return _trim(entries)


def _map_specs(bundle, fn) -> Pytree:
    from repro_torch.models.common import flatten, unflatten
    return unflatten([(path, fn(s)) for path, s in flatten(bundle.specs())])


def param_shardings(bundle, mesh) -> Pytree:
    """NamedSharding tree aligned with the bundle's param tree."""
    return _map_specs(bundle, lambda s: NamedSharding(
        mesh, resolve_pspec(s.shape, s.axes, mesh)))


def sharded_param_bytes(bundle, mesh) -> float:
    """Per-device parameter bytes under the sharding policy (spec
    arithmetic only; ``launch.dryrun`` re-exports it)."""
    import math
    from repro_torch.models.common import flatten
    total = 0.0
    dtype_bytes = 2 if bundle.cfg.dtype == "bfloat16" else 4
    for _, s in flatten(bundle.specs()):
        denom = 1
        for entry in resolve_pspec(s.shape, s.axes, mesh):
            if entry is None:
                continue
            for a in (entry if isinstance(entry, tuple) else (entry,)):
                denom *= mesh.shape[a]
        total += math.prod(s.shape) / denom * dtype_bytes
    return total


def batch_axes(mesh) -> Tuple[str, ...]:
    """Mesh axes the global batch shards over (pod major)."""
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def _batch_spec(mesh, batch: int):
    axes = batch_axes(mesh)
    total = 1
    for a in axes:
        total *= mesh.shape[a]
    return axes if axes and batch % total == 0 else None


def batch_shardings(bundle, mesh, input_specs: Dict[str, Any]
                    ) -> Dict[str, NamedSharding]:
    """Shardings for a train/prefill batch dict (leading dim = batch; the
    (B, T, d) frame and patch embeddings batch-sharded only)."""
    out = {}
    for name, t in input_specs.items():
        spec = [_batch_spec(mesh, t.shape[0])] + [None] * (len(t.shape) - 1)
        out[name] = NamedSharding(mesh, _trim(spec))
    return out


def activation_constraint(mesh, seq_shard: bool = True):
    """The two-point Megatron-SP constraint hook of training, ``h ->
    h``: the residual stream (a DTensor) redistributed to

    kind="carry": between layers, batch over ("pod","data") and sequence
      over "model" (what the sqrt(L) remat saves, so it must be small);
    kind="inner": inside a block right before the TP matmuls, the full
      sequence (the per-layer gather / reduce-scatter pair).

    A batch that does not divide over the batch axes stays whole (a
    long-context decode's batch of 1).  The identity when ``mesh`` is
    None, and on anything but a 3-D DTensor."""
    if mesh is None:
        return lambda h, kind="carry": h

    def constrain(h, kind: str = "carry"):
        from torch.distributed.tensor import DTensor
        if not isinstance(h, DTensor) or h.ndim != 3:
            return h
        seq_ax = None
        if kind == "carry" and seq_shard and "model" in mesh.shape and \
                h.shape[1] % mesh.shape["model"] == 0:
            seq_ax = "model"
        spec = _trim([_batch_spec(mesh, h.shape[0]), seq_ax])
        return h.redistribute(h.device_mesh,
                              placements(spec, h.device_mesh))

    return constrain


# ----------------------------------------------------------- cache policy ----
def cache_shardings(cfg, cache_abstract: Pytree, mesh,
                    long_context: bool = False) -> Pytree:
    """Shardings for a serving cache tree (matched by structure; the
    port's ``pos`` is a Python int, a 0-d leaf)."""
    b_ax = batch_axes(mesh)
    model_sz = _mesh_size(mesh, "model")
    total_b = 1
    for a in b_ax:
        total_b *= _mesh_size(mesh, a)

    def kv_spec(shape):
        # (L, B, S, KV, hd)
        _, b, s, kv, _ = shape
        batch_ok = b_ax and b % total_b == 0
        if long_context or not batch_ok:
            # batch unshardable: spread the sequence over everything
            seq_axes = tuple(a for a in ("data", "model") if a in mesh.shape
                             and s % _mesh_size(mesh, a) == 0)
            tot = 1
            for a in seq_axes:
                tot *= _mesh_size(mesh, a)
            seq_axes = seq_axes if tot and s % tot == 0 else ()
            return _trim([None, None, seq_axes or None])
        if model_sz and kv % model_sz == 0:
            return _trim([None, b_ax, None, "model"])
        if model_sz and s % model_sz == 0:
            return _trim([None, b_ax, "model"])
        return _trim([None, b_ax])

    def generic_spec(shape):
        if len(shape) == 5:             # KV cache (L,B,S,KV,hd)
            return kv_spec(shape)
        if len(shape) == 0:             # pos scalar
            return ()
        # recurrent / ssm states: (L, B, ...): trailing big dim on model
        bspec = b_ax if (len(shape) > 1 and b_ax and
                         shape[1] % max(total_b, 1) == 0) else None
        entries = [None, bspec] + [None] * (len(shape) - 2)
        if model_sz:
            for i in range(len(shape) - 1, 1, -1):
                if shape[i] % model_sz == 0 and shape[i] >= model_sz:
                    entries[i] = "model"
                    break
        return _trim(entries)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return NamedSharding(mesh, generic_spec(tuple(getattr(node, "shape",
                                                              ()))))
    return walk(cache_abstract)


def _zero1_spec(shard: NamedSharding, shape: Tuple[int, ...]
                ) -> NamedSharding:
    """ZeRO-1: additionally shard the first free dim over "data"."""
    mesh = shard.mesh
    if "data" not in mesh.shape:
        return shard
    dsz = mesh.shape["data"]
    entries = list(shard.spec) + [None] * (len(shape) - len(shard.spec))
    used = {a for e in entries if e is not None
            for a in (e if isinstance(e, tuple) else (e,))}
    if "data" in used:
        return shard
    for i, (dim, e) in enumerate(zip(shape, entries)):
        if e is None and dim % dsz == 0 and dim >= dsz:
            entries[i] = "data"
            return NamedSharding(mesh, _trim(entries))
    return shard


def opt_state_shardings(param_shardings_tree: Pytree,
                        params_abstract: Optional[Pytree]):
    """AdamW moments: param sharding + ZeRO-1 over "data"; step
    replicated.  ``params_abstract`` supplies leaf shapes for the ZeRO
    split; when None the moments just mirror the param shardings."""
    from repro_torch.models.common import flatten, unflatten
    from repro_torch.optim.adamw import AdamWState
    leaves = flatten(param_shardings_tree)
    mesh = leaves[0][1].mesh
    if params_abstract is None:
        mom = param_shardings_tree
    else:
        shapes = dict(flatten(params_abstract))
        mom = unflatten([(path, _zero1_spec(sh, tuple(shapes[path].shape)))
                         for path, sh in leaves])
    return AdamWState(step=NamedSharding(mesh, ()), mu=mom, nu=mom)


# ------------------------------------------------------------ DTensor side ---
def placements(spec: Spec, device_mesh) -> list:
    """A spec on a ``DeviceMesh`` as DTensor placements: ``Shard(dim)``
    on each mesh dim that tensor dim ``dim`` claims, ``Replicate()``
    elsewhere.  A dim claimed by several mesh axes is split major first,
    in the mesh's order, as a jax spec's tuple is.  A mesh dim of size 1
    splits nothing and stays ``Replicate()``: a one-card mesh then runs
    the unsharded model's ops, and DTensor's view rules (which refuse to
    flatten a split that is not leading, on any mesh size) never see
    it."""
    from torch.distributed.tensor import Replicate, Shard
    names = device_mesh.mesh_dim_names
    out = [Replicate() for _ in names]
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            i = names.index(a)
            if device_mesh.size(i) > 1:
                out[i] = Shard(dim)
    return out


def distribute(t: torch.Tensor, sharding: NamedSharding, device_mesh):
    """``t`` (the whole tensor, the same on every rank) laid out by
    ``sharding`` on ``device_mesh``: each rank keeps its shard, with no
    communication."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t, device_mesh,
                             placements(sharding.spec, device_mesh),
                             src_data_rank=None)


def contiguous_stride(shape: Sequence[int]) -> Tuple[int, ...]:
    """The row-major strides of a contiguous ``shape``."""
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def from_local(local: torch.Tensor, sharding: NamedSharding, device_mesh,
               shape: Sequence[int]):
    """The DTensor of global ``shape`` (contiguous) laid out by
    ``sharding`` whose shard on this rank is ``local``, with no
    communication."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, device_mesh,
                              placements(sharding.spec, device_mesh),
                              run_check=False, shape=torch.Size(shape),
                              stride=contiguous_stride(shape))


def whole(t: torch.Tensor) -> torch.Tensor:
    """A DTensor gathered whole (a collective every rank joins); any other
    tensor as it is."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def local_shape(shape: Sequence[int], spec: Spec, mesh) -> Tuple[int, ...]:
    """A rank's shard shape of a ``shape`` tensor laid out by ``spec``
    (every split divides, as the policy's divisibility rules ensure)."""
    out = list(shape)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            out[dim] //= mesh.shape[a]
    return tuple(out)


def coordinates(device_mesh) -> Dict[str, int]:
    """This rank's coordinate on each named dim of ``device_mesh``."""
    return dict(zip(device_mesh.mesh_dim_names, device_mesh.get_coordinate()))


def local_box(shape: Sequence[int], spec: Spec, mesh,
              coords: Dict[str, int]) -> Tuple[Tuple[int, int], ...]:
    """The (start, size) a dim of the shard of a ``shape`` tensor laid out
    by ``spec`` held at mesh coordinates ``coords`` (axis name -> index):
    a dim split over several axes is split major first in the mesh's
    order, as ``placements`` lays it out; its size is ``local_shape``'s."""
    box = []
    for dim, n in enumerate(shape):
        entry = spec[dim] if dim < len(spec) else None
        axes = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        index, parts = 0, 1
        for a in mesh.shape:
            if a in axes:
                index = index * mesh.shape[a] + coords[a]
                parts *= mesh.shape[a]
        box.append((index * (n // parts), n // parts))
    return tuple(box)


def spec_of(t) -> Spec:
    """The spec of a DTensor's layout (``placements``' inverse): each
    tensor dim's splitting mesh axes, major first.  A pending sum
    (``Partial``) or a strided shard has no spec and raises."""
    from torch.distributed.tensor import Replicate, Shard
    names = t.device_mesh.mesh_dim_names
    dims: List[List[str]] = [[] for _ in range(t.ndim)]
    for name, p in zip(names, t.placements):
        if type(p) is Shard:
            dims[p.dim % t.ndim].append(name)
        elif not isinstance(p, Replicate):
            raise ValueError(f"no spec for the placement {p} on {name!r}")
    return _trim([tuple(d) if d else None for d in dims])


def first_replica(spec: Spec, coords: Dict[str, int]) -> bool:
    """Whether the rank at mesh coordinates ``coords`` is the first of the
    ranks holding the same shard of a tensor laid out by ``spec``: at
    coordinate 0 on every mesh axis the spec does not split."""
    split = {a for e in spec if e is not None
             for a in (e if isinstance(e, tuple) else (e,))}
    return all(c == 0 for a, c in coords.items() if a not in split)


def param_boxes(bundle, mesh, coords: Dict[str, int]) -> Dict[str, Any]:
    """Each parameter's box ('/' path -> ``local_box``) at mesh
    coordinates ``coords`` under the policy's shardings: the shards one
    rank holds (``ModelBundle.init_local`` draws them alone)."""
    from repro_torch.models.common import flatten
    return {path: local_box(s.shape, resolve_pspec(s.shape, s.axes, mesh),
                            mesh, coords)
            for path, s in flatten(bundle.specs())}
