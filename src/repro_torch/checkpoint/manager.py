"""Checkpoint/restart substrate (the counterpart of
``repro/checkpoint/manager.py``, same layout on disk).

A state tree (nested dicts of tensors; an ``AdamWState`` as its fields
``step``, ``mu``, ``nu``) -> one .npy per leaf plus a JSON manifest (leaf
names, shapes, dtypes, step).  Leaf names are '/'-joined paths
(``params/layers/attn/wq``, ``opt/mu/...``, ``opt/step``).  Writes go to a
temp directory that is renamed into place, so a worker dying mid-save
never corrupts the latest checkpoint.  ``async_save`` snapshots to host
memory at once and writes on a thread.  numpy has no bfloat16: a bf16
leaf is stored as its 16-bit patterns (uint16) with ``"bfloat16"`` in the
manifest, as the reference stores it, so either package reads the
other's files.

Sharded state (DTensor leaves, ``Trainer(mesh=...)``) is saved into the
same files and bits as an unsharded save of the same values (the
reference's layout: one whole-shape .npy a leaf, which it writes from
``np.asarray`` of each leaf), and no leaf is ever whole on any rank:
  1. rank 0 of the default group makes the temp directory and every
     leaf's file at its whole shape and saved dtype (``create_files``);
  2. the ranks agree (``_agree``: a barrier that also carries failures);
  3. each rank writes its local shard into its box of each file
     (``write_part``: ``sharding.local_box`` at its mesh coordinates,
     through a memory map), one replica of each box only: the rank at
     coordinate 0 on every mesh axis the leaf's spec does not split
     (``sharding.first_replica``), so a replicated leaf is written once;
  4. the maps are flushed, and the ranks agree;
  5. rank 0 writes the manifest and renames the directory into place
     (``publish``), runs gc, and a last agreement follows.
A failure on any rank fails the save on every rank at the next
agreement; nothing falls back to gathering.  ``async_save`` copies only
the boxes this rank writes to host memory and does steps 1-2 before it
returns, step 3 on a thread; ``wait`` joins the thread and does 4-5 (no
collective runs on the thread).  ``write_part`` takes the coordinates
explicitly, so one process can write any rank's part.  Every rank must
see the same directory on a filesystem where several processes' writes
to disjoint bytes of a file all land (a local disk, a parallel
filesystem).

``restore(step, like, shardings)`` lays each leaf out by the given
shardings (``distributed.sharding.NamedSharding``, on the mesh of
``like``'s DTensor leaf, else the sharding's own mesh), which may be
another mesh than the one that saved: elastic restore.  Each rank reads
only its shard's box of each file (``read_box``, memory-mapped).
"""
from __future__ import annotations

import json
import math
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import (Spec, coordinates,
                                              first_replica, local_box,
                                              spec_of)

Pytree = Any
# One leaf of a rank's part: its local shard and its spec (None where the
# rank writes no box of it).
Part = Optional[Tuple[torch.Tensor, Spec]]

_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "bfloat16": torch.bfloat16, "float16": torch.float16,
           "int32": torch.int32, "int64": torch.int64, "uint8": torch.uint8,
           "int8": torch.int8, "bool": torch.bool}
_NAMES = {v: k for k, v in _DTYPES.items()}


def _flatten_with_names(tree: Pytree, prefix: str = ""
                        ) -> List[Tuple[str, Any]]:
    """(name, leaf) pairs: dict keys sorted, a NamedTuple by its fields."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(_flatten_with_names(tree[k], f"{prefix}{k}/"))
        return out
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out = []
        for k in tree._fields:
            out.extend(_flatten_with_names(getattr(tree, k), f"{prefix}{k}/"))
        return out
    return [(prefix[:-1], tree)]


def _unflatten_like(like: Pytree, leaves: dict, prefix: str = "") -> Pytree:
    if isinstance(like, dict):
        return {k: _unflatten_like(v, leaves, f"{prefix}{k}/")
                for k, v in like.items()}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_unflatten_like(getattr(like, k), leaves,
                                            f"{prefix}{k}/")
                            for k in like._fields))
    return leaves[prefix[:-1]]


def _is_sharded(state: Pytree) -> bool:
    return any(hasattr(leaf, "device_mesh")
               for _, leaf in _flatten_with_names(state))


def _to_host(leaf) -> Tuple[np.ndarray, str]:
    """A leaf as a savable numpy array and its logical dtype name."""
    t = torch.as_tensor(leaf).detach()
    name = _NAMES[t.dtype]
    t = t.cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), name
    return t.numpy(), name


def _from_saved(arr: np.ndarray, logical: str) -> torch.Tensor:
    if logical == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _leaf_file(i: int) -> str:
    return f"leaf-{i:05d}.npy"


def create_files(tmp: str, leaves: Sequence[Tuple[str, Sequence[int],
                                                   torch.dtype]]
                 ) -> List[Dict[str, Any]]:
    """A sharded save's temp directory ``tmp`` (made afresh) with each
    leaf's (name, whole shape, dtype) file at its whole shape and saved
    dtype, unwritten, as ``np.save`` lays it out -> the manifest's
    records."""
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    records = []
    for i, (name, shape, dtype) in enumerate(leaves):
        saved, logical = _to_host(torch.empty((), dtype=dtype))
        path = os.path.join(tmp, _leaf_file(i))
        if math.prod(shape):
            mm = np.lib.format.open_memmap(path, "w+", saved.dtype,
                                           tuple(shape))
            del mm
        else:
            np.save(path, np.empty(tuple(shape), saved.dtype))
        records.append({"name": name, "file": _leaf_file(i),
                        "shape": list(shape), "dtype": logical})
    return records


def write_part(tmp: str, leaves: Sequence[Part], mesh,
               coords: Dict[str, int]) -> int:
    """One rank's part of a sharded save, into the files ``create_files``
    made in ``tmp``: ``leaves[i]`` = (the local shard of leaf i, its spec)
    goes into its box at mesh coordinates ``coords`` (axis name -> index,
    ``sharding.local_box`` on ``mesh``) through a memory map flushed
    before the next leaf; a leaf is skipped where it is None or ``coords``
    is not its box's first replica.  The coordinates are explicit, so
    one process can write any rank's part -> the bytes written."""
    written = 0
    for i, leaf in enumerate(leaves):
        if leaf is None or not first_replica(leaf[1], coords):
            continue
        arr, _ = _to_host(leaf[0])
        if not arr.size:
            continue
        mm = np.load(os.path.join(tmp, _leaf_file(i)), mmap_mode="r+")
        box = local_box(mm.shape, leaf[1], mesh, coords)
        if tuple(n for _, n in box) != arr.shape or arr.dtype != mm.dtype:
            raise ValueError(f"{_leaf_file(i)}: a {arr.dtype} shard of "
                             f"shape {arr.shape} for the {mm.dtype} box "
                             f"{box}")
        mm[tuple(slice(s, s + n) for s, n in box)] = arr
        mm.flush()
        del mm
        written += arr.nbytes
    return written


def publish(directory: str, step: int, tmp: str,
            records: List[Dict[str, Any]]) -> str:
    """The manifest written into ``tmp``, then ``tmp`` renamed into place
    as step ``step``'s checkpoint (atomic) -> its path."""
    final = os.path.join(directory, f"step-{step:08d}")
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump({"step": step, "leaves": records}, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)            # atomic publish
    return final


def read_box(file: str, logical: str, box, device=None,
             dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The (start, size)-a-dim ``box`` of a saved leaf, read alone
    (memory-mapped), on ``device`` in ``dtype``."""
    arr = np.load(file, mmap_mode="r")
    part = np.array(arr[tuple(slice(s, s + n) for s, n in box)])  # a copy
    return _from_saved(part, logical).to(device=device, dtype=dtype)


def _part(state: Pytree):
    """This rank's part of a sharded state: each leaf's (name, whole
    shape, dtype), its ``Part`` (a plain leaf is replicated), the mesh
    (``launch.mesh.Mesh``) and this rank's coordinates on it."""
    from repro_torch.launch.mesh import Mesh
    flat = [(name, torch.as_tensor(leaf).detach())
            for name, leaf in _flatten_with_names(state)]
    dm = next(t.device_mesh for _, t in flat if hasattr(t, "device_mesh"))
    coords = coordinates(dm)
    layout, parts = [], []
    for name, t in flat:
        layout.append((name, tuple(t.shape), t.dtype))
        if hasattr(t, "device_mesh"):
            if t.device_mesh != dm:
                raise ValueError(f"{name}: a sharded save takes one mesh")
            spec, local = spec_of(t), t.to_local()
        else:
            spec, local = (), t
        parts.append((local, spec) if first_replica(spec, coords) else None)
    return layout, parts, Mesh(dm.shape, dm.mesh_dim_names), coords


def _snapshot(parts: Sequence[Part]) -> List[Part]:
    """Host copies of the shards a rank writes (its async snapshot)."""
    return [None if p is None else (p[0].to("cpu", copy=True), p[1])
            for p in parts]


def _rank0() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def _agree(ok: bool) -> bool:
    """Whether every rank of the default group is ``ok``: one all-reduce,
    so also a barrier (``ok`` itself without a group)."""
    if not dist.is_initialized():
        return ok
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    flag = torch.tensor([int(ok)], dtype=torch.int32, device=dev)
    dist.all_reduce(flag, op=dist.ReduceOp.MIN)
    return bool(flag.item())


class _Pending:
    """A sharded save between its files' creation and its publication."""

    def __init__(self, step, tmp, records, parts, mesh, coords):
        self.step, self.tmp, self.records = step, tmp, records
        self.parts, self.mesh, self.coords = parts, mesh, coords
        self.error: Optional[BaseException] = None

    def write(self) -> None:
        try:
            write_part(self.tmp, self.parts, self.mesh, self.coords)
        except BaseException as e:      # raised by every rank at _finish
            self.error = e
        self.parts = None


def _failed(what: str, step: int, error: Optional[BaseException]):
    msg = f"checkpoint step {step}: {what}"
    if error is not None:
        return RuntimeError(f"{msg}: {error!r}")
    return RuntimeError(f"{msg} on another rank")


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._pending: Optional[_Pending] = None   # a sharded save

    # ------------------------------------------------------------- saving --
    def save(self, step: int, state: Pytree) -> str:
        if _is_sharded(state):
            self.wait()
            self._begin(step, *_part(state))
            self._pending.write()
            return self._finish()
        leaves = [(name, _to_host(leaf))
                  for name, leaf in _flatten_with_names(state)]
        tmp = os.path.join(self.directory, f".tmp-{step}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        records = []
        for i, (name, (arr, logical)) in enumerate(leaves):
            np.save(os.path.join(tmp, _leaf_file(i)), arr)
            records.append({"name": name, "file": _leaf_file(i),
                            "shape": list(arr.shape), "dtype": logical})
        final = publish(self.directory, step, tmp, records)
        self._gc()
        return final

    def async_save(self, step: int, state: Pytree) -> None:
        """Snapshot to host memory now (device -> host copies; of a
        sharded state, the boxes this rank writes), write on a thread."""
        self.wait()
        if _is_sharded(state):
            layout, parts, mesh, coords = _part(state)
            self._begin(step, layout, _snapshot(parts), mesh, coords)
            self._thread = threading.Thread(target=self._pending.write)
            self._thread.start()
            return
        snap = _unflatten_like(state, {
            name: torch.as_tensor(leaf).detach().to("cpu", copy=True)
            for name, leaf in _flatten_with_names(state)})
        self._thread = threading.Thread(target=self.save, args=(step, snap))
        self._thread.start()

    def wait(self) -> None:
        """Until the save in flight is written (on every rank, and
        published, after a sharded save)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._pending is not None:
            self._finish()

    def _begin(self, step: int, layout, parts: Sequence[Part], mesh,
               coords: Dict[str, int]) -> None:
        """Steps 1-2 of a sharded save (the module's docstring)."""
        tmp = os.path.join(self.directory, f".tmp-{step}")
        records, error = None, None
        if _rank0():
            try:
                records = create_files(tmp, layout)
            except Exception as e:
                error = e
        if not _agree(error is None):
            raise _failed("creating the files failed", step, error) \
                from error
        self._pending = _Pending(step, tmp, records, parts, mesh, coords)

    def _finish(self) -> str:
        """Steps 4-5 of a sharded save (the module's docstring)."""
        p, self._pending = self._pending, None
        if not _agree(p.error is None):
            raise _failed("writing a part failed", p.step, p.error) \
                from p.error
        final = os.path.join(self.directory, f"step-{p.step:08d}")
        error = None
        if _rank0():
            try:
                publish(self.directory, p.step, p.tmp, p.records)
                self._gc()
            except Exception as e:
                error = e
        if not _agree(error is None):
            raise _failed("publishing failed", p.step, error) from error
        return final

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step-{s:08d}"),
                          ignore_errors=True)

    # ----------------------------------------------------------- restoring --
    def all_steps(self):
        out = []
        for d in os.listdir(self.directory):
            if d.startswith("step-"):
                out.append(int(d.split("-")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like: Pytree,
                shardings: Optional[Pytree] = None, device=None) -> Pytree:
        """Load ``step`` shaped like ``like`` (tensors, DTensors or meta
        tensors): each leaf in like's dtype, on ``device`` (else like's
        own device; the CPU for a meta tensor), laid out by ``shardings``
        (a tree of ``NamedSharding`` like ``like``) when given.  A leaf
        count or shape that differs raises AssertionError, as the
        reference's checks do."""
        path = os.path.join(self.directory, f"step-{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        names = _flatten_with_names(like)
        if len(names) != len(manifest["leaves"]):
            raise AssertionError(f"checkpoint has {len(manifest['leaves'])} "
                                 f"leaves, state needs {len(names)}")
        by_name = {rec["name"]: rec for rec in manifest["leaves"]}
        placed = dict(_flatten_with_names(shardings)) if shardings else {}
        out = {}
        for name, like_leaf in names:
            rec = by_name[name]
            file = os.path.join(path, rec["file"])
            like_t = torch.as_tensor(like_leaf)
            if tuple(rec["shape"]) != tuple(like_t.shape):
                raise AssertionError(f"{name}: ckpt {tuple(rec['shape'])} "
                                     f"!= state {tuple(like_t.shape)}")
            dev = device if device is not None else (
                "cpu" if like_t.device.type == "meta" else like_t.device)
            if name in placed and like_t.dim():
                out[name] = _read_shard(file, rec["dtype"], placed[name],
                                        like_t, dev)
            else:
                out[name] = _from_saved(np.load(file), rec["dtype"]).to(
                    device=dev, dtype=like_t.dtype)
        return _unflatten_like(like, out)

    def restore_latest(self, like: Pytree, shardings: Optional[Pytree] = None,
                       device=None) -> Optional[Pytree]:
        step = self.latest_step()
        if step is None:
            return None
        return self.restore(step, like, shardings, device)


def _read_shard(file: str, logical: str, sharding, like_t: torch.Tensor,
                device):
    """This rank's shard of a saved leaf laid out by ``sharding`` (on
    like's mesh when like is a DTensor): only the shard's box is read from
    the file and moved to ``device``; no communication."""
    from repro_torch.distributed.sharding import from_local
    mesh = getattr(like_t, "device_mesh", None)
    if mesh is None:
        mesh = sharding.mesh.device_mesh(torch.device(device).type)
    box = local_box(like_t.shape, sharding.spec, sharding.mesh,
                    coordinates(mesh))
    local = read_box(file, logical, box, device, like_t.dtype)
    return from_local(local, sharding, mesh, like_t.shape)
