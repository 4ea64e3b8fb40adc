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
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

Pytree = Any

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


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- saving --
    def save(self, step: int, state: Pytree) -> str:
        leaves = [(name, _to_host(leaf))
                  for name, leaf in _flatten_with_names(state)]
        tmp = os.path.join(self.directory, f".tmp-{step}")
        final = os.path.join(self.directory, f"step-{step:08d}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "leaves": []}
        for i, (name, (arr, logical)) in enumerate(leaves):
            fname = f"leaf-{i:05d}.npy"
            np.save(os.path.join(tmp, fname), arr)
            manifest["leaves"].append({
                "name": name, "file": fname,
                "shape": list(arr.shape), "dtype": logical})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)            # atomic publish
        self._gc()
        return final

    def async_save(self, step: int, state: Pytree) -> None:
        """Snapshot to host memory now (device -> host copies), write on a
        thread."""
        self.wait()
        snap = _unflatten_like(state, {
            name: torch.as_tensor(leaf).detach().to("cpu", copy=True)
            for name, leaf in _flatten_with_names(state)})
        self._thread = threading.Thread(target=self.save, args=(step, snap))
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

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

    def restore(self, step: int, like: Pytree, device=None) -> Pytree:
        """Load ``step`` shaped like ``like`` (tensors or meta tensors):
        each leaf in like's dtype, on ``device`` (else like's own device;
        the CPU for a meta tensor).  A leaf count or shape that differs
        raises AssertionError, as the reference's checks do."""
        path = os.path.join(self.directory, f"step-{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        names = _flatten_with_names(like)
        if len(names) != len(manifest["leaves"]):
            raise AssertionError(f"checkpoint has {len(manifest['leaves'])} "
                                 f"leaves, state needs {len(names)}")
        by_name = {rec["name"]: rec for rec in manifest["leaves"]}
        out = {}
        for name, like_leaf in names:
            rec = by_name[name]
            t = _from_saved(np.load(os.path.join(path, rec["file"])),
                            rec["dtype"])
            like_t = torch.as_tensor(like_leaf)
            if tuple(t.shape) != tuple(like_t.shape):
                raise AssertionError(f"{name}: ckpt {tuple(t.shape)} != "
                                     f"state {tuple(like_t.shape)}")
            dev = device if device is not None else (
                "cpu" if like_t.device.type == "meta" else like_t.device)
            out[name] = t.to(device=dev, dtype=like_t.dtype)
        return _unflatten_like(like, out)

    def restore_latest(self, like: Pytree, device=None) -> Optional[Pytree]:
        step = self.latest_step()
        if step is None:
            return None
        return self.restore(step, like, device)
