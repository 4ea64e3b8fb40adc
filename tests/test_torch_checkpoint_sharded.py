"""The sharded checkpoint save's box writer on the CPU, one process: the
smoke qwen3-moe-30b-a3b's parameters as a 4 x 2 ("data", "model") mesh
lays them out (the expert leaves split on two dims), each rank's boxes
drawn alone (``ModelBundle.init_local``) and written by
``checkpoint.manager.write_part`` at that rank's coordinates into the
files ``create_files`` made, then published.  The files equal an
unsharded save of the whole init byte for byte (each box written once,
by its first replica), a rank's boxes read back are its draw bit for
bit, and a shard that does not fit its box is refused; on a one-rank
gloo group, a part that fails to write fails the save.  The gloo runs
of ``tests/test_torch_mesh_train.py`` drive the same writer through
``CheckpointManager`` on 8 processes.
"""
import os

import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch import prng
from repro_torch.checkpoint import CheckpointManager, manager
from repro_torch.distributed.sharding import (first_replica, param_boxes,
                                              resolve_pspec)
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import common
from repro_torch.models import registry as tregistry

ARCH = "qwen3-moe-30b-a3b"
COORDS = [{"data": d, "model": m} for d in range(4) for m in range(2)]


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """Every rank's part written, rank by rank; and the unsharded save."""
    root = tmp_path_factory.mktemp("ckpt_sharded")
    bundle = tregistry.ModelBundle(tconfigs.smoke_config(ARCH))
    mesh = make_mesh((4, 2), ("data", "model"))
    specs = {path: resolve_pspec(s.shape, s.axes, mesh)
             for path, s in common.flatten(bundle.specs())}
    layout = [(name, tuple(t.shape), t.dtype) for name, t in
              manager._flatten_with_names(bundle.abstract())]
    key = prng.PRNGKey(3)
    tmp = str(root / "sharded" / ".tmp-5")
    records = manager.create_files(tmp, layout)
    written = []
    for coords in COORDS:
        tree = dict(common.flatten(bundle.init_local(
            key, param_boxes(bundle, mesh, coords), "cpu")))
        written.append(manager.write_part(
            tmp, [(tree[name], specs[name]) for name, _, _ in layout], mesh,
            coords))
    manager.publish(str(root / "sharded"), 5, tmp, records)
    whole = bundle.init(key, device="cpu").tree
    CheckpointManager(str(root / "plain")).save(5, whole)
    return {"root": root, "bundle": bundle, "mesh": mesh, "key": key,
            "records": records, "written": written, "specs": specs,
            "whole_bytes": sum(t.numel() * t.element_size() for _, t in
                               common.flatten(whole))}


def test_ranks_parts_are_the_unsharded_save_byte_for_byte(saved):
    ours = saved["root"] / "sharded" / "step-00000005"
    plain = saved["root"] / "plain" / "step-00000005"
    names = sorted(os.listdir(ours))
    assert names == sorted(os.listdir(plain))
    assert len(names) == len(saved["records"]) + 1
    for name in names:
        assert (ours / name).read_bytes() == (plain / name).read_bytes(), \
            name
    assert sum(saved["written"]) == saved["whole_bytes"]
    assert max(saved["written"]) < saved["whole_bytes"] / 2


def test_a_box_is_written_by_its_first_replica_only(saved):
    """A replicated leaf (a norm) is written by rank (0, 0) alone; the
    expert leaves (split on "model" and "data") by every rank."""
    specs = saved["specs"]
    norm = next(p for p, s in specs.items() if s == ())
    expert = next(p for p, s in specs.items()
                  if {"data", "model"} <= set(a for a in s if a))
    assert [first_replica(specs[norm], c) for c in COORDS] == \
        [True] + [False] * 7
    assert all(first_replica(specs[expert], c) for c in COORDS)


def test_a_ranks_boxes_read_back_bit_for_bit(saved):
    bundle, mesh = saved["bundle"], saved["mesh"]
    boxes = param_boxes(bundle, mesh, {"data": 3, "model": 1})
    want = dict(common.flatten(bundle.init_local(saved["key"], boxes,
                                                 "cpu")))
    step_dir = saved["root"] / "sharded" / "step-00000005"
    for rec in saved["records"]:
        got = manager.read_box(str(step_dir / rec["file"]), rec["dtype"],
                               boxes[rec["name"]], "cpu", torch.bfloat16)
        assert torch.equal(got.view(torch.int16),
                           want[rec["name"]].view(torch.int16)), rec["name"]


def test_a_shard_that_does_not_fit_its_box_is_refused(tmp_path):
    mesh = make_mesh((2, 1), ("data", "model"))
    tmp = str(tmp_path / ".tmp-1")
    manager.create_files(tmp, [("w", (4, 3), torch.float32)])
    with pytest.raises(ValueError, match="shard"):
        manager.write_part(tmp, [(torch.zeros(3, 3), ("data",))], mesh,
                           {"data": 0, "model": 0})
    with pytest.raises(ValueError, match="shard"):
        manager.write_part(tmp, [(torch.zeros(2, 3, dtype=torch.float64),
                                  ("data",))], mesh,
                           {"data": 1, "model": 0})
    assert manager.write_part(tmp, [(torch.ones(2, 3), ("data",))], mesh,
                              {"data": 1, "model": 0}) == 24


@pytest.fixture
def one_rank_group(tmp_path):
    """A one-rank gloo default group on a file store."""
    import torch.distributed as dist
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    yield
    dist.destroy_process_group()


def test_a_failed_part_fails_the_save(one_rank_group, tmp_path,
                                      monkeypatch):
    """Through ``CheckpointManager`` on a 1 x 1 mesh: a sharded save
    writes the unsharded save's files; a part that fails to write fails
    ``save`` and, for ``async_save``, ``wait``, and publishes nothing."""
    from repro_torch.distributed.sharding import NamedSharding, distribute
    mesh = make_mesh((1, 1), ("data", "model"))
    w = torch.arange(6.0).reshape(2, 3)
    state = {"w": distribute(w, NamedSharding(mesh, ("data",)),
                             mesh.device_mesh("cpu")),
             "step": torch.ones((), dtype=torch.int32)}
    ckpt = CheckpointManager(str(tmp_path / "ck"))
    ckpt.save(1, state)
    plain = {"w": w, "step": state["step"]}
    CheckpointManager(str(tmp_path / "plain")).save(1, plain)
    for name in ("leaf-00000.npy", "leaf-00001.npy", "manifest.json"):
        assert (tmp_path / "ck" / "step-00000001" / name).read_bytes() == \
            (tmp_path / "plain" / "step-00000001" / name).read_bytes()

    def broken(*args):
        raise OSError("no space left")
    monkeypatch.setattr(manager, "write_part", broken)
    with pytest.raises(RuntimeError, match="writing a part failed"):
        ckpt.save(2, state)
    ckpt.async_save(3, state)
    with pytest.raises(RuntimeError, match="no space left"):
        ckpt.wait()
    assert ckpt.all_steps() == [1]
