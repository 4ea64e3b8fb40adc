"""Mesh training against the JAX package: the reference's
``tests/test_trainer_integration.py`` elastic case in both packages.

The smoke qwen3-4b trainer at float32 (``smoke_config`` patched in both
packages, in the worker processes and the reference's subprocess) trains
6 steps on a 4x2 ("data", "model") mesh (8 gloo ranks here, 8 forced host
devices there), checkpointing every 3; then a trainer of 8 steps on a
2x2 mesh (4 ranks) restores the step-6 checkpoint and runs steps 6-7.
The losses and grad norms are held within 1e-5 relative to the
reference's same run, and to the port's unsharded trainer doing the same
(6 steps, then the step-6 checkpoint restored onto no mesh: elastic
restore onto another layout).  Also the launcher's ``--mesh`` on a
one-rank mesh, and the mesh trainer's init: every rank draws only its
own shards, each equal to its slice of the unsharded init.
"""
import json
import os
import socket
import subprocess
import sys

import pytest
import torch
import torch.multiprocessing as mp

from repro_torch import configs as tconfigs
from repro_torch.models import common as tcommon
from repro_torch.models import registry as tregistry
from repro_torch.training import trainer as ttrainer

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_dist  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-5

_REFERENCE = """
import json, tempfile
from repro import configs
base = configs.smoke_config
configs.smoke_config = lambda name: base(name).scaled(dtype="float32")
from repro.launch.mesh import make_mesh
from repro.distributed import opt_state_shardings
from repro.training.trainer import Trainer, TrainerConfig
import jax
d = tempfile.mkdtemp()
cfg = TrainerConfig(arch="qwen3-4b", steps=6, batch=8, seq=64,
                    ckpt_dir=d, ckpt_every=3, lr=1e-3)
tr = Trainer(cfg, make_mesh((4, 2), ("data", "model")))
p, o = tr.init_state()
p, o, hist = tr.run(p, o)
cfg2 = TrainerConfig(arch="qwen3-4b", steps=8, batch=8, seq=64,
                     ckpt_dir=d, ckpt_every=100, lr=1e-3)
tr2 = Trainer(cfg2, make_mesh((2, 2), ("data", "model")))
p2, o2 = tr2.init_state()
state = tr2.ckpt.restore(
    tr2.ckpt.latest_step(),
    {"params": jax.eval_shape(lambda: p2), "opt": jax.eval_shape(lambda: o2)},
    {"params": tr2.p_shard, "opt": opt_state_shardings(tr2.p_shard, None)})
p2, o2, hist2 = tr2.run(state["params"], state["opt"],
                        start_step=tr2.ckpt.latest_step())
print(json.dumps([hist, hist2]))
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn_mesh(world, shape, steps, ckpt, restore, out):
    os.makedirs(out, exist_ok=True)
    mp.spawn(_torch_dist.mesh_train,
             args=(world, _free_port(), out, shape, steps, ckpt, 3, restore),
             nprocs=world, join=True)
    rank0 = torch.load(os.path.join(out, "rank0.pt"))
    for name in ("init", "save"):
        rank0[name] = [torch.load(os.path.join(out, f"{name}{r}.pt"))
                       for r in range(world)]
    return rank0


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's elastic run (a subprocess, started first and read
    last) and the port's: 4x2 then 2x2 on gloo, and the unsharded
    trainer restoring the same checkpoint."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(REPO, "src"))
    ref = subprocess.Popen([sys.executable, "-c", _REFERENCE], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    root = tmp_path_factory.mktemp("mesh")
    ckpt = str(root / "ckpt")
    rank0 = _spawn_mesh(8, (4, 2), 6, ckpt, False, str(root / "a"))
    mesh1 = rank0["hist"]
    second = _spawn_mesh(4, (2, 2), 8, ckpt, True, str(root / "b"))
    mesh2 = second["hist"]
    steps = sorted(int(d.split("-")[1]) for d in os.listdir(ckpt)
                   if d.startswith("step-"))

    base = tconfigs.smoke_config
    tconfigs.smoke_config = lambda name: base(name).scaled(dtype="float32")
    try:
        cfg = dict(arch="qwen3-4b", batch=8, seq=64, lr=1e-3)
        t1 = ttrainer.Trainer(ttrainer.TrainerConfig(steps=6, **cfg),
                              device="cpu")
        _, _, plain1 = t1.run(*t1.init_state())
        t2 = ttrainer.Trainer(ttrainer.TrainerConfig(
            steps=8, ckpt_dir=ckpt, ckpt_every=100, **cfg), device="cpu")
        params, opt = t2.init_state()
        opt = t2.restore(6, params, opt)
        _, _, plain2 = t2.run(params, opt, 6)
    finally:
        tconfigs.smoke_config = base
    out, err = ref.communicate(timeout=600)
    assert ref.returncode == 0, err[-3000:]
    ref1, ref2 = json.loads(out.strip().splitlines()[-1])
    return {"mesh": (mesh1, mesh2), "plain": (plain1, plain2),
            "ref": (ref1, ref2), "ckpt_steps": steps,
            "init": {"4x2": rank0["init"], "2x2": second["init"]},
            "ckpt": ckpt, "gathered": str(root / "a" / "plain"),
            "save": rank0["save"]}


def _close(have, want, what):
    assert [h["step"] for h in have] == [w["step"] for w in want], what
    for h, w in zip(have, want):
        for k in ("loss", "grad_norm"):
            assert abs(h[k] - w[k]) <= RTOL * abs(w[k]), (what, h["step"],
                                                         k, h[k], w[k])


def test_mesh_run_matches_the_reference(runs):
    """4x2 for 6 steps, then 2x2 from the step-6 checkpoint."""
    (m1, m2), (r1, r2) = runs["mesh"], runs["ref"]
    assert [h["step"] for h in m1] == list(range(6))
    assert [h["step"] for h in m2] == [6, 7]
    _close(m1, r1, "4x2")
    _close(m2, r2, "2x2 elastic")
    assert m2[-1]["loss"] < m1[0]["loss"]
    assert runs["ckpt_steps"] == [3, 6]


def test_mesh_run_matches_the_unsharded_trainer(runs):
    """The same runs without a mesh; the second restores the checkpoint
    the 4x2 mesh wrote."""
    (m1, m2), (p1, p2) = runs["mesh"], runs["plain"]
    _close(m1, p1, "4x2 vs unsharded")
    _close(m2, p2, "2x2 vs unsharded restore")


@pytest.mark.parametrize("mesh", ["4x2", "2x2"])
def test_mesh_init_draws_only_each_ranks_shards(runs, mesh):
    """``init_state`` on a mesh draws, on every rank, each leaf at its
    local shape under the policy and nothing whole (the reference's
    ``jax.jit(init, out_shardings=...)`` builds only each device's
    shards); the split leaves are smaller than whole."""
    for rank in runs["init"][mesh]:
        assert rank["built"] == [tuple(s) for s in rank["local_shapes"]]
    specs = [s.shape for _, s in tcommon.flatten(
        tregistry.ModelBundle(tconfigs.smoke_config("qwen3-4b")).specs())]
    assert any(tuple(b) != tuple(s) for b, s in zip(
        runs["init"][mesh][0]["built"], specs))


@pytest.mark.parametrize("mesh", ["4x2", "2x2"])
def test_mesh_init_shards_are_the_unsharded_init_sliced(runs, mesh):
    """Every rank's shard of every leaf equals its slice of the unsharded
    init, bit for bit (the window draws hash the whole leaf's counters)."""
    for rank in runs["init"][mesh]:
        assert rank["equal"] and all(rank["equal"])


def _files(step_dir):
    return sorted(os.listdir(step_dir))


@pytest.mark.parametrize("step", [3, 6])
def test_sharded_save_is_the_unsharded_save_byte_for_byte(runs, step):
    """The 4x2 run's checkpoints (each rank writing its own boxes) are the
    files an unsharded save of the same state writes (the state gathered
    whole after the save, outside the manager), byte for byte: every
    leaf's .npy and the manifest."""
    ours = os.path.join(runs["ckpt"], f"step-{step:08d}")
    plain = os.path.join(runs["gathered"], f"step-{step:08d}")
    assert _files(ours) == _files(plain)
    assert len(_files(ours)) > 40
    for name in _files(ours):
        with open(os.path.join(ours, name), "rb") as f, \
                open(os.path.join(plain, name), "rb") as g:
            assert f.read() == g.read(), name


def test_sharded_save_gathers_no_leaf(runs):
    """No rank calls ``full_tensor`` inside ``async_save``, ``save`` or
    ``wait``; both saves of the 4x2 run went through the async path."""
    for rank in runs["save"]:
        assert rank["steps"] == [3, 6]
        assert rank["full_tensor"] == 0


def test_async_snapshot_holds_only_the_ranks_shards(runs):
    """Each rank's host snapshot holds at most its local shards' bytes,
    below the whole state's, and the ranks' snapshots together hold the
    whole state once: each box is copied by one replica."""
    ranks = runs["save"]
    for i in range(2):
        whole = ranks[0]["whole_bytes"][i]
        for rank in ranks:
            assert rank["snapshot_bytes"][i] <= rank["shard_bytes"][i]
            assert rank["shard_bytes"][i] < whole
        assert sum(r["snapshot_bytes"][i] for r in ranks) == whole


def test_reference_restores_the_sharded_save(runs):
    """``repro.checkpoint.CheckpointManager.restore`` reads the 4x2 run's
    step-3 checkpoint (a flat tree whose key paths print as the port's
    leaf names, which the manifest records): every leaf equals the
    gathered state's, bit for bit."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from repro.checkpoint import CheckpointManager as JManager
    step_dir = os.path.join(runs["ckpt"], "step-00000003")
    with open(os.path.join(step_dir, "manifest.json")) as f:
        records = json.load(f)["leaves"]
    like = _Named({r["name"]: jax.ShapeDtypeStruct(tuple(r["shape"]),
                                                   jnp.dtype(r["dtype"]))
                   for r in records})
    back = JManager(runs["ckpt"]).restore(3, like)
    plain = os.path.join(runs["gathered"], "step-00000003")
    for r in records:
        want = np.load(os.path.join(plain, r["file"]))
        np.testing.assert_array_equal(np.asarray(back.leaves[r["name"]]),
                                      want, r["name"])


class _Key:
    """A pytree key that prints as a port leaf name."""

    def __init__(self, name):
        self.name = name

    def __str__(self):
        return self.name


class _Named:
    """A flat pytree of leaves by '/' name."""

    def __init__(self, leaves):
        self.leaves = leaves


def _register_named():
    import jax
    jax.tree_util.register_pytree_with_keys(
        _Named,
        lambda t: ([(_Key(k), v) for k, v in t.leaves.items()], tuple(
            t.leaves)),
        lambda names, values: _Named(dict(zip(names, values))))


_register_named()


def test_launch_train_mesh_one_rank(capsys, tmp_path):
    """``--mesh 1x1`` makes and ends a group of its own; the loss falls."""
    import torch.distributed as dist
    from repro_torch.launch import train
    rc = train.main(["--steps", "4", "--mesh", "1x1", "--device", "cpu",
                     "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"])
    out = capsys.readouterr().out
    assert rc == 0 and not dist.is_initialized()
    assert "mesh={'data': 1, 'model': 1}" in out
    assert "over 4 logged steps" in out
    mesh = train.parse_mesh("2x2x2")
    assert mesh.shape == {"pod": 2, "data": 2, "model": 2}
    assert train.parse_mesh("8").shape == {"data": 8}


def test_resilient_grads_refuse_a_mesh():
    """The straggler-resilient path takes a group (its ranks hold the
    whole model, as the reference replicates its parameters there), not
    a mesh; the refusal comes before any group is needed."""
    from repro_torch.launch.mesh import make_mesh
    with pytest.raises(ValueError, match="resilient_grads"):
        ttrainer.Trainer(ttrainer.TrainerConfig(
            arch="qwen3-4b", resilient_grads=True), device="cpu",
            mesh=make_mesh((1, 1), ("data", "model")))
