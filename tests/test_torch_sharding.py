"""The port's sharding policy, meshes, analytic costs and distributed
paths against the JAX package.

Specs: every leaf of all ten configs at 16x16, 2x16x16 and 4x2, the
serving caches of every family (decode and long-context), the ZeRO-1
moments, batch specs: equal to the reference's over a
``jax.sharding.AbstractMesh`` of the same shape (trailing Nones dropped on
both sides, as ``PartitionSpec`` drops them in ``resolve_pspec``).
``cell_costs``: all ten configs x four shapes at 256 and 512 chips
against the reference's run in a subprocess with 512 forced host
devices (where its production mesh can be built), within 1e-12
relative.  The three distributed functions: gloo groups of 1, 2 and 4
worker processes against the port's local functions and the
reference's (shard_map on a one-device mesh), rtol 1e-5.
"""
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from jax.sharding import AbstractMesh

from repro.core import coded as jcoded
from repro.core import linesearch as jls
from repro.core import objectives as jobj
from repro.core import sketch as jsketch
from repro.distributed import sharding as jsh
from repro.models import registry as jregistry

from repro_torch import configs as tconfigs
from repro_torch.core import coded as tcoded
from repro_torch.core import objectives as tobj
from repro_torch.core import sketch as tsketch
from repro_torch.distributed import sharding as tsh
from repro_torch.launch import analytic as tanalytic
from repro_torch.launch import mesh as tmesh
from repro_torch.models import common as tcommon
from repro_torch.models import registry as tregistry

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_dist  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "4x2": ((4, 2), ("data", "model"))}


def _meshes(name):
    shape, axes = MESHES[name]
    return AbstractMesh(shape, axes), tmesh.make_mesh(shape, axes)


def _norm(spec) -> tuple:
    entries = list(spec)
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def _jpaths(tree, is_leaf=None):
    return {"/".join(str(getattr(k, "key", getattr(k, "name", k)))
                     for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=is_leaf)[0]}


def _is_named(x):
    return isinstance(x, jax.sharding.NamedSharding)


# ------------------------------------------------------------------ specs --
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_param_and_zero1_specs_equal_the_references(mesh_name):
    """Every leaf of every config: ``param_shardings`` and the ZeRO-1
    moments of ``opt_state_shardings``."""
    jm, tm = _meshes(mesh_name)
    for arch in tconfigs.ASSIGNED_ARCHS:
        jb, tb = jregistry.get_bundle(arch), tregistry.get_bundle(arch)
        jp = jsh.param_shardings(jb, jm)
        want = {k: _norm(v.spec) for k, v in
                _jpaths(jp, _is_named).items()}
        tp = tsh.param_shardings(tb, tm)
        got = {k: v.spec for k, v in tcommon.flatten(tp)}
        assert got == want, arch
        jo = jsh.opt_state_shardings(jp, jb.abstract())
        to = tsh.opt_state_shardings(tp, tb.abstract())
        assert to.step.spec == _norm(jo.step.spec) == ()
        for field in ("mu", "nu"):
            want = {k: _norm(v.spec) for k, v in
                    _jpaths(getattr(jo, field), _is_named).items()}
            got = {k: v.spec for k, v in tcommon.flatten(getattr(to,
                                                                 field))}
            assert got == want, (arch, field)
        mirror = tsh.opt_state_shardings(tp, None)
        assert mirror.mu is tp and mirror.nu is tp


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_cache_and_batch_specs_equal_the_references(mesh_name):
    """Each family's serving cache at decode_32k and long_500k (full
    configs: the reference's shapes from ``eval_shape``, the port's on
    the meta device) and every cell's batch specs."""
    jm, tm = _meshes(mesh_name)
    for arch in tconfigs.ASSIGNED_ARCHS:
        jb, tb = jregistry.get_bundle(arch), tregistry.get_bundle(arch)
        for shape_name in ("decode_32k", "long_500k"):
            shape = tregistry.SHAPES[shape_name]
            b, s = shape.global_batch, shape.seq_len
            long_context = b == 1
            jc = jax.eval_shape(lambda: jb.init_cache(b, s))
            tc = tb.init_cache(b, s, device="meta")
            want = {k: _norm(v.spec) for k, v in _jpaths(
                jsh.cache_shardings(jb.cfg, jc, jm, long_context),
                _is_named).items()}
            got = {k: v.spec for k, v in tcommon.flatten(
                tsh.cache_shardings(tb.cfg, tc, tm, long_context))}
            assert got == want, (arch, shape_name)
        for shape in tregistry.SHAPES.values():
            jins = jb.input_specs(jregistry.SHAPES[shape.name])
            tins = tb.input_specs(shape)
            want = {k: _norm(v.spec) for k, v in
                    jsh.batch_shardings(jb, jm, jins).items()}
            got = {k: v.spec for k, v in
                   tsh.batch_shardings(tb, tm, tins).items()}
            assert got == want, (arch, shape.name)
    assert tsh.batch_axes(tm) == jsh.batch_axes(jm)


@pytest.mark.parametrize("shape,axes", [
    ((64, 128), ("embed", "ffn")),
    ((64, 64), ("rnn", "rnn")),
    ((128, 64, 96), ("experts", "embed", "expert_ffn")),
    ((36, 28, 128), ("layers", "heads", "head_dim")),
    ((7, 30), ("vocab", "heads")),
])
def test_resolve_rules_on_small_meshes(shape, axes):
    """The divisibility and one-axis-per-spec rules on the meshes of the
    reference's ``tests/test_sharding.py`` and a 4x2 one."""
    for sizes, names in (((1,), ("model",)), ((1, 1), ("data", "model")),
                         ((4, 2), ("data", "model")),
                         ((2, 4), ("data", "model"))):
        jm = AbstractMesh(sizes, names)
        assert tsh.resolve_pspec(shape, axes, tmesh.make_mesh(sizes, names)) \
            == _norm(jsh.resolve_pspec(shape, axes, jm))


def test_zero1_cases():
    """The reference's two ZeRO-1 unit cases."""
    m = tmesh.make_mesh((1, 1), ("data", "model"))
    out = tsh._zero1_spec(tsh.NamedSharding(m, (None, None, "model")),
                          (36, 2560, 9728))
    assert out.spec == ("data", None, "model")
    base = tsh.NamedSharding(m, ("model", None, "data"))
    assert tsh._zero1_spec(base, (128, 64, 96)) is base


def test_meshes_and_placements():
    """Production and host meshes; a spec's DTensor placements (a dim
    claimed by two axes is split on both mesh dims)."""
    from torch.distributed.tensor import Replicate, Shard
    assert tmesh.make_production_mesh().shape == {"data": 16, "model": 16}
    assert tmesh.make_production_mesh(multi_pod=True).shape == \
        {"pod": 2, "data": 16, "model": 16}
    assert tmesh.make_production_mesh(multi_pod=True).size == 512
    assert tmesh.make_host_mesh().shape == {"data": 1}

    class _DM:
        mesh_dim_names = ("pod", "data", "model")

        def __init__(self, sizes=(2, 16, 16)):
            self.sizes = sizes

        def size(self, i):
            return self.sizes[i]
    assert tsh.placements((("pod", "data"), "model"), _DM()) == \
        [Shard(0), Shard(0), Shard(1)]
    assert tsh.placements((None, None, "data"), _DM()) == \
        [Replicate(), Shard(2), Replicate()]
    assert tsh.placements((("pod", "data"), "model"), _DM((1, 4, 1))) == \
        [Replicate(), Shard(0), Replicate()]
    assert tsh.local_shape((8, 6, 4), (("pod", "data"), None, "model"),
                           tmesh.make_production_mesh(multi_pod=True)) == \
        (8 // 32, 6, 4 // 16)


# ---------------------------------------------------------- analytic ------
@pytest.fixture(scope="module")
def reference_cell_costs():
    """The reference's ``cell_costs`` for every config x shape at 256 and
    512 chips, in a subprocess with 512 forced host devices."""
    code = (
        "import json\n"
        "from repro.launch import analytic\n"
        "from repro.models.registry import SHAPES, get_config\n"
        "from repro.configs import ASSIGNED_ARCHS\n"
        "out = {}\n"
        "for a in ASSIGNED_ARCHS:\n"
        "    for s in SHAPES:\n"
        "        for chips in (256, 512):\n"
        "            c = analytic.cell_costs(get_config(a), SHAPES[s], chips)\n"
        "            out[f'{a}|{s}|{chips}'] = [c.flops_per_chip,\n"
        "                c.hbm_bytes_per_chip, c.coll_bytes_per_chip,\n"
        "                c.detail['param_bytes_per_chip']]\n"
        "print(json.dumps(out))\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=512",
               PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("chips", [256, 512])
def test_cell_costs_equal_the_references_dry_run(reference_cell_costs,
                                                 chips):
    n = 0
    for key, want in reference_cell_costs.items():
        arch, shape, c = key.split("|")
        if int(c) != chips:
            continue
        got = tanalytic.cell_costs(tregistry.get_config(arch),
                                   tregistry.SHAPES[shape], chips)
        have = [got.flops_per_chip, got.hbm_bytes_per_chip,
                got.coll_bytes_per_chip,
                got.detail["param_bytes_per_chip"]]
        for h, w in zip(have, want):
            assert abs(h - w) <= 1e-12 * abs(w), (key, h, w)
        n += 1
    assert n == 40


def test_port_states_no_tpu_figure():
    """No TPU constant (v5e's 197e12 FLOP/s, 819e9 B/s, 50 GB/s ICI) in
    the port's launchers and benches."""
    import re
    root = os.path.join(REPO, "src", "repro_torch")
    tpu = re.compile(r"(?<![\d.])(197e12|819e9|50e9|50 GB/s)")
    for sub in ("launch", "benchmarks", "distributed"):
        for name in os.listdir(os.path.join(root, sub)):
            if name.endswith(".py"):
                text = open(os.path.join(root, sub, name)).read()
                assert not tpu.search(text), (sub, name)


# ------------------------------------------------- distributed functions --
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def dist_case():
    """Inputs (numpy, from seeds) and the reference's results on a
    one-device mesh: a (256, 9) A, 12 sketch blocks of 64 (block 2 a
    straggler); a (256, 33) matrix's product code (3 x 3 workers padded to
    12, worker 4 erased); a 96 x 7 logistic problem at six trial steps."""
    rs = np.random.RandomState(11)
    key = jax.random.PRNGKey(5)
    a = rs.standard_normal((256, 9)).astype(np.float32)
    cfg = jsketch.OverSketchConfig(512, 64, 0.5)
    cs = jsketch.sample_countsketch(jax.random.fold_in(key, 6), 256, cfg)
    surv = np.arange(cfg.total_blocks) != 2
    m = rs.standard_normal((256, 33)).astype(np.float32)
    v = rs.standard_normal(33).astype(np.float32)
    code = jcoded.make_code(256, 64)
    enc = np.asarray(jcoded.encode_2d(jnp.asarray(m), code))
    w = code.num_workers
    enc_flat = np.zeros((12,) + enc.shape[2:], np.float32)
    enc_flat[:w] = enc.reshape((w,) + enc.shape[2:])
    erased = np.zeros(12, bool)
    erased[4] = True
    x = rs.standard_normal((96, 7)).astype(np.float32)
    y = np.sign(rs.standard_normal(96)).astype(np.float32)
    wv = rs.standard_normal(7).astype(np.float32) * 0.3
    p = rs.standard_normal(7).astype(np.float32)
    cand = np.asarray([4.0 ** -i for i in range(6)], np.float32)

    one = jax.make_mesh((1,), ("i",),
                        axis_types=(jax.sharding.AxisType.Auto,))
    ref_gram = np.asarray(jsketch.distributed_sketched_gram(
        jnp.asarray(a), cs, jnp.asarray(surv), mesh=one, block_axis="i"))
    ref_y, ref_ok = jcoded.distributed_coded_matvec(
        jnp.asarray(enc_flat), jnp.asarray(v), jnp.asarray(erased), code,
        256, mesh=one, worker_axis="i")
    from jax.sharding import PartitionSpec as P
    obj = jobj.LogisticRegression(lam=1e-3)
    ref_f = np.asarray(jax.shard_map(
        lambda xl, yl: jls.distributed_f_trials(
            obj, jobj.Dataset(xl, yl), jnp.asarray(wv), jnp.asarray(p),
            jnp.asarray(cand), "i"),
        mesh=one, in_specs=(P("i"), P("i")), out_specs=P())(
            jnp.asarray(x), jnp.asarray(y)))
    case = {"a": torch.from_numpy(a),
            "h": torch.from_numpy(np.asarray(cs.h)),
            "sigma": torch.from_numpy(np.asarray(cs.sigma)),
            "block": cs.block_size, "surv": torch.from_numpy(surv),
            "enc_flat": torch.from_numpy(enc_flat),
            "v": torch.from_numpy(v), "erased": torch.from_numpy(erased),
            "code": (code.num_blocks, code.block_rows, code.grid),
            "out_rows": 256, "x": torch.from_numpy(x),
            "y": torch.from_numpy(y), "w": torch.from_numpy(wv),
            "p": torch.from_numpy(p), "cand": torch.from_numpy(cand)}
    return case, {"gram": ref_gram, "y": np.asarray(ref_y),
                  "ok": bool(ref_ok), "f": ref_f, "m": m, "v": v}


def _local(case):
    """The port's single-process results of the same functions."""
    cs = tsketch.CountSketch(case["h"], case["sigma"], case["block"])
    gram = tsketch.sketched_gram(tsketch.apply_sketch(cs, case["a"]),
                                 case["surv"])
    code = tcoded.ProductCode(*case["code"])
    g1 = code.grid + 1
    w = code.num_workers
    enc = case["enc_flat"][:w].reshape(g1, g1, *case["enc_flat"].shape[1:])
    y, ok = tcoded.coded_matvec(enc, case["v"], code, case["out_rows"],
                                case["erased"][:w].reshape(g1, g1))
    obj = tobj.LogisticRegression(lam=1e-3)
    f = obj.value(case["w"][None] + case["cand"][:, None] * case["p"][None],
                  tobj.Dataset(case["x"], case["y"]))
    return {"gram": gram.numpy(), "y": y.numpy(), "ok": bool(ok),
            "f": f.numpy()}


def test_distributed_paths_no_group(dist_case):
    """Without a process group each function is its local counterpart."""
    case, ref = dist_case
    local = _local(case)
    cs = tsketch.CountSketch(case["h"], case["sigma"], case["block"])
    gram = tsketch.distributed_sketched_gram(case["a"], cs, case["surv"])
    np.testing.assert_allclose(gram.numpy(), local["gram"], rtol=1e-5,
                               atol=1e-5 * np.abs(local["gram"]).max())
    np.testing.assert_allclose(local["gram"], ref["gram"], rtol=1e-5,
                               atol=1e-5 * np.abs(ref["gram"]).max())
    assert local["ok"] and ref["ok"]
    np.testing.assert_allclose(local["y"], ref["m"] @ ref["v"], rtol=1e-3,
                               atol=1e-3)


@pytest.mark.parametrize("world", [1, 2, 4])
def test_distributed_paths_on_gloo(dist_case, world, tmp_path):
    case, ref = dist_case
    mp.spawn(_torch_dist.distributed_paths,
             args=(world, _free_port(), str(tmp_path), case), nprocs=world,
             join=True)
    local = _local(case)
    for r in range(world):
        got = torch.load(tmp_path / f"rank{r}.pt")
        assert got["ok"] and ref["ok"]
        for name in ("gram", "y", "f"):
            have = got[name].numpy()
            for want in (local[name], ref[name]):
                np.testing.assert_allclose(
                    have, want, rtol=1e-5,
                    atol=1e-5 * np.abs(want).max(), err_msg=name)
