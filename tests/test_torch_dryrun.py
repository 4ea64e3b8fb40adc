"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
package's.

The reduced-mesh cells of the reference's
``tests/test_dryrun_integration.py`` (smoke configs under the registry's
names, a 4x2 ("data", "model") mesh) run in one subprocess on torch's
fake process group of 8 ranks: every field of ``analyze`` present, and
the counted flops per chip inside ``dryrun.expected_band`` of
``dryrun.expected_flops_per_chip``, the analytic model's parts
(``analytic.cell_costs``) under the port's own rules (every key chunk
attended, the two-level remat's passes, the one-hot backward; the rules
are in its docstring; the XLA counts of the reference's dry run count a
loop body once and are no yardstick).  Every step's band is
``FLOPS_TOL`` wide (prefill's and decode's too: their layouts are
pinned), and a planted miscount (the remat switched off: a third fewer
forward passes) falls outside it; so is a decode whose cache splits its
sequence.  mamba2's prefill_32k cell at 4x2 counts one projection of
the prompt a layer (its state comes from the chunked scan).  mamba2's
train cell on a 3-D mesh runs in a subprocess of its own, in a minute.  The same subprocess
checks the collective recorder on one known all-gather and the flops of
one sharded product.
Skip rules, ``active_param_count`` and ``sharded_param_bytes`` equal the
reference's for every config.
"""
import json
import os
import subprocess
import sys

import pytest
from jax.sharding import AbstractMesh

from repro.models import registry as jregistry

from repro_torch import configs as tconfigs
from repro_torch.launch import dryrun as tdryrun
from repro_torch.launch import mesh as tmesh
from repro_torch.models import registry as tregistry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reference_dryrun():
    """The reference's ``repro.launch.dryrun``, imported with jax's backend
    already up and the environment restored after: the module sets
    ``XLA_FLAGS`` to 512 host devices on import, which would reach every
    later jax backend of this process (a test worker's included)."""
    import jax
    jax.devices()
    before = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun
    if before is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = before
    return dryrun
CELLS = [("qwen3-4b", "train_4k"), ("qwen3-moe-30b-a3b", "decode_32k"),
         ("mamba2-780m", "long_500k"), ("recurrentgemma-2b", "prefill_32k")]
# A decode whose cache splits its sequence over "model" (kv heads 2 on a
# model axis of 4): decode attention's softmax combined across ranks.
SEQ_SPLIT = ("qwen3-4b", "decode_32k", (2, 4))

_SUB = """
import json
import torch
from repro_torch.configs import smoke_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.registry import _REGISTRY
out = {"cells": {}}
for arch, shape in CELLS:
    cfg = smoke_config(arch).scaled(
        max_seq=40_000 if shape != "long_500k" else 600_000)
    _REGISTRY[arch] = lambda cfg=cfg: cfg
    info = dryrun.run_cell(arch, shape,
                           mesh=make_mesh((4, 2), ("data", "model")),
                           verbose=False)
    out["cells"][arch + "|" + shape] = info
arch, shape, mesh = SEQ_SPLIT
out["seq_split"] = dryrun.run_cell(arch, shape,
                                   mesh=make_mesh(mesh, ("data", "model")),
                                   verbose=False)
cfg = smoke_config("mamba2-780m").scaled(max_seq=40_000)
_REGISTRY["mamba2-780m"] = lambda: cfg
out["ssm_prefill"] = dryrun.run_cell("mamba2-780m", "prefill_32k",
                                     mesh=make_mesh((4, 2), ("data", "model")),
                                     verbose=False)

from repro_torch.models import transformer


def no_remat(body, h, n):
    aux = 0
    for i in range(n):
        h, a = body(i, h)
        aux = aux + a
    return h, aux


two_level, transformer._two_level = transformer._two_level, no_remat
out["no_remat"] = dryrun.run_cell("qwen3-4b", "train_4k",
                                  mesh=make_mesh((4, 2), ("data", "model")),
                                  verbose=False)
transformer._two_level = two_level

from torch.distributed.tensor import DTensor, Replicate, Shard
dm = make_mesh((8,), ("data",)).device_mesh("cpu")
x = DTensor.from_local(torch.empty(3, 5, device="meta"), dm, [Shard(0)],
                       run_check=False)
w = DTensor.from_local(torch.empty(5, 7, device="meta"), dm, [Replicate()],
                       run_check=False)
rec = dryrun.CostRecorder()
with rec:
    y = (x @ w).redistribute(dm, [Replicate()])
out["gather"] = dryrun.collective_bytes(rec.collectives)
out["mm_flops"] = rec.flops
out["y_shape"] = list(y.shape)
print("JSON" + json.dumps(out, default=str))
"""


@pytest.fixture(scope="module")
def cells():
    code = f"CELLS = {CELLS!r}\nSEQ_SPLIT = {SEQ_SPLIT!r}\n" + _SUB
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("JSON")]
    return json.loads(line[-1][4:])


@pytest.mark.parametrize("arch,shape", CELLS)
def test_reduced_mesh_cell(cells, arch, shape):
    info = cells["cells"][f"{arch}|{shape}"]
    for k in tdryrun.FIELDS:
        assert k in info, k
    assert info["chips"] == 8 and info["mesh"] == {"data": 4, "model": 2}
    assert set(info["memory"]) == {"argument_bytes", "output_bytes",
                                   "temp_bytes", "alias_bytes"}
    assert info["memory"]["temp_bytes"] >= 0
    assert info["memory"]["argument_bytes"] > 0
    t = info["roofline_seconds"]
    assert info["bottleneck"] == max(("compute", "memory", "collective"),
                                     key=t.get)
    # the memory term that names the bound is the analytic HBM bytes'; the
    # unfused bytes' is an upper bound beside it
    assert t["memory"] == info["analytic"]["roofline_seconds"]["memory"]
    assert t["memory_unfused_upper_bound"] >= t["memory"]
    assert set(info["collectives"]) <= {"all-gather", "reduce-scatter",
                                        "all-reduce", "all-to-all",
                                        "broadcast"}
    a = info["analytic"]
    lo, hi = a["expected_band"]
    assert lo <= a["counted_over_expected"] <= hi, (
        a["counted_over_expected"], lo, hi)
    assert a["expected_flops_per_chip"] * a["counted_over_expected"] == \
        pytest.approx(info["flops_per_chip"], rel=1e-12)
    assert info["flops_per_chip"] > 0 and info["bytes_per_chip"] > 0


def test_serving_cells_are_held_to_the_train_band(cells):
    """Prefill and decode run with their layouts pinned (the activation
    constraint threaded through ``bundle.prefill``/``decode``, decode
    attention on local shards), so their band is the train step's 1 -+
    FLOPS_TOL, and a decode whose cache splits its sequence counts
    within it too."""
    tol = tdryrun.FLOPS_TOL
    infos = [cells["cells"][f"{a}|{s}"] for a, s in CELLS
             if s != "train_4k"] + [cells["seq_split"]]
    assert len(infos) == 4
    for info in infos:
        a = info["analytic"]
        assert tuple(a["expected_band"]) == (1 - tol, 1 + tol)
        assert abs(a["counted_over_expected"] - 1) <= tol, info["arch"]
    assert cells["seq_split"]["mesh"] == {"data": 2, "model": 4}


def test_ssm_prefill_cell_projects_the_prompt_once(cells):
    """mamba2-780m x prefill_32k at 4x2: the prefill takes each layer's
    state from the chunked scan's carry, so the prompt is projected once
    a layer (``expected_flops_per_chip`` counts one projection) and the
    count is inside the band; the cell takes seconds, not the minutes of
    a per-token recurrence on DTensors."""
    info = cells["ssm_prefill"]
    a = info["analytic"]
    lo, hi = a["expected_band"]
    assert (lo, hi) == (1 - tdryrun.FLOPS_TOL, 1 + tdryrun.FLOPS_TOL)
    assert lo <= a["counted_over_expected"] <= hi
    assert info["cell_seconds"] < 120


_THREE_D = """
import json
from repro_torch.configs import smoke_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.registry import _REGISTRY
cfg = smoke_config("mamba2-780m").scaled(max_seq=40_000)
_REGISTRY["mamba2-780m"] = lambda: cfg
info = dryrun.run_cell("mamba2-780m", "train_4k", mesh=make_mesh(
    (2, 2, 2), ("pod", "data", "model")), verbose=False)
print("JSON" + json.dumps(info["analytic"], default=str))
"""


def test_ssm_train_cell_on_a_three_dim_mesh():
    """mamba2-780m x train_4k on a 2 x 2 x 2 ("pod", "data", "model") mesh
    at smoke width finishes within 60 s (its SSD scan runs on local
    shards: DTensor's own rules planned a strided batch split for
    minutes) and counts within the band."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", _THREE_D],
                         capture_output=True, text=True, env=env,
                         timeout=60)
    assert out.returncode == 0, out.stderr[-3000:]
    a = json.loads([ln for ln in out.stdout.splitlines()
                    if ln.startswith("JSON")][-1][4:])
    lo, hi = a["expected_band"]
    assert lo <= a["counted_over_expected"] <= hi


def test_train_flops_gate_is_tight(cells):
    """The train cell's band is 1 -+ FLOPS_TOL; its count is within it, a
    planted 2x (or half) count is not, and so is not a step that runs
    without the remat."""
    tol = tdryrun.FLOPS_TOL
    a = cells["cells"]["qwen3-4b|train_4k"]["analytic"]
    assert tuple(a["expected_band"]) == (1 - tol, 1 + tol)
    assert abs(a["counted_over_expected"] - 1) <= tol
    for planted in (2.0, 0.5):
        assert abs(planted * a["counted_over_expected"] - 1) > tol
    bare = cells["no_remat"]["analytic"]
    assert bare["expected_flops_per_chip"] == a["expected_flops_per_chip"]
    assert bare["counted_over_expected"] < 1 - tol


def test_collective_recorder_and_local_flops(cells):
    """A (24, 5) x (5, 7) product with rows on 8 ranks: 2 * 3 * 5 * 7
    flops a rank; gathering its (24, 7) float32 result is one all-gather
    whose result is 24 * 7 * 4 bytes."""
    assert cells["gather"] == {"all-gather": 24 * 7 * 4}
    assert cells["mm_flops"] == 2 * 3 * 5 * 7
    assert cells["y_shape"] == [24, 7]


def test_skip_rules_active_params_and_param_bytes():
    """Every config x shape's skip rule, every config's active parameter
    count and its sharded parameter bytes at 16x16 and 2x16x16, as the
    reference's; a skipped cell makes no process group."""
    import torch.distributed as dist
    jdryrun = _reference_dryrun()
    meshes = [(AbstractMesh((16, 16), ("data", "model")),
               tmesh.make_production_mesh()),
              (AbstractMesh((2, 16, 16), ("pod", "data", "model")),
               tmesh.make_production_mesh(multi_pod=True))]
    for arch in tconfigs.ASSIGNED_ARCHS:
        jb, tb = jregistry.get_bundle(arch), tregistry.get_bundle(arch)
        assert tdryrun.active_param_count(tb) == \
            jdryrun.active_param_count(jb)
        for jm, tm in meshes:
            assert tdryrun.sharded_param_bytes(tb, tm) == \
                jdryrun.sharded_param_bytes(jb, jm)
        for shape in tregistry.SHAPES:
            ok, why = tb.supports(tregistry.SHAPES[shape])
            assert (ok, why) == jb.supports(jregistry.SHAPES[shape])
            if not ok:
                lowered, info = tdryrun.lower_cell(arch, shape)
                assert lowered is None and info["skipped"] == why
    assert not dist.is_initialized()
    b = tregistry.get_bundle("qwen3-moe-235b-a22b")
    assert b.param_count() > 200e9
    assert 15e9 < tdryrun.active_param_count(b) < 30e9


def test_main_skipped_cell_json(tmp_path):
    """The CLI on a skipped cell: the JSON names the skip, exit 0."""
    out = tmp_path / "cells.json"
    assert tdryrun.main(["--arch", "qwen3-32b", "--shape", "long_500k",
                         "--json-out", str(out)]) == 0
    rows = json.loads(out.read_text())
    assert rows[0]["arch"] == "qwen3-32b" and "skipped" in rows[0]
