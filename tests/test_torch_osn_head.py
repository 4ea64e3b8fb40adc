"""``training/osn_head.py`` against ``repro/training/osn_head.py`` at smoke
width: backbone features, then ``train_osn_head`` for 3 iterations with
the fused sketch kernel off and on (the reference's Newton loop with
``use_kernels=True``, its Pallas kernels in interpret mode); fval and
gnorm within rtol 1e-4, simulated time and cost bit for bit.  Then
``examples/osn_lm_head_torch.py --device cpu`` beside
``examples/osn_lm_head.py``."""
import functools
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import NewtonConfig as JConfig
from repro.core import OverSketchConfig as JSketch
from repro.core import Dataset as JDataset
from repro.core import SoftmaxRegression as JSoftmax
from repro.core import oversketched_newton as j_newton
from repro.models.registry import ModelBundle as JBundle
from repro.training import osn_head as josn

from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.kernels import ops
from repro_torch.models.registry import ModelBundle as TBundle
from repro_torch.training import extract_features, train_osn_head

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
K, N, SEQ, ITERS = 4, 512, 16, 3
RTOL = 1e-4


ENV = {"PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu",
       "PATH": "/usr/bin:/bin"}


@pytest.fixture(scope="module", autouse=True)
def reference_example():
    """examples/osn_lm_head.py (~30 s, mostly the reference's per-call
    compiles) started with the module's first test, so that it runs beside
    the others; the example test reads its output."""
    proc = subprocess.Popen([sys.executable, "examples/osn_lm_head.py"],
                            stdout=subprocess.PIPE, text=True, cwd=str(ROOT),
                            env=ENV)
    yield proc
    if proc.poll() is None:
        proc.kill()
    proc.wait()


@functools.lru_cache(maxsize=None)
def _setup(dtype: str, arch: str = "qwen3-4b"):
    """(reference features, port features, labels) for N synthetic
    documents with class-conditioned token ranges."""
    jc = jconfigs.smoke_config(arch).scaled(dtype=dtype)
    tc = tconfigs.smoke_config(arch).scaled(dtype=dtype)
    jb, tb = JBundle(jc), TBundle(tc)
    jp = jb.init(jax.random.PRNGKey(0))
    tp = convert.params(tc, jax.tree.map(np.asarray, jp), "cpu")
    rs = np.random.RandomState(0)
    labels = rs.randint(0, K, N)
    toks = (rs.randint(1, jc.vocab_size // K - 1, (N, SEQ)) +
            labels[:, None] * (jc.vocab_size // K)).astype(np.int32)
    fj = np.concatenate([np.asarray(josn.extract_features(
        jb, jp, jnp.asarray(toks[i:i + 128]))) for i in range(0, N, 128)])
    ft = torch.cat([extract_features(tb, tp, torch.from_numpy(
        toks[i:i + 128])) for i in range(0, N, 128)])
    return fj, ft, labels


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 3e-2)])
def test_extract_features(dtype, tol):
    fj, ft, _ = _setup(dtype)
    assert ft.dtype == torch.float32 and ft.shape == (N, 64)
    assert np.abs(ft.numpy() - fj).max() <= tol * np.abs(fj).max()


def _reference_run(fj, onehot, use_kernels: bool):
    """The reference's train_osn_head, with ``use_kernels`` set (its
    NewtonConfig leaves it False)."""
    b, d = fj.shape
    sketch_dim = max(128, 128 * (-(-4 * d * K // 128)))
    cfg = JConfig(iters=ITERS, solver="pinv",
                  sketch=JSketch(sketch_dim, 128, 0.25),
                  coded_block_rows=min(256, max(32, b // 8)), seed=0,
                  use_kernels=use_kernels)
    res = j_newton(JSoftmax(num_classes=K),
                   JDataset(x=jnp.asarray(fj), y=jnp.asarray(onehot)),
                   jnp.zeros(K * d), cfg)
    return res.w, res.history


@pytest.mark.parametrize("use_kernels", [False, True])
def test_train_osn_head_matches_reference(use_kernels):
    fj, _, labels = _setup("float32")
    onehot = np.eye(K, dtype=np.float32)[labels]
    if use_kernels:
        wj, hj = _reference_run(fj, onehot, True)
    else:
        wj, hj = josn.train_osn_head(jnp.asarray(fj), jnp.asarray(onehot),
                                     num_classes=K, iters=ITERS)
    ops.reset_launch_counts()
    wt, ht = train_osn_head(torch.from_numpy(fj), torch.from_numpy(onehot),
                            num_classes=K, iters=ITERS,
                            use_kernels=use_kernels)
    assert sum(ops.launch_counts().values()) == 0     # plain on the CPU
    assert ht["time"] == hj["time"] and ht["cost"] == hj["cost"]
    for key in ("fval", "gnorm"):
        np.testing.assert_allclose(ht[key], hj[key], rtol=RTOL)
    assert len(ht["fval"]) == ITERS
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=1e-3,
                               atol=1e-4)


def test_moe_backbone():
    """The head on an MoE backbone (qwen3-moe-30b-a3b at smoke width,
    float32): features within 1e-5, then the fused path's history against
    the reference's train_osn_head."""
    fj, ft, labels = _setup("float32", "qwen3-moe-30b-a3b")
    assert np.abs(ft.numpy() - fj).max() <= 1e-5 * np.abs(fj).max()
    onehot = np.eye(K, dtype=np.float32)[labels]
    _, hj = josn.train_osn_head(jnp.asarray(fj), jnp.asarray(onehot),
                                num_classes=K, iters=ITERS)
    _, ht = train_osn_head(torch.from_numpy(fj), torch.from_numpy(onehot),
                           num_classes=K, iters=ITERS, use_kernels=True)
    assert ht["time"] == hj["time"] and ht["cost"] == hj["cost"]
    for key in ("fval", "gnorm"):
        np.testing.assert_allclose(ht[key], hj[key], rtol=RTOL)


def test_kernel_flag_keeps_the_history():
    """On the CPU the fused path's plain version gives the unfused path's
    history: use_kernels changes the route, not the iterates."""
    fj, _, labels = _setup("float32")
    onehot = torch.from_numpy(np.eye(K, dtype=np.float32)[labels])
    runs = [train_osn_head(torch.from_numpy(fj), onehot, num_classes=K,
                           iters=2, use_kernels=u)[1] for u in (False, True)]
    assert runs[0]["time"] == runs[1]["time"]
    np.testing.assert_allclose(runs[0]["fval"], runs[1]["fval"], rtol=RTOL)


def _table(out: str):
    rows = re.findall(r"^\s*(\d+)\s+(\S+)\s+(\S+)\s+(\S+)$", out, re.M)
    acc = float(re.search(r"accuracy: (\S+)", out).group(1))
    return [tuple(float(x) for x in r[1:]) for r in rows], acc


def test_example_on_the_cpu(reference_example):
    """examples/osn_lm_head_torch.py --device cpu beside the reference's
    example: 8 iterations with the same simulated times.  The example's
    backbone is bfloat16, so its features carry the bfloat16 gap (3e-2 of
    max |ref| above): fval within 1e-3 relative, the accuracy within
    0.01."""
    mine = subprocess.run([sys.executable, "examples/osn_lm_head_torch.py",
                           "--device", "cpu"], capture_output=True,
                          text=True, check=True, cwd=str(ROOT), env=ENV)
    theirs = reference_example.communicate()[0]
    assert reference_example.returncode == 0
    (want, acc_w), (got, acc_g) = _table(theirs), _table(mine.stdout)
    assert len(got) == len(want) == 8
    for (fg, _, tg), (fw, _, tw) in zip(got, want):
        assert tg == tw
        assert abs(fg - fw) <= 1e-3 * abs(fw)
    assert abs(acc_g - acc_w) <= 0.01
