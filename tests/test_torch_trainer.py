"""The LM training path against the JAX package at smoke width: AdamW
(three steps from one state, a clipped one among them; the schedule),
the token pipeline bit for bit, the checkpoint manager (the reference's
``tests/test_checkpoint.py`` cases), the trainer against the reference
trainer and its restart, the launcher and the example, and the
straggler-resilient collectives and gradients on gloo groups of worker
processes against the reference under ``jax.vmap``.

Tolerances: AdamW float32 within 1e-6 of max |ref|, bfloat16 parameters
at most one bf16 ulp apart (they agree bit for bit); the trainer at
float32 (``smoke_config`` patched to float32 in both packages, here in
the test) loss and grad norm within 1e-4 relative at every step, at
bfloat16 both losses fall and the first within 3e-2; a restart's losses
equal an uninterrupted run's bit for bit; the collectives within 1e-6
(the int8 form bit for bit); the 2-rank resilient step within 1e-5.
"""
import os
import socket
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro import configs as jconfigs
from repro.checkpoint import CheckpointManager as JManager
from repro.data.pipeline import TokenPipeline as JPipeline
from repro.distributed import collectives as jcol
from repro.launch.mesh import make_host_mesh
from repro.models import registry as jregistry
from repro.optim import adamw as jadamw
from repro.training import trainer as jtrainer

from repro_torch import configs as tconfigs
from repro_torch import convert, prng
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.models import common as tcommon
from repro_torch.models import registry as tregistry
from repro_torch.optim import adamw as tadamw
from repro_torch.training import trainer as ttrainer

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_dist  # noqa: E402

torch.set_num_threads(1)

STEPS, BATCH, SEQ = 10, 4, 64


def _paths(tree):
    return {"/".join(k.key for k in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _np(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _bits(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.view(torch.int16).numpy().astype(np.int64)
    return np.asarray(t).view(np.int16).astype(np.int64)


# -------------------------------------------------------------- AdamW ------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_three_steps(dtype):
    """Three ``apply`` steps from one state (non-zero moments at step 5,
    carried across by ``convert.adamw_state``) and one set of gradients
    per step, the second past the clip norm."""
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    rs = np.random.RandomState(0)
    shapes = {"embed": (40, 16), "layers": {"w": (3, 16, 24),
                                            "scale": (3, 24)}}

    def tree(scale, dt=jdt):
        return jax.tree.map(
            lambda sh: jnp.asarray(rs.standard_normal(sh) * scale).astype(
                dt), shapes, is_leaf=lambda x: isinstance(x, tuple))
    jp = tree(1.0)
    js = jadamw.AdamWState(step=jnp.asarray(5, jnp.int32), mu=tree(0.01),
                           nu=jax.tree.map(jnp.abs, tree(1e-4, jnp.float32)))
    grads = [tree(0.01), tree(5.0), tree(0.005)]
    cfg = dict(lr=1e-2, warmup_steps=3, total_steps=12)
    jc, tc = jadamw.AdamWConfig(**cfg), tadamw.AdamWConfig(**cfg)

    def port(t):
        return jax.tree.map(lambda a: convert.tensor(np.asarray(a), "cpu"),
                            t)
    tp = port(jp)
    ts = convert.adamw_state(jax.tree.map(np.asarray, js), "cpu")
    clipped = []
    for g in grads:
        clipped.append(float(jadamw.global_norm(g)) > jc.clip_norm)
        jp, js = jadamw.apply(jc, g, js, jp)
        tg = port(g)
        before = {k: v.clone() for k, v in tcommon.flatten(tg)}
        tp, ts = tadamw.apply(tc, tg, ts, tp)
        assert all(torch.equal(v, before[k])
                   for k, v in tcommon.flatten(tg))   # grads untouched
    assert clipped == [False, True, False]
    assert int(ts.step) == int(js.step) == 8
    for name, jt, tt_ in (("params", jp, tp), ("mu", js.mu, ts.mu),
                          ("nu", js.nu, ts.nu)):
        want = _paths(jt)
        for path, got in tcommon.flatten(tt_):
            w = want[path]
            if got.dtype == torch.bfloat16:
                assert np.abs(_bits(got) - _bits(w)).max() <= 1, (name, path)
            else:
                err = np.abs(got.numpy() - _np(w)).max()
                assert err <= 1e-6 * np.abs(_np(w)).max(), (name, path, err)


@pytest.mark.parametrize("warmup,total", [(20, 1000), (3, 12), (0, 5)])
def test_schedule_equals_the_reference(warmup, total):
    """The float32 learning rate at every step 0 .. total, bit for bit."""
    jc = jadamw.AdamWConfig(lr=1e-3, warmup_steps=warmup, total_steps=total)
    tc = tadamw.AdamWConfig(lr=1e-3, warmup_steps=warmup, total_steps=total)
    want = np.asarray(jax.vmap(lambda s: jadamw.schedule(jc, s))(
        jnp.arange(total + 1, dtype=jnp.int32)))
    got = np.array([tadamw.schedule(tc, torch.tensor(s, dtype=torch.int32))
                    .item() for s in range(total + 1)], np.float32)
    np.testing.assert_array_equal(got, want)


def test_global_norm_and_init():
    """global_norm over a tree in sorted-key order; init's moment dtypes
    and the int32 step."""
    rs = np.random.RandomState(2)
    t = {"b": rs.standard_normal((5, 3)).astype(np.float32),
         "a": {"z": rs.standard_normal(7).astype(np.float32)}}
    got = tadamw.global_norm(jax.tree.map(torch.from_numpy, t))
    assert abs(float(got) - float(jadamw.global_norm(t))) <= \
        1e-6 * float(got)
    st = tadamw.init({"w": torch.zeros(3, dtype=torch.bfloat16)})
    assert st.mu["w"].dtype == torch.bfloat16
    assert st.nu["w"].dtype == torch.float32
    assert st.step.dtype == torch.int32 and int(st.step) == 0


# ------------------------------------------------------------ pipeline -----
@pytest.mark.parametrize("arch", ["qwen3-4b", "llava-next-34b",
                                  "whisper-large-v3"])
def test_token_pipeline_bit_for_bit(arch):
    """``batch_at`` equals the reference's at several steps, the patch and
    frame extras (shaped by each bundle's input_specs) included; and
    ``device_batch`` and the prefetch thread give the same batches."""
    jb, tb = jregistry.ModelBundle(jconfigs.smoke_config(arch)), \
        tregistry.ModelBundle(tconfigs.smoke_config(arch))
    jins = jb.input_specs(jregistry.ShapeSpec("t", "train", 32, 3))
    tins = tb.input_specs(tregistry.ShapeSpec("t", "train", 32, 3))
    names = ("frame_embeds", "patch_embeds")
    jp = JPipeline(jb.cfg.vocab_size, 3, jins["tokens"].shape[1], seed=5,
                   extra_specs={k: v for k, v in jins.items()
                                if k in names})
    tp = TokenPipeline(tb.cfg.vocab_size, 3, tins["tokens"].shape[1],
                       seed=5, extra_specs={k: v for k, v in tins.items()
                                            if k in names})
    for step in (0, 1, 7, 123):
        want, got = jp.batch_at(step), tp.batch_at(step)
        assert sorted(want) == sorted(got)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
        dev = tp.device_batch(step)
        for k in want:
            np.testing.assert_array_equal(dev[k].numpy(), want[k])
    tp.start(3)
    try:
        for step in (3, 4):
            s, b = tp.next()
            assert s == step
            np.testing.assert_array_equal(b["tokens"].numpy(),
                                          jp.batch_at(step)["tokens"])
    finally:
        tp.stop()


# ---------------------------------------------------------- checkpoints ----
def _state(seed=0):
    w = prng.normal_bf16_plain(prng.PRNGKey(seed), (8, 16), "cpu")
    return {"params": {"w": w, "b": torch.zeros(16)},
            "step": torch.tensor(7, dtype=torch.int32)}


def _leaves(state):
    from repro_torch.checkpoint.manager import _flatten_with_names
    return _flatten_with_names(state)


def test_checkpoint_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    state = _state()
    mgr.save(5, state)
    restored = mgr.restore(5, state)
    for (na, a), (nb, b) in zip(_leaves(state), _leaves(restored)):
        assert na == nb and a.dtype == b.dtype
        assert torch.equal(a, b)
        assert a.data_ptr() != b.data_ptr()


def test_checkpoint_latest_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    state = _state()
    for s in (1, 2, 3, 4):
        mgr.save(s, state)
    assert mgr.all_steps() == [3, 4]
    assert mgr.latest_step() == 4


def test_checkpoint_async_save(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    state = _state(1)
    mgr.async_save(9, state)
    w = state["params"]["w"].clone()
    state["params"]["w"].zero_()          # the snapshot was taken already
    mgr.wait()
    restored = mgr.restore_latest(state)
    assert torch.equal(restored["params"]["w"], w)


def test_checkpoint_restore_empty_returns_none(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.restore_latest(_state()) is None


def test_checkpoint_leaf_count_mismatch_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _state())
    with pytest.raises(AssertionError):
        mgr.restore(1, {"params": {"w": torch.zeros((8, 16),
                                                    dtype=torch.bfloat16)}})
    like = _state()
    like["params"]["b"] = torch.zeros(15)
    with pytest.raises(AssertionError, match="ckpt"):
        mgr.restore(1, like)


def test_checkpoint_partial_write_never_corrupts(tmp_path):
    """Only fully-renamed step dirs are visible."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _state())
    os.makedirs(os.path.join(str(tmp_path), ".tmp-2"))
    assert mgr.all_steps() == [1]


def test_checkpoint_layout_is_the_references(tmp_path):
    """The same files: bf16 stored as uint16 with "bfloat16" in the
    manifest, one .npy a leaf, the bits the reference writes; a meta
    tensor restores onto the CPU."""
    import json
    state = _state(2)
    CheckpointManager(str(tmp_path / "t")).save(3, state)
    jstate = {"params": {"w": convert_bf16(state["params"]["w"]),
                         "b": np.zeros(16, np.float32)},
              "step": np.asarray(7, np.int32)}
    JManager(str(tmp_path / "j")).save(3, jstate)
    man = [json.load(open(tmp_path / d / "step-00000003" / "manifest.json"))
           for d in ("t", "j")]
    assert [(r["shape"], r["dtype"]) for r in man[0]["leaves"]] == \
        [(r["shape"], r["dtype"]) for r in man[1]["leaves"]]
    for a, b in zip(man[0]["leaves"], man[1]["leaves"]):
        x = np.load(tmp_path / "t" / "step-00000003" / a["file"])
        y = np.load(tmp_path / "j" / "step-00000003" / b["file"])
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    like = {"params": {"w": torch.empty((8, 16), dtype=torch.bfloat16,
                                        device="meta"),
                       "b": torch.empty(16, device="meta")},
            "step": torch.empty((), dtype=torch.int32, device="meta")}
    back = CheckpointManager(str(tmp_path / "t")).restore(3, like)
    assert back["params"]["w"].device.type == "cpu"
    assert torch.equal(back["params"]["w"], state["params"]["w"])


def convert_bf16(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy().view(jnp.bfloat16)


# -------------------------------------------------------------- trainer ----
def _smoke_dtype(monkeypatch, dtype="float32"):
    """``smoke_config`` at ``dtype`` in both packages (a test-side patch)."""
    for mod in (jconfigs, tconfigs):
        base = mod.smoke_config
        monkeypatch.setattr(mod, "smoke_config",
                            lambda name, b=base: b(name).scaled(dtype=dtype))


def _histories(monkeypatch, dtype):
    _smoke_dtype(monkeypatch, dtype)
    cfg = dict(arch="qwen3-4b", steps=STEPS, batch=BATCH, seq=SEQ, lr=1e-3)
    jt = jtrainer.Trainer(jtrainer.TrainerConfig(**cfg), make_host_mesh())
    _, _, jh = jt.run(*jt.init_state())
    tt_ = ttrainer.Trainer(ttrainer.TrainerConfig(**cfg), device="cpu")
    params, opt = tt_.init_state()
    _, _, th = tt_.run(params, opt)
    return jh, th


def test_trainer_matches_the_reference_float32(monkeypatch):
    jh, th = _histories(monkeypatch, "float32")
    assert [h["step"] for h in th] == list(range(STEPS))
    for a, b in zip(jh, th):
        for k in ("loss", "grad_norm"):
            assert abs(a[k] - b[k]) <= 1e-4 * abs(a[k]), (a["step"], k)
        assert b["step_time"] > 0
    assert th[-1]["loss"] < th[0]["loss"]


def test_trainer_bfloat16_losses_fall(monkeypatch):
    jh, th = _histories(monkeypatch, "bfloat16")
    assert th[-1]["loss"] < th[0]["loss"] and jh[-1]["loss"] < jh[0]["loss"]
    assert abs(th[0]["loss"] - jh[0]["loss"]) <= 3e-2 * jh[0]["loss"]


def test_restart_resumes_bit_for_bit(tmp_path, monkeypatch):
    """A failure at step 9 resumes from the step-8 checkpoint (steps 8-11
    returned, as the reference's restart loop returns them), with the
    uninterrupted run's losses and norms bit for bit."""
    _smoke_dtype(monkeypatch)
    cfg = dict(arch="qwen3-4b", steps=12, batch=BATCH, seq=SEQ, lr=1e-3)
    tr = ttrainer.Trainer(ttrainer.TrainerConfig(
        **cfg, ckpt_dir=str(tmp_path), ckpt_every=4), device="cpu")
    hist = tr.run_with_restarts(fail_at=9)
    assert [h["step"] for h in hist] == [8, 9, 10, 11]
    assert tr.ckpt.all_steps() == [4, 8, 12]
    ref = ttrainer.Trainer(ttrainer.TrainerConfig(**cfg), device="cpu")
    _, _, full = ref.run(*ref.init_state())
    assert [(h["loss"], h["grad_norm"]) for h in hist] == \
        [(h["loss"], h["grad_norm"]) for h in full[8:]]
    assert hist[-1]["loss"] < full[0]["loss"]


def test_launch_train_and_example(tmp_path, capsys, monkeypatch):
    """``python -m repro_torch.launch.train --device cpu`` with a failure
    and a restart exits 0 (the loss fell) and prints the reference's
    lines; the example runs its failure and restart on the CPU."""
    from repro_torch.launch import train
    rc = train.main(["--steps", "12", "--ckpt-dir", str(tmp_path),
                     "--ckpt-every", "4", "--fail-at", "9", "--device",
                     "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    assert out.startswith("arch=qwen3-4b params=139,648 device=cpu")
    assert "step     8 loss" not in out and "step    10 loss" in out
    assert "over 4 logged steps" in out
    import runpy
    monkeypatch.setattr(sys, "argv", ["train_lm_torch.py", "--steps", "8",
                                      "--device", "cpu"])
    runpy.run_path(os.path.join(os.path.dirname(__file__), "..",
                                "examples", "train_lm_torch.py"),
                   run_name="__main__")
    assert "survived a simulated failure at step 4" in \
        capsys.readouterr().out


# --------------------------------------------------- gloo collectives ------
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(fn, world, tmp_path, *args):
    mp.spawn(fn, args=(world, _free_port(), str(tmp_path), *args),
             nprocs=world, join=True)
    return [torch.load(tmp_path / f"rank{r}.pt") for r in range(world)]


def test_collectives_on_gloo_against_vmap(tmp_path):
    """The three collectives on 4 gloo processes against the reference's
    under ``jax.vmap(axis_name=...)``, with 0, 1 and 3 ranks dead."""
    rs = np.random.RandomState(4)
    world = 4
    xs = [rs.standard_normal((world, 6, 5)).astype(np.float32)
          for _ in range(3)]
    lives = [np.ones(world, np.float32), np.array([1, 0, 1, 1], np.float32),
             np.array([0, 0, 1, 0], np.float32)]
    got = _spawn(_torch_dist.collectives, world, tmp_path,
                 [torch.from_numpy(x) for x in xs],
                 [torch.from_numpy(lv) for lv in lives])

    def ref(x, live):
        tree = {"a": x, "b": {"c": 2.0 * x}}
        return (jcol.resilient_psum(tree, live, "i"),
                jcol.masked_allgather_mean(x, live, "i"),
                jcol.compressed_resilient_psum(tree, live, "i"))
    for case, (x, lv) in enumerate(zip(xs, lives)):
        psum, gather, int8 = jax.vmap(ref, axis_name="i")(jnp.asarray(x),
                                                         jnp.asarray(lv))
        for r in range(world):
            res = got[r][case]
            for path, want in _paths(psum).items():
                have = dict(tcommon.flatten(res["psum"]))[path]
                np.testing.assert_allclose(have.numpy(), np.asarray(want)[r],
                                           rtol=1e-6, atol=1e-6)
                have8 = dict(tcommon.flatten(res["int8"]))[path]
                np.testing.assert_array_equal(have8.numpy(),
                                              np.asarray(_paths(int8)[path])
                                              [r])
            np.testing.assert_array_equal(res["gather"][0].numpy(),
                                          np.asarray(gather[0])[r])
            np.testing.assert_array_equal(res["gather"][1].numpy(),
                                          np.asarray(gather[1])[r])


def test_resilient_grads_on_two_gloo_ranks(tmp_path, monkeypatch):
    """A 2-rank resilient_grads step: both live, the reduced gradients
    (each rank's tree) equal the 1-process step's within 1e-5; rank 1
    dead, they equal rank 0's own gradients of its half of the batch."""
    _smoke_dtype(monkeypatch)
    one = ttrainer.Trainer(ttrainer.TrainerConfig(
        arch="qwen3-4b", steps=2, batch=4, seq=32, lr=1e-3), device="cpu")
    params, _ = one.init_state()
    batch = one.pipeline.device_batch(0)
    _, full = one._loss_and_grads(params, batch)
    full = {k: v.clone() for k, v in tcommon.flatten(full)}
    _, half = one._loss_and_grads(params, {k: v[:2]
                                           for k, v in batch.items()})
    half = {k: v.clone() for k, v in tcommon.flatten(half)}
    for live, want in (([1.0, 1.0], full), ([1.0, 0.0], half)):
        out = _spawn(_torch_dist.resilient_step, 2, tmp_path, live)
        for r in range(2):
            for path, w in want.items():
                g = out[r]["grads"][path]
                assert float((g - w).abs().max()) <= \
                    1e-5 * float(w.abs().max()), (live, r, path)
        assert out[0]["loss"] == out[1]["loss"]
