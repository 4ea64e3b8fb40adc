"""The training losses of every model family against ``repro/models`` at
smoke width: the loss and every parameter's gradient (the reference's
``jax.value_and_grad(bundle.loss)`` against the port's ``loss.backward()``
into a tree of stacked leaves), the two custom backwards alone
(``embed_lookup``'s chunked one-hot product and ``chunked_cross_entropy``
with a chunk shorter than the sequence), the bundle's dry-run helpers,
rematerialization and serving without autograd.

The weights are the port's own init, crossed to jax bit for bit (the
init's parity with the reference's is ``tests/test_torch_models.py`` and
``_families.py``).  float32: the loss within 1e-5 relative, each leaf's
gradient within 1e-4 of that leaf's max |ref grad|, except a leaf whose
reference gradient is rounding noise (below 1e-6 of the tree's largest:
whisper's key biases, whose exact gradient is zero, as a softmax ignores
a shift shared by every key), held to 1e-4 of the tree's largest.
bfloat16: the loss within 3e-2 relative.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import common as jcommon
from repro.models import registry as jregistry

from repro_torch import configs as tconfigs
from repro_torch import prng
from repro_torch.models import common as tcommon
from repro_torch.models import registry as tregistry
from repro_torch.models import transformer as tt

torch.set_num_threads(1)

LOSS_F32 = 1e-5
GRAD_F32 = 1e-4
NOISE_FLOOR = 1e-6
LOSS_BF16 = 3e-2
ARCHS = ["qwen3-4b", "gemma3-27b", "llava-next-34b", "qwen3-moe-30b-a3b",
         "mamba2-780m", "recurrentgemma-2b", "whisper-large-v3"]
BATCH, SEQ = 2, 24


def _to_jax(t: torch.Tensor):
    """A CPU tensor as a jax array, bfloat16 by its 16-bit patterns."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.view(torch.int16).numpy().view(jnp.bfloat16))
    return jnp.asarray(t.numpy())


def _jax_tree(tree):
    if isinstance(tree, dict):
        return {k: _jax_tree(v) for k, v in tree.items()}
    return _to_jax(tree)


def _paths(tree):
    return {"/".join(k.key for k in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


@functools.lru_cache(maxsize=None)
def _model(arch: str, dtype: str):
    """(jax bundle, jax params, port bundle, port modules): the port's
    init from PRNGKey(0), the same bits in jax."""
    jc = jconfigs.smoke_config(arch).scaled(dtype=dtype)
    tc = tconfigs.smoke_config(arch).scaled(dtype=dtype)
    tb = tregistry.ModelBundle(tc)
    tp = tb.init(prng.PRNGKey(0), device="cpu")
    return jregistry.ModelBundle(jc), _jax_tree(tp.tree), tb, tp


def _batch(tb, seed: int = 3):
    """A numpy batch shaped by the bundle's ``input_specs``: tokens and
    labels in [1, V - 1) with the last label of each row ignored (-1),
    frame or patch embeddings standard normal."""
    rs = np.random.RandomState(seed)
    out = {}
    specs = tb.input_specs(tregistry.ShapeSpec("t", "train", SEQ, BATCH))
    for name, spec in specs.items():
        if spec.dtype == torch.int32:
            out[name] = rs.randint(1, tb.cfg.vocab_size - 1,
                                   tuple(spec.shape)).astype(np.int32)
        else:
            out[name] = rs.standard_normal(tuple(spec.shape)).astype(
                np.float32)
    out["labels"][:, -1] = -1
    return out


def _sides(jb, tb, batch):
    """The batch for each package: ints as they are, embeddings in the
    compute dtype."""
    jdt, tdt = jb.cfg.compute_dtype, tb.cfg.compute_dtype
    jbatch = {k: jnp.asarray(v) if v.dtype == np.int32 else
              jnp.asarray(v).astype(jdt) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) if v.dtype == np.int32 else
              torch.from_numpy(v).to(tdt) for k, v in batch.items()}
    return jbatch, tbatch


def _port_loss_and_grads(tb, tp, tbatch):
    tp.requires_grad_(True)
    try:
        grads = tcommon.zero_grads(tp)
        loss = tb.loss(tp, tbatch)
        loss.backward()
    finally:
        tp.requires_grad_(False)
    return float(loss.detach()), grads


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_float32(arch):
    """Loss and every leaf's gradient at float32, the MoE's aux term
    included."""
    jb, jp, tb, tp = _model(arch, "float32")
    jbatch, tbatch = _sides(jb, tb, _batch(tb))
    lj, gj = jax.jit(jax.value_and_grad(jb.loss))(jp, jbatch)
    lt, grads = _port_loss_and_grads(tb, tp, tbatch)
    assert abs(lt - float(lj)) <= LOSS_F32 * abs(float(lj))
    want = {k: np.asarray(v) for k, v in _paths(gj).items()}
    got = dict(tcommon.flatten(grads))
    assert sorted(got) == sorted(want)
    top = max(np.abs(w).max() for w in want.values())
    for path, w in want.items():
        scale = np.abs(w).max()
        if scale < NOISE_FLOOR * top:
            scale = top
        err = np.abs(got[path].numpy() - w).max()
        assert err <= GRAD_F32 * scale, (path, err, scale)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_bfloat16(arch):
    """The bf16 loss within 3e-2 (both round every op, in other orders;
    the hybrid's stack included, whose forward gap Queue 3 item 11 holds
    at the logits)."""
    jb, jp, tb, tp = _model(arch, "bfloat16")
    jbatch, tbatch = _sides(jb, tb, _batch(tb))
    lj = float(jb.loss(jp, jbatch))
    with torch.no_grad():
        lt = float(tb.loss(tp, tbatch))
    assert np.isfinite(lt)
    assert abs(lt - lj) <= LOSS_BF16 * abs(lj)


# ------------------------------------------------- the custom backwards ----
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embed_lookup_backward(dtype):
    """The gather's gradient by chunked one-hot products (a chunk of 5 on
    a sequence of 12: two whole chunks and a padded one) against the
    reference's ``custom_vjp``, repeated tokens included."""
    rs = np.random.RandomState(0)
    vocab, d = 40, 16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    emb = torch.from_numpy(rs.standard_normal((vocab, d)).astype(
        np.float32)).to(tdt)
    toks = rs.randint(0, 8, (3, 12)).astype(np.int32)
    g = torch.from_numpy(rs.standard_normal((3, 12, d)).astype(
        np.float32)).to(tdt)
    out, vjp = jax.vjp(lambda e: jcommon.embed_lookup(e, jnp.asarray(toks),
                                                      5), _to_jax(emb))
    want = np.asarray(vjp(_to_jax(g))[0].astype(jnp.float32))
    e = emb.clone().requires_grad_(True)
    got = tcommon.embed_lookup(e, torch.from_numpy(toks), 5)
    np.testing.assert_array_equal(got.detach().float().numpy(),
                                  np.asarray(out.astype(jnp.float32)))
    got.backward(g)
    assert e.grad.dtype == tdt
    tol = 1e-6 if dtype == "float32" else 1e-2
    assert np.abs(e.grad.float().numpy() - want).max() <= \
        tol * np.abs(want).max()
    # the grad of a token never looked up is exactly zero
    assert float(e.grad[20:].abs().max()) == 0.0


@pytest.mark.parametrize("tied", [False, True])
def test_chunked_cross_entropy(tied):
    """Value and gradients (h and the head) with chunk < S (7 of 20:
    three chunks, the last padded), an ignored label, tied and untied
    heads; and against the unchunked ``cross_entropy_loss``."""
    rs = np.random.RandomState(1)
    b, s, d, vocab = 2, 20, 8, 30
    h = rs.standard_normal((b, s, d)).astype(np.float32)
    head = rs.standard_normal((vocab, d) if tied else (d, vocab)).astype(
        np.float32)
    labels = rs.randint(0, vocab, (b, s)).astype(np.int32)
    labels[0, 3] = labels[1, -1] = -1

    def jloss(hh, hd):
        return jcommon.chunked_cross_entropy(
            hh, hd, jnp.asarray(labels), transpose_head=tied, chunk=7)
    lj, (gh, ghead) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(head))
    th = torch.from_numpy(h).requires_grad_(True)
    thead = torch.from_numpy(head).requires_grad_(True)
    lt = tcommon.chunked_cross_entropy(th, thead, torch.from_numpy(labels),
                                       transpose_head=tied, chunk=7)
    lt.backward()
    assert abs(float(lt.detach()) - float(lj)) <= 1e-6 * abs(float(lj))
    for got, want in ((th.grad, gh), (thead.grad, ghead)):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    logits = torch.from_numpy(h) @ (torch.from_numpy(head).T if tied
                                    else torch.from_numpy(head))
    plain = tcommon.cross_entropy_loss(logits, torch.from_numpy(labels))
    jplain = jcommon.cross_entropy_loss(jnp.asarray(logits.numpy()),
                                        jnp.asarray(labels))
    assert abs(float(plain) - float(jplain)) <= 1e-6 * abs(float(jplain))
    assert abs(float(plain) - float(lt.detach())) <= 1e-5 * abs(float(lj))


def test_chunk_slices_clamp_as_dynamic_slice():
    """A label sequence shorter than the padded hidden states is sliced as
    ``lax.dynamic_slice_in_dim`` slices it: the start clamped."""
    x = torch.arange(10)
    assert tcommon.dynamic_slice(x, 8, 4, 0).tolist() == [6, 7, 8, 9]
    with pytest.raises(ValueError):
        tcommon.dynamic_slice(x, 0, 11, 0)


# ------------------------------------------------------ rematerialization ---
def test_remat_changes_no_bit():
    """gemma3's six layers (two remat groups of three) and the hybrid's
    (rec, rec, attn) groups: the loss and every gradient with the
    two-level checkpointing equal those of the plain pass, bit for bit."""
    for arch in ("gemma3-27b", "recurrentgemma-2b"):
        _, _, tb, tp = _model(arch, "float32")
        _, tbatch = _sides(_model(arch, "float32")[0], tb, _batch(tb))
        lt, grads = _port_loss_and_grads(tb, tp, tbatch)
        lt_r = {k: v.clone() for k, v in tcommon.flatten(grads)}
        plain = tt.forward_hidden
        try:
            tt.forward_hidden = lambda *a, remat=False, **kw: plain(*a,
                                                                    **kw)
            lp, gp = _port_loss_and_grads(tb, tp, tbatch)
        finally:
            tt.forward_hidden = plain
        assert lp == lt
        for path, g in tcommon.flatten(gp):
            assert torch.equal(g, lt_r[path]), (arch, path)


# ------------------------------------------------------ dry-run helpers -----
@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_axes_input_specs_supports(arch):
    """``abstract`` (meta tensors), ``logical_axes``, ``input_specs`` of
    every cell kind and ``supports`` against the reference's, and
    ``SHAPES``."""
    jb, tb = jregistry.get_bundle(arch), tregistry.get_bundle(arch)
    want = _paths(jb.abstract())
    got = dict(tcommon.flatten(tb.abstract()))
    assert sorted(got) == sorted(want)
    for path, t in got.items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == want[path].shape
        assert (t.dtype == torch.bfloat16) == (want[path].dtype ==
                                               jnp.bfloat16)
    axes_j = {"/".join(k.key for k in p): a for p, a in
              jax.tree_util.tree_flatten_with_path(
                  jb.logical_axes(), is_leaf=lambda x: isinstance(
                      x, tuple))[0]}
    assert dict(tcommon.flatten(tb.logical_axes())) == axes_j
    assert {k: dataclasses.asdict(v) for k, v in tregistry.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in jregistry.SHAPES.items()}
    for name, shape in jregistry.SHAPES.items():
        tshape = tregistry.SHAPES[name]
        assert tb.supports(tshape) == jb.supports(shape)
        ji, ti = jb.input_specs(shape), tb.input_specs(tshape)
        assert sorted(ji) == sorted(ti)
        for k, v in ji.items():
            assert tuple(ti[k].shape) == v.shape, (name, k)
            assert ti[k].device.type == "meta"
            assert str(ti[k].dtype).split(".")[-1] == str(v.dtype), (name, k)


# ----------------------------------------------------- serving, no grad -----
def test_serving_runs_without_autograd_on_a_trainable_model():
    """A trainable model (requires_grad on) serves the same tokens as the
    frozen one, with no graph: prefill's logits need no grad."""
    from repro_torch.launch import serve
    _, _, tb, tp = _model("qwen3-4b", "float32")
    rs = np.random.RandomState(0)
    prompts = [rs.randint(1, 500, n) for n in (5, 9, 7)]
    frozen = serve.BatchedServer(tb, tp, 4, 64).generate(prompts, 6)
    tp.requires_grad_(True)
    try:
        cache = tb.init_cache(1, 16, device="cpu")
        logits, _ = tb.prefill(tp, torch.from_numpy(prompts[0][None]),
                               cache)
        assert not logits.requires_grad
        assert serve.BatchedServer(tb, tp, 4, 64).generate(prompts, 6) == \
            frozen
    finally:
        tp.requires_grad_(False)
