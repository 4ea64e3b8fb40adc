"""The dense model family against ``repro/models`` at smoke width: the
configs field for field, parameter counts, the init bit for bit (float32
and bfloat16), rope, the norms, chunked and decode attention, and
forward, prefill and decode of qwen3-4b, qwen2-7b (QKV bias),
llava-next-34b (patch stub) and gemma3-27b (windowed cache), with the
weights crossed by ``convert.params``; then the analytic cost model.

float32 agrees within 1e-5 of max |ref|.  bfloat16 agrees within
``BF16_REL`` of max |ref|: both sides round every operation to bfloat16,
in orders that differ (the largest gap measured at smoke width is 1.8e-2,
gemma3-27b's forward).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import analytic as janalytic
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import registry as jregistry
from repro.models import transformer as jt

from repro_torch import configs as tconfigs
from repro_torch import convert, prng
from repro_torch.kernels import ops
from repro_torch.launch import analytic as tanalytic
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import registry as tregistry
from repro_torch.models import transformer as tt

torch.set_num_threads(1)

F32_REL = 1e-5
BF16_REL = 3e-2
DENSE = ["qwen3-4b", "qwen3-32b", "qwen2-7b", "gemma3-27b", "llava-next-34b"]
MODELS = ["qwen3-4b", "qwen2-7b", "llava-next-34b", "gemma3-27b"]
DTYPES = ["float32", "bfloat16"]
# Each model at float32, and the two that differ in their layer stack at
# bfloat16 (the reference's init alone takes ~3.5 s a model here).
MODEL_CASES = [(a, "float32") for a in MODELS] + [
    ("qwen3-4b", "bfloat16"), ("gemma3-27b", "bfloat16")]


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    return float(np.abs(got.float().numpy() - want).max() /
                 np.abs(want).max())


def _tol(dtype: str) -> float:
    return F32_REL if dtype == "float32" else BF16_REL


def _bits(t: torch.Tensor) -> np.ndarray:
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


# ---------------------------------------------------------------- configs ----
@pytest.mark.parametrize("arch", jconfigs.ASSIGNED_ARCHS)
def test_configs_equal_field_for_field(arch):
    assert tconfigs.ASSIGNED_ARCHS == jconfigs.ASSIGNED_ARCHS
    full = (jregistry.get_config(arch), tregistry.get_config(arch))
    smoke = (jconfigs.smoke_config(arch), tconfigs.smoke_config(arch))
    for j, t in (full, smoke):
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        assert t.resolved_head_dim == j.resolved_head_dim
        assert (t.compute_dtype == torch.bfloat16) == \
            (j.compute_dtype == jnp.bfloat16)


@pytest.mark.parametrize("arch", DENSE)
def test_param_count(arch):
    assert tregistry.get_bundle(arch).param_count() == \
        jregistry.get_bundle(arch).param_count()


def test_qwen3_4b_full_width_parameters():
    assert tregistry.get_bundle("qwen3-4b").param_count() == 4_411_424_256


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "recurrentgemma-2b",
                                  "mamba2-780m", "whisper-large-v3"])
def test_families_not_yet_ported_raise(arch):
    """These families were refused until they were ported: the bundle now
    builds, with the reference's spec tree (the families' parity is
    ``tests/test_torch_families.py``)."""
    tb, jb = tregistry.get_bundle(arch), jregistry.get_bundle(arch)
    assert tb.param_count() == jb.param_count()
    assert [p for p, _ in tcommon.flatten(tb.specs())] == [
        "/".join(k.key for k in path) for path, _ in
        jax.tree_util.tree_flatten_with_path(
            jb.specs(), is_leaf=lambda x: isinstance(x, jcommon.Spec))[0]]


# ----------------------------------------------------------------- models ----
@functools.lru_cache(maxsize=None)
def _model(arch: str, dtype: str):
    """(jax cfg, jax params, port cfg, port modules by convert.params)."""
    jc = jconfigs.smoke_config(arch).scaled(dtype=dtype)
    tc = tconfigs.smoke_config(arch).scaled(dtype=dtype)
    jp = jregistry.ModelBundle(jc).init(jax.random.PRNGKey(0))
    tp = convert.params(tc, jax.tree.map(np.asarray, jp), "cpu")
    return jc, jp, tc, tp


def _inputs(jc, seq: int, seed: int = 2):
    """Tokens (2, seq) and, for the patch stub, its embeddings."""
    rs = np.random.RandomState(seed)
    toks = rs.randint(1, jc.vocab_size - 1, (2, seq)).astype(np.int32)
    if jc.frontend != "patch_stub":
        return toks, None, None
    e = rs.standard_normal((2, jc.num_patches, jc.d_model)).astype(
        np.float32)
    td = torch.float32 if jc.dtype == "float32" else torch.bfloat16
    return toks, jnp.asarray(e).astype(jc.compute_dtype), \
        torch.from_numpy(e).to(td)


@pytest.mark.parametrize("arch,dtype", MODEL_CASES)
def test_init_bit_for_bit(arch, dtype):
    """The port's own init from PRNGKey(0) equals the reference's, leaf by
    leaf (stacked layer leaves at every layer), bf16 included; with one
    normal draw per normally initialized leaf."""
    jc, jp, tc, conv = _model(arch, dtype)
    ops.reset_launch_counts()
    tp = tregistry.ModelBundle(tc).init(prng.PRNGKey(0), device="cpu")
    assert ops.launch_counts()["normal"] == 0      # the plain draw on the CPU
    mine, theirs = tp.state_dict(), conv.state_dict()
    assert mine.keys() == theirs.keys()
    for name, t in mine.items():
        assert t.dtype == tc.compute_dtype, name
        np.testing.assert_array_equal(_bits(t), _bits(theirs[name]), name)
    per_layer = len(jax.tree.leaves(jp["layers"]))
    top = len(jax.tree.leaves(jp)) - per_layer
    assert len(mine) == top + tc.num_layers * per_layer


def test_normal_bf16_plain_matches_jax():
    for seed, shape in ((0, (5,)), (3, (1000, 7)), (11, (64, 33, 3))):
        want = jax.random.normal(jax.random.PRNGKey(seed), shape,
                                 jnp.bfloat16)
        got = ops.normal(prng.PRNGKey(seed), shape, "cpu",
                         dtype=torch.bfloat16)
        np.testing.assert_array_equal(
            _bits(got), np.asarray(want).view(np.int16))


def test_convert_tensor_crosses_bf16_bit_for_bit():
    a = np.asarray(jax.random.normal(jax.random.PRNGKey(5), (7, 9),
                                     jnp.bfloat16))
    t = convert.tensor(a, "cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(t), a.view(np.int16))


@pytest.mark.parametrize("dtype", DTYPES)
def test_rms_norm_and_layer_norm(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    s = (0.1 * rng.standard_normal(64)).astype(np.float32)
    b = (0.1 * rng.standard_normal(64)).astype(np.float32)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    jx, tx = jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)
    assert _rel(tcommon.rms_norm(tx, torch.from_numpy(s).to(td)),
                jcommon.rms_norm(jx, jnp.asarray(s).astype(jd))) <= _tol(dtype)
    assert _rel(tcommon.layer_norm(tx, torch.from_numpy(s),
                                   torch.from_numpy(b)),
                jcommon.layer_norm(jx, jnp.asarray(s), jnp.asarray(b))) <= \
        _tol(dtype)


@pytest.mark.parametrize("positions", ["1d", "2d"])
@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope(theta, positions):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 40, 3, 16)).astype(np.float32)
    pos = np.arange(40) if positions == "1d" else \
        rng.integers(0, 300, (2, 40))
    got = tcommon.rope(torch.from_numpy(x), torch.from_numpy(pos),
                       np.float32(theta))
    want = jcommon.rope(jnp.asarray(x), jnp.asarray(pos),
                        jnp.float32(theta))
    assert _rel(got, want) <= F32_REL


ATTN_CASES = {   # name: (sq, skv, h, kv, window, softcap, chunk, kv_len)
    "causal_mha": (24, 24, 4, 4, 0, 0.0, 512, None),
    "causal_gqa_chunks": (40, 40, 4, 2, 0, 0.0, 16, None),
    "window": (40, 40, 4, 2, 7, 0.0, 16, None),
    "softcap": (24, 24, 4, 1, 0, 30.0, 8, None),
    "padded_kv_len": (20, 33, 4, 2, 0, 0.0, 16, 29),
}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", list(ATTN_CASES) + ["gqa_unrepeated"])
def test_chunked_attention(case, dtype):
    repeat_kv = case != "gqa_unrepeated"
    sq, skv, h, kv, window, cap, chunk, kv_len = ATTN_CASES.get(
        case, ATTN_CASES["causal_gqa_chunks"])
    rng = np.random.default_rng(sq + skv + h + kv)
    q = rng.standard_normal((2, sq, h, 16)).astype(np.float32)
    k = rng.standard_normal((2, skv, kv, 16)).astype(np.float32)
    v = rng.standard_normal((2, skv, kv, 16)).astype(np.float32)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    q_off = skv - sq
    want = jattn.chunked_attention(
        *(jnp.asarray(a).astype(jd) for a in (q, k, v)), causal=True,
        window=window, softcap=cap, q_offset=q_off,
        kv_len=None if kv_len is None else jnp.asarray(kv_len), chunk=chunk,
        repeat_kv=repeat_kv)
    got = tattn.chunked_attention(
        *(torch.from_numpy(a).to(td) for a in (q, k, v)), causal=True,
        window=window, softcap=cap, q_offset=q_off, kv_len=kv_len,
        chunk=chunk, repeat_kv=repeat_kv)
    assert got.dtype == td
    assert _rel(got, want) <= _tol(dtype)


@pytest.mark.parametrize("window", [0, 5])
def test_decode_attention(window):
    rng = np.random.default_rng(window)
    q = rng.standard_normal((2, 1, 4, 16)).astype(np.float32)
    kc = rng.standard_normal((2, 32, 2, 16)).astype(np.float32)
    vc = rng.standard_normal((2, 32, 2, 16)).astype(np.float32)
    want = jattn.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                  jnp.asarray(vc), jnp.asarray(19),
                                  window=window, softcap=20.0)
    got = tattn.decode_attention(*(torch.from_numpy(a) for a in (q, kc, vc)),
                                 19, window=window, softcap=20.0)
    assert _rel(got, want) <= F32_REL


@pytest.mark.parametrize("arch,dtype", MODEL_CASES)
def test_forward_prefill_decode(arch, dtype):
    """forward's logits, prefill's last logits and the cache it writes,
    then two decode steps, against the reference."""
    jc, jp, tc, tp = _model(arch, dtype)
    seq = 24
    toks, jx, tx = _inputs(jc, seq)
    lj, _ = jt.forward(jc, jp, jnp.asarray(toks), jx, remat=False)
    lt, _ = tt.forward(tc, tp, torch.from_numpy(toks), tx)
    assert lt.shape == lj.shape and lt.dtype == tc.compute_dtype
    assert _rel(lt, lj) <= _tol(dtype)

    jb, tb = jregistry.ModelBundle(jc), tregistry.ModelBundle(tc)
    jcache = jb.init_cache(2, 64)
    tcache = tb.init_cache(2, 64, device="cpu")
    assert set(tcache) == set(jcache)
    pj, jcache = jb.prefill(jp, jnp.asarray(toks[:, :seq - 2]), jcache, jx)
    pt, tcache = tb.prefill(tp, torch.from_numpy(toks[:, :seq - 2]), tcache,
                            tx)
    assert _rel(pt, pj) <= _tol(dtype)
    assert tcache["pos"] == int(jcache["pos"])
    for name in set(jcache) - {"pos"}:
        assert _rel(tcache[name], jcache[name]) <= _tol(dtype), name
    decode = jax.jit(jb.decode)
    for i in (seq - 2, seq - 1):
        dj, jcache = decode(jp, jcache, jnp.asarray(toks[:, i]))
        dt, tcache = tb.decode(tp, tcache, torch.from_numpy(toks[:, i]))
        assert dt.shape == dj.shape
        assert _rel(dt, dj) <= _tol(dtype)
    assert tcache["pos"] == int(jcache["pos"])


@pytest.mark.parametrize("arch", MODELS)
def test_decode_matches_forward(arch):
    """The reference's serving invariant on the port alone, float32:
    prefill of S-1 tokens plus one decode gives forward's last logits."""
    _, _, tc, tp = _model(arch, "float32")
    jc = jconfigs.smoke_config(arch)
    seq = 24
    toks, _, tx = _inputs(jc.scaled(dtype="float32"), seq, seed=3)
    full, _ = tt.forward(tc, tp, torch.from_numpy(toks), tx)
    tb = tregistry.ModelBundle(tc)
    cache = tb.init_cache(2, 64, device="cpu")
    _, cache = tb.prefill(tp, torch.from_numpy(toks[:, :seq - 1]), cache, tx)
    dec, cache = tb.decode(tp, cache, torch.from_numpy(toks[:, seq - 1]))
    assert cache["pos"] == seq + tc.num_patches
    err = float((dec - full[:, -1]).abs().max() / full[:, -1].abs().max())
    assert err <= F32_REL


def test_windowed_ring_wraps():
    """gemma3's local layers keep window_size slots: decoding past the
    window evicts the oldest token and stays the reference's."""
    jc, jp, tc, tp = _model("gemma3-27b", "float32")
    toks, _, _ = _inputs(jc, 22, seed=4)
    jb, tb = jregistry.ModelBundle(jc), tregistry.ModelBundle(tc)
    jcache = jb.init_cache(2, 64)
    tcache = tb.init_cache(2, 64, device="cpu")
    assert tcache["kl"].shape[2] == jc.window_size
    _, jcache = jb.prefill(jp, jnp.asarray(toks[:, :10]), jcache)
    _, tcache = tb.prefill(tp, torch.from_numpy(toks[:, :10]), tcache)
    decode = jax.jit(jb.decode)
    for i in range(10, 22):
        dj, jcache = decode(jp, jcache, jnp.asarray(toks[:, i]))
        dt, tcache = tb.decode(tp, tcache, torch.from_numpy(toks[:, i]))
        assert _rel(dt, dj) <= F32_REL, i
    assert _rel(tcache["kl"], jcache["kl"]) <= F32_REL


# --------------------------------------------------------------- analytic ----
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
@pytest.mark.parametrize("arch", DENSE)
def test_analytic_costs(arch, shape):
    """Flops are the reference's; HBM and collective bytes are too once
    the parameter bytes are taken out: the port's are the sharding
    policy's count over the production mesh, as the reference's dry run
    computes them, and the reference in this one-device process falls
    back to its policy estimate (the two against the reference under 512
    forced host devices: ``tests/test_torch_sharding.py``)."""
    from repro_torch.distributed.sharding import sharded_param_bytes
    from repro_torch.launch.mesh import make_production_mesh
    jc, tc = jregistry.get_config(arch), tregistry.get_config(arch)
    js, ts = jregistry.SHAPES[shape], tregistry.SHAPES[shape]
    assert dataclasses.asdict(js) == dataclasses.asdict(ts)
    j = janalytic.cell_costs(jc, js, 256)
    t = tanalytic.cell_costs(tc, ts, 256)
    assert t.flops_per_chip == j.flops_per_chip
    assert t.detail["tokens"] == j.detail["tokens"]
    tp, jp = t.detail["param_bytes_per_chip"], j.detail["param_bytes_per_chip"]
    coll = 2 if ts.kind == "train" else 0
    assert t.coll_bytes_per_chip - coll * tp == \
        pytest.approx(j.coll_bytes_per_chip - coll * jp, rel=1e-12)
    mult = {"train": 8, "prefill": 1, "decode": 1}[ts.kind]
    assert t.hbm_bytes_per_chip - mult * tp == \
        pytest.approx(j.hbm_bytes_per_chip - mult * jp, rel=1e-12)
    assert tp == sharded_param_bytes(tregistry.get_bundle(arch),
                                     make_production_mesh())
