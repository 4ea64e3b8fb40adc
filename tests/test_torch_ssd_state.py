"""The SSD's post-prefill state against the JAX package's.

The port's prefill keeps the chunked scan's final carry as the decode's
state (``models/ssd.py::ssd_forward`` with a state); the reference
recomputes it token by token (``repro/models/transformer.py::
_ssd_final_state``).  mamba2-780m at smoke width (chunk 16): prompts of
one chunk, one short of two (the scan right-pads it: a padded position
must neither decay nor feed the state), two chunks, and several chunks
padded; every layer's ``ssm`` and ``conv`` state and the next decode's
logits within 1e-5 of max |ref| at float32, 3e-2 at bfloat16.  The
prompt is projected once a layer.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import registry as jregistry

from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.models import registry as tregistry
from repro_torch.models import ssd as tssd

torch.set_num_threads(1)

ARCH = "mamba2-780m"
TOL = {"float32": 1e-5, "bfloat16": 3e-2}
PROMPTS = (16, 31, 32, 50)


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    return float(np.abs(got.float().numpy() - want).max() /
                 np.abs(want).max())


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def models(request):
    dtype = request.param
    jc = jconfigs.smoke_config(ARCH).scaled(dtype=dtype)
    tc = tconfigs.smoke_config(ARCH).scaled(dtype=dtype)
    jp = jregistry.ModelBundle(jc).init(jax.random.PRNGKey(0))
    tp = convert.params(tc, jax.tree.map(np.asarray, jp), "cpu")
    return dtype, jc, jp, tc, tp


@pytest.mark.parametrize("seq", PROMPTS)
def test_post_prefill_state_and_next_decode(models, seq, monkeypatch):
    dtype, jc, jp, tc, tp = models
    assert tc.ssm_chunk == 16
    rs = np.random.RandomState(seq)
    toks = rs.randint(1, jc.vocab_size - 1, (2, seq + 1)).astype(np.int32)
    jb, tb = jregistry.ModelBundle(jc), tregistry.ModelBundle(tc)
    _, jcache = jb.prefill(jp, jnp.asarray(toks[:, :seq]),
                           jb.init_cache(2, seq + 1))
    projections = []
    conv_inputs = tssd._conv_inputs
    monkeypatch.setattr(tssd, "_conv_inputs", lambda *a: projections.append(
        1) or conv_inputs(*a))
    _, tcache = tb.prefill(tp, torch.from_numpy(toks[:, :seq]),
                           tb.init_cache(2, seq + 1, device="cpu"))
    assert len(projections) == tc.num_layers
    for name in ("ssm", "conv"):
        got, want = tcache["layers"][name], jcache["layers"][name]
        assert got.shape == want.shape and got.dtype == tc.compute_dtype
        assert _rel(got, want) <= TOL[dtype], name
    dj, _ = jb.decode(jp, jcache, jnp.asarray(toks[:, seq]))
    dt, _ = tb.decode(tp, tcache, torch.from_numpy(toks[:, seq]))
    assert _rel(dt, dj) <= TOL[dtype]


def test_padded_positions_leave_the_state_alone():
    """The scan's carry after ``valid`` positions of a right-padded input
    equals the carry of the unpadded input's scan (the positions past
    ``valid`` take dt = 0), and y's first ``valid`` rows are unchanged."""
    rng = np.random.default_rng(0)

    def arr(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32))
    s, valid, q = 32, 21, 8
    xh, bm, cm = arr(2, s, 3, 4), arr(2, s, 5), arr(2, s, 5)
    dt, a, skip = arr(2, s, 3).abs(), -arr(3).abs(), arr(3)
    y, last = tssd._chunked_scan(xh, dt, a, bm, cm, skip, q, valid)
    y_whole, _ = tssd._chunked_scan(xh, dt, a, bm, cm, skip, q)
    torch.testing.assert_close(y[:, :valid], y_whole[:, :valid], rtol=0,
                               atol=0)
    y24, last24 = tssd._chunked_scan(xh[:, :24], dt[:, :24], a, bm[:, :24],
                                     cm[:, :24], skip, q, valid)
    torch.testing.assert_close(last, last24, rtol=1e-6, atol=1e-6)
    h = torch.zeros(2, 3, 4, 5)
    for t in range(valid):
        h = h * torch.exp(dt[:, t] * a)[..., None, None] + \
            (dt[:, t, :, None] * bm[:, t, None, :])[:, :, None, :] * \
            xh[:, t, ..., None]
    assert float((last - h).abs().max() / h.abs().max()) <= 1e-5
    _, unmasked = tssd._chunked_scan(xh, dt, a, bm, cm, skip, q)
    assert float((unmasked - h).abs().max() / h.abs().max()) > 1e-2
