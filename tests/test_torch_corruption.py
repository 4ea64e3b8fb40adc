"""Corruption detection in both packages on the same inputs: the parity
residuals, the detector's flag grid, the verified and the blind decode
(``tests/test_faults.py``'s coded cases), and the Newton loop under a
corruption plan with detection on and off (its end-to-end setup: n = 256,
d = 8, ``OverSketchConfig(64, 16, 0.25)``, ``coded_block_rows=32``).

Tolerances: the residuals 1e-6 (float32 sums of a few O(1) products);
decoded vectors 1e-5; simulated time, cost, trace rows (every phase's mask)
and the step history bit for bit; with detection on, ``fval`` within 1e-5
relative and ``gnorm`` within 1e-5 relative plus 1e-7 absolute (near
convergence the gradient is a difference of O(0.1) terms, so its float32
error is absolute).  With detection off the noise enters the decoded
vector through a mean that XLA and torch sum in different orders; the
blind history is held to the same tolerances."""
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.runtime as jrt
from repro.core import coded as jcoded
from repro.core import straggler as jstraggler
from repro.core.newton import NewtonConfig as JConfig
from repro.core.newton import oversketched_newton as j_newton
from repro.core.objectives import Dataset as JDataset
from repro.core.objectives import LogisticRegression as JLogistic
from repro.core.sketch import OverSketchConfig as JSketch
from repro.kernels.coded_matvec import parity_residuals as j_parity

import repro_torch.runtime as trt
from repro_torch.core import coded as tcoded
from repro_torch.core import straggler as tstraggler
from repro_torch.core.newton import NewtonConfig as TConfig
from repro_torch.core.newton import oversketched_newton as t_newton
from repro_torch.core.objectives import Dataset as TDataset
from repro_torch.core.objectives import LogisticRegression as TLogistic
from repro_torch.core.sketch import OverSketchConfig as TSketch
from repro_torch.kernels.coded_matvec import parity_residuals as t_parity

torch.set_num_threads(1)


# ------------------------------------------------------- parity residuals
@pytest.mark.parametrize("erased", [(), ((0, 1),), ((1, 1), (2, 0), (3, 3))],
                         ids=["none", "one", "three"])
def test_parity_residuals_match_reference(erased):
    rng = np.random.default_rng(11)
    prods = rng.standard_normal((4, 4, 5)).astype(np.float32)
    known = np.ones((4, 4), bool)
    for cell in erased:
        known[cell] = False
    ref = j_parity(jnp.asarray(prods), jnp.asarray(known))
    out = t_parity(torch.from_numpy(prods), torch.from_numpy(known))
    for r, o in zip(ref, out):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=1e-6)


# ------------------------------------------- detection and verified decode
def _coded_setup(rows=32, cols=12, block=8):
    """make_code(32, 8): 4 blocks on a 2 x 2 systematic grid; index 2 is
    the parity line of the 3 x 3 worker grid."""
    rng = np.random.default_rng(3)
    a = rng.standard_normal((rows, cols)).astype(np.float32)
    v = rng.standard_normal(cols).astype(np.float32)
    jcode, tcode = jcoded.make_code(rows, block), tcoded.make_code(rows,
                                                                    block)
    jp = jcoded.coded_block_products(
        jcoded.encode_2d(jnp.asarray(a), jcode), jnp.asarray(v))
    tp = tcoded.coded_block_products(
        tcoded.encode_2d(torch.from_numpy(a), tcode), torch.from_numpy(v))
    return a @ v, (jp, jcode), (tp, tcode), rows


CELLS = [(1, 1), (2, 1), (1, 2)]
CELL_IDS = ["systematic", "col_parity", "row_parity"]


def _corrupt(jp, tp, cells):
    for cell in cells:
        jp = jp.at[cell].add(7.5)
        tp = tp.clone()
        tp[cell] += 7.5
    return jp, tp


@pytest.mark.parametrize("cell", CELLS + [None], ids=CELL_IDS + ["clean"])
def test_detect_corrupted_matches_reference(cell):
    _, (jp, jcode), (tp, tcode), _ = _coded_setup()
    jp, tp = _corrupt(jp, tp, [cell] if cell else [])
    known = np.ones((3, 3), bool)
    jf = jcoded.detect_corrupted(jp, jnp.asarray(known), jcode)
    tf = tcoded.detect_corrupted(tp, torch.from_numpy(known), tcode)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    assert bool(tf.any()) == (cell is not None)
    if cell is not None:
        assert bool(tf[cell])


@pytest.mark.parametrize("cells,erased", [
    ([(1, 1)], ()), ([(2, 1)], ()), ([(1, 2)], ()),
    ([(0, 0)], ((1, 1),)),
    # Unlocalizable: the corrupted cell's row parity, column parity and
    # corner are erased, so no decoder can see it; verification passes it.
    ([(0, 0)], ((0, 2), (2, 0), (2, 2))),
    # Two corrupted cells on one row: the intersection over-flags and the
    # peel cannot finish, so the decode is refused.
    ([(0, 0), (0, 1)], ((2, 2),)),
], ids=["systematic", "col_parity", "row_parity", "beside_an_erasure",
        "witnesses_erased", "undecodable"])
def test_verified_decode_matches_reference(cells, erased):
    exact, (jp, jcode), (tp, tcode), rows = _coded_setup()
    jp, tp = _corrupt(jp, tp, cells)
    known = np.ones((3, 3), bool)
    for c in erased:
        known[c] = False
    jy, jok, jn = jcoded.verified_decode(jp, jnp.asarray(known), jcode, rows)
    ty, tok, tn = tcoded.verified_decode(tp, torch.from_numpy(known), tcode,
                                         rows)
    assert (tok, tn) == (jok, jn)
    assert (ty is None) == (jy is None)
    if ty is not None:
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                                   atol=1e-5)
    if cells == [(1, 1)]:
        assert tok and tn >= 1
        np.testing.assert_allclose(ty.numpy(), exact, rtol=1e-4, atol=1e-4)


def test_blind_decode_returns_the_corruption():
    exact, (jp, jcode), (tp, tcode), rows = _coded_setup()
    jp, tp = _corrupt(jp, tp, [(1, 1)])
    known = np.ones((3, 3), bool)
    jy, jok = jcoded.decode_matvec(jp, jnp.asarray(known), jcode, rows)
    ty, tok = tcoded.decode_matvec(tp, torch.from_numpy(known), tcode, rows)
    assert bool(tok) and bool(jok)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    assert not np.allclose(ty.numpy(), exact, rtol=1e-4, atol=1e-4)


# ------------------------------------------------ the Newton loop, end to end
@pytest.fixture(scope="module")
def problem():
    key = jax.random.PRNGKey(0)
    x = jax.random.normal(key, (256, 8))
    y = jnp.sign(x @ jax.random.normal(jax.random.fold_in(key, 1), (8,)))
    return (JDataset(x=x, y=y),
            TDataset(x=torch.from_numpy(np.array(x)),
                     y=torch.from_numpy(np.array(y))))


def solve(port, data, faults=None, *, detection=True, fleet=None,
          pool=None, replay=None, iters=8):
    """test_faults.py's ``_newton_solve`` in one package, with a trace
    recorder; returns (result, clock, recorded rows)."""
    rt, sg = (trt, tstraggler) if port else (jrt, jstraggler)
    cfg = (TConfig if port else JConfig)(
        iters=iters, sketch=(TSketch if port else JSketch)(
            sketch_dim=64, block_size=16, straggler_tolerance=0.25),
        coded_block_rows=32, corruption_detection=detection)
    rec = rt.TraceRecorder() if replay is None else None
    clock = sg.SimClock(sg.StragglerModel(), fleet=fleet, pool=pool,
                        faults=faults, recorder=rec, replay=replay)
    if port:
        res = t_newton(TLogistic(lam=1e-3), data[1], np.zeros(8, np.float32),
                       cfg, clock, device="cpu")
    else:
        res = j_newton(JLogistic(lam=1e-3), data[0], jnp.zeros((8,)), cfg,
                       clock)
    rows = [] if rec is None else [json.loads(json.dumps(r))
                                   for r in rec.rows]
    return res, clock, rows


def assert_same_history(rj, rt):
    hj, ht = rj.history, rt.history
    assert ht["step"] == [float(v) for v in hj["step"]]
    for k in ("time", "cost", "sketch_dim"):
        assert ht[k] == [float(v) for v in hj[k]], k
    np.testing.assert_allclose(ht["fval"], hj["fval"], rtol=1e-5)
    np.testing.assert_allclose(ht["gnorm"], hj["gnorm"], rtol=1e-5,
                               atol=1e-7)


def plan(port):
    return (trt if port else jrt).get_scenario("corruption", prob=0.3)


@pytest.fixture(scope="module")
def corrupted_runs(problem):
    """prob = 0.3 with detection on and off, 4 iterations (the reference's
    loop takes ~0.5 s an iteration on the CPU), in both packages."""
    return {(port, det): solve(port, problem, plan(port), detection=det,
                               iters=4)
            for det in (True, False) for port in (False, True)}


@pytest.mark.parametrize("detection", [True, False], ids=["detected",
                                                          "blind"])
def test_newton_under_corruption_matches_reference(corrupted_runs,
                                                   detection):
    rj, jc, jrows = corrupted_runs[(False, detection)]
    rt, tc, trows = corrupted_runs[(True, detection)]
    assert trows == jrows                      # every phase's mask
    assert (tc.time, tc.dollars) == (jc.time, jc.dollars)
    assert_same_history(rj, rt)
    assert any((r.get("faults") or {}).get("corrupted") for r in trows)


def test_detection_recovers_what_blind_decode_loses(problem):
    """tests/test_faults.py's contract, on the port (8 iterations)."""
    healthy, _, _ = solve(True, problem)
    detected = solve(True, problem, plan(True))[0].history["gnorm"][-1]
    blind = solve(True, problem, plan(True),
                  detection=False)[0].history["gnorm"][-1]
    assert healthy.history["gnorm"][-1] < 1e-3
    assert detected < 1e-3
    assert blind > 10.0 * detected


def test_recorded_corruption_replays_through_newton(corrupted_runs,
                                                    problem):
    """A reference recording of Newton under corruption, replayed with no
    plan: the rows' ``corrupted`` masks drive the same decode, and both
    packages reproduce the recorded history.  (The committed
    ``chaos_trace_golden.jsonl`` is a fleet schedule, not a Newton one: a
    Newton replay of it stops at its first row in both packages.)"""
    rj, _, jrows = corrupted_runs[(False, True)]
    for port in (False, True):
        rt = trt if port else jrt
        res, _, _ = solve(port, problem, replay=rt.TraceReplayer(jrows),
                          iters=4)
        assert_same_history(rj, res)


def test_chaos_trace_replay_stops_where_the_reference_stops(problem):
    rows = [json.loads(line) for line in (
        pathlib.Path(__file__).parent / "fixtures"
        / "chaos_trace_golden.jsonl").read_text().splitlines()
        if line.strip()][1:]
    assert any((r.get("faults") or {}).get("corrupted") for r in rows)
    errors = []
    for port in (False, True):
        rt = trt if port else jrt
        with pytest.raises(ValueError, match="not the same schedule") as ei:
            solve(port, problem, replay=rt.TraceReplayer(rows))
        errors.append(str(ei.value))
    assert errors[0] == errors[1]
