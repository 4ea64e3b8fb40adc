"""The comparison that decides ``correct`` can fail: the control (the
plain reference solver in TF32, the precision below the configuration's
float32) put in the program's place comes out not correct from the
harness's own verdict, the sound float32 reference and the program pass,
and a run with its timed path broken underneath comes out not correct,
once for each planted fault (``osnbench/faults.py``).  CPU, small sizes."""
import time

import pytest
import torch

from osnbench import audit, datagen, faults, run
from osnbench.reference import control, judge, sketch

CELLS = ("logistic-oversketch", "softmax-emnist", "logistic-srht")


def _run(cell, seed=2 ** 31 + 3, seconds=0.3, make_solver=None):
    return run.run_cell(cell, seed, seconds, False, torch.device("cpu"),
                        time.time(), make_solver=make_solver)


def _failing(out):
    return sorted(k for k, c in out["check"].items()
                  if c["value"] is not None and c["value"] > c["limit"])


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [2 ** 31 + 1, 2 ** 32 + 5])
def test_the_tf32_control_fails_and_float32_passes(tiny, name, seed):
    def solver(rounding):
        return lambda cell, x, y, device: control.Control(cell, x, y, device,
                                                          rounding)
    out = _run(tiny(name), seed, 0.0, solver("float32"))
    assert out["correct"], out["check"]
    out = _run(tiny(name), seed, 0.0, solver("tf32"))
    assert not out["correct"]
    assert out["judged"]["audits"] == 1
    # it fails on numbers it reached, the audit's among them
    assert {"gram_gap", "grad_gap"} <= set(_failing(out)), out["check"]


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -3.14159265])
    r = control.tf32(x)
    assert r.tolist()[:3] == [1.0, 1.0, 1.0 + 2 ** -9]
    assert (r.view(torch.int32) & 0x1FFF).eq(0).all()


@pytest.mark.parametrize("name", CELLS)
def test_the_program_passes(tiny, name):
    out = _run(tiny(name))
    assert out["correct"], out["check"]
    assert out["failed"] == 0 and out["attempted"] >= 1
    assert out["judged"]["audits"] >= 1


# the numbers each fault has to fail, at the least
CAUGHT_BY = {"state_unchanged": {"grad_ratio", "opt_gap", "not_fallen"},
             "half_batch": {"fval_gap", "audit_bad"},
             "answer_altered": {"gnorm_gap"},
             "half_blocks": {"gram_gap", "dir_gap"},
             "hessian_x2": {"gram_gap", "dir_gap"},
             "tf32_gram": {"gram_gap"}}


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", faults.FAULTS)
def test_a_broken_timed_path_is_not_correct(tiny, name, fault):
    cell = tiny(name)
    with faults.plant(fault):
        out = _run(cell)
    assert not out["correct"], out["check"]
    want = CAUGHT_BY[fault] & set(out["check"])
    assert want and want <= set(_failing(out)), (want, out["check"])


def test_the_faults_are_undone(tiny):
    from repro_torch import core
    from repro_torch.kernels import ops as kops
    before = (core.oversketched_newton, kops.sketch_gram_count)
    for fault in faults.FAULTS:
        with faults.plant(fault):
            pass
    assert (core.oversketched_newton, kops.sketch_gram_count) == before


def _explicit_gram(cfg, x, y, w, draws):
    """The Gram from A and S written out whole, float64."""
    n, d = x.shape
    r = sketch.rows_per_sample(cfg)
    cf = sketch.coef(cfg, x.double(), y.double(), w.double(), n)  # (n, R, R)
    a = torch.einsum("nci,nj->ncij", cf, x.double()).reshape(n * r, r * d)
    b = draws["block_size"]
    grams = []
    for k in torch.nonzero(draws["live"]).flatten().tolist():
        s = torch.zeros((b, n * r), dtype=torch.float64)
        if draws["family"] == "count":
            s[draws["h"][k].long(), torch.arange(n * r)] = \
                draws["sigma"][k].double()
        else:
            n_pad = 1 << (n * r - 1).bit_length()
            hd = torch.ones((1, 1), dtype=torch.float64)
            while hd.shape[0] < n_pad:
                hd = torch.cat([torch.cat([hd, hd], 1),
                                torch.cat([hd, -hd], 1)], 0)
            s = (hd[draws["rows"][k].long()][:, :n * r]
                 * draws["sigma"][k].double() / b ** 0.5)
        at = s @ a
        grams.append(at.T @ at)
    return sum(grams) / len(grams)


@pytest.mark.parametrize("name", CELLS)
def test_the_reference_gram_is_the_explicit_product(tiny, name):
    cell = tiny(name)
    cfg, tr = cell["config"], cell["traffic"]
    cfg.update(n=300, d=6)
    x, y = datagen.make(cfg, 7, "cpu")
    dim = 6 * sketch.rows_per_sample(cfg)
    w = 0.3 * torch.randn(dim, generator=torch.Generator().manual_seed(1))
    gen = torch.Generator().manual_seed(2)
    family = control.FAMILIES[tr["sketch_family"]]
    draws = sketch.draw(family, 5, 16, 300 * sketch.rows_per_sample(cfg),
                        gen, "cpu")
    draws["live"][1] = False
    got = sketch.gram(sketch.blocks(cfg, x, y, w, draws))
    want = _explicit_gram(cfg, x, y, w, draws)
    assert torch.allclose(got, want, rtol=1e-10, atol=1e-14)


def test_the_audit_plan_is_drawn_from_the_seed():
    tr = {"iters": 12, "audit_calls": 8}
    plans = [audit.plan(s, tr) for s in (1, 2, 3, 2 ** 40 + 1)]
    assert all(0 in p and len(p) == 2 for p in plans)
    assert all(0 <= i < 12 for p in plans for i in p.values())
    assert all(1 <= max(p) < 8 for p in plans)
    assert len({tuple(sorted(p.items())) for p in plans}) > 1
    assert audit.plan(5, tr) == audit.plan(5, tr)


def test_audit_bad_counts_broken_draws(tiny):
    cell = tiny("logistic-oversketch")
    cfg, tr = cell["config"], cell["traffic"]
    x, y = datagen.make(cfg, 3, "cpu")
    gen = torch.Generator().manual_seed(4)
    draws = sketch.draw("count", control.total_blocks(tr),
                        int(tr["block_size"]), x.shape[0], gen, "cpu")
    w = torch.zeros(x.shape[1])
    gram = sketch.gram(sketch.blocks(cfg, x, y, w, draws)).float()
    rec = {"w": w, "g": torch.ones(x.shape[1]), "p": -torch.ones(x.shape[1]),
           "gram": gram}
    ok = judge.audit(cfg, tr, x, y, [dict(rec, draws=audit.compact_draws(
        draws))], None)
    assert ok["audit_bad"] == 0 and ok["gram_gap"] < 1e-6
    few = dict(draws, live=torch.zeros_like(draws["live"]))
    few["live"][:3] = True
    bad_sign = dict(draws, sigma=draws["sigma"] * 0.5)
    for broken in (few, bad_sign):
        out = judge.audit(cfg, tr, x, y, [dict(rec, draws=audit.compact_draws(
            broken))], None)
        assert out["audit_bad"] == 1 and out["gram_gap"] is None
