"""The comparison that decides ``correct`` can fail: the control (the
plain reference solver in TF32, the precision below the configuration's
float32) put in the program's place comes out not correct from the
harness's own verdict, the sound float32 reference and the program pass,
and a run with its timed path broken underneath comes out not correct,
once for each planted fault (``osnbench/faults.py``).  CPU, small sizes."""
import time

import pytest
import torch

from osnbench import audit, faults, run
from osnbench.reference import control, judge, sketch

CELLS = ("logistic-oversketch", "softmax-emnist", "logistic-srht",
         "logistic-sjlt")


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
    with faults.plant(fault, cell["family"]):
        out = _run(cell)
    assert not out["correct"], out["check"]
    want = CAUGHT_BY[fault] & set(out["check"])
    assert want and want <= set(_failing(out)), (want, out["check"])


@pytest.mark.parametrize("name", CELLS)
def test_the_faults_are_undone(tiny, name):
    from repro_torch import core
    from repro_torch.kernels import ops as kops
    family = tiny(name)["family"]
    before = (core.oversketched_newton, getattr(kops, family.ENTRY))
    for fault in faults.FAULTS:
        with faults.plant(fault, family):
            pass
    assert (core.oversketched_newton, getattr(kops, family.ENTRY)) == before


def _explicit_gram(cell, x, y, w, draws):
    """The Gram from A and S written out whole (the family's ``dense``),
    float64."""
    cfg, obj = cell["config"], cell["objective"]
    n, d = x.shape
    r = obj.rows_per_sample(cfg)
    cf = obj.coef(cfg, x.double(), y.double(), w.double(), n)  # (n, R, R)
    a = torch.einsum("nci,nj->ncij", cf, x.double()).reshape(n * r, r * d)
    grams = []
    for k in torch.nonzero(draws["live"]).flatten().tolist():
        at = cell["family"].dense(draws, k, n * r) @ a
        grams.append(at.T @ at)
    return sum(grams) / len(grams)


@pytest.mark.parametrize("name", CELLS)
def test_the_reference_gram_is_the_explicit_product(tiny, name):
    cell = tiny(name)
    cfg = cell["config"]
    cfg.update(n=300, d=6)
    x, y = cell["objective"].generate(cfg, 7, "cpu")
    r = cell["objective"].rows_per_sample(cfg)
    w = 0.3 * torch.randn(6 * r, generator=torch.Generator().manual_seed(1))
    gen = torch.Generator().manual_seed(2)
    draws = cell["family"].draw(5, 16, 300 * r, gen, "cpu")
    draws["live"][1] = False
    got = sketch.gram(sketch.blocks(cell, x, y, w, draws))
    want = _explicit_gram(cell, x, y, w, draws)
    assert torch.allclose(got, want, rtol=1e-10, atol=1e-14)


def test_the_audit_plan_is_drawn_from_the_seed():
    tr = {"iters": 12, "audit_calls": 8}
    plans = [audit.plan(s, tr) for s in (1, 2, 3, 2 ** 40 + 1)]
    assert all(0 in p and len(p) == 2 for p in plans)
    assert all(0 <= i < 12 for p in plans for i in p.values())
    assert all(1 <= max(p) < 8 for p in plans)
    assert len({tuple(sorted(p.items())) for p in plans}) > 1
    assert audit.plan(5, tr) == audit.plan(5, tr)


@pytest.mark.parametrize("name", ["logistic-oversketch", "logistic-srht",
                                  "logistic-sjlt"])
def test_audit_bad_counts_broken_draws(tiny, name):
    cell = tiny(name)
    cfg, tr, fam = cell["config"], cell["traffic"], cell["family"]
    x, y = cell["objective"].generate(cfg, 3, "cpu")
    gen = torch.Generator().manual_seed(4)
    draws = fam.draw(control.total_blocks(tr), int(tr["block_size"]),
                     x.shape[0], gen, "cpu")
    w = torch.zeros(x.shape[1])
    gram = sketch.gram(sketch.blocks(cell, x, y, w, draws)).float()
    rec = {"w": w, "g": torch.ones(x.shape[1]), "p": -torch.ones(x.shape[1]),
           "gram": gram}

    def judged(d):
        return judge.audit(cell, x, y, [dict(rec, draws=audit.compact_draws(
            d, fam))], None)
    ok = judged(draws)
    assert ok["audit_bad"] == 0 and ok["gram_gap"] < 1e-6
    few = dict(draws, live=torch.zeros_like(draws["live"]))
    few["live"][:3] = True
    bad_sign = dict(draws, sigma=draws["sigma"] * 0.5)
    short = {k: v[..., :-1] if torch.is_tensor(v) and v.shape[-1] == x.shape[0]
             else v for k, v in draws.items()}
    broken = [few, bad_sign, short]
    if "h" in draws and draws["h"].dim() == 3:      # layered: s fewer
        broken.append(dict(draws, h=draws["h"][:, :2],
                           sigma=draws["sigma"][:, :2]))
    for d in broken:
        out = judged(d)
        assert out["audit_bad"] == 1 and out["gram_gap"] is None
