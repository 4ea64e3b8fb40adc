"""Objectives and sketch families are files of their own, found by name:
the moved code reads as it did when it lived in ``datagen.py``,
``counts.py`` and ``reference/`` (values frozen from that code at small
sizes), the SJLT family's reference is the port's plain SJLT apply, and an
objective written under another root is found and judged with no file of
``osnbench/`` changed."""
import hashlib
import json
import shutil
import time
from pathlib import Path

import pytest
import torch

from osnbench import audit, datagen, faults, run, spec
from osnbench.reference import judge, sketch

REPO = Path(__file__).resolve().parents[2]
BENCH = REPO / "osnbench"
SEED = 2 ** 33 + 17
CFGS = {"logistic": {"objective": "logistic", "n": 500, "d": 7, "cond": 10.0,
                     "sorted_layout": True, "lam": 1e-3},
        "softmax": {"objective": "softmax", "n": 400, "d": 6, "classes": 4,
                    "lam": 0.0}}
ACCURACY = {"logistic": {"opt_gap": 0.01}, "softmax": {"not_fallen": 0}}
# What the harness read at these inputs before its objectives and families
# moved into files of their own: the fingerprint bit for bit, the judge's
# numbers, the reference Gram's trace, norm and two entries, the draws'
# sums and the audit's numbers of each family, and the operations of an
# iteration.
FROZEN = {
    "logistic": {
        "fingerprint": (-24.777823994050777, 309.8263361815341, 20.0, 500.0),
        "judge": {"fval_gap": 0.12893400710129238,
                  "gnorm_gap": 0.722304959116552,
                  "grad_ratio": 1.105466128107705, "not_fallen": 2,
                  "g0n": 0.08206716970657271, "opt_gap": 5.816870303452546},
        "flops": 94500.0,
        "oversketch": {
            "gram": (0.13417682410566345, 0.08046007794199657,
                     0.07028806199274158, 0.0005056631742369041),
            "draw_sums": (10.0, 19103.0),
            "audit": {"grad_gap": 0.003223875117161346,
                      "gram_gap": 0.0001000572400851835,
                      "dir_gap": 0.967626272161391, "audit_bad": 0,
                      "audits": 1}},
        "srht": {
            "gram": (0.15583668404874654, 0.09730839125875007,
                     0.08585500365366402, 0.00036532159947472924),
            "draw_sums": (10.0, 21234.0),
            "audit": {"grad_gap": 0.003223875117161346,
                      "gram_gap": 0.00010008572325080559,
                      "dir_gap": 0.9586872059663815, "audit_bad": 0,
                      "audits": 1}}},
    "softmax": {
        "fingerprint": (-23.55851737386547, 2466.107512747866, 400.0, 400.0),
        "judge": {"fval_gap": 0.6348404042264821,
                  "gnorm_gap": 1.1570225934837213,
                  "grad_ratio": 1.2625258665110801, "not_fallen": 2,
                  "g0n": 0.47391894644855415},
        "flops": 423552.0,
        "oversketch": {
            "gram": (4.168706204502913, 1.1101110086976724,
                     0.17393216862198993, -0.011103172990623605),
            "draw_sums": (-62.0, 59600.0),
            "audit": {"grad_gap": 0.0010337243126275811,
                      "gram_gap": 0.00010000180404816338,
                      "dir_gap": 0.8275020574460864, "audit_bad": 0,
                      "audits": 1}},
        "srht": {
            "gram": (3.9753449444074342, 1.0691729249871924,
                     0.134423313913069, 0.005467343414619718),
            "draw_sums": (-62.0, 76732.0),
            "audit": {"grad_gap": 0.0010337243126275811,
                      "gram_gap": 0.00010001507777516657,
                      "dir_gap": 0.8234109462136128, "audit_bad": 0,
                      "audits": 1}}},
}
# the full-size configurations' operations an iteration
FROZEN_FULL = {"synthetic-logistic": 24300000000.0,
               "emnist-softmax": 79150131200.0}


def _cell(objective: str, family: str) -> dict:
    cfg = dict(CFGS[objective])
    return {"config": cfg, "objective": spec.objective(objective),
            "family": spec.family(family),
            "traffic": {"sketch_dim": 64, "block_size": 16, "solver": "auto",
                        "sketch_family": family,
                        "accuracy": ACCURACY[objective], "limits": {}}}


def _iterates(cell, dim):
    g = torch.Generator().manual_seed(5)
    return [0.2 * torch.randn(dim, generator=g) for _ in range(3)]


def _close(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=1e-12, abs=0), k


@pytest.mark.parametrize("objective", sorted(CFGS))
def test_generator_judge_and_counts_read_as_frozen(objective):
    cell = _cell(objective, "oversketch")
    cfg, obj = cell["config"], cell["objective"]
    x, y = obj.generate(cfg, SEED, "cpu")
    assert datagen.fingerprint(x, y) == FROZEN[objective]["fingerprint"]
    assert obj.iteration_flops(cfg) == FROZEN[objective]["flops"]
    ws = _iterates(cell, cfg["d"] * obj.rows_per_sample(cfg))
    calls = [{"w0": torch.zeros_like(ws[0]) if i == 0 else 0.5 * ws[i - 1],
              "w": ws[i], "fval": 0.6 + 0.01 * i, "gnorm": 0.05 * (i + 1)}
             for i in range(3)]
    got = judge.judge(cell, x, y, calls)
    _close({k: v for k, v in got.items() if k != "per_call"},
           FROZEN[objective]["judge"])


@pytest.mark.parametrize("family", ["oversketch", "srht"])
@pytest.mark.parametrize("objective", sorted(CFGS))
def test_reference_gram_draws_and_audit_read_as_frozen(objective, family):
    cell = _cell(objective, family)
    cfg, obj, fam = cell["config"], cell["objective"], cell["family"]
    want = FROZEN[objective][family]
    x, y = obj.generate(cfg, SEED, "cpu")
    r = obj.rows_per_sample(cfg)
    w = _iterates(cell, cfg["d"] * r)[0]
    draws = fam.draw(5, 16, cfg["n"] * r, torch.Generator().manual_seed(11),
                     "cpu")
    draws["live"][1] = False
    codes = draws["h"] if "h" in draws else draws["rows"]
    assert (float(draws["sigma"].sum()), float(codes.double().sum())) == \
        want["draw_sums"]
    ref = sketch.gram(sketch.blocks(cell, x, y, w, draws))
    got = (float(torch.trace(ref)), float(torch.linalg.matrix_norm(ref)),
           float(ref[0, 0]), float(ref[0, -1]))
    assert got == pytest.approx(want["gram"], rel=1e-12, abs=0)
    _, g_ref = obj.evaluate(cfg, x, y, w[None])
    rec = {"w": w, "gram": ref.float() * (1 + 1e-4),
           "g": g_ref[0].float() + 1e-4, "p": -g_ref[0].float(),
           "draws": audit.compact_draws(draws, fam)}
    _close(judge.audit(cell, x, y, [rec], None), want["audit"])


def test_full_size_iteration_counts_read_as_frozen():
    for name, want in FROZEN_FULL.items():
        cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
        assert spec.objective(cfg["objective"]).iteration_flops(cfg) == want


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 9])
def test_sjlt_reference_is_the_ports_plain_apply(seed):
    from repro_torch.kernels import ref as kref
    fam = spec.family("sjlt")
    n, d, b, k = 300, 5, 16, 6
    gen = torch.Generator().manual_seed(seed)
    draws = fam.draw(k, b, n, gen, "cpu")
    a = torch.randn((n, d), generator=gen, dtype=torch.float64)
    want = kref.sjlt_apply(draws["h"], draws["sigma"], a, b)    # (K, b, d)
    ones = torch.ones((n, 1, 1), dtype=torch.float64)
    q = fam.q(draws, torch.arange(k), ones, 0).reshape(k, b, n)
    assert torch.allclose(q @ a, want, rtol=1e-12, atol=1e-14)
    # and through the blocks of a problem's A: a logistic cell's rows
    cell = _cell("logistic", "sjlt")
    cfg, obj = cell["config"], cell["objective"]
    x, y = obj.generate(cfg, seed, "cpu")
    w = _iterates(cell, cfg["d"])[0]
    draws = fam.draw(k, b, cfg["n"], gen, "cpu")
    a = obj.coef(cfg, x.double(), y.double(), w.double(), cfg["n"])[:, 0] \
        * x.double()
    got = sketch.blocks(cell, x, y, w, draws)
    want = kref.sjlt_apply(draws["h"], draws["sigma"], a, b)
    assert torch.allclose(got, want, rtol=1e-12, atol=1e-14)


RIDGE = '''"""Ridge regression: f(w) = mean (x.w - y)^2 / 2 + lam / 2 ||w||^2."""
import math

import torch

from osnbench.counts import CANDIDATES
from osnbench.datagen import ROWS, generator

AUTO_SOLVER = "chol"


def generate(cfg, seed, device):
    n, d = int(cfg["n"]), int(cfg["d"])
    g = generator(seed, device)
    w = torch.randn(d, generator=g, device=device)
    x = torch.randn((n, d), generator=g, device=device)
    y = x @ w + 0.1 * torch.randn(n, generator=g, device=device)
    return x, y


def program(core, cfg):
    return core.RidgeRegression(lam=float(cfg["lam"]))


def rows_per_sample(cfg):
    return 1


def lam(cfg):
    return float(cfg["lam"])


def evaluate(cfg, x, y, w):
    n = x.shape[0]
    w = w.to(device=x.device, dtype=torch.float64)
    f = torch.zeros(w.shape[0], dtype=torch.float64, device=x.device)
    g = torch.zeros_like(w)
    for i in range(0, n, ROWS):
        xb = x[i:i + ROWS].double()
        r = xb @ w.T - y[i:i + ROWS].double()[:, None]
        f += 0.5 * (r * r).sum(0)
        g += r.T @ xb
    return f / n + 0.5 * lam(cfg) * (w * w).sum(1), g / n + lam(cfg) * w


def coef(cfg, xb, yb, w, n):
    return torch.full((xb.shape[0], 1, 1), 1.0 / math.sqrt(n),
                      dtype=xb.dtype, device=xb.device)


class Problem:
    strongly_convex = True

    def __init__(self, cfg, x, y, rnd):
        self.x, self.y, self.lam, self.rnd = rnd(x), y, lam(cfg), rnd

    def value(self, w):
        r = self.x @ self.rnd(w).T - self.y[:, None]
        return 0.5 * (r * r).mean(0) + 0.5 * self.lam * (w * w).sum(1)

    def gradient(self, w):
        r = self.x @ self.rnd(w) - self.y
        return self.x.T @ self.rnd(r) / self.x.shape[0] + self.lam * w


def iteration_flops(cfg):
    return (4 + 2 + 2 * (1 + CANDIDATES) + 6) * float(cfg["n"]) * cfg["d"]
'''


def _digests(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).digest()
            for p in sorted(root.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_objective_is_found_and_judged(tmp_path):
    """A configuration with an objective of its own is new files and new
    entries only: ``objectives/ridge.py``, its configuration, a mix and a
    cell.  The run finds the objective by name, drives the port's ridge
    regression and judges it; a planted fault still fails it."""
    root = tmp_path / "osnbench"
    shutil.copytree(BENCH, root, ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(root)
    (root / "objectives" / "ridge.py").write_text(RIDGE)
    (root / "configs" / "ridge.json").write_text(json.dumps(
        {"name": "ridge", "objective": "ridge", "n": 2000, "d": 40,
         "lam": 1e-3}))
    mix = json.loads((root / "traffic" / "logistic-oversketch.json")
                     .read_text())
    mix.update(sketch_dim=512, block_size=64, coded_block_rows=128)
    (root / "traffic" / "ridge-mix.json").write_text(json.dumps(mix))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "ridge", "source": "x",
                             "file": "osnbench/configs/ridge.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "ridge-cell", "config": "ridge",
                               "traffic": "ridge-mix", "chips": 1,
                               "why": "x"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    after = _digests(root)
    assert {k: v for k, v in after.items() if k in before} == before
    assert _digests(BENCH) == before

    cell = spec.cell("ridge-cell", repo=tmp_path, root=root)
    assert cell["objective"].NAME == "ridge"
    out = run.run_cell(cell, 2 ** 31 + 3, 0.3, False, torch.device("cpu"),
                       time.time())
    assert out["correct"], out["check"]
    assert out["judged"]["audits"] >= 1
    assert out["check"]["gram_gap"]["value"] < 1e-6
    with faults.plant("hessian_x2", cell["family"]):
        bad = run.run_cell(cell, 2 ** 31 + 3, 0.3, False,
                           torch.device("cpu"), time.time())
    assert not bad["correct"]
