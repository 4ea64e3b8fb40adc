"""The generators: the same seed gives the same bytes, other seeds differ,
and shapes, dtypes, labels and the margin sort are as the recipe says."""
import torch

from osnbench import datagen, spec

LOGISTIC = {"objective": "logistic", "n": 500, "d": 7, "cond": 10.0,
            "sorted_layout": True}
SOFTMAX = {"objective": "softmax", "n": 400, "d": 6, "classes": 4}
BIG_SEED = 2 ** 33 + 17


def make(cfg, seed):
    return spec.objective(cfg["objective"]).generate(cfg, seed, "cpu")


def test_same_seed_same_bytes_other_seed_differs():
    for cfg in (LOGISTIC, SOFTMAX):
        x1, y1 = make(cfg, BIG_SEED)
        x2, y2 = make(cfg, BIG_SEED)
        x3, _ = make(cfg, BIG_SEED + 1)
        assert torch.equal(x1, x2) and torch.equal(y1, y2)
        assert not torch.equal(x1, x3)


def test_logistic_shapes_scales_labels_and_sort():
    x, y = make(LOGISTIC, BIG_SEED)
    assert x.shape == (500, 7) and y.shape == (500,)
    assert x.dtype == y.dtype == torch.float32
    assert set(y.unique().tolist()) <= {-1.0, 1.0}
    # column j lies in [-s_j, s_j], s geometric from 1 to 1/cond
    scales = torch.logspace(0, -1, 7, dtype=torch.float64).float()
    assert bool((x.abs() <= scales + 1e-6).all())
    assert float(x[:, -1].abs().max()) < 0.1 + 1e-6 < float(x[:, 0].abs().max())
    # the ground truth is the generator's first draw: rows sorted by margin
    g = torch.Generator().manual_seed(datagen.derive(BIG_SEED, "data"))
    w = torch.randn(7, generator=g)
    margin = x @ w
    assert bool((margin[1:] >= margin[:-1] - 1e-5).all())
    # the unsorted layout holds the same rows
    xu, yu = make(dict(LOGISTIC, sorted_layout=False), BIG_SEED)
    assert torch.equal(xu[torch.argsort(xu @ w, stable=True)], x)


def test_softmax_shapes_and_one_hot_labels():
    x, y = make(SOFTMAX, BIG_SEED)
    assert x.shape == (400, 6) and y.shape == (400, 4)
    assert x.dtype == y.dtype == torch.float32
    assert torch.equal(y.sum(1), torch.ones(400))
    assert set(y.unique().tolist()) == {0.0, 1.0}
    assert len(y.argmax(1).unique()) == 4


def test_derive_takes_any_whole_seed():
    seeds = {datagen.derive(s, "call", 0) for s in (0, -1, 2 ** 31, 2 ** 40)}
    assert len(seeds) == 4
    assert all(0 <= s < 2 ** 63 for s in seeds)


def test_fingerprint_sees_a_write():
    x, y = make(SOFTMAX, BIG_SEED)
    before = datagen.fingerprint(x, y)
    assert datagen.fingerprint(x, y) == before
    x[3, 2] += 1.0
    assert datagen.fingerprint(x, y) != before
