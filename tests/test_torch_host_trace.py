"""The port's host tracer (``repro_torch.obs.host``): the span tree, the
ring, the profiler's ranges and clock, the spans and counters a solve
records, and that the counts the benchmark's outside wrappers take
(``osnbench.spans.Recorder``) can be read from the program's spans."""
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import core, obs
from repro_torch.core import straggler
from repro_torch.obs import host

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

torch.set_num_threads(1)


def _data(n=600, d=20, softmax=False):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(n, d, generator=g)
    if softmax:
        y = torch.nn.functional.one_hot(
            torch.randint(0, 3, (n,), generator=g), 3).float()
        return core.SoftmaxRegression(num_classes=3), x, y
    y = torch.sign(torch.randn(n, generator=g))
    return core.LogisticRegression(lam=1e-3), x, y


def _solve(iters=3, softmax=False, **overrides):
    """A small CPU solve; returns its result and its host spans."""
    objective, x, y = _data(softmax=softmax)
    kw = dict(iters=iters, sketch=core.OverSketchConfig(256, 64, 0.25),
              coded_block_rows=128, use_kernels=False)
    kw.update(overrides)
    cfg = core.NewtonConfig(**kw)
    dim = x.shape[1] * (3 if softmax else 1)
    first = host.TRACER.appended
    res = core.oversketched_newton(objective, core.Dataset(x=x, y=y),
                                   torch.zeros(dim), cfg, device="cpu")
    spans = list(host.TRACER.spans)[-(host.TRACER.appended - first):]
    return res, spans


def test_spans_nest_by_parent_and_share_call_and_iteration_ids():
    tr = host.HostTracer()
    a = tr.begin("call")
    b = tr.begin("iteration", t=4)
    with tr.span("gradient", tag="X"):
        with tr.sync("decode_ok"):
            pass
    tr.end(b)
    tr.end(a)
    c = tr.begin("call")
    tr.end(c)
    call, it, grad, sync, call2 = tr.spans
    assert (call.parent_id, it.parent_id, grad.parent_id,
            sync.parent_id) == (0, call.span_id, it.span_id, grad.span_id)
    assert [s.call for s in tr.spans] == [1, 1, 1, 1, 2]
    assert [s.iteration for s in tr.spans] == [-1, 4, 4, 4, -1]
    assert sync.attrs == {"site": "decode_ok"}
    assert all(s.start <= s.end for s in tr.spans)
    assert it.attrs["host.syncs"] == 1 and call2.attrs["host.syncs"] == 0


def test_out_of_order_end_and_a_raise_close_every_inner_span():
    tr = host.HostTracer()

    @tr.traced("direction")
    def boom():
        tr.annotate(solver="chol")
        tr.begin("sync", site="never closed")
        raise RuntimeError

    outer = tr.begin("call")
    with pytest.raises(RuntimeError):
        boom()
    inner = tr.begin("tail")
    tr.begin("sync", site="fval")
    tr.end(outer)
    assert tr.current == 0
    assert all(s.end >= s.start for s in tr.spans)
    assert tr.spans[1].attrs == {"solver": "chol"}
    assert tr.spans[3].span_id == inner and tr.spans[4].end == tr.spans[0].end


def test_ring_keeps_the_newest_spans_and_counts_the_dropped():
    tr = host.HostTracer(capacity=8)
    for i in range(20):
        with tr.span("fleet", phase=i):
            pass
    assert len(tr.spans) == 8 and tr.dropped == 12 and tr.appended == 20
    assert [s.attrs["phase"] for s in tr.spans] == list(range(12, 20))


def test_no_profiler_range_while_no_profiler_runs(monkeypatch):
    opened = []
    real = torch.autograd.profiler.record_function

    def counting(name, *args):
        opened.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.autograd.profiler, "record_function", counting)
    _solve(iters=1)
    assert opened == []
    tr = host.HostTracer()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with tr.span("hessian"):
            with tr.sync("gp"):
                pass
    assert opened == ["repro_torch.hessian", "repro_torch.sync"]


def test_spans_share_the_profilers_clock():
    """Every span of a solve run under the profiler and its range in the
    profiler's events start and end within 0.5 ms of each other."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with host.HostTracer().span("warm"):     # the ranges' first use
            pass
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _, spans = _solve(iters=2)
    events = sorted(((e.name()[len(host.PREFIX):], e.start_ns(),
                      e.start_ns() + e.duration_ns())
                     for e in prof.profiler.kineto_results.events()
                     if e.name().startswith(host.PREFIX)),
                    key=lambda e: e[1])
    mine = sorted(((s.name, s.start, s.end) for s in spans),
                  key=lambda e: e[1])
    assert [e[0] for e in events] == [m[0] for m in mine]
    for (_, ks, ke), (_, s, e) in zip(events, mine):
        assert abs(s - ks) < 500_000 and abs(e - ke) < 500_000


@pytest.mark.parametrize("softmax", [False, True])
def test_a_solve_records_its_layers_and_counts_its_syncs(softmax):
    iters = 3
    res, spans = _solve(iters=iters, softmax=softmax)
    its = [s for s in spans if s.name == "iteration"]
    assert [s.iteration for s in its] == list(range(iters))
    assert len(res.history["wall_s"]) == iters
    (call,) = [s for s in spans if s.name == "call"]
    assert all(s.call == call.call for s in spans)
    by_id = {s.span_id: s for s in spans}
    for s in spans:
        if s.name == "fleet":
            # every fleet phase runs inside an iteration, under a layer
            assert s.iteration >= 0
            assert by_id[s.parent_id].name in (
                "gradient", "hessian", "linesearch")
    syncs = [s for s in spans if s.name == "sync"]
    assert call.attrs["host.syncs"] == len(syncs)
    for it in its:
        assert it.attrs["host.syncs"] == sum(
            1 for s in syncs if s.iteration == it.iteration)
    sites = {s.attrs["site"] for s in syncs}
    assert {"gp", "fval", "gnorm", "step", "decode_ok", "candidate"} <= sites
    assert ("eigh" if softmax else "cholesky") in sites
    for name in ("encode", "gradient", "hessian", "sketch_gram",
                 "direction", "linesearch", "tail"):
        assert any(s.name == name for s in spans), name
    # on the host, nothing is copied to a device
    assert call.attrs["host.h2d_pageable_copies"] == 0


def test_to_device_counts_copies_to_a_device_only():
    tr = host.HostTracer()
    t = torch.zeros(10, dtype=torch.float32)
    tr.to_device(t, torch.device("cpu"))
    assert tr.counts() == (0.0, 0.0, 0.0)
    out = tr.to_device(t, "meta")
    assert out.device.type == "meta"
    assert tr.counts() == (0.0, 1.0, 40.0)


def test_telemetry_sees_no_host_span_or_counter():
    tel = obs.Telemetry()
    objective, x, y = _data()
    clock = straggler.SimClock(straggler.StragglerModel(), telemetry=tel)
    core.oversketched_newton(objective, core.Dataset(x=x, y=y),
                             torch.zeros(x.shape[1]),
                             core.NewtonConfig(iters=2, coded_block_rows=128,
                                               sketch=core.OverSketchConfig(
                                                   256, 64, 0.25)),
                             model=clock, device="cpu")
    names = {s.name for s in tel.trace.spans}
    assert not names & {"call", "sync", "fleet", "tail", "sketch_gram"}
    assert not [k for k in tel.metrics.snapshot()["counters"]
                if k.startswith("host.")]


@pytest.mark.parametrize("family", ["oversketch", "srht"])
def test_program_counts_equal_the_outside_wrappers(family):
    """Sketch calls with their live blocks, coded launches with their live
    workers and solves with their dimension, from the program's spans,
    equal what the benchmark's wrappers count over the same solve."""
    from osnbench import spans as outside
    rec = outside.Recorder().install()
    try:
        _, spans = _solve(iters=3, sketch_family=family, use_kernels=True)
    finally:
        rec.remove()
    label = {"oversketch": "count", "srht": "srht"}
    sketch = [(label[s.attrs["family"]], s.attrs["k"], s.attrs["n"],
               s.attrs["d"], s.attrs["b"], s.attrs["live"])
              for s in spans if s.name == "sketch_gram" and s.attrs["fused"]]
    coded = []
    for s in spans:
        if s.name == "gradient" and s.attrs["tag"] != "exact":
            a = s.attrs
            coded.append((a["workers"], a["b"], a["s"], a["arrived"]))
            if a.get("relaunched"):
                coded.append((a["workers"], a["b"], a["s"], a["workers"]))
    solves = [(s.attrs["solver"], s.attrs["dim"]) for s in spans
              if s.name == "direction"]
    assert sketch == rec.sketch_calls() and len(sketch) == 3
    assert coded == rec.coded_calls() and len(coded) == 6
    assert solves == rec.solves
    assert any(c[3] < c[0] for c in coded)    # stragglers were erased
