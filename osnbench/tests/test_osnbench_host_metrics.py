"""The readers of the program's host spans (``hostspans.py`` and the
metrics ``fleet_host_ms``, ``sync_wait_ms``, ``host_syncs`` and
``idle_fleet_share``) on a hand-built tracer and trace of known overlap."""
import sys

import pytest

from osnbench import hostspans, spec


def _span(tr, name, start, end, **attrs):
    sid = tr.begin(name, start=start, **attrs)
    return lambda: tr.end(sid, end=end)


def _iteration(tr, t, start, fleet=(), syncs=()):
    """An iteration span at ``start`` .. ``start`` + 100 with ``fleet`` and
    ``sync`` children at the given (start, end) offsets."""
    close = _span(tr, "iteration", start, start + 100, t=t)
    for a, b in fleet:
        _span(tr, "fleet", start + a, start + b)()
    for a, b in syncs:
        tr.metrics.counter("host.syncs").inc()
        _span(tr, "sync", start + a, start + b, site="gp")()
    close()


def _call(tr, start, iterations):
    close = _span(tr, "call", start, start + 100 * len(iterations))
    for t, (fleet, syncs) in enumerate(iterations):
        _iteration(tr, t, start + 100 * t, fleet, syncs)
    close()


def _ctx(plain_iterations=2, first_op=1005,
         gaps=((20, 1000), (30, 1030), (10, 1090))):
    ops = [("k", first_op, 1, ())]
    return {"trace": {"ops": ops, "gaps": [(n, at, "a", "b")
                                           for n, at in gaps]},
            "iterations": 1, "plain": {"iterations": plain_iterations}}


@pytest.fixture
def tracer(monkeypatch):
    """A fresh tracer in the process-wide one's place: a warm-up call,
    a plain window of two iterations (one call), a traced call."""
    from repro_torch.obs import host
    tr = host.HostTracer()
    monkeypatch.setattr(host, "TRACER", tr)
    _call(tr, -300, [([(10, 20)], [(30, 35)])])
    _call(tr, 0, [([(10, 30), (50, 60)], [(70, 75), (80, 90)]),
                  ([(5, 25)], [(40, 41)])])
    _call(tr, 1000, [([(10, 40), (60, 95)], [(96, 99)])])
    return tr


def read(name, ctx):
    return spec.metric_reader(name).read(ctx)


def test_plain_window_readers_are_exact(tracer):
    ctx = _ctx()
    # fleet 20 + 10 ns, then 20 ns: 50 ns over two iterations
    assert read("fleet_host_ms", ctx) == pytest.approx(50 / 1e6 / 2)
    # sync 5 + 10, then 1
    assert read("sync_wait_ms", ctx) == pytest.approx(16 / 1e6 / 2)
    # two syncs, then one
    assert read("host_syncs", ctx) == pytest.approx(1.5)


def test_plain_window_is_the_last_iterations_before_the_trace(tracer):
    its, members = hostspans.plain_window(_ctx(plain_iterations=1))
    assert [(s.call, s.iteration) for s in its] == [(2, 1)]
    assert {s.name for s in members} == {"iteration", "fleet", "sync"}
    assert all(s.iteration == 1 and s.call == 2 for s in members)


def test_idle_fleet_share_is_the_overlap_of_intervals(tracer):
    # fleet spans [1010, 1040] and [1060, 1095]; gaps [1000, 1020],
    # [1030, 1060], [1090, 1100]: 10 + 10 + 5 of 60 ns overlap, the first
    # gap starting before the span it overlaps
    assert read("idle_fleet_share", _ctx()) == pytest.approx(100 * 25 / 60)


def test_idle_by_leaf_names_every_idle_ns(tracer):
    rows = hostspans.idle_by_leaf(_ctx())
    # [1000, 1010] iteration, [1010, 1020] fleet; [1030, 1040] fleet,
    # [1040, 1060] iteration; [1090, 1095] fleet, [1095, 1096] iteration,
    # [1096, 1099] sync, [1099, 1100] iteration
    want = {"iteration": 10 + 20 + 1 + 1, "fleet": 10 + 10 + 5, "sync": 3,
            "none": 0}
    assert rows == pytest.approx({k: v / 1e6 for k, v in want.items()})
    assert sum(rows.values()) == pytest.approx(60 / 1e6)


def test_leaf_segments_nest():
    class S:
        def __init__(self, name, start, end):
            self.name, self.start, self.end = name, start, end
    segs = hostspans.leaf_segments([S("a", 0, 10), S("b", 2, 4),
                                    S("c", 4, 6), S("d", 8, 10)])
    assert segs == [(0, 2, "a"), (2, 4, "b"), (4, 6, "c"), (6, 8, "a"),
                    (8, 10, "d")]


@pytest.mark.parametrize("name", ["fleet_host_ms", "sync_wait_ms",
                                  "host_syncs", "idle_fleet_share"])
def test_readers_give_none_without_the_program_spans(tracer, monkeypatch,
                                                     name):
    assert read(name, _ctx()) is not None
    # more plain iterations than the ring holds before the trace
    if name != "idle_fleet_share":
        assert read(name, _ctx(plain_iterations=5)) is None
    # a ring that dropped the window's spans
    small = type(tracer)(capacity=3)
    for s in list(tracer.spans)[-3:]:
        small.spans.append(s)
    small.appended = tracer.appended
    from repro_torch.obs import host
    monkeypatch.setattr(host, "TRACER", small)
    assert read(name, _ctx()) is None
    # a program without the host tracer, as the one before it
    import repro_torch.obs
    monkeypatch.delattr(repro_torch.obs, "host")
    monkeypatch.setitem(sys.modules, "repro_torch.obs.host", None)
    assert hostspans.tracer() is None
    assert read(name, _ctx()) is None
