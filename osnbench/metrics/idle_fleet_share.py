"""idle_fleet_share: the share of the traced span's device-idle time (the
trace's gaps between device operations) during which the host was in the
program's ``fleet`` spans, by the overlap of the intervals: how much of
the idle device waits on the simulated fleet's host work.  None from a
program without host spans."""
from osnbench import hostspans

LAYER = "device"
UNIT = "%"


def read(ctx):
    spans = hostspans.traced_spans(ctx)
    gaps = ctx["trace"]["gaps"]
    if spans is None or not gaps:
        return None
    fleet = [(s.start, s.end) for s in spans if s.name == "fleet"]
    if not fleet:
        return None
    idle = sum(g[0] for g in gaps)
    return 100.0 * hostspans.overlap_ns(gaps, fleet) / idle
