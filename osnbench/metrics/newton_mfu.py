"""newton_mfu: the whole Newton iteration's share of the card's float32
peak.  The operations that the window's iterations needed (the
objective's ``iteration_flops``: the coded gradient, the Hessian's square
root, the line search, the logged f and gradient; each sketch -> Gram call
at the blocks that survived, by its family's ``flops``; ``counts.py``:
each direction solve, each call's product-code encodes) over the window's
seconds and 67e12 FLOP/s.  The window is the one a traced run times
without the profiler (its spans count the work), so the profiler's host
cost is not in it.  It bounds every kernel's share: a kernel taken off the
path leaves its roofline silent but not this."""
from osnbench import counts

LAYER = "Newton loop"
UNIT = "%"


def read(ctx):
    plain = ctx["plain"]
    if not plain["iterations"] or plain["window_s"] <= 0:
        return None
    cfg, rec = ctx["config"], plain["recorder"]
    n, d = int(cfg["n"]), int(cfg["d"])
    ops = (ctx["objective"].iteration_flops(cfg) * plain["iterations"]
           + sum(fam.flops(live, **sizes)
                 for fam, sizes, live in rec.family_calls())
           + sum(counts.direction_flops(s, dim) for s, dim in rec.solves)
           + 2 * counts.encode_flops(n, d) * plain["calls"])
    return 100.0 * ops / plain["window_s"] / counts.FP32_FLOPS
