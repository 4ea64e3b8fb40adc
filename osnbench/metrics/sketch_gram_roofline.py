"""sketch_gram_roofline: the fused sketch -> Gram kernel's share of its
roofline.  Each call's least time, the larger of its operations over
67e12 FLOP/s and its bytes over 3.35e12 B/s at the blocks that survived
(its family's ``bound_s``: the count sketch's frozen
``counts.sketch_gram_intensity``, the SJLT's ``counts.sjlt_gram_intensity``),
summed, over the device time of every operation the calls launched.  None
where a call's family has no roofline (the SRHT's)."""
from osnbench import trace

LAYER = "kernels"
UNIT = "%"


def read(ctx):
    bounds = [fam.bound_s(live, **sizes)
              for fam, sizes, live in ctx["recorder"].family_calls()]
    s = trace.device_s(ctx["trace"], "sketch_gram")
    if not bounds or None in bounds or s <= 0:
        return None
    return 100.0 * sum(bounds) / s
