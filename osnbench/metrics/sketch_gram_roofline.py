"""sketch_gram_roofline: the fused count-sketch -> Gram kernel's share of
its roofline.  Each call's least time, the larger of its operations over
67e12 FLOP/s and its bytes over 3.35e12 B/s (the frozen
``counts.sketch_gram_intensity`` at the blocks that survived), summed,
over the device time of every operation the calls launched."""
from osnbench import counts, trace

LAYER = "kernels"
UNIT = "%"


def read(ctx):
    calls = [c for c in ctx["recorder"].sketch_calls() if c[0] == "count"]
    s = trace.device_s(ctx["trace"], "sketch_gram")
    if not calls or s <= 0:
        return None
    bound = sum(counts.sketch_gram_bound_s(k, n, d, b, live)
                for _, k, n, d, b, live in calls)
    return 100.0 * bound / s
