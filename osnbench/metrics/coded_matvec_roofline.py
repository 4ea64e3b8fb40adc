"""coded_matvec_roofline: the coded block mat-vec kernel's share of its
roofline.  The bytes each launch needs (the arrived workers' encoded
blocks of X or X^T read once, x read once, the outputs written once) over
3.35e12 B/s, summed, over the device time of every operation the launches
made."""
from osnbench import counts, trace

LAYER = "kernels"
UNIT = "%"


def read(ctx):
    calls = ctx["recorder"].coded_calls()
    s = trace.device_s(ctx["trace"], "coded_matvec")
    if not calls or s <= 0:
        return None
    byts = sum(counts.coded_matvec_bytes(*c) for c in calls)
    return 100.0 * byts / counts.HBM_BW / s
