"""sync_wait_ms: host milliseconds an iteration blocked in the program's
``sync`` spans, each a read of a device value by the host, so how long the
host waited for the device; over the iterations of the plain window, timed
without the profiler.  None from a program without host spans."""
from osnbench import hostspans

LAYER = "Newton loop"
UNIT = "ms"


def read(ctx):
    return hostspans.per_iteration_ms(ctx, "sync")
