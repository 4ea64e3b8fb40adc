"""host_syncs: the program's ``host.syncs`` counter an iteration (one a
blocking read of a device value by the host), as each ``iteration`` span
of the plain window recorded it.  None from a program without host
spans."""
from osnbench import hostspans

LAYER = "Newton loop"
UNIT = "count"


def read(ctx):
    got = hostspans.plain_window(ctx)
    if got is None:
        return None
    its, _ = got
    counts = [s.attrs.get("host.syncs") for s in its]
    if None in counts:
        return None
    return sum(counts) / len(its)
