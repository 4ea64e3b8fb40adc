"""device_idle: the share of an iteration in which no operation ran on the
device: 1 - (the union of the device operations' intervals in the traced
span, an iteration) / (the window's seconds an iteration, timed without
the profiler, whose host work would stretch the idle gaps)."""

LAYER = "device"
UNIT = "%"


def read(ctx):
    plain = ctx["plain"]
    if not ctx["trace"]["ops"] or not ctx["iterations"] \
            or not plain["iterations"] or plain["window_s"] <= 0:
        return None
    busy = ctx["busy_s"] / ctx["iterations"]
    wall = plain["window_s"] / plain["iterations"]
    return 100.0 * (1.0 - busy / wall)
