"""direction_ms: device milliseconds an iteration of the direction's
solve (``core/newton.py::_solve_direction``: Cholesky, or eigh and the
pinv), from the device trace."""
from osnbench import trace

LAYER = "direction"
UNIT = "ms"


def read(ctx):
    if not ctx["iterations"]:
        return None
    s = trace.device_s(ctx["trace"], "direction")
    return 1e3 * s / ctx["iterations"] if s > 0 else None
