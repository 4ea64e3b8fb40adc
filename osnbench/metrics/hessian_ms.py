"""hessian_ms: device milliseconds an iteration of the Hessian phase
(``core/newton.py::_hessian_phase``: the square root A, the sketch's
draws, the fused sketch -> Gram kernel), from the device trace."""
from osnbench import trace

LAYER = "Hessian sketch"
UNIT = "ms"


def read(ctx):
    if not ctx["iterations"]:
        return None
    s = trace.device_s(ctx["trace"], "hessian")
    return 1e3 * s / ctx["iterations"] if s > 0 else None
