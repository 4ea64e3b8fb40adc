"""fleet_host_ms: host milliseconds an iteration that the program spent in
the simulated fleet (its ``fleet`` spans: ``runtime.FleetEngine.run_phase``
and ``charge``), over the iterations of the plain window, timed without
the profiler.  The program's own spans (``repro_torch.obs.host``): None
from a program that has none."""
from osnbench import hostspans

LAYER = "fleet (host)"
UNIT = "ms"


def read(ctx):
    return hostspans.per_iteration_ms(ctx, "fleet")
