"""The paper's figure benches and the fleet, scheduler and tenancy sweeps;
port of the JAX package's ``benchmarks/`` (one module per figure or sweep,
each with ``run(quick=True)``), driven by ``python -m
repro_torch.benchmarks.run``.

Each figure module keeps the reference's configurations (seeds, iteration
counts, sketch dimensions, worker counts, fleet and cost models) and row
names.  Its body takes the dataset and the iteration counts, so that the
same comparison runs at any size; ``run`` calls it at the reference's
sizes.  The Newton runs take the kernels: on
the card that is the port's path, and on the CPU every kernel entry point
takes its plain version.  The fleet, scheduler and tenancy sweeps run on
the host.
"""
