"""CPU tests of the benchmark: ``python -m pytest osnbench/tests`` from the
root of the repository.  The port's package is imported from ``src/``."""
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
for p in (str(REPO), str(REPO / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)
# The tests' shapes are small: a few threads a process run them faster
# than every core, when several test processes share the machine.
torch.set_num_threads(2)


# Each configuration's sizes in the CPU tests, and its mixes' sketch sizes.
TINY = {"synthetic-logistic": ({"n": 2000, "d": 40},
                               {"sketch_dim": 512, "block_size": 64,
                                "coded_block_rows": 128}),
        "emnist-softmax": ({"n": 1500, "d": 12, "classes": 4},
                           {"sketch_dim": 384, "block_size": 64,
                            "coded_block_rows": 128})}


@pytest.fixture
def tiny():
    """A cell of BENCHMARK.json cut to a CPU test's size: the same
    objective, family, traffic and limits, the sizes of a few seconds'
    run."""
    from osnbench import spec

    def make(name: str) -> dict:
        cell = spec.cell(name)
        sizes, sketch = TINY[cell["config"]["name"]]
        cell["config"].update(sizes)
        cell["traffic"].update(sketch)
        return cell
    return make
