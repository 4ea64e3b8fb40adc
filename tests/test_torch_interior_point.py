"""``examples/interior_point_torch.py`` against ``examples/interior_point.py``
on the CPU: the same stage lines, the LP stages' c.x and feasibility and
the Lasso dual stages' objective and max |X^T z|, value for value."""
import re
import runpy
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
NUMBER = re.compile(r"[-+]?\d+\.\d+|True|False")


def _stages(text: str):
    """Each stage line's values: floats, and feasibility as 1.0 or 0.0."""
    rows = []
    for line in text.splitlines():
        if line.startswith("  tau="):
            rows.append([1.0 if v == "True" else 0.0 if v == "False"
                         else float(v) for v in NUMBER.findall(line)])
    return rows


def test_interior_point_example_matches_reference(monkeypatch, capsys):
    import repro.core.newton as j_newton
    # The reference caches its jitted Hessian by objective, which the LP's
    # array c cannot key (its hash is refused): the uncached function is the
    # same computation, so its script runs.
    monkeypatch.setattr(j_newton, "_jitted_sketched_hessian",
                        j_newton._jitted_sketched_hessian.__wrapped__)
    runpy.run_path(str(ROOT / "examples" / "interior_point.py"),
                   run_name="__main__")
    want = _stages(capsys.readouterr().out)
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "interior_point_torch.py"),
         "--device", "cpu"], capture_output=True, text=True, check=True,
        cwd=str(ROOT), env={"PYTHONPATH": str(ROOT / "src"),
                            "PATH": "/usr/bin:/bin"})
    got = _stages(out.stdout)
    assert len(want) == 7 and len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
    # Every LP stage is strictly feasible; the dual approaches |X^T z| <= lam.
    assert all(row[-1] == 1.0 for row in got[:4])
    assert all(row[-2] < row[-1] for row in got[4:])
