"""Fig. 1: straggler tail of a 3600-worker distributed job; port of
``benchmarks/fig1_stragglers.py``.

Paper: median ~135 s, ~2% of workers up to ~180 s.  We sample the calibrated
straggler model at the paper's scale and report the median, the tail
fraction and the p99/median ratio.  The fleet samples on the host.
"""
from __future__ import annotations

import numpy as np

from repro_torch import prng
from repro_torch.core.straggler import StragglerModel


def run(quick: bool = True):
    model = StragglerModel(base_time=135.0, invoke_overhead=0.0)
    times = model.sample_times(prng.PRNGKey(0), 3600).numpy()
    med = float(np.median(times))
    frac_tail = float((times > 1.25 * med).mean())
    p99 = float(np.percentile(times, 99))
    mx = float(times.max())
    return [{
        "name": "fig1_straggler_tail",
        "us": med * 1e6,
        "derived": (f"median_s={med:.1f};tail_frac={frac_tail:.3f};"
                    f"p99_s={p99:.1f};max_s={mx:.1f}"),
    }]
