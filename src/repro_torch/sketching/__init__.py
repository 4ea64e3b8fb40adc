"""Pluggable sketching subsystem: block-structured sketch families behind a
string-keyed registry, plus Marchenko-Pastur direction debiasing.
``get(name, cfg)`` is what ``core.newton`` calls."""
from repro_torch.sketching.base import SketchFamily, next_pow2
from repro_torch.sketching.registry import available, get, register
from repro_torch.sketching.debias import (debias_direction, mp_factor,
                                          mp_stalled, rows_for_target)

# Importing a family module registers it.
from repro_torch.sketching.oversketch import OverSketchFamily
from repro_torch.sketching.sjlt import SJLTFamily
from repro_torch.sketching.srht import SRHTFamily
from repro_torch.sketching.gaussian import GaussianFamily
from repro_torch.sketching.nystrom import NystromFamily
from repro_torch.sketching.leverage import LeverageFamily

__all__ = ["SketchFamily", "available", "get", "register",
           "debias_direction", "mp_factor", "mp_stalled", "rows_for_target",
           "next_pow2", "OverSketchFamily", "SJLTFamily", "SRHTFamily",
           "GaussianFamily", "NystromFamily", "LeverageFamily"]
