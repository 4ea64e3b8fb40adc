"""Pluggable sketching subsystem: block-structured sketch families behind a
string-keyed registry.  ``get(name, cfg)`` is what ``core.newton`` calls."""
from repro_torch.sketching.base import SketchFamily
from repro_torch.sketching.registry import available, get, register

# Importing a family module registers it.
from repro_torch.sketching.oversketch import OverSketchFamily

__all__ = ["SketchFamily", "available", "get", "register",
           "OverSketchFamily"]
