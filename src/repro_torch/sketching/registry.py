"""String-keyed registry of sketch families; port of
``repro/sketching/registry.py``."""
from __future__ import annotations

from typing import Callable, Dict, Type

from repro_torch.core.sketch import OverSketchConfig
from repro_torch.sketching.base import SketchFamily

_FAMILIES: Dict[str, Type[SketchFamily]] = {}


def register(name: str) -> Callable[[Type[SketchFamily]], Type[SketchFamily]]:
    def deco(cls: Type[SketchFamily]) -> Type[SketchFamily]:
        if name in _FAMILIES and _FAMILIES[name] is not cls:
            raise ValueError(f"sketch family {name!r} already registered")
        cls.name = name
        _FAMILIES[name] = cls
        return cls
    return deco


def get(name: str, cfg: OverSketchConfig, **kwargs) -> SketchFamily:
    """Instantiate family ``name`` with the shared dimension config."""
    try:
        cls = _FAMILIES[name]
    except KeyError:
        raise KeyError(
            f"unknown sketch family {name!r}; available: {available()}"
        ) from None
    return cls(cfg=cfg, **kwargs)


def available() -> list:
    return sorted(_FAMILIES)
