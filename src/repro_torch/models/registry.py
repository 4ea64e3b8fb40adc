"""Model bundle: a uniform interface over the model families, consumed by
the server and the OSN readout head (the counterpart of
``repro/models/registry.py``).

A bundle exposes:
  specs()                    -> param Spec tree (shapes + logical axes)
  init(key)                  -> the model's modules with real parameters
  param_count()              -> parameters in the spec tree
  init_cache(batch, s)       -> serving cache
  prefill(params, ...)       -> (logits, cache)
  decode(params, cache, tok) -> (logits, cache)

The dense family is ported; the MoE, hybrid, SSM and encoder-decoder
families raise ``NotImplementedError`` (ROADMAP Queue 1 item 13), as do
the reference's ``abstract``, ``logical_axes``, ``input_specs``,
``supports`` and ``loss``, which come with training and the dry run.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch import resolve_device
from repro_torch.models import common, transformer
from repro_torch.models.common import ModelConfig

Pytree = Any
PORTED_FAMILIES = ("dense",)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One assigned input-shape cell."""
    name: str                 # train_4k | prefill_32k | decode_32k | long_500k
    kind: str                 # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}


class ModelBundle:
    def __init__(self, cfg: ModelConfig):
        if cfg.family not in PORTED_FAMILIES:
            raise NotImplementedError(
                f"{cfg.name}: the {cfg.family} family is not ported yet "
                f"(ROADMAP Queue 1 item 13)")
        self.cfg = cfg

    # ------------------------------------------------------------- params --
    def specs(self) -> Pytree:
        return transformer.decoder_specs(self.cfg)

    def init(self, key: torch.Tensor,
             device=None) -> transformer.DecoderLM:
        """The model with the reference's init from ``key`` on ``device``
        (the CUDA device when none is given)."""
        tree = common.materialize(self.specs(), key, self.cfg.compute_dtype,
                                  resolve_device(device))
        return transformer.DecoderLM(self.cfg, tree)

    def param_count(self) -> int:
        return common.param_count(self.specs())

    # --------------------------------------------------------------- steps --
    def init_cache(self, batch: int, max_seq: int, dtype=None,
                   device=None) -> Pytree:
        return transformer.init_cache(self.cfg, batch, max_seq, dtype,
                                      resolve_device(device))

    def prefill(self, params: transformer.DecoderLM, tokens: torch.Tensor,
                cache: Pytree, extra: Optional[torch.Tensor] = None):
        return transformer.prefill(self.cfg, params, tokens, cache, extra)

    def decode(self, params: transformer.DecoderLM, cache: Pytree,
               token: torch.Tensor):
        return transformer.decode_step(self.cfg, params, cache, token)


# --------------------------------------------------------------- registry ----
_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        from repro_torch import configs  # noqa: F401 — populate registry
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def get_bundle(name: str) -> ModelBundle:
    return ModelBundle(get_config(name))


def list_archs():
    if not _REGISTRY:
        from repro_torch import configs  # noqa: F401
    return sorted(_REGISTRY)
