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

Every family is ported: dense, MoE, hybrid and SSM through
``transformer``, the encoder-decoder through ``encdec`` (its prefill takes
the frame embeddings as ``extra``).  The reference's ``abstract``,
``logical_axes``, ``input_specs``, ``supports`` and ``loss`` come with
training and the dry run (ROADMAP Queue 1 items 12 and 13).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch import resolve_device
from torch import nn

from repro_torch.models import common, encdec, transformer
from repro_torch.models.common import ModelConfig

Pytree = Any


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


def build(cfg: ModelConfig, tree: Pytree) -> nn.Module:
    """The modules of ``cfg``'s family from a parameter tree in the
    reference's layout."""
    if cfg.family == "encdec":
        return encdec.EncDecLM(cfg, tree)
    return transformer.build(cfg, tree)


class ModelBundle:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.is_encdec = cfg.family == "encdec"
        self._mod = encdec if self.is_encdec else transformer

    # ------------------------------------------------------------- params --
    def specs(self) -> Pytree:
        if self.is_encdec:
            return encdec.encdec_specs(self.cfg)
        return transformer.decoder_specs(self.cfg)

    def init(self, key: torch.Tensor, device=None) -> nn.Module:
        """The model with the reference's init from ``key`` on ``device``
        (the CUDA device when none is given)."""
        tree = common.materialize(self.specs(), key, self.cfg.compute_dtype,
                                  resolve_device(device))
        return build(self.cfg, tree)

    def param_count(self) -> int:
        return common.param_count(self.specs())

    # --------------------------------------------------------------- steps --
    def init_cache(self, batch: int, max_seq: int, dtype=None,
                   device=None) -> Pytree:
        return self._mod.init_cache(self.cfg, batch, max_seq, dtype,
                                    resolve_device(device))

    def prefill(self, params: nn.Module, tokens: torch.Tensor,
                cache: Pytree, extra: Optional[torch.Tensor] = None):
        if self.is_encdec:
            return encdec.prefill(self.cfg, params, tokens, cache, extra)
        return transformer.prefill(self.cfg, params, tokens, cache, extra)

    def decode(self, params: nn.Module, cache: Pytree, token: torch.Tensor):
        return self._mod.decode_step(self.cfg, params, cache, token)


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
