"""Model bundle: a uniform interface over the model families, consumed by
the trainer, the server and the OSN readout head (the counterpart of
``repro/models/registry.py``).

A bundle exposes:
  specs()                    -> param Spec tree (shapes + logical axes)
  init(key)                  -> the model's modules with real parameters
  abstract()                 -> meta-tensor params (no allocation)
  logical_axes()             -> the specs' logical axes
  param_count()              -> parameters in the spec tree
  loss(params, batch)        -> scalar train loss
  init_cache(batch, s)       -> serving cache
  prefill(params, ...)       -> (logits, cache)
  decode(params, cache, tok) -> (logits, cache)
  input_specs(shape)         -> meta-tensor batch of one cell
  supports(shape)            -> (applicable, reason)

Every family is ported: dense, MoE, hybrid and SSM through
``transformer``, the encoder-decoder through ``encdec`` (its prefill takes
the frame embeddings as ``extra``).  ``init`` builds frozen modules
(``requires_grad`` off), as serving wants them; the trainer makes them
trainable (``model.requires_grad_(True)``).  ``prefill`` and ``decode``
run without autograd.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

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

    def abstract(self) -> Pytree:
        """Meta tensors of every parameter (the dry run's stand-in)."""
        return common.abstract(self.specs(), self.cfg.compute_dtype)

    def logical_axes(self) -> Pytree:
        return common.spec_axes(self.specs())

    def param_count(self) -> int:
        return common.param_count(self.specs())

    # --------------------------------------------------------------- steps --
    def loss(self, params: nn.Module,
             batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The scalar train loss of ``batch`` (tokens, labels, and the
        family's frame or patch embeddings)."""
        return self._mod.loss_fn(self.cfg, params, batch)

    def init_cache(self, batch: int, max_seq: int, dtype=None,
                   device=None) -> Pytree:
        return self._mod.init_cache(self.cfg, batch, max_seq, dtype,
                                    resolve_device(device))

    @torch.no_grad()
    def prefill(self, params: nn.Module, tokens: torch.Tensor,
                cache: Pytree, extra: Optional[torch.Tensor] = None):
        if self.is_encdec:
            return encdec.prefill(self.cfg, params, tokens, cache, extra)
        return transformer.prefill(self.cfg, params, tokens, cache, extra)

    @torch.no_grad()
    def decode(self, params: nn.Module, cache: Pytree, token: torch.Tensor):
        return self._mod.decode_step(self.cfg, params, cache, token)

    # --------------------------------------------------------- input specs --
    def input_specs(self, shape: ShapeSpec, *, reduced: bool = False
                    ) -> Dict[str, torch.Tensor]:
        """Meta-tensor stand-ins (``device="meta"``) for every model input
        of one cell: int32 tokens and labels, embeddings in the compute
        dtype.  For the patch stub, the tokens are the sequence less its
        patches while the labels cover the whole sequence."""
        cfg = self.cfg
        b, s = shape.global_batch, shape.seq_len
        dt = cfg.compute_dtype

        def meta(shp, dtype=torch.int32):
            return torch.empty(shp, dtype=dtype, device="meta")
        if shape.kind == "train":
            if self.is_encdec:
                return {"tokens": meta((b, s)), "labels": meta((b, s)),
                        "frame_embeds": meta((b, cfg.encoder_seq,
                                              cfg.d_model), dt)}
            out = {"tokens": meta((b, s - cfg.num_patches)),
                   "labels": meta((b, s))}
            if cfg.frontend == "patch_stub":
                out["patch_embeds"] = meta((b, cfg.num_patches,
                                            cfg.d_model), dt)
            return out
        if shape.kind == "prefill":
            out = {"tokens": meta((b, s - cfg.num_patches))}
            if self.is_encdec:
                out["frame_embeds"] = meta((b, cfg.encoder_seq,
                                            cfg.d_model), dt)
            elif cfg.frontend == "patch_stub":
                out["patch_embeds"] = meta((b, cfg.num_patches,
                                            cfg.d_model), dt)
            return out
        # decode: one new token against a seq_len cache
        return {"token": meta((b,))}

    def supports(self, shape: ShapeSpec) -> Tuple[bool, str]:
        """Cell applicability, as the reference decides it."""
        if shape.name == "long_500k" and self.cfg.family not in ("ssm",
                                                                 "hybrid"):
            return False, ("full-attention architecture: 500k decode needs "
                           "sub-quadratic attention (skip per assignment)")
        return True, ""


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
