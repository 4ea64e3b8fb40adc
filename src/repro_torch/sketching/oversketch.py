"""OverSketch family: the paper's stacked Count-Sketch blocks (Eq. 4); port
of ``repro/sketching/oversketch.py``.  The kernel path takes the fused
count-sketch -> Gram kernel."""
from __future__ import annotations

import dataclasses

import torch

import repro_torch.core.sketch as core_sketch
from repro_torch.kernels import ops as kops
from repro_torch.sketching.base import SketchFamily
from repro_torch.sketching.registry import register


@register("oversketch")
@dataclasses.dataclass(frozen=True)
class OverSketchFamily(SketchFamily):

    has_fused_gram = True

    def sample(self, key: torch.Tensor, num_rows: int,
               device=None) -> core_sketch.CountSketch:
        return core_sketch.sample_countsketch(key, num_rows, self.cfg,
                                              device=device)

    def apply(self, state: core_sketch.CountSketch, a: torch.Tensor,
              use_kernels: bool = False) -> torch.Tensor:
        if use_kernels:
            return kops.count_sketch_apply(state.h, state.sigma, a,
                                           self.cfg.block_size)
        return core_sketch.apply_sketch(state, a)

    def gram_fused(self, state: core_sketch.CountSketch, a: torch.Tensor,
                   survivors: torch.Tensor) -> torch.Tensor:
        return kops.sketch_gram_count(state.h, state.sigma, a,
                                      self.cfg.block_size, survivors)
