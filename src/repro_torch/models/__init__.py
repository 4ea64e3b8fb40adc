"""The model zoo: the dense, MoE, hybrid (RG-LRU), SSM (SSD) and
encoder-decoder families (the counterpart of ``repro.models``)."""
from repro_torch.models.common import ModelConfig, Spec
from repro_torch.models.registry import (ModelBundle, ShapeSpec, SHAPES,
                                         get_bundle, get_config, list_archs)

__all__ = ["ModelConfig", "Spec", "ModelBundle", "ShapeSpec", "SHAPES",
           "get_bundle", "get_config", "list_archs"]
